"""The port's input pipeline against the reference's, on the CPU.

`TokenBatches` gives the reference's batches across seeds, epochs and
process splits; the reference's prefetch tests are mirrored; the
pipeline feeds the port's TINY step; and one launch of 2 gloo processes
at fsdp 2 assembles the reference's one-process global batches and
resumes a `"dcp"` and a local checkpoint of the sharded state bit for
bit."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from kubeflow_tpu.runtime.data import TokenBatches as RefTokenBatches
from kubeflow_tpu_torch import dryrun
from kubeflow_tpu_torch.models import configs, train
from kubeflow_tpu_torch.runtime.data import (
    DevicePrefetcher,
    TokenBatches,
    batch_rank,
    input_pipeline,
    to_device,
)

TOKENS = np.arange(10_000) % 251


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _take(batches, n):
    return list(itertools.islice(iter(batches), n))


@pytest.mark.parametrize("seed,count", [(0, 1), (3, 2), (7, 4)])
def test_token_batches_match_reference(seed, count):
    """Every process of a split, two epochs (the second reshuffled): the
    same int32 rows as the reference's, bit for bit."""
    for index in range(count):
        kw = dict(global_batch=8, seq_len=32, seed=seed, num_epochs=2,
                  process_index=index, process_count=count)
        ours = list(TokenBatches(TOKENS, **kw))
        ref = list(RefTokenBatches(TOKENS, **kw))
        assert len(ours) == len(ref) == 2 * ((len(TOKENS) - 1) // 32 // 8)
        for a, b in zip(ours, ref):
            for key in ("inputs", "targets"):
                assert a[key].dtype == b[key].dtype == np.int32
                np.testing.assert_array_equal(a[key], b[key])


def test_token_batches_default_to_one_process_and_validate():
    assert batch_rank() == (0, 1)
    batches = TokenBatches(TOKENS, 8, 32)
    assert (batches.process_index, batches.process_count) == (0, 1)
    with pytest.raises(ValueError, match="not divisible"):
        TokenBatches(TOKENS, 9, 32, process_count=2)
    with pytest.raises(ValueError, match="windows"):
        TokenBatches(TOKENS[:100], 64, 32)


class TestPrefetch:
    def test_prefetcher_preserves_order_and_terminates(self):
        src = ({"i": np.full((2,), n)} for n in range(7))
        pf = DevicePrefetcher(src, depth=3)
        assert [int(b["i"][0]) for b in pf] == list(range(7))

    def test_prefetcher_propagates_loader_errors(self):
        def bad():
            yield {"i": np.zeros(1)}
            raise RuntimeError("disk on fire")

        pf = DevicePrefetcher(bad(), depth=2)
        next(pf)
        with pytest.raises(RuntimeError, match="disk on fire"):
            next(pf)

    def test_close_unblocks_producer(self):
        src = ({"i": np.full((1,), n)} for n in range(1000))
        pf = DevicePrefetcher(src, depth=1)
        next(pf)
        pf.close()  # must not hang on the full queue
        assert not pf._thread.is_alive()

    def test_cpu_transfer_gives_tensors_of_the_rows(self):
        batch = next(iter(TokenBatches(TOKENS, 4, 16, seed=1)))
        moved = to_device("cpu")(batch)
        for key in ("inputs", "targets"):
            assert moved[key].dtype == torch.int32
            np.testing.assert_array_equal(moved[key].numpy(), batch[key])


def test_pipeline_feeds_the_tiny_step():
    """input_pipeline without a mesh on the CPU: each batch is the
    TokenBatches batch, and four AdamW steps of TINY take them."""
    setup = train.setup_training(configs.TINY, device="cpu")
    pipe = input_pipeline(TOKENS, global_batch=8, seq_len=32, seed=4,
                          num_epochs=1, prefetch=2, device="cpu")
    want = _take(TokenBatches(TOKENS, 8, 32, seed=4, num_epochs=1), 4)
    losses = []
    for batch, ref in zip(pipe, want):
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(batch[key].numpy(), ref[key])
        _, metrics = setup.train_step(setup.state, batch)
        losses.append(float(metrics["loss"]))
    pipe.close()
    assert len(losses) == 4 and all(0 < x < 20 for x in losses)


# -- two gloo processes --------------------------------------------------------


def _fsdp2_battery(want: list, directory: str) -> dict:
    """Rank worker at data 1 x fsdp 2: the pipeline's global batches, and
    a dcp save after 2 AdamW steps resumed by a fresh setup from another
    seed, against 2 more uninterrupted steps."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager

    mesh = make_mesh(MeshConfig(data=1, fsdp=2), device="cpu")
    rows = TokenBatches(TOKENS, 8, 32, seed=2, num_epochs=1, mesh=mesh)
    pipe = input_pipeline(TOKENS, global_batch=8, seq_len=32, mesh=mesh,
                          seed=2, num_epochs=1, device="cpu")
    batches = _take(pipe, len(want))
    pipe.close()

    def optimizer():
        return train.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                       total_steps=20, mu_dtype="bfloat16")

    def full(state):
        sd = train.train_state_dict(state)
        return ({k: v.full_tensor() for k, v in sd["model"].items()},
                {k: v.full_tensor() for k, v in sd["optimizer"]["mu"].items()})

    run = train.setup_training(configs.TINY, mesh, device="cpu", seed=0,
                               optimizer=optimizer())
    for b in batches[:2]:
        run.train_step(run.state, b)
    mgr = CheckpointManager(directory)
    mgr.save(2, train.train_state_dict(run.state))
    # the local backend over the same sharded state: whole tensors saved
    # by each rank, redistributed on restore
    local = CheckpointManager(f"{directory}-local-{dist.get_rank()}",
                              backend="local")
    local.save(2, train.train_state_dict(run.state))
    straight = [float(run.train_step(run.state, b)[1]["loss"])
                for b in batches[2:4]]
    params, mu = full(run.state)

    fresh = train.setup_training(configs.TINY, mesh, device="cpu", seed=1,
                                 optimizer=optimizer())
    again = CheckpointManager(directory)
    like = train.train_state_dict(fresh.state)
    train.load_train_state(fresh.state, again.restore(like))
    resumed = [float(fresh.train_step(fresh.state, b)[1]["loss"])
               for b in batches[2:4]]
    params2, mu2 = full(fresh.state)
    from_local = train.setup_training(configs.TINY, mesh, device="cpu",
                                      seed=2, optimizer=optimizer())
    train.load_train_state(from_local.state, local.restore(
        train.train_state_dict(from_local.state)))
    resumed_local = [float(from_local.train_step(from_local.state, b)[1][
        "loss"]) for b in batches[2:4]]
    return {
        "rank": dist.get_rank(), "batch_rank": batch_rank(mesh),
        "rows": rows.process_index,
        "batches": [{k: v.numpy() for k, v in b.items()} for b in batches],
        "backend": mgr.backend, "latest": again.latest_step(),
        "step": fresh.state.step, "count": fresh.state.optimizer.count,
        "straight": straight, "resumed": resumed,
        "resumed_local": resumed_local,
        "params_equal": all(torch.equal(params[k], params2[k])
                            for k in params),
        "mu_equal": all(torch.equal(mu[k], mu2[k]) for k in mu),
    }


def test_two_gloo_processes_assemble_batches_and_resume_dcp(tmp_path):
    """2 processes at fsdp 2: every global batch equals the reference's
    one-process batch (rank 1's rows after rank 0's); the dcp checkpoint
    of the sharded AdamW state (bf16 first moment) resumes bit for bit,
    and so does a local one of the same state (whole tensors)."""
    want = _take(RefTokenBatches(TOKENS, 8, 32, seed=2, num_epochs=1,
                                 process_index=0, process_count=1), 4)
    got = dryrun.launch(2, _fsdp2_battery, (want, str(tmp_path / "dcp")),
                        timeout=300)
    assert got["rank"] == got["rows"] == 0 and got["batch_rank"] == (0, 2)
    for a, b in zip(got["batches"], want):
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(a[key], b[key])
    assert got["backend"] == "dcp" and got["latest"] == 2
    assert got["step"] == 4 and got["count"] == 4
    assert got["resumed"] == got["straight"] == got["resumed_local"]
    assert got["params_equal"] and got["mu_equal"]
    assert sorted(p.name for p in (tmp_path / "dcp").iterdir()) == \
        ["step_2.dcp"]
    assert [p.name for p in (tmp_path / "dcp-local-0").iterdir()] == \
        ["step_2.ckpt"]
