"""The port's in-notebook runtime against the reference's, on the CPU.

Metrics and telemetry: the registry's exposition and the step families
byte for byte, the agent's samples and summaries under one FakeClock,
and a port summary read by the reference controller's parser and
aggregator.  Checkpoints: the reference's checkpoint and torn-write
tests mirrored (a truncated `torch.save` file among them), a resumed
AdamW run bit-identical to an uninterrupted one, a reference AdamW run
continued in the port, the cull handshake honoured by the reference
culling controller, and the sidecar's session stores read across the
two packages."""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.api.types import Notebook, TPUSpec
from kubeflow_tpu.core import culler
from kubeflow_tpu.core import sessionstate as jsession
from kubeflow_tpu.core import telemetry as core_telemetry
from kubeflow_tpu.core.culling_controller import setup_culling
from kubeflow_tpu.core.jupyter import FakeJupyterState
from kubeflow_tpu.core.metrics import NotebookMetrics
from kubeflow_tpu.core.notebook_controller import setup_core_controllers
from kubeflow_tpu.kube import ApiServer, FakeCluster, Manager
from kubeflow_tpu.kube.meta import KubeObject, ObjectMeta
from kubeflow_tpu.models import configs as jconfigs
from kubeflow_tpu.models import train as jtrain
from kubeflow_tpu.parallel.mesh import MeshConfig, make_mesh
from kubeflow_tpu.runtime import metrics as jmetrics
from kubeflow_tpu.runtime import telemetry as jtelemetry
from kubeflow_tpu.tpu import topology
from kubeflow_tpu.utils import metrics as jregistry
from kubeflow_tpu.utils.clock import FakeClock
from kubeflow_tpu.utils.config import CoreConfig
from kubeflow_tpu_torch.core import sessionstate
from kubeflow_tpu_torch.models import configs, train
from kubeflow_tpu_torch.models.convert import (
    opt_state_from_optax,
    params_from_flax,
    state_dict_from_flax,
)
from kubeflow_tpu_torch.runtime import checkpoint, metrics, telemetry
from kubeflow_tpu_torch.runtime.checkpoint import (
    ACK_FILE,
    REQUEST_FILE,
    CheckpointManager,
    CheckpointSidecar,
    CullSignalWatcher,
    checkpoint_on_cull,
    restore_instructions,
)
from kubeflow_tpu_torch.runtime.data import TokenBatches
from kubeflow_tpu_torch.runtime.roofline import GPU_PEAKS
from kubeflow_tpu_torch.utils import metrics as registry

H100 = "NVIDIA H100 80GB HBM3"
# the agents run the same float formulas in the same order
AGENT_RTOL = 1e-12
# the AdamW continuation: tests/test_torch_train.py's AdamW tolerance
ADAMW_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several CPU workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# -- metrics ------------------------------------------------------------------


def _observe(reg) -> None:
    """The same families and observations on either package's Registry."""
    c = reg.counter("demo_requests_total", "Requests", labels=("code",))
    c.labels("200").inc()
    c.labels("500").inc(2.5)
    g = reg.gauge("demo_inflight", "In flight")
    g.set(3)
    fn = reg.gauge("demo_fn", "From a function")
    fn.set_function(lambda: 1.25)
    h = reg.histogram("demo_latency_seconds", "Latency", labels=("verb",),
                      buckets=(0.1, 1.0, 10.0))
    for v, ex in ((0.05, {"trace_id": "a"}), (0.5, None), (3.0, None),
                  (30.0, {"trace_id": "b"})):
        h.labels("get").observe(v, exemplar=ex)
    h.labels("put").observe(0.2)
    capped = reg.gauge("demo_capped", "Capped", labels=("ns",),
                       max_label_sets=2)
    for ns in ("a", "b", "c"):
        capped.labels(ns).set(1)


def test_registry_renders_the_reference_bytes():
    ours, ref = registry.Registry(), jregistry.Registry()
    _observe(ours)
    _observe(ref)
    assert ours.render() == ref.render()
    assert ours.render(openmetrics=True) == ref.render(openmetrics=True)
    assert ours.families() == ref.families()
    assert ours.labelsets_dropped() == ref.labelsets_dropped()


def test_step_families_render_the_reference_bytes():
    ours, ref = registry.Registry(), jregistry.Registry()
    fams = metrics.register_step_metrics(ours)
    jfams = jmetrics.register_step_metrics(ref)
    assert metrics.register_step_metrics(ours)["step_duration"] \
        is fams["step_duration"]
    assert metrics.STEP_TIME_BUCKETS == jmetrics.STEP_TIME_BUCKETS
    for v in (0.004, 0.3, 0.3, 7.0, 99.0):
        fams["step_duration"].observe(v)
        jfams["step_duration"].observe(v)
    for name in ("tokens_per_second", "mfu_ratio", "hbm_bytes_in_use"):
        fams[name].set(0.5)
        jfams[name].set(0.5)
    assert ours.render() == ref.render()
    assert ours.families() == ref.families()


def test_hbm_usage_is_keyed_per_card():
    usage = metrics.hbm_usage_bytes()
    if torch.cuda.is_available():
        assert sorted(usage) == [f"cuda:{i}" for i in
                                 range(torch.cuda.device_count())]
    else:
        assert usage == {}


def test_step_timer_reads_the_injected_clock():
    clock = FakeClock(start=0.0)
    timer = metrics.StepTimer(configs.TINY, batch=4, seq_len=128,
                              num_chips=1, accelerator=H100,
                              time_fn=clock.now)
    timer.observe()            # arms the timer; no interval yet
    clock.advance(0.1)
    timer.observe()
    clock.advance(0.3)
    timer.observe()
    assert timer.step_time_s == pytest.approx(0.2)
    hist = timer.registry.get("notebook_training_step_duration_seconds")
    assert hist.count_value() == 2
    assert hist.bucket_counts()[0.1] == 1
    assert timer.tokens_per_s == pytest.approx(4 * 128 / 0.2)
    assert isinstance(timer.report()["mfu"], float)
    assert "# TYPE notebook_training_mfu_ratio gauge" in \
        timer.prometheus_text()


# -- telemetry ----------------------------------------------------------------


@pytest.fixture
def h100_in_reference(monkeypatch):
    """The reference's accelerator table with the H100 at the port's
    GPU_PEAKS rates, so both agents divide by the same peak."""
    peak = GPU_PEAKS[H100]
    monkeypatch.setitem(topology.ACCELERATORS, H100, topology.Accelerator(
        H100, "nvidia-h100", 1, 8, 8, 80, peak.bf16_tflops, peak.hbm_gbps))


def _drive(agent_cls, cfg, mode, clock, spool=None):
    published = []
    agent = agent_cls(config=cfg, batch=4, seq_len=128, num_chips=2,
                      accelerator=H100, mode=mode, worker="nb-0", window=3,
                      ring_size=4, time_fn=clock.now,
                      hbm_fn=lambda: {"cuda:0": 7 << 20, "cuda:1": 5 << 20},
                      publish_fn=published.append, publish_interval_s=1.0)
    if spool is not None:
        agent.spool_to(spool)
    agent.step_boundary()
    for i, dt in enumerate((0.25, 0.5, 0.125, 0.75, 0.3, 0.6)):
        with agent.scope("fwd"):
            clock.advance(dt / 3)
        with agent.scope("bwd"):
            clock.advance(dt * 2 / 3)
        agent.step_boundary()
        if i == 2:
            agent.record_step(0.05)
    summary = agent.summary()
    agent.publish_now()
    return agent, summary, published


def _same(got, want) -> None:
    """Equal structure, keys and strings; floats within AGENT_RTOL."""
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=AGENT_RTOL, abs=0.0)
    else:
        assert got == want


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_agent_samples_and_summaries_match_reference(mode, h100_in_reference,
                                                     tmp_path):
    """Same FakeClock, same durations: every sample, the summary and every
    publish equal the reference agent's; the floats within 1e-12."""
    ours = _drive(telemetry.TelemetryAgent, configs.TINY, mode,
                  FakeClock(start=0.0), str(tmp_path / "ours.jsonl"))
    ref = _drive(jtelemetry.TelemetryAgent, jconfigs.TINY, mode,
                 FakeClock(start=0.0), str(tmp_path / "ref.jsonl"))
    _same(ours[1], ref[1])
    _same(ours[2], ref[2])
    _same(ours[0].samples(), ref[0].samples())
    assert len(ours[2]) > 2 and len(ours[0].samples()) == 4
    _same(telemetry.JsonlRing(str(tmp_path / "ours.jsonl")).read(),
          jtelemetry.JsonlRing(str(tmp_path / "ref.jsonl")).read())
    summary = ours[1]
    assert isinstance(summary["mfu"], float) and summary["mfu"] > 0
    assert isinstance(summary["roofline_fraction"], float)
    assert ours[0].registry.render() == ref[0].registry.render()


def test_unknown_accelerator_raises():
    with pytest.raises(KeyError):
        telemetry.TelemetryAgent(config=configs.TINY, accelerator="v5e")
    with pytest.raises(KeyError):
        jtelemetry.TelemetryAgent(config=jconfigs.TINY,
                                  accelerator="NVIDIA A100").mfu


def _pod(api, name, payload):
    return api.create(KubeObject(
        api_version="v1", kind="Pod",
        metadata=ObjectMeta(name=name, namespace="u1",
                            labels={"notebook-name": "nb"},
                            annotations={telemetry.TELEMETRY_ANNOTATION:
                                         payload}),
        body={"status": {"phase": "Running"}}))


def test_port_annotation_is_read_by_the_reference_controller():
    """A port worker's annotation passes the reference's parsers and
    counts as a complete worker (tokens/s, step time and a numeric mfu)
    in WorkerTelemetryAggregator; a straggler among port workers is
    found."""
    assert telemetry.TELEMETRY_ANNOTATION == \
        core_telemetry.TELEMETRY_ANNOTATION
    assert telemetry.SUMMARY_VERSION == jtelemetry.SUMMARY_VERSION
    api = ApiServer()
    summaries = {}
    for w, dt in enumerate((1.0, 1.0, 4.0)):
        agent = telemetry.TelemetryAgent(
            config=configs.BENCH_CHIP, batch=8, seq_len=2048, accelerator=H100,
            worker=f"nb-{w}", time_fn=lambda: 0.0, hbm_fn=lambda: {})
        for _ in range(3):
            agent.record_step(dt)
        summaries[f"nb-{w}"] = agent.summary()
        payload = telemetry.annotation_payload(summaries[f"nb-{w}"])
        assert payload == jtelemetry.annotation_payload(summaries[f"nb-{w}"])
        assert jtelemetry.parse_annotation(payload) == summaries[f"nb-{w}"]
        assert telemetry.parse_annotation(payload) == summaries[f"nb-{w}"]
        parsed = core_telemetry.parse_pod_telemetry(_pod(api, f"nb-{w}",
                                                         payload))
        assert parsed["summary"] == summaries[f"nb-{w}"]
    assert telemetry.parse_annotation("{not json") is None
    agg = core_telemetry.WorkerTelemetryAggregator(api, jregistry.Registry(),
                                                   FakeClock())
    out = agg.evaluate()
    entry = out["notebooks"]["u1/nb"]
    assert sorted(entry["workers"]) == ["nb-0", "nb-1", "nb-2"]
    assert entry["mfu"] == pytest.approx(
        sum(s["mfu"] for s in summaries.values()) / 3)
    assert [s["worker"] for s in out["stragglers"]] == ["nb-2"]


def test_jsonl_ring_compacts_to_the_reference_lines(tmp_path):
    ours = telemetry.JsonlRing(str(tmp_path / "ours.jsonl"), max_records=3)
    ref = jtelemetry.JsonlRing(str(tmp_path / "ref.jsonl"), max_records=3)
    for i in range(8):
        rec = {"step": i, "t": i * 0.5, "phases": {"fwd": 0.1}}
        ours.append(rec)
        ref.append(rec)
    assert (tmp_path / "ours.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    assert ours.read() == ref.read() == [
        {"step": i, "t": i * 0.5, "phases": {"fwd": 0.1}} for i in (5, 6, 7)]


# -- checkpoints: the reference's tests, mirrored -----------------------------


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        assert mgr.backend == "local"
        state = {"w": torch.arange(8.0), "step": torch.tensor(3)}
        mgr.save(3, state, wait=True)
        like = {"w": torch.zeros(8, dtype=torch.bfloat16),
                "step": torch.tensor(0)}
        restored = mgr.restore(like)
        assert float(restored["w"][5]) == 5.0
        assert restored["w"].dtype == torch.bfloat16  # state_like's dtype
        assert mgr.latest_step() == 3
        mgr.close()

    def test_restore_without_checkpoint_returns_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "empty"))
        assert mgr.restore({"w": torch.zeros(2)}) is None

    def test_restore_into_another_structure_raises(self, tmp_path):
        """A step that loads but does not fit is no torn write: it raises
        instead of starting cold."""
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(1, {"w": torch.ones(4)})
        with pytest.raises(KeyError):
            mgr.restore({"v": torch.zeros(4)})
        with pytest.raises(ValueError):
            mgr.restore({"w": torch.zeros(5)})
        assert mgr.latest_step() == 1

    def test_cull_signal_hook(self, tmp_path):
        signal_dir = tmp_path / "podinfo"
        signal_dir.mkdir()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        watcher = CullSignalWatcher(str(signal_dir))
        hook = checkpoint_on_cull(mgr, watcher)
        state = {"w": torch.ones(4)}
        assert hook(1, state) is False  # no signal yet
        (signal_dir / REQUEST_FILE).write_text("true")
        assert hook(2, state) is True
        assert (signal_dir / ACK_FILE).exists()
        assert mgr.latest_step() == 2
        assert hook(3, state) is False  # fires once


class TestTornCheckpoints:
    def _mgr(self, tmp_path):
        return CheckpointManager(str(tmp_path / "local"), backend="local")

    def test_local_roundtrip(self, tmp_path):
        mgr = self._mgr(tmp_path)
        state = {"w": torch.arange(8.0), "step": 3, "lr": 0.5}
        mgr.save(3, state)
        restored = mgr.restore({"w": torch.zeros(8), "step": 0, "lr": 0.0})
        assert torch.equal(restored["w"], state["w"])
        assert restored["step"] == 3 and restored["lr"] == 0.5

    def test_kill_mid_save_leaves_previous_step_restorable(
            self, tmp_path, monkeypatch):
        mgr = self._mgr(tmp_path)
        mgr.save(1, {"w": torch.ones(4)})

        def power_cut(src, dst):
            raise OSError("killed mid-save (before rename)")

        monkeypatch.setattr(os, "replace", power_cut)
        with pytest.raises(OSError):
            mgr.save(2, {"w": torch.full((4,), 2.0)})
        monkeypatch.undo()
        assert list(mgr.directory.glob(".tmp-*"))
        assert mgr.latest_step() == 1
        mgr2 = CheckpointManager(str(mgr.directory), backend="local")
        restored = mgr2.restore({"w": torch.zeros(4)})
        assert float(restored["w"][0]) == 1.0
        assert not list(mgr2.directory.glob(".tmp-*"))

    @pytest.mark.parametrize("husk", ["garbage", "truncated", "empty"])
    def test_corrupt_step_skipped_and_gced_on_restore(self, tmp_path, husk):
        """garbage bytes (the reference's case), a `torch.save` file cut
        in half (its zip reader raises RuntimeError) and an empty file."""
        mgr = self._mgr(tmp_path)
        mgr.save(1, {"w": torch.ones(2)})
        mgr.save(2, {"w": torch.full((2,), 2.0)})
        whole = (mgr.directory / "step_2.ckpt").read_bytes()
        data = {"garbage": b"\x00garbage", "empty": b"",
                "truncated": whole[:len(whole) // 2]}[husk]
        (mgr.directory / "step_3.ckpt").write_bytes(data)
        assert mgr.latest_step() == 3
        restored = mgr.restore({"w": torch.zeros(2)})
        assert float(restored["w"][0]) == 2.0
        assert not (mgr.directory / "step_3.ckpt").exists()
        assert mgr.latest_step() == 2

    def test_max_to_keep_prunes_oldest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "p"), max_to_keep=2,
                                backend="local")
        for step in (1, 2, 3):
            mgr.save(step, {"w": torch.full((2,), float(step))})
        assert mgr._steps() == [2, 3]


# -- resume -------------------------------------------------------------------


def _optimizer():
    return train.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                   total_steps=20, mu_dtype="bfloat16")


def _batches(n: int) -> list:
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, configs.TINY.vocab_size, 20_000)
    out = []
    for batch in TokenBatches(tokens, 4, 64, seed=2):
        out.append({k: torch.from_numpy(v) for k, v in batch.items()})
        if len(out) == n:
            return out


def test_resume_is_bit_identical(tmp_path):
    """6 AdamW steps (bf16 first moment, warmup 2) straight, against 3,
    a save, a fresh setup from another seed, a restore and 3 more: the
    resumed losses, parameters, moments, count and step equal the
    uninterrupted run's bit for bit."""
    batches = _batches(6)
    straight = train.setup_training(configs.TINY, device="cpu", seed=0,
                                    optimizer=_optimizer())
    want = [float(straight.train_step(straight.state, b)[1]["loss"])
            for b in batches]

    first = train.setup_training(configs.TINY, device="cpu", seed=0,
                                 optimizer=_optimizer())
    for b in batches[:3]:
        first.train_step(first.state, b)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), backend="local")
    mgr.save(3, train.train_state_dict(first.state))
    del first

    resumed = train.setup_training(configs.TINY, device="cpu", seed=1,
                                   optimizer=_optimizer())
    like = train.train_state_dict(resumed.state)
    train.load_train_state(resumed.state, mgr.restore(like))
    assert resumed.state.step == 3 and resumed.state.optimizer.count == 3
    assert resumed.state.optimizer.b1_mu == \
        straight.state.optimizer.b1_mu != 0.9
    got = [float(resumed.train_step(resumed.state, b)[1]["loss"])
           for b in batches[3:]]
    assert got == want[3:]
    a = train.train_state_dict(straight.state)
    b = train.train_state_dict(resumed.state)
    for part in ("model",):
        for name, t in a[part].items():
            assert torch.equal(t, b[part][name]), name
    for key in ("mu", "nu"):
        for name, t in a["optimizer"][key].items():
            assert torch.equal(t, b["optimizer"][key][name]), (key, name)
    assert a["step"] == b["step"] == 6


def test_optimizer_state_dict_is_keyed_by_name():
    setup = train.setup_training(configs.TINY, device="cpu",
                                 optimizer=_optimizer())
    sd = setup.state.optimizer.state_dict()
    names = [n for n, _ in setup.model.named_parameters()]
    assert list(sd["mu"]) == list(sd["nu"]) == names
    assert sd["mu"][names[0]].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        setup.state.optimizer.load_state_dict(
            {**sd, "mu": {**sd["mu"], "extra": torch.zeros(1)}})
    assert train.SGD(0.1).state_dict() == {}


# -- a reference AdamW run continued in the port ------------------------------


def _np(tree):
    import flax.linen as nn

    return jax.tree.map(np.asarray, jax.device_get(nn.unbox(tree)))


def test_reference_adamw_run_continues_in_the_port():
    """3 reference AdamW steps (warmup-cosine, clipping, weight decay) on
    TINY, carried across by params_from_flax and opt_state_from_optax;
    then 3 more steps in each package on the same batches: losses and
    every parameter within tests/test_torch_train.py's AdamW tolerance
    (1e-5), and the carried moments and count exact.  The first moment
    is fp32 here: the two packages' gradients differ in their last bits,
    and a bf16 moment rounds a few such elements one bf16 step apart
    (3 of 16384 off by 1.5e-5 after 3 steps), which the tolerance is not
    for; the bf16 moment's arithmetic is held on identical gradients by
    tests/test_torch_train.py, and its restore by the resume test."""
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    batches = [{k: v.numpy() for k, v in b.items()} for b in _batches(6)]
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    setup = jtrain.setup_training(jconfigs.TINY, mesh,
                                  optimizer=jtrain.default_optimizer(**kw),
                                  batch_shape=(4, 64))
    state = setup.state
    for b in batches[:3]:
        state, _ = setup.train_step(state, jax.tree.map(jax.numpy.asarray, b))
    params, opt_state = _np(state.params), _np(state.opt_state)

    model = params_from_flax(params, configs.TINY, device="cpu")
    opt = train.default_optimizer(**kw)
    named = list(model.named_parameters())
    opt.init([p for _, p in named], [n for n, _ in named])
    carried = opt_state_from_optax(opt_state)
    opt.load_state_dict(carried)
    assert opt.count == 3
    assert opt.b1_mu == 0.9
    for name, mu in zip(opt.names, opt.mu):
        assert torch.equal(mu, carried["mu"][name])
    port_state = train.TrainState(model, opt, step=3)
    port_step = train.make_train_step(model, opt)

    for b in batches[3:]:
        state, want = setup.train_step(state,
                                       jax.tree.map(jax.numpy.asarray, b))
        port_state, got = port_step(port_state,
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=ADAMW_TOL)
    final = state_dict_from_flax(_np(state.params))
    for name, tensor in model.state_dict().items():
        np.testing.assert_allclose(tensor.numpy(), final[name].numpy(),
                                   rtol=ADAMW_TOL, atol=ADAMW_TOL)


def test_opt_state_from_optax_keeps_the_bf16_moment():
    """default_optimizer(mu_dtype="bfloat16")'s optax state converts to a
    bf16 mu by port name, an fp32 nu, the count and b1 as bf16 holds it."""
    params = {"layer_0": {"mlp": {"down": {"kernel": np.ones((4, 2),
                                                             np.float32)}}}}
    tx = jtrain.default_optimizer(mu_dtype="bfloat16")
    opt_state = _np(tx.init(jax.tree.map(jax.numpy.asarray, params)))
    sd = opt_state_from_optax(opt_state)
    assert list(sd["mu"]) == ["layers.0.mlp.down.kernel"]
    assert sd["mu"]["layers.0.mlp.down.kernel"].dtype == torch.bfloat16
    assert sd["nu"]["layers.0.mlp.down.kernel"].dtype == torch.float32
    assert sd["count"] == 0
    assert sd["b1_mu"] == torch.tensor(0.9, dtype=torch.bfloat16).item()
    with pytest.raises(ValueError):
        opt_state_from_optax(())


# -- the cull handshake against the reference controller ----------------------


def test_cull_handshake_honoured_by_the_reference_controller(tmp_path):
    """The reference culling controller writes the request file; the
    port's hook saves a train state and acknowledges; the controller's
    next pass honours the ack: the stop annotation lands and the signal
    files are retired."""
    api = ApiServer()
    cluster = FakeCluster(api)
    cluster.add_tpu_slice_nodes("tpu-v5-lite-podslice", "4x4", 4, 4)
    mgr = Manager(api, clock=FakeClock())
    cfg = CoreConfig(enable_culling=True, cull_idle_time_min=60,
                     idleness_check_period_min=1,
                     checkpoint_before_cull=True,
                     checkpoint_signal_root=str(tmp_path / "signals"))
    nb_metrics = NotebookMetrics(api)
    jupyter = FakeJupyterState()
    setup_core_controllers(mgr, cfg, nb_metrics)
    setup_culling(mgr, cfg, jupyter, nb_metrics)
    api.create(Notebook.new("tnb", "u1", tpu=TPUSpec("v5e", "4x4")).obj)
    mgr.run_until_idle()
    jupyter.set_kernels("u1", "tnb", [{
        "id": "k1", "name": "python3", "last_activity":
        "2023-01-01T00:00:00Z", "execution_state": "idle",
        "connections": 0}])
    sig_dir = tmp_path / "signals" / "u1" / "tnb"

    setup = train.setup_training(configs.TINY, device="cpu",
                                 optimizer=_optimizer())
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), backend="local")
    hook = checkpoint_on_cull(ckpt, CullSignalWatcher(str(sig_dir)))
    assert hook(6, train.train_state_dict(setup.state)) is False

    mgr.advance(61 * 60)  # idle verdict -> request written, cull held
    nb = api.get("Notebook", "u1", "tnb")
    assert not culler.stop_annotation_is_set(nb.metadata)
    assert (sig_dir / REQUEST_FILE).read_text() == "true"
    assert hook(7, train.train_state_dict(setup.state)) is True
    assert ckpt.latest_step() == 7
    assert (sig_dir / ACK_FILE).exists()

    mgr.advance(61)
    nb = api.get("Notebook", "u1", "tnb")
    assert culler.stop_annotation_is_set(nb.metadata)
    assert api.list("Pod", namespace="u1") == []
    assert not (sig_dir / REQUEST_FILE).exists()
    assert not (sig_dir / ACK_FILE).exists()
    assert nb_metrics.checkpoint_snapshots.value("u1", "cull") == 1


# -- the sidecar and its session stores ---------------------------------------


class TestCheckpointSidecar:
    def _store(self, clock):
        return sessionstate.InMemorySessionStore(clock=clock)

    def test_periodic_interval(self):
        clock = FakeClock(start=0.0)
        sidecar = CheckpointSidecar(self._store(clock), "u1", "nb", 0,
                                    interval_s=60.0, time_fn=clock.now)
        assert sidecar.maybe_snapshot(lambda: b"s0") is not None  # first
        assert sidecar.maybe_snapshot(lambda: b"s1") is None      # too soon
        clock.advance(61)
        info = sidecar.maybe_snapshot(lambda: b"s1")
        assert info.generation == 2 and info.trigger == "periodic"

    def test_cull_signal_forces_snapshot_and_acks(self, tmp_path):
        clock = FakeClock(start=0.0)
        signal_dir = tmp_path / "podinfo"
        signal_dir.mkdir()
        sidecar = CheckpointSidecar(self._store(clock), "u1", "nb", 0,
                                    interval_s=1e9,
                                    watcher=CullSignalWatcher(str(signal_dir)),
                                    time_fn=clock.now)
        sidecar.maybe_snapshot(lambda: b"base")
        (signal_dir / REQUEST_FILE).write_text("true")
        info = sidecar.maybe_snapshot(lambda: b"final-state")
        assert info is not None and info.trigger == "cull"
        assert (signal_dir / ACK_FILE).exists()
        assert sidecar.maybe_snapshot(lambda: b"again") is None

    def test_restore_instructions_and_payload(self):
        assert restore_instructions({}) is None
        assert restore_instructions(
            {"CHECKPOINT_RESTORE_URI": "mem://x",
             "CHECKPOINT_RESTORE_GENERATION": "nope"}) is None
        clock = FakeClock()
        store = self._store(clock)
        info = store.put("u1", "nb", 0, b"the-session")
        sidecar = CheckpointSidecar(store, "u1", "nb", 0, time_fn=clock.now)
        env = {"CHECKPOINT_RESTORE_URI": store.uri,
               "CHECKPOINT_RESTORE_GENERATION": str(info.generation)}
        assert sidecar.restore_payload(env) == b"the-session"
        assert sidecar.restore_payload({}) is None  # cold start

    def test_from_env_honors_contract(self, tmp_path):
        assert CheckpointSidecar.from_env("u1", "nb", 0, env={}) is None
        sidecar = CheckpointSidecar.from_env(
            "u1", "nb", 1,
            env={"CHECKPOINT_STORE_URI": f"file://{tmp_path}/s",
                 "CHECKPOINT_INTERVAL_S": "45"})
        assert isinstance(sidecar.store, sessionstate.DirSessionStore)
        assert sidecar.interval_s == 45.0
        info = sidecar.snapshot_now(b"pre-stop-state")
        assert info.trigger == "pre-stop"
        assert sidecar.store.payload("u1", "nb", 1) == b"pre-stop-state"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_dir_session_stores_read_each_other(tmp_path, writer):
    """One package's DirSessionStore writes three generations (max_to_keep
    2) and a torn one; the other's reads the same snapshots and payloads,
    and the files on disk are the same names."""
    clock = FakeClock(start=100.0)
    port = sessionstate.DirSessionStore(str(tmp_path), clock=clock,
                                        max_to_keep=2)
    ref = jsession.DirSessionStore(str(tmp_path), clock=clock, max_to_keep=2)
    w, r = (port, ref) if writer == "port" else (ref, port)
    for i, trigger in enumerate(("periodic", "pre-stop", "cull")):
        clock.advance(1.0)
        w.put("u1", "nb", 0, b"state-%d" % i, trigger=trigger)
    d = tmp_path / "u1" / "nb" / "slice-0"
    (d / "gen-9.bin").write_bytes(b"torn")      # a payload with no marker
    assert sorted(p.name for p in d.iterdir()) == [
        "gen-2.bin", "gen-2.json", "gen-3.bin", "gen-3.json", "gen-9.bin"]
    got = [dataclasses.asdict(s) for s in r.snapshots("u1", "nb", 0)]
    want = [dataclasses.asdict(s) for s in w.snapshots("u1", "nb", 0)]
    assert got == want and [s["generation"] for s in got] == [2, 3]
    assert got[-1]["trigger"] == "cull"
    assert r.payload("u1", "nb", 0) == b"state-2"
    assert r.payload("u1", "nb", 0, 2) == w.payload("u1", "nb", 0, 2) \
        == b"state-1"
    assert not (d / "gen-9.bin").exists()
    assert json.loads((d / "gen-3.json").read_text())["uri"] == \
        f"file://{tmp_path}/u1/nb/slice-0/gen-3"
    assert isinstance(checkpoint.CheckpointSidecar.from_env(
        "u1", "nb", 0, env={"CHECKPOINT_STORE_URI": "mem://x"}).store,
        sessionstate.InMemorySessionStore)
