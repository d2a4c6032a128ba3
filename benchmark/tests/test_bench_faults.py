"""The check catches what it exists to catch, on the CPU at a test's
size: a run drives the port with its timed path broken underneath (the
look for a card skipped) and `correct` comes out false, once for each
fault a cell can have; the sound run comes out true.  The control, the
reference in fp8 in the program's place, reads at least three times
what the program reads.  `test_control_at_cell_size` runs the control
on the card at the cells' own sizes."""

import pytest
import torch

from benchmark import calibrate, run, spec
from benchmark.tests import tiny

TRAIN = [("mistral-7b.train-4k", "mistral-7b-pp2")]
CHAT = ("mistral-7b.int4-chat", "mistral-7b")


def _run(cell, config, mix, seed=2_147_483_651):
    setting = dict(spec.cell(cell))
    serving = setting["runner"] == "decode"
    if not serving:
        setting["limits"] = tiny.TRAIN_LIMITS
    return run.main(["--workload", cell, "--seed", str(seed),
                     "--seconds", "0.3", "--trace", "0"], device="cpu",
                    shape=tiny.shape(config, logit_scale=serving), mix=mix,
                    cell=setting)


@pytest.mark.parametrize("cell,config", TRAIN)
def test_sound_training_run_is_correct(cell, config):
    assert _run(cell, config, tiny.TRAIN_MIX)["correct"]


@pytest.mark.parametrize("cell,config", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(cell, config,
                                                      monkeypatch):
    from kubeflow_tpu_torch.models import train

    monkeypatch.setattr(train.AdamW, "step",
                        lambda self, params, grads, norm: None)
    result = _run(cell, config, tiny.TRAIN_MIX)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell,config", TRAIN)
def test_half_the_batch_left_out_fails(cell, config, monkeypatch):
    from kubeflow_tpu_torch.models import train

    whole = train.loss_terms

    def half(model, batch):
        rows = batch["inputs"].shape[0] // 2
        return whole(model, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(train, "loss_terms", half)
    assert not _run(cell, config, tiny.TRAIN_MIX)["correct"]


def test_sound_serving_run_is_correct():
    assert _run(*CHAT, tiny.CHAT_MIX)["correct"]


def test_an_altered_token_fails(monkeypatch):
    from kubeflow_tpu_torch.models import generate

    plain = generate.sample_token

    def altered(logits, *args, **kwargs):
        return (plain(logits, *args, **kwargs) + 1) % logits.shape[-1]

    monkeypatch.setattr(generate, "sample_token", altered)
    assert not _run(*CHAT, tiny.CHAT_MIX)["correct"]


def test_a_step_that_leaves_the_cache_unchanged_fails(monkeypatch):
    from kubeflow_tpu_torch.models import transformer

    stack = transformer.Transformer.run_stack

    def stuck(self, x, positions, cache=None):
        if cache is None or x.shape[1] != 1:
            return stack(self, x, positions, cache)
        index, pos = cache.index, cache.pos.clone()
        out = stack(self, x, positions, cache)
        cache.index = index
        cache.pos.copy_(pos)
        return out

    monkeypatch.setattr(transformer.Transformer, "run_stack", stuck)
    assert not _run(*CHAT, tiny.CHAT_MIX)["correct"]


@pytest.mark.parametrize("cell,config", TRAIN + [CHAT])
def test_the_control_reads_three_times_the_program(cell, config):
    mix = tiny.CHAT_MIX if cell == CHAT[0] else tiny.TRAIN_MIX
    lines = calibrate.readings(cell, 2_147_483_652, 2, True, False, "cpu",
                               tiny.shape(config, logit_scale=cell == CHAT[0]),
                               mix)
    program, control = lines[0]["numbers"], lines[1]["numbers"]
    assert any(control[k] >= 3 * program[k] for k in program), \
        (program, control)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["mistral-7b.train-4k", CHAT[0]])
def test_control_at_cell_size(cell, card):
    """On the card, at the cell's own size, three seeds: the control
    fails one of the cell's numbers on every seed."""
    limits = spec.cell(cell)["limits"]
    for seed in (3_000_000_101, 3_000_000_102, 3_000_000_103):
        lines = calibrate.readings(cell, seed, 5, True, False, card)
        control = lines[1]["numbers"]
        assert any(control[k] > limits[k] for k in limits), control
        torch.cuda.empty_cache()
