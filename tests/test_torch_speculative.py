"""The port's speculative decoding against the reference package, on the CPU.

Greedy: with the target itself as the draft and with a 1-layer draft of
other widths, the port gives the reference's tokens and round count, and
its own `generate`'s tokens; both caches are rewound to the accepted
frontier each round.  The fixed-buffer round (`SpeculativeRound`, what
the card captures as a CUDA graph), driven eagerly round by round, gives
the reference's tokens and round count, and after each round both caches'
device and host fill indices sit at the frontier.  Sampling draws from a
torch.Generator by the exponential race, whose bits are not jax.random's,
so it is held to the target's distribution: a chi-square gate on the
first two emitted tokens against marginals enumerated from the reference
model's logits, the race's own draws against their probabilities, and
the self-draft acceptance rate."""

from __future__ import annotations

from math import ceil, sqrt

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.configs import TINY as JTINY
from kubeflow_tpu.models.speculative import (
    speculative_generate as jspeculative_generate,
)
from kubeflow_tpu.models.transformer import Transformer as JTransformer
from kubeflow_tpu_torch.models.configs import TINY
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.generate import generate, prepare_decode, race
from kubeflow_tpu_torch.models.speculative import (
    SpeculativeRound,
    run_rounds,
    speculative_generate,
    speculative_sample,
)

DRAFT = dict(num_layers=1, embed_dim=32, num_heads=2, num_kv_heads=1,
             head_dim=16, mlp_dim=64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several CPU workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _params(cfg, seed: int = 0) -> dict:
    tree = JTransformer(cfg).init(jax.random.PRNGKey(seed),
                                  jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, nn.unbox(tree))


def _model(cfg, tree):
    """(decode cfg, port Transformer) for a reference tree."""
    dcfg, dtree = prepare_decode(cfg, tree)
    return dcfg, params_from_flax(dtree, dcfg, device="cpu")


@pytest.fixture(scope="module")
def target():
    return _params(JTINY)


@pytest.fixture(scope="module")
def prompt():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 6), 0,
                                         JTINY.vocab_size))


@pytest.mark.parametrize("draft", ["perfect", "mismatched"])
def test_greedy_matches_reference_and_generate(draft, target, prompt):
    """Tokens and rounds equal the reference's; tokens equal the port's
    own greedy generate.  The perfect draft takes ceil(11 / 4) = 3 rounds
    for 12 tokens, the mismatched one at most 11."""
    if draft == "perfect":
        jdraft_cfg, draft_cfg, dtree = JTINY, TINY, target
    else:
        jdraft_cfg = JTINY.with_(**DRAFT)
        draft_cfg, dtree = TINY.with_(**DRAFT), _params(jdraft_cfg, seed=7)
    want, want_rounds = jspeculative_generate(
        JTINY, target, jdraft_cfg, dtree, jnp.asarray(prompt), 12, gamma=4)
    got, rounds = speculative_generate(TINY, target, draft_cfg, dtree,
                                       prompt, 12, gamma=4, device="cpu")
    assert got.shape == (2, 18)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)
    assert rounds == ceil(11 / 4) if draft == "perfect" else rounds <= 11
    plain = generate(TINY, target, prompt, 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("draft", ["perfect", "mismatched"])
def test_fixed_buffer_round_matches_reference(draft, target, prompt):
    """`SpeculativeRound` driven by `run_rounds` (eager on the CPU) gives
    the reference's greedy tokens and its round count exactly."""
    jdraft_cfg, draft_cfg, dtree = JTINY, TINY, target
    if draft == "mismatched":
        jdraft_cfg = JTINY.with_(**DRAFT)
        draft_cfg, dtree = TINY.with_(**DRAFT), _params(jdraft_cfg, seed=7)
    want, want_rounds = jspeculative_generate(
        JTINY, target, jdraft_cfg, dtree, jnp.asarray(prompt), 12, gamma=4)
    _, model = _model(TINY, target)
    _, draft_model = _model(draft_cfg, dtree)
    with torch.inference_mode():
        rnd = SpeculativeRound(model, draft_model, torch.as_tensor(prompt),
                               12, gamma=4)
        rounds = run_rounds(rnd)
    np.testing.assert_array_equal(rnd.tokens[:, :rnd.total].numpy(),
                                  np.asarray(want))
    assert rounds == int(want_rounds)


def test_round_rewinds_both_caches_to_the_frontier(target, prompt):
    """One call of the round moves the frontier n to n + m + 1 and both
    caches' device fill index to n + m, with no host value; their host
    mirrors ran ahead with the steps (gamma draft steps, a gamma + 1 token
    verify pass) until `sync`, the round's host read, sets them to n + m
    too.  The gamma proposals land at n .. n + gamma - 1 and the round's
    last token at n + m."""
    gamma = 4
    _, model = _model(TINY, target)
    _, draft = _model(TINY.with_(**DRAFT), _params(JTINY.with_(**DRAFT), 7))
    with torch.inference_mode():
        rnd = SpeculativeRound(model, draft, torch.as_tensor(prompt), 12,
                               gamma)
        t_cache, d_cache = rnd.caches
        while rnd.n < rnd.total:
            n = rnd.n
            assert t_cache.index == d_cache.index == n - 1
            assert int(t_cache.pos) == int(d_cache.pos) == n - 1
            before = rnd.tokens.clone()
            rnd()
            frontier = int(rnd.frontier)
            m = frontier - n - 1
            assert 0 <= m <= gamma - 1
            assert int(t_cache.pos) == int(d_cache.pos) == n + m
            assert (t_cache.index, d_cache.index) == (n + gamma,
                                                      n - 1 + gamma)
            assert rnd.sync() == frontier == rnd.n
            assert t_cache.index == d_cache.index == n + m
            changed = (rnd.tokens != before).any(dim=0).nonzero()[:, 0]
            assert set(changed.tolist()) <= set(range(n, n + gamma))
            assert torch.equal(rnd.tokens[:, :n], before[:, :n])
    out, _ = speculative_generate(TINY, target, TINY.with_(**DRAFT),
                                  _params(JTINY.with_(**DRAFT), 7), prompt,
                                  12, gamma=gamma, device="cpu")
    assert torch.equal(rnd.tokens[:, :rnd.total], out)


def test_exponential_race_draws_its_probabilities():
    """`race`, the round's sampler: 20000 draws from one row of 8
    probabilities against their expected counts (chi-square, the 99.9%
    bound of the distribution test below)."""
    probs = torch.tensor([0.3, 0.2, 0.15, 0.1, 0.1, 0.08, 0.05, 0.02])
    draws = race(probs.expand(20000, 8).contiguous(),
                 torch.Generator().manual_seed(3))
    counts = np.bincount(draws.numpy(), minlength=8)
    expected = probs.numpy() * 20000
    chi2 = float(np.sum((counts - expected) ** 2 / expected))
    dof = 7
    assert chi2 < dof + 3.1 * sqrt(2 * dof) + 9.5, (chi2, counts)


def test_caches_rewound_to_the_accepted_frontier(target, prompt):
    """Every call writes its keys at its first position (cache index ==
    position), and each round starts both caches where the last one
    ended: at n + m, m <= gamma - 1 accepted tokens past its first new
    position n.  Seen through forward pre-hooks on built Transformers."""
    cfg, model = _model(TINY, target)
    dcfg, draft = _model(TINY.with_(**DRAFT), _params(JTINY.with_(**DRAFT), 7))
    calls = {"target": [], "draft": []}

    def hook(name):
        def record(_module, args, kwargs):
            cache, positions = kwargs.get("cache"), kwargs.get("positions")
            first = 0 if positions is None else int(positions[0, 0])
            assert bool((positions is None) or (
                positions == first + torch.arange(args[0].shape[1])).all())
            calls[name].append((cache.index, first, args[0].shape[1]))
        return record

    model.register_forward_pre_hook(hook("target"), with_kwargs=True)
    draft.register_forward_pre_hook(hook("draft"), with_kwargs=True)
    gamma = 4
    out, rounds = speculative_generate(cfg, model, dcfg, draft, prompt, 12,
                                       gamma=gamma)
    for name in calls:
        for index, first, _ in calls[name]:
            assert index == first, (name, calls[name])
    verify = calls["target"][1:]
    assert len(verify) == rounds
    assert all(q_len == gamma + 1 for _, _, q_len in verify)
    starts = [index for index, _, _ in verify]
    # the draft's first step of each round starts where the target's does
    draft_starts = [index for index, _, _ in calls["draft"][1::gamma]]
    assert draft_starts == starts
    assert starts[0] == prompt.shape[1]
    for a, b in zip(starts, starts[1:]):
        assert 1 <= b - a <= gamma
    assert starts[-1] + gamma >= out.shape[1] - 1


def test_guards(target, prompt):
    for fn in (speculative_generate, speculative_sample):
        with pytest.raises(ValueError, match="gamma"):
            fn(TINY, target, TINY, target, prompt, 4, gamma=1, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        speculative_sample(TINY, target, TINY, target, prompt, 4,
                           temperature=0.0, device="cpu")


@pytest.fixture(scope="module")
def small_vocab():
    """Vocab 16, small enough to enumerate the target's marginals."""
    jcfg = JTINY.with_(vocab_size=16)
    return (jcfg, TINY.with_(vocab_size=16), _params(jcfg),
            _params(jcfg.with_(**DRAFT), seed=7))


def test_self_draft_sampling_accepts_everything(small_vocab, prompt):
    """p == q: every draft token is accepted, so each round emits gamma
    tokens and the rate is (gamma - 1) / gamma."""
    _, cfg, tree, _ = small_vocab
    out, rounds, rate = speculative_sample(
        cfg, tree, cfg, tree, prompt[:1] % 16, 12, gamma=4, temperature=1.0,
        generator=torch.Generator().manual_seed(5), device="cpu")
    assert out.shape == (1, 18)
    assert rate >= 0.74 and rounds <= 4, (rate, rounds)


def test_mismatched_draft_sampling_stays_in_vocab(small_vocab, prompt):
    _, cfg, tree, dtree = small_vocab
    out, rounds, rate = speculative_sample(
        cfg, tree, cfg.with_(**DRAFT), dtree, prompt % 16, 10, gamma=4,
        temperature=0.8, generator=torch.Generator().manual_seed(11),
        device="cpu")
    assert out.shape == (2, 16) and rounds >= 1
    assert 0.0 <= rate <= 0.75
    np.testing.assert_array_equal(out[:, :6].numpy(), prompt % 16)
    assert int(out.min()) >= 0 and int(out.max()) < 16


def test_distribution_matches_target_sampling(small_vocab):
    """1500 independent rows, one call: the first two emitted tokens
    against the target's marginals enumerated from the reference model
    (chi-square over bins expecting >= 5, the 99.9% bound).  The draft is
    another model, so rejections and residual draws happen.  Each row's
    tokens depend on its own draws only, whatever the batch's frontier,
    so the rows are independent trials."""
    jcfg, cfg, tree, dtree = small_vocab
    prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    vocab, trials = 16, 1500
    model = JTransformer(jcfg)
    logits = model.apply({"params": tree}, jnp.asarray(prompt))
    p1 = jax.nn.softmax(logits[0, -1].astype(jnp.float32))
    exts = jnp.concatenate([jnp.broadcast_to(prompt, (vocab, 5)),
                            jnp.arange(vocab, dtype=jnp.int32)[:, None]],
                           axis=1)
    p2 = p1 @ jax.nn.softmax(model.apply({"params": tree}, exts)[:, -1]
                             .astype(jnp.float32), axis=-1)
    out, _, rate = speculative_sample(
        cfg, tree, cfg.with_(**DRAFT), dtree, np.repeat(prompt, trials, 0),
        2, gamma=2, temperature=1.0,
        generator=torch.Generator().manual_seed(42), device="cpu")
    assert rate < 0.5   # the draft is rejected often enough to matter
    samples = out[:, -2:].numpy()
    for pos, want in ((0, np.asarray(p1)), (1, np.asarray(p2))):
        counts = np.bincount(samples[:, pos], minlength=vocab)
        expected = want * trials
        mask = expected >= 5
        chi2 = float(np.sum((counts[mask] - expected[mask]) ** 2
                            / expected[mask]))
        dof = int(mask.sum()) - 1
        bound = dof + 3.1 * sqrt(2 * dof) + 9.5
        assert chi2 < bound, (pos, chi2, bound, dof)
