"""Speculative decoding: a draft proposes gamma tokens, the target checks
them in one pass.  The port of kubeflow_tpu/models/speculative.py.

- `speculative_generate` is greedy: the longest prefix on which the
  target's greedy choice agrees with the draft's is accepted, plus one
  token from the target, so the output equals the target's own greedy
  decode whatever the draft (up to near-ties that another summation
  order can flip).
- `speculative_sample` samples at a temperature by the rejection rule of
  Leviathan et al. (2023): draft token x_i is accepted with probability
  min(1, p_i(x_i) / q_i(x_i)), and at the first rejection a token is drawn
  from the normalized residual max(0, p_i - q_i).  The emitted tokens are
  distributed as the target's own samples.  Draws come from a
  `torch.Generator` by the exponential race (models/generate.py
  `sample_token`), so the bits differ from jax.random's.

Each round the draft takes gamma single-token steps and the target one
(gamma + 1)-token pass at explicit positions.  Acceptance is the minimum
over the batch rows, capped at gamma - 1 (the draft never consumed its
last proposal), which keeps one cache index for the batch.  Both caches
are then rewound to the accepted frontier: entries past it are masked by
decode attention's position mask until they are overwritten.

A round (`SpeculativeRound`) works on fixed buffers and reads every
position from the device: the caches' fill index `KVCache.pos` and the
frontier `n`, the column of the next token.  It writes its proposals and
last token into the token buffer by `index_copy_` at device indices and
rewinds both caches by writing `n + m` into their `pos`.  So on a CUDA
device one round is captured as a CUDA graph and replayed once a round
(`GraphedRound`), the counterpart of the reference's one compiled
while_loop; on the CPU, and with `cuda_graph=False`, the same object runs
eagerly.  One host read a round remains (`SpeculativeRound.sync`): the
frontier, to stop the loop and to move the caches' host mirrors.

`params` (target or draft) is a reference-layout param tree or a port
Transformer built for its config's decode layout, as in `generate`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Union

import torch

from .configs import TransformerConfig
from .generate import CapturedCall, capturable, prepare_decode, race, warm_up
from .transformer import KVCache, Transformer, torch_dtype


def rewind(cache: KVCache, index: int) -> None:
    """Move the cache's fill index back to `index` (the reference's
    _rewind), on the device and in its host mirror: the stale tail stays
    in the buffers, masked by position."""
    cache.set_index(index)


def _model(cfg: TransformerConfig, params: Union[Mapping, Transformer],
           device) -> Transformer:
    if isinstance(params, Transformer):
        if params.cfg != cfg:
            raise ValueError("got a Transformer built for another config "
                             "than its `cfg`")
        return params
    from .convert import params_from_flax

    cfg, tree = prepare_decode(cfg, params)
    return params_from_flax(tree, cfg, device)


def _check_gamma(gamma: int) -> None:
    if gamma < 2:
        raise ValueError("gamma must be >= 2 (acceptance caps at gamma-1)")


class SpeculativeRound:
    """One speculative round of `target` and `draft` on fixed buffers.

    Construction sizes both caches for the run (the prompt, the new
    tokens and the gamma + 1 positions a verify pass writes past the
    frontier), prefills both with `prompt` [B, P] and writes the first
    token (the target's greedy choice, or a draw at `temperature` from
    `generator`) into `tokens` [B, P + N + gamma + 1].  Then `frontier`,
    a 0-dim device tensor, is P + 1: the column of the next token; the
    last accepted token is at `frontier - 1`, and both caches' `pos` are
    there too.

    A call runs one round without a host value: the draft's gamma
    single-token steps, the verify pass, the accepted count m (the
    minimum over the rows, capped at gamma - 1), the gamma proposals
    written at n .. n + gamma - 1 and the round's last token at n + m,
    both caches' `pos` set to n + m and the frontier moved to n + m + 1.
    The caches' host mirrors `index` advance by the steps' lengths as in
    any decode call; `sync` (the round's one host read) sets them to the
    frontier."""

    def __init__(self, target: Transformer, draft: Transformer,
                 prompt: torch.Tensor, max_new_tokens: int, gamma: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        _check_gamma(gamma)
        device = target.device
        if draft.device != device:
            raise ValueError(f"target on {device}, draft on {draft.device}")
        batch, prompt_len = prompt.shape
        self.target, self.draft, self.gamma = target, draft, gamma
        self.total = prompt_len + max_new_tokens
        self.inv_t = 1.0 / temperature if temperature > 0.0 else 0.0
        self.generator = generator if temperature > 0.0 else None
        rows = self.total + gamma + 1
        self.caches = [KVCache(m.cfg.with_(max_seq_len=rows), batch,
                               torch_dtype(m.cfg.dtype), device)
                       for m in (target, draft)]
        self.tokens = torch.zeros((batch, rows), dtype=torch.int64,
                                  device=device)
        self.tokens[:, :prompt_len] = prompt
        logits = target(prompt, cache=self.caches[0])[:, -1, :]
        draft(prompt, cache=self.caches[1])
        if self.generator is None:
            first = torch.argmax(logits, dim=-1)
        else:
            first = race(torch.softmax(logits.float() * self.inv_t, -1),
                         self.generator)
        self.tokens[:, prompt_len] = first
        self.frontier = torch.full((), prompt_len + 1, dtype=torch.int64,
                                   device=device)
        self.n = prompt_len + 1                  # the frontier's host copy
        self.steps = torch.arange(gamma + 1, device=device)

    def _propose(self, last: torch.Tensor):
        """The draft's gamma steps from `last` [B]: proposals [B, gamma]
        and, when sampling, their distributions q [B, gamma, V]."""
        cache, batch = self.caches[1], last.shape[0]
        tok, proposals, qs = last, [], []
        for _ in range(self.gamma):
            row = self.draft(tok[:, None],
                             positions=cache.pos.expand(batch, 1),
                             cache=cache)[:, -1, :]
            if self.generator is None:
                tok = torch.argmax(row, dim=-1)
            else:
                q = torch.softmax(row.float() * self.inv_t, dim=-1)
                tok = race(q, self.generator)
                qs.append(q)
            proposals.append(tok)
        return torch.stack(proposals, 1), (torch.stack(qs, 1) if qs else None)

    def __call__(self) -> None:
        gamma, n = self.gamma, self.frontier
        last = self.tokens.index_select(1, (n - 1).view(1))       # [B, 1]
        batch = last.shape[0]
        proposals, qs = self._propose(last[:, 0])
        cache = self.caches[0]
        positions = (cache.pos + self.steps).expand(batch, gamma + 1)
        logits = self.target(torch.cat([last, proposals], dim=1),
                             positions=positions, cache=cache)
        if self.generator is None:
            greedy = torch.argmax(logits, dim=-1)           # [B, gamma + 1]
            agree = (greedy[:, :gamma] == proposals).to(torch.int32)
            m = torch.cumprod(agree, dim=1).sum(dim=1).min().clamp_max(
                gamma - 1)
            at = m.view(1, 1).expand(batch, 1)
            emit = greedy.gather(1, at)
        else:
            p = torch.softmax(logits.float() * self.inv_t, dim=-1)
            index = proposals[..., None]
            p_prop = p[:, :gamma].gather(-1, index)[..., 0]
            q_prop = qs.gather(-1, index)[..., 0]
            u = torch.rand((batch, gamma), generator=self.generator,
                           device=p.device)
            accept = (u * q_prop < p_prop).to(torch.int32)
            acc_count = torch.cumprod(accept, dim=1).sum(dim=1)     # [B]
            m = acc_count.min().clamp_max(gamma - 1)
            at = m.view(1, 1).expand(batch, 1)
            # the residual at the frontier; p == q leaves it empty, where
            # rejection has probability 0: fall back to p
            p_m = p.index_select(1, m.view(1))[:, 0]
            residual = torch.clamp_min(
                p_m - qs.index_select(1, m.view(1))[:, 0], 0.0)
            mass = residual.sum(-1, keepdim=True)
            residual = torch.where(
                mass > 0.0, residual / torch.clamp_min(mass, 1e-30), p_m)
            x_res = race(residual, self.generator)
            emit = torch.where(acc_count == m, x_res,
                               proposals.gather(1, at)[:, 0])[:, None]
        self.tokens.index_copy_(1, n + self.steps[:gamma], proposals)
        self.tokens.index_copy_(1, (n + m).view(1), emit)
        for c in self.caches:
            c.pos.copy_(n + m)
        n.add_(m + 1)

    def sync(self) -> int:
        """The round's host read: the frontier, whose host copy `n` and
        the caches' host mirrors (at n - 1) follow it."""
        self.n = int(self.frontier)
        for cache in self.caches:
            cache.index = self.n - 1
        return self.n


class GraphedRound:
    """A `SpeculativeRound` captured as one CUDA graph, replayed once a
    round, as models/generate.py `GraphedStep` does for a decode step.

    Construction runs the round once eagerly (`warm_up`), which is the
    run's first round and is kept, and syncs it.  Where the run needs
    more rounds it captures the next one (`CapturedCall`: launches
    credited per replay, a sampling round's generator registered, the
    int4 counters kept) and sets back the caches' host mirrors that the
    capture advanced."""

    def __init__(self, rnd: SpeculativeRound):
        warm_up(rnd, rnd.frontier.device)
        rnd.sync()
        self.captured = None
        if rnd.n >= rnd.total:
            return
        index = [cache.index for cache in rnd.caches]
        self.captured = CapturedCall(rnd, rnd.generator)
        for cache, i in zip(rnd.caches, index):
            cache.index = i

    def __call__(self) -> None:
        self.captured.replay()


def run_rounds(rnd: SpeculativeRound, cuda_graph: bool = True) -> int:
    """Run rounds until the frontier reaches the run's end; the rounds.
    On a CUDA device the rounds replay one captured graph unless
    `cuda_graph=False` or a model's config is not `capturable`."""
    graphed = (cuda_graph and rnd.frontier.device.type == "cuda"
               and capturable(rnd.target.cfg) and capturable(rnd.draft.cfg))
    rounds, runner = 0, rnd
    if graphed and rnd.n < rnd.total:
        runner, rounds = GraphedRound(rnd), 1
    while rnd.n < rnd.total:
        runner()
        rnd.sync()
        rounds += 1
    return rounds


def _prepare(target_cfg, target_params, draft_cfg, draft_params, prompt,
             device):
    target = _model(target_cfg, target_params, device)
    draft = _model(draft_cfg, draft_params, device)
    prompt = prompt if isinstance(prompt, torch.Tensor) else torch.tensor(
        prompt)
    return target, draft, prompt.to(target.device, torch.int64)


def speculative_generate(
    target_cfg: TransformerConfig,
    target_params: Union[Mapping, Transformer],
    draft_cfg: TransformerConfig,
    draft_params: Union[Mapping, Transformer],
    prompt,
    max_new_tokens: int,
    gamma: int = 4,
    device="cuda",
    cuda_graph: bool = True,
):
    """prompt [B, P] -> ([B, P + max_new_tokens] greedy tokens, rounds).

    A round emits at most gamma tokens (gamma - 1 accepted and one from
    the target) and the first token comes from the prefill, so the ideal
    is ceil((N - 1) / gamma) rounds and the worst N - 1."""
    with torch.inference_mode():
        target, draft, prompt = _prepare(target_cfg, target_params,
                                         draft_cfg, draft_params, prompt,
                                         device)
        rnd = SpeculativeRound(target, draft, prompt, max_new_tokens, gamma)
        rounds = run_rounds(rnd, cuda_graph)
        return rnd.tokens[:, :rnd.total], rounds


def speculative_sample(
    target_cfg: TransformerConfig,
    target_params: Union[Mapping, Transformer],
    draft_cfg: TransformerConfig,
    draft_params: Union[Mapping, Transformer],
    prompt,
    max_new_tokens: int,
    gamma: int = 4,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    cuda_graph: bool = True,
):
    """prompt [B, P] -> ([B, P + max_new_tokens] tokens, rounds,
    accept_rate), sampled at `temperature` from `generator` (seeded 0 on
    the model's device when None).  accept_rate is accepted draft tokens
    over rounds * gamma, at most (gamma - 1) / gamma.

    A row that rejected at the round's frontier n + m emits the residual
    draw there; a row that accepted further emits its proposal and draws
    the later positions again next round, which keeps each row's tokens
    distributed as the target's samples."""
    if temperature <= 0.0:
        raise ValueError("temperature must be > 0; use "
                         "speculative_generate for greedy")
    with torch.inference_mode():
        target, draft, prompt = _prepare(target_cfg, target_params,
                                         draft_cfg, draft_params, prompt,
                                         device)
        gen = generator if generator is not None else torch.Generator(
            device=target.device).manual_seed(0)
        rnd = SpeculativeRound(target, draft, prompt, max_new_tokens, gamma,
                               temperature, gen)
        start = rnd.n
        rounds = run_rounds(rnd, cuda_graph)
        # each round moves the frontier by its accepted count + 1
        accepted = rnd.n - start - rounds
        return (rnd.tokens[:, :rnd.total], rounds,
                accepted / max(rounds * gamma, 1))


def teacher_forced_gaps(model: Transformer, tokens: torch.Tensor,
                        prompt_len: int) -> dict:
    """How far the emitted tokens of `tokens` [B, P + N] are from `model`'s
    own greedy choice, in one pass over the sequence with the emitted
    tokens as context: "argmax_share", the share of them that are the
    argmax of their row of logits, and "max_gap_rel", the largest gap
    between a row's max and the emitted token's logit, over max |logit|
    of the row.  Greedy speculative decoding emits the argmax up to
    near-ties that another summation order rounds apart."""
    with torch.inference_mode():
        cache = model.new_cache(tokens.shape[0])
        forced = model(tokens[:, :-1], cache=cache)[:, prompt_len - 1:]
        forced = forced.float()                               # [B, N, V]
        emitted = tokens[:, prompt_len:]
        top = forced.max(dim=-1).values
        picked = forced.gather(-1, emitted[..., None])[..., 0]
        gap = (top - picked) / forced.abs().max(dim=-1).values
        return {"argmax_share": (picked == top).float().mean().item(),
                "max_gap_rel": gap.max().item()}


__all__ = ["GraphedRound", "SpeculativeRound", "rewind", "run_rounds",
           "speculative_generate", "speculative_sample",
           "teacher_forced_gaps"]
