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
  `torch.Generator`, so the bits differ from jax.random's.

Each round the draft takes gamma single-token steps and the target one
(gamma + 1)-token pass at explicit positions.  Acceptance is the minimum
over the batch rows, capped at gamma - 1 (the draft never consumed its
last proposal), which keeps one cache index for the batch.  Both caches
are then rewound to the accepted frontier (`KVCache.set_index`):
entries past it are masked by decode attention's position mask until
they are overwritten.  Knowing the frontier takes one host read of the
accepted count per round: the round's shapes and the caches' host
mirrors of their fill index depend on it.

`params` (target or draft) is a reference-layout param tree or a port
Transformer built for its config's decode layout, as in `generate`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Union

import torch

from .configs import TransformerConfig
from .generate import prepare_decode
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


class _Pair:
    """Target and draft with caches sized for the run: `total` tokens
    plus the gamma + 1 positions a verify pass writes past the last
    accepted one."""

    def __init__(self, target_cfg, target_params, draft_cfg, draft_params,
                 batch: int, total: int, gamma: int, device):
        self.target = _model(target_cfg, target_params, device)
        self.draft = _model(draft_cfg, draft_params, device)
        self.device = self.target.device
        self.caches = [
            KVCache(m.cfg.with_(max_seq_len=total + gamma + 1), batch,
                    torch_dtype(m.cfg.dtype), m.device)
            for m in (self.target, self.draft)]

    def prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """Both caches filled with the prompt; the target's last logits."""
        t_cache, d_cache = self.caches
        logits = self.target(prompt, cache=t_cache)
        self.draft(prompt, cache=d_cache)
        return logits[:, -1, :]

    def draft_step(self, tok: torch.Tensor, pos: int) -> torch.Tensor:
        """The draft consumes `tok` [B] at position `pos`: its logits."""
        d_cache = self.caches[1]
        if d_cache.index != pos:
            raise RuntimeError(f"draft cache at {d_cache.index}, step at "
                               f"position {pos}")
        positions = torch.full((tok.shape[0], 1), pos, device=tok.device)
        return self.draft(tok[:, None], positions=positions,
                          cache=d_cache)[:, -1, :]

    def verify(self, block: torch.Tensor, start: int) -> torch.Tensor:
        """The target consumes `block` [B, gamma + 1] at positions
        start, start + 1, ...: its logits [B, gamma + 1, V]."""
        t_cache = self.caches[0]
        if t_cache.index != start:
            raise RuntimeError(f"target cache at {t_cache.index}, verify "
                               f"at position {start}")
        positions = start + torch.arange(
            block.shape[1], device=block.device).expand(block.shape)
        return self.target(block, positions=positions, cache=t_cache)

    def rewind(self, index: int) -> None:
        for cache in self.caches:
            rewind(cache, index)


def _as_tensor(prompt) -> torch.Tensor:
    return prompt if isinstance(prompt, torch.Tensor) else torch.tensor(
        prompt)


def _check_gamma(gamma: int) -> None:
    if gamma < 2:
        raise ValueError("gamma must be >= 2 (acceptance caps at gamma-1)")


def _emit(tokens: torch.Tensor, n: int, m: int, proposals: torch.Tensor,
          last: torch.Tensor) -> None:
    """Write the m accepted proposals at n.. and the round's last token
    at n + m."""
    tokens[:, n:n + m] = proposals[:, :m]
    tokens[:, n + m] = last


def speculative_generate(
    target_cfg: TransformerConfig,
    target_params: Union[Mapping, Transformer],
    draft_cfg: TransformerConfig,
    draft_params: Union[Mapping, Transformer],
    prompt,
    max_new_tokens: int,
    gamma: int = 4,
    device="cuda",
):
    """prompt [B, P] -> ([B, P + max_new_tokens] greedy tokens, rounds).

    A round emits at most gamma tokens (gamma - 1 accepted and one from
    the target) and the first token comes from the prefill, so the ideal
    is ceil((N - 1) / gamma) rounds and the worst N - 1."""
    _check_gamma(gamma)
    prompt = _as_tensor(prompt)
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    with torch.inference_mode():
        pair = _Pair(target_cfg, target_params, draft_cfg, draft_params,
                     batch, total, gamma, device)
        prompt = prompt.to(pair.device, torch.int64)
        tokens = torch.zeros((batch, total + gamma + 1), dtype=torch.int64,
                             device=pair.device)
        tokens[:, :prompt_len] = prompt
        tokens[:, prompt_len] = torch.argmax(pair.prefill(prompt), dim=-1)
        n, rounds = prompt_len + 1, 0
        while n < total:
            # tokens[:, n - 1] is the last accepted token
            last = tokens[:, n - 1]
            tok, proposals = last, []
            for i in range(gamma):
                tok = torch.argmax(pair.draft_step(tok, n - 1 + i), dim=-1)
                proposals.append(tok)
            proposals = torch.stack(proposals, dim=1)            # [B, gamma]
            block = torch.cat([last[:, None], proposals], dim=1)
            greedy = torch.argmax(pair.verify(block, n - 1), dim=-1)
            agree = (greedy[:, :gamma] == proposals).to(torch.int32)
            accepted = torch.cumprod(agree, dim=1).sum(dim=1).min()
            m = min(int(accepted), gamma - 1)       # the round's host read
            _emit(tokens, n, m, proposals, greedy[:, m])
            pair.rewind(n + m)
            n, rounds = n + m + 1, rounds + 1
        return tokens[:, :total], rounds


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
    _check_gamma(gamma)
    prompt = _as_tensor(prompt)
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    inv_t = 1.0 / temperature
    with torch.inference_mode():
        pair = _Pair(target_cfg, target_params, draft_cfg, draft_params,
                     batch, total, gamma, device)
        gen = generator if generator is not None else torch.Generator(
            device=pair.device).manual_seed(0)

        def draw(probs: torch.Tensor) -> torch.Tensor:
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        prompt = prompt.to(pair.device, torch.int64)
        tokens = torch.zeros((batch, total + gamma + 1), dtype=torch.int64,
                             device=pair.device)
        tokens[:, :prompt_len] = prompt
        first = pair.prefill(prompt).to(torch.float32) * inv_t
        tokens[:, prompt_len] = draw(torch.softmax(first, dim=-1))
        n, rounds, accepted_total = prompt_len + 1, 0, 0
        while n < total:
            last = tokens[:, n - 1]
            tok, proposals, qs = last, [], []
            for i in range(gamma):
                row = pair.draft_step(tok, n - 1 + i).to(torch.float32)
                q = torch.softmax(row * inv_t, dim=-1)
                tok = draw(q)
                proposals.append(tok)
                qs.append(q)
            proposals = torch.stack(proposals, dim=1)            # [B, gamma]
            qs = torch.stack(qs, dim=1)                          # [B, gamma, V]
            block = torch.cat([last[:, None], proposals], dim=1)
            logits = pair.verify(block, n - 1).to(torch.float32)
            p = torch.softmax(logits * inv_t, dim=-1)        # [B, gamma+1, V]
            index = proposals[..., None]
            p_prop = p[:, :gamma].gather(-1, index)[..., 0]
            q_prop = qs.gather(-1, index)[..., 0]
            u = torch.rand((batch, gamma), generator=gen, device=pair.device)
            accept = (u * q_prop < p_prop).to(torch.int32)
            acc_count = torch.cumprod(accept, dim=1).sum(dim=1)  # [B]
            m = min(int(acc_count.min()), gamma - 1)  # the round's host read
            # the residual at the frontier; p == q leaves it empty, where
            # rejection has probability 0: fall back to p
            residual = torch.clamp_min(p[:, m] - qs[:, m], 0.0)
            mass = residual.sum(-1, keepdim=True)
            residual = torch.where(mass > 0.0,
                                   residual / torch.clamp_min(mass, 1e-30),
                                   p[:, m])
            x_res = draw(residual)
            emit_m = torch.where(acc_count == m, x_res, proposals[:, m])
            _emit(tokens, n, m, proposals, emit_m)
            pair.rewind(n + m)
            n, rounds = n + m + 1, rounds + 1
            accepted_total += m
        accept_rate = accepted_total / max(rounds * gamma, 1)
        return tokens[:, :total], rounds, accept_rate


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


__all__ = ["rewind", "speculative_generate", "speculative_sample",
           "teacher_forced_gaps"]
