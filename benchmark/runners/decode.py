"""Serving cells: the port's `generate` on an int4 model built once.

Set-up makes the benchmark's seeded weights in bf16, lays them out as
the port's decode tree (fused q/k/v and gate/up, unrolled layers), and
hands the tree to `quantize_params_int4` and then `params_from_flax`:
the path `python -m kubeflow_tpu_torch.bench --decode --int4` takes.
It warms every prompt length of the mix (a prefill and one step each)
and one whole call (the graph capture).  A unit is one `generate` call
of the closed loop; its tokens are copied to the host at the boundary.
After the window a sample of the finished requests, drawn from the seed
and holding a longest one, is run through the reference.
"""

from __future__ import annotations

import random

import torch

from .. import weights as W
from ..reference import decode as ref_decode
from ..reference.precision import PRECISIONS, strict_fp32
from ..traffic import PromptFeed


def port_config(shape, mix: dict):
    from kubeflow_tpu_torch.models.configs import TransformerConfig
    from kubeflow_tpu_torch.models.generate import decode_config

    cfg = TransformerConfig(
        vocab_size=shape.vocab, num_layers=shape.layers,
        embed_dim=shape.dim, num_heads=shape.heads,
        num_kv_heads=shape.kv_heads, head_dim=shape.head_dim,
        mlp_dim=shape.mlp, max_seq_len=mix["max_seq_len"],
        rope_theta=shape.rope_theta, norm_eps=shape.eps,
        dtype=shape.assumed["dtype"])
    return decode_config(cfg).with_(param_dtype="bfloat16",
                                    weight_dtype=shape.assumed["weight_dtype"])


def decode_tree(shape, seed: int, device) -> dict:
    """The bf16 decode-layout tree of the seed's weights."""
    g = {name: W.make(shape, name, seed, torch.bfloat16, device)
         for name in W.groups(shape)}
    tree = {"embed": {"embedding": g.pop("embed")},
            "final_norm": {"scale": g.pop("final_norm")},
            "lm_head": {"kernel": g.pop("head")}}
    for i in range(shape.layers):
        tree[f"layer_{i}"] = {
            "attn_norm": {"scale": g["attn_norm"][i]},
            "attn": {"qkv": {"kernel": torch.cat(
                [g["q"][i], g["k"][i], g["v"][i]], dim=1)},
                "out": {"kernel": g["out"][i]}},
            "mlp_norm": {"scale": g["mlp_norm"][i]},
            "mlp": {"gate_up": {"kernel": torch.stack(
                [g["gate"][i], g["up"][i]], dim=1)},
                "down": {"kernel": g["down"][i]}}}
    return tree


class Runner:
    unit_span = "generate_call"

    def __init__(self, ctx):
        self.ctx = ctx
        self.shape, self.mix = ctx.shape, ctx.mix
        self.calls: list = []        # (prompt length, tokens on the host)
        self.out = None

    def setup(self) -> None:
        from kubeflow_tpu_torch.models.convert import params_from_flax
        from kubeflow_tpu_torch.models.generate import generate
        from kubeflow_tpu_torch.models.quant import quantize_params_int4

        ctx, shape, mix = self.ctx, self.shape, self.mix
        self.cfg = port_config(shape, mix)
        tree = quantize_params_int4(decode_tree(shape, ctx.seed, ctx.device))
        self.model = params_from_flax(tree, self.cfg, ctx.device)
        del tree
        self.generate = generate
        self.feed = PromptFeed(mix, shape.vocab, ctx.seed, ctx.device)
        warm = PromptFeed(mix, shape.vocab, ctx.seed + 1, ctx.device)
        for length in sorted(set(mix["prompt_lens"])):
            generate(self.cfg, self.model, warm.prompt(length), 2)
        generate(self.cfg, self.model, warm.prompt(mix["prompt_lens"][0]),
                 mix["new_tokens"])
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self) -> int:
        prompt = self.feed.next()
        self.out = (prompt.shape[1],
                    self.generate(self.cfg, self.model, prompt,
                                  self.mix["new_tokens"]))
        return prompt.shape[0] * self.mix["new_tokens"]

    def boundary(self) -> None:
        length, tokens = self.out
        self.calls.append((length, tokens.cpu()))
        self.ctx.unit_sizes.append(length)

    def finish(self) -> None:
        pass

    def failed(self) -> int:
        total = self.mix["new_tokens"]
        return sum(int((t.shape[1] - p) != total) * t.shape[0]
                   for p, t in self.calls)

    @property
    def requests(self) -> int:
        return sum(t.shape[0] for _, t in self.calls)

    def free(self) -> None:
        self.model = None
        self.out = None

    def sample(self) -> list:
        """[(tokens, first served index)]: `check_rows` finished requests
        drawn from the seed, the first from a call of the longest
        prompt."""
        pick = random.Random(self.ctx.seed)
        n = self.ctx.cell.get("check_rows", 4)
        longest = max(p for p, _ in self.calls)
        calls = [c for c in self.calls if c[0] == longest]
        chosen = [pick.choice(calls)]
        chosen += [pick.choice(self.calls) for _ in range(n - 1)]
        rows = []
        for length, tokens in chosen:
            rows.append((tokens[pick.randrange(tokens.shape[0])], length))
        return rows

    def reference(self, precision: str = "fp32"):
        """{"served_gap"}: the widest gap of the sampled served tokens, or
        with a lower precision the gap of the tokens it puts first."""
        strict_fp32()
        w = ref_decode.decode_weights(self.shape, self.ctx.seed,
                                      self.ctx.device)
        rows = self.sample()
        if precision == "fp32":
            gaps = ref_decode.gaps(w, rows, self.shape)
        else:
            gaps = ref_decode.pick_gaps(w, rows, self.shape,
                                        PRECISIONS[precision])
        return {"served_gap": float(max(g.max() for g in gaps)),
                "served_tokens": sum(g.numel() for g in gaps)}

    def numbers(self, reference) -> dict:
        return {"served_gap": reference["served_gap"]}


__all__ = ["Runner", "decode_tree", "port_config"]
