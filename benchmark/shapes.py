"""A configuration file's sizes as the benchmark reads them.

Plain Python: the reference, the traffic and the roofline use it, and
none of them imports the port.  `Shape` holds the published sizes of a
configuration file (Hugging Face key names) and the settings the file
lists under `assumed`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Shape:
    name: str
    vocab: int
    layers: int
    dim: int
    heads: int
    kv_heads: int
    head_dim: int
    mlp: int
    rope_theta: float
    eps: float
    init_std: float
    experts: int = 0
    top_k: int = 0
    aux_coef: float = 0.0
    capacity_factor: float = 0.0
    assumed: dict = field(default_factory=dict, compare=False, hash=False)

    @property
    def moe(self) -> bool:
        return self.experts > 0

    def capacity(self, seq: int) -> int:
        """Slots an expert has per batch row (the port's per-row rule)."""
        return max(1, int(self.capacity_factor * seq * self.top_k
                          / self.experts))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


# The `assumed` settings the runs apply.  Any other is refused, as is a
# published setting the port's decoder does not implement, so that a
# file cannot state what its runs do not do.
ASSUMED = {"norm_scale_std", "dtype", "param_dtype", "weight_dtype",
           "loss_chunks", "remat_policy", "attention_impl", "optimizer",
           "capacity_factor", "moe_dispatch"}
IMPLEMENTED = {"hidden_act": "silu", "tie_word_embeddings": False}


def shape_from(name: str, cfg: dict) -> Shape:
    """The Shape of configuration `name` from its file's contents."""
    dim, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    assumed = cfg.get("assumed", {})
    unread = sorted(set(assumed) - ASSUMED)
    if unread:
        raise ValueError(f"configuration {name}: no run applies the "
                         f"assumed {unread}")
    for key, value in IMPLEMENTED.items():
        if cfg.get(key, value) != value:
            raise ValueError(f"configuration {name}: {key} "
                             f"{cfg[key]!r} is not implemented")
    experts = cfg.get("num_local_experts", 0)
    return Shape(
        name=name, vocab=cfg["vocab_size"], layers=cfg["num_hidden_layers"],
        dim=dim, heads=heads, kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or dim // heads,
        mlp=cfg["intermediate_size"], rope_theta=float(cfg["rope_theta"]),
        eps=float(cfg["rms_norm_eps"]), init_std=cfg["initializer_range"],
        experts=experts, top_k=cfg.get("num_experts_per_tok", 0),
        aux_coef=cfg.get("router_aux_loss_coef", 0.0),
        capacity_factor=float(assumed.get("capacity_factor", 0.0)),
        assumed=assumed)


def load_shape(name: str) -> Shape:
    return shape_from(name, load_json(ROOT / "configs" / f"{name}.json"))


__all__ = ["ASSUMED", "IMPLEMENTED", "ROOT", "Shape", "load_json", "load_shape",
           "shape_from"]
