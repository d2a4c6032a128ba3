"""Decoder, quantized layers, weight conversion and generation.

Exports are lazy (PEP 562), as in the reference's models/__init__.py:
`models.configs` is plain dataclasses and importing this package imports
no submodule; `from kubeflow_tpu_torch.models import Transformer`
resolves on first use.  The names are the reference's, plus the presets
the port adds (LLAMA2_13B, BENCH_CHIP, BENCH_MOE).  `MLP` is the MNIST
MLP (models/mlp.py), as in the reference; the decoder's MLP block is
models.transformer.MLP."""

import importlib

_LAZY = {
    "BENCH_CHIP": ".configs",
    "BENCH_MOE": ".configs",
    "GEMMA_7B": ".configs",
    "LLAMA2_13B": ".configs",
    "LLAMA2_7B": ".configs",
    "LLAMA2_350M": ".configs",
    "PRESETS": ".configs",
    "TINY": ".configs",
    "TransformerConfig": ".configs",
    "MLP": ".mlp",
    "Transformer": ".transformer",
    "VIT_B16": ".vit",
    "VIT_TINY": ".vit",
    "ViT": ".vit",
    "ViTConfig": ".vit",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(target, __name__)
    value = getattr(mod, name)
    globals()[name] = value  # cache: resolve each export once
    return value
