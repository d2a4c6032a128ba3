"""Attention and the int4 dequant-matmul (kernel + plain version), and
the control plane's diagnostics bundle (ops/diagnose.py, no torch).

Exports are lazy (PEP 562), as in the reference's ops/__init__.py:
importing this package imports no submodule.  Three of the reference's
names, `attention`, `flash_attention` and `ring_attention`, are also the
names of submodules here (ops/attention.py, ops/flash_attention.py with
the Hopper kernels and their launch counts, ops/ring_attention.py), and
Python binds a submodule to its package attribute once it is imported.
So those names resolve to the submodules, and each of the three is
callable (`CallableModule`): `ops.attention(q, k, v)` calls
ops.attention.attention, as the reference's export does, while
`ops.flash_attention.launches` stays the module's count.
"""

import importlib
import types

_LAZY = {"xla_attention": ".attention"}
_CALLABLE = ("attention", "flash_attention", "ring_attention")

__all__ = ["attention", "flash_attention", "ring_attention", "xla_attention"]


class CallableModule(types.ModuleType):
    """The class of a submodule named after one of its functions: calling
    the module calls that function."""

    def __call__(self, *args, **kwargs):
        return getattr(self, self.__name__.rpartition(".")[2])(*args,
                                                               **kwargs)


def __getattr__(name):
    if name in _CALLABLE:
        return importlib.import_module(f".{name}", __name__)
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(target, __name__)
    value = getattr(mod, name)
    globals()[name] = value  # cache: resolve each export once
    return value
