"""The flash kernels' share of their roofline: the least time their
causal attention FLOPs take at the bf16 peak (each forward launch its
Q K^T and P V; each backward, dK/dV and dQ together, its five
products) over the flash kernels' device time, in %."""

from benchmark import roofline


def read(run):
    pk = roofline.peak(run.device_name)
    if run.trace is None or pk is None:
        return None
    t = run.trace
    fwd = t.op_count(lambda n: "flash_fwd_kernel" in n)
    bwd = min(t.op_count(lambda n: "flash_bwd_dkv_kernel" in n),
              t.op_count(lambda n: "flash_bwd_dq_kernel" in n))
    seconds = t.op_seconds(lambda n: "flash_" in n and "_kernel" in n)
    if seconds <= 0:
        return None
    s = run.shape
    dims = (run.mix["batch"], s.heads, run.mix["seq"], s.head_dim)
    flops = fwd * roofline.flash_fwd_flops(*dims) \
        + bwd * roofline.flash_bwd_flops(*dims)
    return 100.0 * flops / pk.bf16_flops / seconds
