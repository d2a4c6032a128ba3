"""Share of the device's operation time in float32 GEMM kernels (the
chunked loss's fp32 logits products, TF32 off), in %.  The kernels are
told by name: cuBLAS's single-precision GEMMs."""

import re

FP32_GEMM = re.compile(r"sgemm|gemm_f32f32|f32f32_f32|gemmSN", re.I)
LOWER = re.compile(r"bf16|tf32|f16|e4m3|i8", re.I)


def is_fp32_gemm(name: str) -> bool:
    return bool(FP32_GEMM.search(name)) and not LOWER.search(name)


def read(run):
    if run.trace is None:
        return None
    total = run.trace.op_seconds(lambda name: True)
    if total <= 0:
        return None
    return 100.0 * run.trace.op_seconds(is_fp32_gemm) / total
