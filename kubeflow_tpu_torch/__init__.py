"""PyTorch port of the compute plane of `kubeflow_tpu`, for NVIDIA Hopper.

The reference package stays the numerics reference; this package imports
nothing of it nor of JAX.  It holds the int4 KV-cache serving path of the
decoder (models/), the attention and int4 dequant-matmul ops (ops/, with
the hand-written CUDA kernel in csrc/) and the decode roofline (runtime/).
Entry points run on "cuda" unless the caller passes device="cpu".
"""
