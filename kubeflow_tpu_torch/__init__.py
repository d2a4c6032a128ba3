"""PyTorch port of the compute plane of `kubeflow_tpu`, for NVIDIA Hopper.

The reference package stays the numerics reference; this package imports
nothing of it nor of JAX.  It holds the int4 KV-cache serving path and the
training step of the decoder (models/), on one card, on a device mesh and
in pipeline stages (parallel/), the attention, flash-attention and
int4 dequant-matmul ops (ops/, with the hand-written CUDA kernels in
csrc/), the decode and training roofline (runtime/) and the training
benchmark (`python -m kubeflow_tpu_torch.bench`).  Entry points run on
"cuda" unless the caller passes device="cpu".
"""
