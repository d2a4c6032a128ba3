"""Attention and the int4 dequant-matmul (kernel + plain version)."""
