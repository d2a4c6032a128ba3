"""The plain reference: float32 PyTorch (TF32 off), no kernel, no cache,
no batching tricks, and nothing of the port.

- `model`: the decoder (RMSNorm, split-half RoPE, causal GQA attention,
  SwiGLU or a top-k MoE with the port's per-row capacity rule and its
  Switch-style load-balance loss), the mean next-token loss, run layer
  by layer under checkpoints so a 16-layer 7B step fits beside nothing
  else on the card;
- `adamw`: three training steps with the port's AdamW arithmetic (a bf16
  first moment), and the readings the checks compare;
- `int4`: a frozen copy of the int4 quantizer's arithmetic;
- `decode`: the teacher-forced logits of served tokens, and the gaps.

`precision.FP8` puts the control's lower precision into every product:
e4m3 operands, and e5m2 gradients coming back into the products.
"""
