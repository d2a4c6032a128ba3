"""Measurement tools of the port on one card (`python -m
kubeflow_tpu_torch.tools.<name>`), twins of the reference's compute
tools in ci/: the HBM read probe and decode variants (`decode_profile`),
the KV-cache probe (`kv_cache_probe`), the decode ablations
(`decode_ablate`), 7B int8 decode (`llama7b_decode`) and the training
sweeps (`mfu_sweep`, `longctx_sweep`).  Each runs on the card unless
given --cpu, and prints one JSON line per measurement."""
