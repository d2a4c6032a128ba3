"""Runnable workflows on the port (`python -m
kubeflow_tpu_torch.examples.<name>`), twins of the reference's
examples/."""
