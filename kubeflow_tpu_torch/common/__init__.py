"""Helpers the port's controllers share (the port of kubeflow_tpu/common)."""
