"""The GPU gang's NetworkPolicy (the port's counterpart of the TPU worker
policy in kubeflow_tpu/odh/network.py)."""
