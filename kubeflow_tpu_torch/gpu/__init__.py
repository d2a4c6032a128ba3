"""The GPU side of the controller's device contract: the accelerator
table (`topology`) and the rendezvous env a gang's pods get (`env`).
The port's counterpart of kubeflow_tpu/tpu."""
