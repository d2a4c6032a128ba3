"""The GPU side of the controller's device contract: the accelerator
table (`topology`), the rendezvous env a gang's pods get (`env`) and the
fake `nvidia.com/gpu` device plugin (`device_plugin`).  The port's
counterpart of kubeflow_tpu/tpu."""
