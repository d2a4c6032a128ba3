"""The notebook conformance profile of the port, with `spec.gpu` gangs:
the rendered-object goldens (`goldens`), the black-box behaviour runner
(`behavior`, HTTP only), the metric-family gate (`metrics`), and
`python -m kubeflow_tpu_torch.conformance`, which runs the goldens and
then the apiserver fixtures and the behaviour runner against a booted
manager.  Control plane: nothing here imports torch."""
