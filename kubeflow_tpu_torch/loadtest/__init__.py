"""The fleet load generators of the port: the deterministic convergence
benchmark on the FakeClock (`python -m
kubeflow_tpu_torch.loadtest.convergence`, with its committed budgets in
budgets/) and the notebook-to-ready latency benchmark (`python -m
kubeflow_tpu_torch.loadtest.start_notebooks`).  Control plane: nothing
here imports torch."""
