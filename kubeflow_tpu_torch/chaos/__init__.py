"""The chaos plane of the GPU workbench stack: its knowledge model
(`knowledge.py`, `knowledge/workbenches.yaml`), the seeded soaks and
fault drills (`soaks.py`) and their runner, `python -m
kubeflow_tpu_torch.chaos` (`__main__.py`).  Control plane only: nothing
here imports torch."""
