"""Deterministic concurrency-testing harnesses (model checking): the
port's copy of kubeflow_tpu/testing.

`interleave` is the schedule-exploring model checker built on the
INVARIANTS_STRICT yield points (utils/invariants.py).
"""
