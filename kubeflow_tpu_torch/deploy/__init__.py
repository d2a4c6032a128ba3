"""Deployment manifests as code (the kustomize plane): the port's copy of
kubeflow_tpu/deploy."""

from .manifests import PROFILES, render_profile, render_yaml, validate_docs

__all__ = ["PROFILES", "render_profile", "render_yaml", "validate_docs"]
