"""ODH extension plane for GPU notebooks: routing, auth, webhooks and the
data-science integrations layered over the core notebook controller (the
port of kubeflow_tpu/odh, reference: components/odh-notebook-controller).
The two webhooks run in the in-memory API server's admission chain, or
over HTTPS from `webhook_server.py` (AdmissionReview and the /convert
ConversionReview), which a wire-served API server calls out to."""

from .controller import OpenshiftNotebookReconciler, setup_odh_controllers
from .webhook import NotebookMutatingWebhook, NotebookValidatingWebhook

__all__ = [
    "NotebookMutatingWebhook",
    "NotebookValidatingWebhook",
    "OpenshiftNotebookReconciler",
    "setup_odh_controllers",
]
