"""ODH extension plane for GPU notebooks: routing, auth, webhooks and the
data-science integrations layered over the core notebook controller (the
port of kubeflow_tpu/odh, reference: components/odh-notebook-controller).
The webhook server that serves the two webhooks over HTTPS is not ported
yet (`ROADMAP.md` queue 1 item 17): they run in the in-memory API
server's admission chain."""

from .controller import OpenshiftNotebookReconciler, setup_odh_controllers
from .webhook import NotebookMutatingWebhook, NotebookValidatingWebhook

__all__ = [
    "NotebookMutatingWebhook",
    "NotebookValidatingWebhook",
    "OpenshiftNotebookReconciler",
    "setup_odh_controllers",
]
