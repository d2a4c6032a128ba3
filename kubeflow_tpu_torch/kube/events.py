"""EventRecorder: records k8s Events against involved objects.

The port's copy of kubeflow_tpu/kube/events.py.

Mirrors record.EventRecorder usage in the reference (manager wiring
notebook-controller/main.go:105; re-emission onto the Notebook CR
controllers/notebook_controller.go:99-122).
"""

from __future__ import annotations

from .errors import AlreadyExistsError
from .meta import KubeObject, ObjectMeta
from .store import ApiServer


class EventRecorder:
    def __init__(self, api: ApiServer, component: str) -> None:
        self.api = api
        self.component = component
        self._seq = 0

    def event(
        self, involved: KubeObject, etype: str, reason: str, message: str
    ) -> KubeObject:
        """etype is "Normal" or "Warning" (corev1.EventTypeNormal/Warning)."""
        # aggregate identical events by bumping count, as client-go does
        for ev in self.api.list("Event", namespace=involved.namespace):
            io = ev.body.get("involvedObject", {})
            if (
                io.get("kind") == involved.kind
                and io.get("name") == involved.name
                and ev.body.get("reason") == reason
                and ev.body.get("message") == message
                and ev.body.get("type") == etype
            ):
                # listed objects are read-only shared snapshots: bump the
                # count on a private copy
                ev = ev.deepcopy()
                ev.body["count"] = int(ev.body.get("count", 1)) + 1
                return self.api.update(ev)
        body = {
            "involvedObject": {
                "apiVersion": involved.api_version,
                "kind": involved.kind,
                "namespace": involved.namespace,
                "name": involved.name,
                "uid": involved.metadata.uid,
            },
            "reason": reason,
            "message": message,
            "type": etype,
            "count": 1,
            "source": {"component": self.component},
        }
        # sequence names collide across recorder instances: a restarted
        # manager (or the new leader after failover) starts its counter at
        # zero while the previous holder's Events still exist.  Skip
        # forward over occupied slots — the loop is bounded by the number
        # of existing same-named Events.
        while True:
            self._seq += 1
            ev = KubeObject(
                api_version="v1",
                kind="Event",
                metadata=ObjectMeta(
                    name=f"{involved.name}.{self.component}.{self._seq:06d}",
                    namespace=involved.namespace or "default",
                ),
                body=dict(body),
            )
            try:
                return self.api.create(ev)
            except AlreadyExistsError:
                continue
