"""Create-or-update helpers with owned-fields-only drift correction.

The port's copy of kubeflow_tpu/common/reconcilehelper.py.

Port of the reconcile semantics in
components/common/reconcilehelper/util.go: create if missing, otherwise copy
only the fields this controller owns (labels, annotations, replicas, pod
template spec; Services deliberately keep their clusterIP, util.go:182) and
write back only when something actually drifted.
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, Optional

from ..kube import ApiServer, KubeObject

logger = logging.getLogger("kubeflow_tpu_torch.reconcile")

CopyFn = Callable[[KubeObject, KubeObject], bool]


def copy_statefulset_fields(desired: KubeObject, found: KubeObject) -> bool:
    """CopyStatefulSetFields (util.go:107-134): labels, annotations,
    replicas, pod template spec."""
    changed = _copy_meta(desired, found)
    if desired.spec.get("replicas") != found.spec.get("replicas"):
        found.spec["replicas"] = desired.spec.get("replicas")
        changed = True
    d_tmpl = desired.spec.get("template", {})
    f_tmpl = found.spec.setdefault("template", {})
    if d_tmpl.get("spec") != f_tmpl.get("spec"):
        f_tmpl["spec"] = copy.deepcopy(d_tmpl.get("spec"))
        changed = True
    # pod template labels ride along when replicas change (reference copies
    # them unconditionally via Template.Spec plus the label special-case at
    # notebook_controller.go:193-198; we keep them continuously consistent)
    if d_tmpl.get("metadata") != f_tmpl.get("metadata"):
        f_tmpl["metadata"] = copy.deepcopy(d_tmpl.get("metadata"))
        changed = True
    return changed


copy_deployment_fields = copy_statefulset_fields  # identical owned-field set


def copy_service_fields(desired: KubeObject, found: KubeObject) -> bool:
    """CopyServiceFields (util.go:166-197): labels, annotations, selector,
    ports — NOT the whole spec, so the allocated clusterIP survives."""
    changed = _copy_meta(desired, found)
    for field in ("selector", "ports"):
        if desired.spec.get(field) != found.spec.get(field):
            found.spec[field] = copy.deepcopy(desired.spec.get(field))
            changed = True
    return changed


def copy_spec(desired: KubeObject, found: KubeObject) -> bool:
    """CopyVirtualService-style whole-spec copy (util.go:199-219), used for
    unstructured/CRD objects (HTTPRoute, NetworkPolicy, ...)."""
    changed = _copy_meta(desired, found)
    if desired.body.get("spec") != found.body.get("spec"):
        found.body["spec"] = copy.deepcopy(desired.body.get("spec"))
        changed = True
    return changed


def copy_data(desired: KubeObject, found: KubeObject) -> bool:
    """ConfigMap/Secret drift: data (+ stringData/type for Secrets)."""
    changed = _copy_meta(desired, found)
    for field in ("data", "stringData", "type"):
        if field in desired.body and desired.body.get(field) != found.body.get(field):
            found.body[field] = copy.deepcopy(desired.body.get(field))
            changed = True
    return changed


def _copy_meta(desired: KubeObject, found: KubeObject) -> bool:
    changed = False
    # a key present in found with a different/absent desired value counts as
    # drift, and desired's maps replace found's wholesale (util.go:109-121)
    if found.metadata.labels != desired.metadata.labels:
        found.metadata.labels = dict(desired.metadata.labels)
        changed = True
    if found.metadata.annotations != desired.metadata.annotations:
        found.metadata.annotations = dict(desired.metadata.annotations)
        changed = True
    return changed


def reconcile_object(
    api: ApiServer,
    desired: KubeObject,
    copy_fn: Optional[CopyFn] = None,
    cache=None,
) -> KubeObject:
    """Create-if-missing / update-if-drifted (util.go Deployment()/Service()
    pattern).  Returns the live object.

    With `cache` (kube.InformerCache) the no-op check reads the informer
    cache instead of the apiserver — zero API calls when nothing drifted,
    which is the steady-state common case.  A stale cached RV surfaces as
    a ConflictError and the manager's backoff retries against the fresher
    cache, exactly the controller-runtime cached-client contract."""
    copy_fn = copy_fn or copy_spec
    if cache is not None:
        found = cache.get(desired.kind, desired.namespace, desired.name)
    else:
        found = api.try_get(desired.kind, desired.namespace, desired.name)
    if found is None:
        logger.info("creating %s %s/%s", desired.kind, desired.namespace, desired.name)
        return api.create(desired)
    if copy_fn(desired, found):
        logger.info("updating %s %s/%s", desired.kind, desired.namespace, desired.name)
        return api.update(found)
    return found
