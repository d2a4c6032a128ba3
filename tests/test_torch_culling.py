"""The port's culler against the reference's, tick for tick.

Both stacks (the reference's with a `spec.tpu` slice, the port's with a
`spec.gpu` gang of the same host count) run on their own FakeClock from
the same epoch, with the same idle Jupyter kernel, and advance one
idleness period a tick.  The Notebook's annotations must be equal at
every tick, with `checkpoint_before_cull` off and on.  With the handshake
on, each training loop's `CullSignalWatcher` (the reference's for the
reference, the port's for the port) answers the request file its culler
wrote under `checkpoint_signal_root/<namespace>/<name>`; only then does
the stop annotation land, and the gang goes away whole.  Only the
reference's control plane (and its stdlib-only checkpoint module) is
imported."""

from __future__ import annotations

import pytest

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core.culling_controller import setup_culling as ref_culling
from kubeflow_tpu.core.jupyter import FakeJupyterState as RefJupyter
from kubeflow_tpu.core.metrics import NotebookMetrics as RefMetrics
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup,
)
from kubeflow_tpu.runtime.checkpoint import (
    CullSignalWatcher as RefCullSignalWatcher,
)
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
from kubeflow_tpu_torch.core import constants as C
from kubeflow_tpu_torch.core.culling_controller import setup_culling
from kubeflow_tpu_torch.core.jupyter import FakeJupyterState
from kubeflow_tpu_torch.core.metrics import NotebookMetrics
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.runtime import checkpoint
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig

NS, NAME, HOSTS = "u1", "nb", 4
IDLE_MIN, PERIOD_MIN, TICKS = 5, 1, 12
IDLE_KERNEL = {"id": "k1", "name": "python3",
               "last_activity": "2023-01-01T00:00:00Z",
               "execution_state": "idle", "connections": 0}


class CullStack:
    """One stack with its culler: the reference's or the port's."""

    def __init__(self, port: bool, handshake: bool, signal_root):
        k = kube if port else ref_kube
        self.port, self.api = port, k.ApiServer()
        self.cluster = k.FakeCluster(self.api)
        self.clock = FakeClock() if port else RefFakeClock()
        self.mgr = k.Manager(self.api, clock=self.clock)
        self.metrics = (NotebookMetrics if port else RefMetrics)(self.api)
        self.jupyter = FakeJupyterState() if port else RefJupyter()
        cfg = (CoreConfig if port else RefConfig)(
            enable_self_healing=False, enable_culling=True,
            cull_idle_time_min=IDLE_MIN, idleness_check_period_min=PERIOD_MIN,
            checkpoint_before_cull=handshake,
            checkpoint_signal_root=str(signal_root))
        (setup_core_controllers if port else ref_setup)(
            self.mgr, cfg, self.metrics)
        (setup_culling if port else ref_culling)(
            self.mgr, cfg, self.jupyter, self.metrics)
        signal_dir = signal_root / NS / NAME
        self.watcher = checkpoint.CullSignalWatcher(
            str(signal_dir), time_fn=self.clock.now, hook_dir="") if port \
            else RefCullSignalWatcher(str(signal_dir), time_fn=self.clock.now)
        if port:
            self.cluster.add_gpu_nodes("h100-80gb", HOSTS, 8)
            obj = kube.KubeObject.from_dict(Notebook.new(
                NAME, NS, gpu=GPUSpec("h100-80gb", 8 * HOSTS)).obj)
        else:
            self.cluster.add_tpu_slice_nodes("tpu-v5-lite-podslice", "4x4",
                                             HOSTS, 4)
            obj = RefNotebook.new(NAME, NS, tpu=TPUSpec("v5e", "4x4")).obj
        self.jupyter.set_kernels(NS, NAME, [IDLE_KERNEL])
        self.api.create(obj)
        self.mgr.run_until_idle()

    def tick(self) -> dict:
        """This tick's annotations and gang; then the training loop acks a
        pending request and one idleness period passes."""
        nb = self.api.get("Notebook", NS, NAME)
        seen = {"annotations": dict(nb.metadata.annotations),
                "pods": len(self.api.list("Pod", namespace=NS)),
                "health": nb.status.get("sliceHealth"),
                "requested": self.watcher.check()}
        if seen["requested"]:
            self.watcher.acknowledge()
        self.mgr.advance(PERIOD_MIN * 60)
        return seen


@pytest.mark.parametrize("handshake", [False, True],
                         ids=["no-handshake", "handshake"])
def test_culler_matches_the_reference_tick_for_tick(handshake, tmp_path):
    ref = CullStack(False, handshake, tmp_path / "ref")
    ours = CullStack(True, handshake, tmp_path / "port")
    ref_ticks = [ref.tick() for _ in range(TICKS)]
    our_ticks = [ours.tick() for _ in range(TICKS)]
    assert our_ticks == ref_ticks

    def first(key):
        return next(i for i, t in enumerate(our_ticks)
                    if key in t["annotations"])

    culled = first(C.STOP_ANNOTATION)
    assert our_ticks[culled - 1]["pods"] == HOSTS
    assert [t["pods"] for t in our_ticks[culled:]] == \
        [0] * (TICKS - culled)
    assert our_ticks[culled]["health"] == "Stopped"
    assert ours.metrics.culling.value(NS, NAME) == 1
    assert ours.api.get("StatefulSet", NS, NAME).spec["replicas"] == 0
    signal_dir = tmp_path / "port" / NS / NAME
    if handshake:
        # requested, acknowledged by the port's watcher, then culled: the
        # culler counts the ack it saw, and the stop clears the handshake
        requested = first(C.ANNOTATION_CHECKPOINT_REQUESTED)
        assert requested < culled
        assert our_ticks[requested]["requested"]
        assert all(C.ANNOTATION_CHECKPOINT_REQUESTED in t["annotations"]
                   for t in our_ticks[requested:culled])
        assert ours.metrics.checkpoint_snapshots.value(NS, "cull") == 1
    else:
        assert not any(t["requested"] for t in our_ticks)
        assert not signal_dir.exists()
    # the cull retires both signal files
    assert not (signal_dir / checkpoint.REQUEST_FILE).exists()
    assert not (signal_dir / checkpoint.ACK_FILE).exists()
