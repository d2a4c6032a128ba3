"""Fake GPU device plugin: protocol-certified against a kubelet harness.

The harness of tests/test_device_plugin.py, for the port's
`FakeGpuDevicePlugin`: it plays the kubelet's two roles over real
unix-domain sockets, a `v1beta1.Registration` gRPC server receiving the
plugin's `Register` handshake and a `v1beta1.DevicePlugin` client driving
`GetDevicePluginOptions` / `ListAndWatch` / `Allocate` against the
plugin's socket, so a node with this plugin gets `nvidia.com/gpu`
allocatable.  The apiserver-side fallback (`label_gpu_node`) is certified
against the port's in-memory ApiServer, with grpc out of reach.
"""

from __future__ import annotations

import sys
import threading
from concurrent import futures

import pytest

grpc = pytest.importorskip("grpc")

from kubeflow_tpu_torch.api.types import GPUSpec, Notebook  # noqa: E402
from kubeflow_tpu_torch.core.notebook_controller import (  # noqa: E402
    setup_core_controllers,
)
from kubeflow_tpu_torch.gpu.device_plugin import (  # noqa: E402
    API_VERSION,
    DEFAULT_RESOURCE,
    HEALTHY,
    LABEL_ACCELERATOR,
    UNHEALTHY,
    FakeGpuDevicePlugin,
    label_gpu_node,
    messages,
)
from kubeflow_tpu_torch.gpu.topology import TopologyError  # noqa: E402
from kubeflow_tpu_torch.kube import (  # noqa: E402
    ApiServer,
    FakeCluster,
    KubeObject,
    Manager,
    ObjectMeta,
)
from kubeflow_tpu_torch.utils.clock import FakeClock  # noqa: E402
from kubeflow_tpu_torch.utils.config import CoreConfig  # noqa: E402


class KubeletHarness:
    """The kubelet side of the handshake: Registration server + plugin
    client helpers."""

    def __init__(self, socket_dir: str):
        self.socket_dir = socket_dir
        self.register_requests: list = []
        self.registered = threading.Event()
        M = messages()
        handlers = {
            "Register": grpc.unary_unary_rpc_method_handler(
                self._register,
                request_deserializer=M["RegisterRequest"].FromString,
                response_serializer=lambda m: m.SerializeToString()),
        }
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                f"{API_VERSION}.Registration", handlers),
        ))
        self.server.add_insecure_port(f"unix://{socket_dir}/kubelet.sock")
        self.server.start()

    def _register(self, request, context):
        self.register_requests.append(request)
        self.registered.set()
        return messages()["Empty"]()

    def plugin_channel(self, endpoint: str):
        return grpc.insecure_channel(f"unix://{self.socket_dir}/{endpoint}")

    def stop(self):
        self.server.stop(grace=0.2)


@pytest.fixture
def socket_dir(tmp_path):
    return str(tmp_path)


@pytest.fixture
def harness(socket_dir):
    h = KubeletHarness(socket_dir)
    yield h
    h.stop()


@pytest.fixture
def plugin(socket_dir, harness):
    p = FakeGpuDevicePlugin(socket_dir, gpus=4)
    p.start()
    yield p
    p.stop()


def _stub(chan, method, req_cls, resp_cls, stream=False):
    kind = chan.unary_stream if stream else chan.unary_unary
    return kind(
        f"/{API_VERSION}.DevicePlugin/{method}",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=resp_cls.FromString)


def test_plugin_registers_with_kubelet(plugin, harness):
    assert harness.registered.wait(timeout=5)
    (req,) = harness.register_requests
    assert req.version == API_VERSION
    assert req.resource_name == DEFAULT_RESOURCE == "nvidia.com/gpu"
    assert req.endpoint == plugin.endpoint


def test_options(plugin, harness):
    M = messages()
    with harness.plugin_channel(plugin.endpoint) as chan:
        opts = _stub(chan, "GetDevicePluginOptions", M["Empty"],
                     M["DevicePluginOptions"])(M["Empty"](), timeout=5)
    assert not opts.pre_start_required


def test_list_and_watch_streams_devices_and_health(plugin, harness):
    M = messages()
    with harness.plugin_channel(plugin.endpoint) as chan:
        stream = _stub(chan, "ListAndWatch", M["Empty"],
                       M["ListAndWatchResponse"], stream=True)(
            M["Empty"](), timeout=10)
        first = next(stream)
        assert [d.ID for d in first.devices] == [
            "gpu-0", "gpu-1", "gpu-2", "gpu-3"]
        assert all(d.health == HEALTHY for d in first.devices)
        # a dead GPU re-streams the list with the device Unhealthy, and
        # its recovery streams it back
        plugin.set_health("gpu-2", healthy=False)
        second = {d.ID: d.health for d in next(stream).devices}
        assert second == {"gpu-0": HEALTHY, "gpu-1": HEALTHY,
                          "gpu-2": UNHEALTHY, "gpu-3": HEALTHY}
        plugin.set_health("gpu-2", healthy=True)
        third = next(stream)
        assert all(d.health == HEALTHY for d in third.devices)


def test_allocate_returns_device_specs_and_visible_devices(plugin, harness):
    M = messages()
    req = M["AllocateRequest"]()
    req.container_requests.add().devicesIDs.extend(["gpu-0", "gpu-3"])
    req.container_requests.add().devicesIDs.extend(["gpu-1"])
    with harness.plugin_channel(plugin.endpoint) as chan:
        resp = _stub(chan, "Allocate", M["AllocateRequest"],
                     M["AllocateResponse"])(req, timeout=5)
    first, second = resp.container_responses
    assert [d.host_path for d in first.devices] == [
        "/dev/nvidia0", "/dev/nvidia3"]
    assert all(d.permissions == "rw" for d in first.devices)
    assert dict(first.envs) == {"NVIDIA_VISIBLE_DEVICES": "gpu-0,gpu-3"}
    assert dict(second.envs) == {"NVIDIA_VISIBLE_DEVICES": "gpu-1"}


def test_set_health_unknown_device(socket_dir):
    p = FakeGpuDevicePlugin(socket_dir, gpus=1)
    with pytest.raises(KeyError):
        p.set_health("gpu-9", healthy=False)


def test_label_gpu_node_needs_no_grpc_and_lets_a_gang_schedule(monkeypatch):
    """The fallback patches the GKE accelerator label and nvidia.com/gpu
    capacity with grpc and protobuf out of reach; an 8-GPU gang then
    binds to the node in the fake cluster."""
    for mod in ("grpc", "google.protobuf"):
        monkeypatch.setitem(sys.modules, mod, None)
    api = ApiServer()
    cluster = FakeCluster(api)
    api.create(KubeObject("v1", "Node", ObjectMeta(name="worker-0")))
    node = label_gpu_node(api, "worker-0", gpus=8, accelerator="h100-80gb")
    assert node.metadata.labels[LABEL_ACCELERATOR] == "nvidia-h100-80gb"
    stored = api.get("Node", "", "worker-0")
    assert stored.status["capacity"]["nvidia.com/gpu"] == "8"
    assert stored.status["allocatable"]["nvidia.com/gpu"] == "8"
    with pytest.raises(TopologyError, match="unknown accelerator 'v5e'"):
        label_gpu_node(api, "worker-0", accelerator="v5e")

    mgr = Manager(api, clock=FakeClock())
    setup_core_controllers(mgr, CoreConfig())
    api.create(KubeObject.from_dict(Notebook.new(
        "nb", "u1", gpu=GPUSpec("h100-80gb", 8)).obj))
    mgr.run_until_idle()
    assert api.get("Pod", "u1", "nb-0").spec["nodeName"] == "worker-0"
    assert cluster.node_used("worker-0") == {"nvidia.com/gpu": 8.0}
    assert api.get("Notebook", "u1", "nb").status["sliceHealth"] == "Healthy"
