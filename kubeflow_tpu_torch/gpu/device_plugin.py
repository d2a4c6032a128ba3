"""Fake GPU kubelet device plugin + node labeler.

The port of kubeflow_tpu/tpu/device_plugin.py for `nvidia.com/gpu`:
nothing in a stock kind cluster provides `nvidia.com/gpu` allocatable, so
the GPU scheduling contract (indexed STS placement, gang scale, the
torchrun env) can only be certified with one.  Two layers, matching the
two substrates:

1. `FakeGpuDevicePlugin` — a real kubelet device plugin speaking the
   v1beta1 gRPC protocol over unix sockets: registers with kubelet
   (`Register` on kubelet.sock), serves `GetDevicePluginOptions` /
   `ListAndWatch` (streamed device list, health transitions re-streamed) /
   `Allocate` (per-container device specs and `NVIDIA_VISIBLE_DEVICES`
   naming the allocated devices, as NVIDIA's plugin sets it).  The
   protobuf messages are built dynamically from a FileDescriptorProto, so
   the module needs only grpcio + protobuf at runtime, and imports them
   only inside the gRPC layer.
2. `label_gpu_node` — the apiserver-side fallback for clusters where the
   kubelet is out of reach: patches `nvidia.com/gpu` into Node status
   capacity/allocatable and sets the GKE accelerator label
   (`cloud.google.com/gke-accelerator`, the value gpu/topology.py names),
   through any client with get/update/update_status.  It needs no
   grpcio.

`tests/test_torch_device_plugin.py` certifies the gRPC layer with a
harness acting as the kubelet.  Run it as a DaemonSet with
`python -m kubeflow_tpu_torch.gpu.device_plugin --gpus 8`.
"""

from __future__ import annotations

import os
import threading
from concurrent import futures
from dataclasses import dataclass, field
from typing import Optional

from ..core.constants import GKE_GPU_ACCELERATOR_LABEL, GPU_RESOURCE
from .topology import ACCELERATORS, TopologyError

API_VERSION = "v1beta1"
KUBELET_SOCKET = "kubelet.sock"
DEFAULT_RESOURCE = GPU_RESOURCE
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

# the GKE GPU node label (public contract; core/workload.py renders it as
# the gang's nodeSelector)
LABEL_ACCELERATOR = GKE_GPU_ACCELERATOR_LABEL


# ---------------------------------------------------------------------------
# v1beta1 protobuf messages, built dynamically (no protoc, no gencode)

_TYPE = {"string": 9, "bool": 8, "int64": 3, "message": 11}
_LABEL = {"optional": 1, "repeated": 3}


def _build_messages():
    from google.protobuf import (
        descriptor_pb2,
        descriptor_pool,
        message_factory,
    )

    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = "kubeflow_tpu_torch/deviceplugin_v1beta1.proto"
    fdp.package = API_VERSION
    fdp.syntax = "proto3"

    def msg(name):
        m = fdp.message_type.add()
        m.name = name
        return m

    def add_field(m, num, name, ftype, label="optional", type_name=""):
        f = m.field.add()
        f.name = name
        f.number = num
        f.type = _TYPE[ftype]
        f.label = _LABEL[label]
        if type_name:
            f.type_name = f".{API_VERSION}.{type_name}"

    def map_entry(parent, entry_name):
        e = parent.nested_type.add()
        e.name = entry_name
        e.options.map_entry = True
        for i, n in ((1, "key"), (2, "value")):
            f = e.field.add()
            f.name = n
            f.number = i
            f.type = _TYPE["string"]
            f.label = _LABEL["optional"]

    msg("Empty")

    m = msg("DevicePluginOptions")
    add_field(m, 1, "pre_start_required", "bool")
    add_field(m, 2, "get_preferred_allocation_available", "bool")

    m = msg("RegisterRequest")
    add_field(m, 1, "version", "string")
    add_field(m, 2, "endpoint", "string")
    add_field(m, 3, "resource_name", "string")
    add_field(m, 4, "options", "message", type_name="DevicePluginOptions")

    m = msg("Device")
    add_field(m, 1, "ID", "string")
    add_field(m, 2, "health", "string")

    m = msg("ListAndWatchResponse")
    add_field(m, 1, "devices", "message", "repeated", "Device")

    m = msg("ContainerAllocateRequest")
    add_field(m, 1, "devicesIDs", "string", "repeated")

    m = msg("AllocateRequest")
    add_field(m, 1, "container_requests", "message", "repeated",
              "ContainerAllocateRequest")

    m = msg("Mount")
    add_field(m, 1, "container_path", "string")
    add_field(m, 2, "host_path", "string")
    add_field(m, 3, "read_only", "bool")

    m = msg("DeviceSpec")
    add_field(m, 1, "container_path", "string")
    add_field(m, 2, "host_path", "string")
    add_field(m, 3, "permissions", "string")

    m = msg("ContainerAllocateResponse")
    map_entry(m, "EnvsEntry")
    add_field(m, 1, "envs", "message", "repeated",
              "ContainerAllocateResponse.EnvsEntry")
    add_field(m, 2, "mounts", "message", "repeated", "Mount")
    add_field(m, 3, "devices", "message", "repeated", "DeviceSpec")

    m = msg("AllocateResponse")
    add_field(m, 1, "container_responses", "message", "repeated",
              "ContainerAllocateResponse")

    m = msg("PreStartContainerRequest")
    add_field(m, 1, "devicesIDs", "string", "repeated")

    msg("PreStartContainerResponse")

    pool = descriptor_pool.DescriptorPool()
    pool.Add(fdp)
    classes = message_factory.GetMessageClassesForFiles([fdp.name], pool)
    return {
        name.rsplit(".", 1)[-1]: cls
        for name, cls in classes.items()
        if "." not in name.rsplit(f"{API_VERSION}.", 1)[-1]
    }


_MSGS = None
_MSGS_LOCK = threading.Lock()


def messages():
    """The v1beta1 message classes, keyed by short name (lazy singleton —
    grpc/protobuf import deferred until a plugin is actually used)."""
    global _MSGS
    with _MSGS_LOCK:
        if _MSGS is None:
            _MSGS = _build_messages()
    return _MSGS


# ---------------------------------------------------------------------------
# the plugin daemon


@dataclass
class FakeGpuDevicePlugin:
    """Advertises `gpus` fake GPU devices to the kubelet in `socket_dir`.

    start() serves the DevicePlugin gRPC service on its own socket and, if
    `<socket_dir>/kubelet.sock` exists, performs the standard registration
    handshake.  set_health() flips a device and re-streams the list to
    every ListAndWatch watcher (how the real plugin reports a dead GPU).
    """

    socket_dir: str
    gpus: int = 8
    resource_name: str = DEFAULT_RESOURCE
    endpoint: str = "kubeflow-gpu.sock"
    device_prefix: str = "/dev/nvidia"

    _server: Optional[object] = field(default=None, repr=False)
    _health: dict = field(default_factory=dict, repr=False)
    _version: int = 0
    _cond: threading.Condition = field(default_factory=threading.Condition,
                                       repr=False)

    def __post_init__(self):
        self._health = {f"gpu-{i}": HEALTHY for i in range(self.gpus)}

    # -- gRPC service handlers -------------------------------------------------

    def _options(self, request, context):
        return messages()["DevicePluginOptions"]()

    def _device_list(self):
        M = messages()
        resp = M["ListAndWatchResponse"]()
        for dev_id, health in sorted(self._health.items()):
            d = resp.devices.add()
            d.ID = dev_id
            d.health = health
        return resp

    def _list_and_watch(self, request, context):
        seen = -1
        while True:
            with self._cond:
                if seen == self._version:
                    # wake on health flips; periodic timeout keeps the
                    # stream responsive to cancellation
                    self._cond.wait(timeout=0.5)
                if seen == self._version:
                    if not context.is_active():
                        return
                    continue
                seen = self._version
                resp = self._device_list()
            yield resp

    def _allocate(self, request, context):
        M = messages()
        resp = M["AllocateResponse"]()
        for creq in request.container_requests:
            cresp = resp.container_responses.add()
            ids = list(creq.devicesIDs)
            for dev_id in ids:
                spec = cresp.devices.add()
                idx = dev_id.rsplit("-", 1)[-1]
                spec.container_path = f"{self.device_prefix}{idx}"
                spec.host_path = f"{self.device_prefix}{idx}"
                spec.permissions = "rw"
            cresp.envs["NVIDIA_VISIBLE_DEVICES"] = ",".join(ids)
        return resp

    def _pre_start(self, request, context):
        return messages()["PreStartContainerResponse"]()

    # -- lifecycle -------------------------------------------------------------

    @property
    def socket_path(self) -> str:
        return os.path.join(self.socket_dir, self.endpoint)

    def start(self, register: bool = True) -> None:
        import grpc

        M = messages()
        ser = lambda m: m.SerializeToString()  # noqa: E731
        handlers = {
            "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
                self._options,
                request_deserializer=M["Empty"].FromString,
                response_serializer=ser),
            "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                self._list_and_watch,
                request_deserializer=M["Empty"].FromString,
                response_serializer=ser),
            "Allocate": grpc.unary_unary_rpc_method_handler(
                self._allocate,
                request_deserializer=M["AllocateRequest"].FromString,
                response_serializer=ser),
            "PreStartContainer": grpc.unary_unary_rpc_method_handler(
                self._pre_start,
                request_deserializer=M["PreStartContainerRequest"].FromString,
                response_serializer=ser),
        }
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                f"{API_VERSION}.DevicePlugin", handlers),
        ))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        if register and os.path.exists(
                os.path.join(self.socket_dir, KUBELET_SOCKET)):
            self.register()

    def register(self) -> None:
        """The kubelet handshake: dial kubelet.sock, announce our endpoint
        and resource name."""
        import grpc

        M = messages()
        kubelet = os.path.join(self.socket_dir, KUBELET_SOCKET)
        with grpc.insecure_channel(f"unix://{kubelet}") as chan:
            register = chan.unary_unary(
                f"/{API_VERSION}.Registration/Register",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=M["Empty"].FromString)
            req = M["RegisterRequest"]()
            req.version = API_VERSION
            req.endpoint = self.endpoint
            req.resource_name = self.resource_name
            register(req, timeout=5)

    def set_health(self, dev_id: str, healthy: bool) -> None:
        with self._cond:
            if dev_id not in self._health:
                raise KeyError(dev_id)
            self._health[dev_id] = HEALTHY if healthy else UNHEALTHY
            self._version += 1
            self._cond.notify_all()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.2)
            self._server = None
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


# ---------------------------------------------------------------------------
# apiserver-side fallback


def label_gpu_node(client, node_name: str, gpus: int = 8,
                   accelerator: str = "h100-80gb",
                   resource_name: str = DEFAULT_RESOURCE):
    """Patch a Node to advertise GPU capacity without a kubelet: the GKE
    accelerator label of `accelerator` (a key of gpu/topology.py's
    table; its `gke_label` is the value) on metadata, `nvidia.com/gpu`
    in status capacity/allocatable.  Works through any client with
    get/update/update_status: the in-memory ApiServer, or a real one."""
    acc = ACCELERATORS.get(accelerator)
    if acc is None:
        raise TopologyError(f"unknown accelerator {accelerator!r}; "
                            f"supported: {sorted(ACCELERATORS)}")
    node = client.get("Node", "", node_name)
    node.metadata.labels[LABEL_ACCELERATOR] = acc.gke_label
    node = client.update(node)

    status = node.status
    for key in ("capacity", "allocatable"):
        res = dict(status.get(key) or {})
        res[resource_name] = str(gpus)
        status[key] = res
    return client.update_status(node)


__all__ = [
    "FakeGpuDevicePlugin",
    "LABEL_ACCELERATOR",
    "label_gpu_node",
    "messages",
    "API_VERSION",
    "DEFAULT_RESOURCE",
    "HEALTHY",
    "UNHEALTHY",
]


def main(argv=None) -> None:
    """DaemonSet entrypoint: serve + register, re-registering whenever the
    kubelet restarts (its socket is recreated, which wipes plugin
    registrations — the standard device-plugin re-register loop)."""
    import argparse
    import time

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--socket-dir",
                        default="/var/lib/kubelet/device-plugins")
    parser.add_argument("--gpus", type=int, default=8)
    parser.add_argument("--resource", default=DEFAULT_RESOURCE)
    args = parser.parse_args(argv)

    plugin = FakeGpuDevicePlugin(args.socket_dir, gpus=args.gpus,
                                 resource_name=args.resource)
    plugin.start(register=False)
    print(f"fake-gpu device plugin serving {args.gpus} GPUs on "
          f"{plugin.socket_path}", flush=True)
    kubelet = os.path.join(args.socket_dir, KUBELET_SOCKET)
    registered_ino = None
    try:
        while True:
            # a restarting kubelet wipes the device-plugins dir (including
            # OUR socket) before recreating kubelet.sock — re-serve first,
            # so the registration we then send points at a live endpoint
            if not os.path.exists(plugin.socket_path):
                plugin.stop()
                plugin.start(register=False)
                registered_ino = None
                print("socket wiped (kubelet restart?); re-serving",
                      flush=True)
            try:
                ino = os.stat(kubelet).st_ino
            except FileNotFoundError:
                ino = None
            if ino is not None and ino != registered_ino:
                try:
                    plugin.register()
                    registered_ino = ino
                    print("registered with kubelet", flush=True)
                except Exception as exc:  # kubelet mid-restart; retry
                    print(f"register failed, retrying: {exc}", flush=True)
            time.sleep(5)
    except KeyboardInterrupt:
        pass
    finally:
        plugin.stop()


if __name__ == "__main__":
    main()
