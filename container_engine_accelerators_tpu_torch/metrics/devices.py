"""Container -> card attribution through the kubelet PodResources
socket: the port's copy of the JAX package's metrics/devices.py, for
`nvidia.com/gpu` (reference pkg/gpu/nvidia/metrics/devices.go:33-101
does the same over /var/lib/kubelet/pod-resources/kubelet.sock)."""

from __future__ import annotations

import dataclasses
import logging

import grpc

from container_engine_accelerators_tpu_torch import GPU_RESOURCE_NAME
from container_engine_accelerators_tpu_torch.metrics import (
    podresources_pb2 as pb,
)

log = logging.getLogger(__name__)

DEFAULT_PODRESOURCES_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"
_LIST = "/v1.PodResources/List"


@dataclasses.dataclass(frozen=True)
class ContainerDevices:
    namespace: str
    pod: str
    container: str
    device_ids: tuple[str, ...]


class PodResourcesStub:
    def __init__(self, channel: grpc.Channel):
        self.List = channel.unary_unary(
            _LIST,
            request_serializer=pb.ListPodResourcesRequest.SerializeToString,
            response_deserializer=pb.ListPodResourcesResponse.FromString)


def add_podresources_servicer(servicer, server: grpc.Server):
    handlers = {
        "List": grpc.unary_unary_rpc_method_handler(
            servicer.List,
            request_deserializer=pb.ListPodResourcesRequest.FromString,
            response_serializer=pb.ListPodResourcesResponse.SerializeToString),
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "v1.PodResources", handlers),))


class PodResourcesClient:
    def __init__(self, socket_path: str = DEFAULT_PODRESOURCES_SOCKET,
                 resource_name: str = GPU_RESOURCE_NAME,
                 timeout: float = 5.0):
        self.socket_path = socket_path
        self.resource_name = resource_name
        self.timeout = timeout

    def containers_with_devices(self) -> list[ContainerDevices]:
        with grpc.insecure_channel(f"unix://{self.socket_path}") as channel:
            stub = PodResourcesStub(channel)
            resp = stub.List(pb.ListPodResourcesRequest(),
                             timeout=self.timeout)
        out = []
        for pod in resp.pod_resources:
            for container in pod.containers:
                ids = tuple(
                    dev_id
                    for dev in container.devices
                    if dev.resource_name == self.resource_name
                    for dev_id in dev.device_ids)
                if ids:
                    out.append(ContainerDevices(
                        namespace=pod.namespace, pod=pod.name,
                        container=container.name, device_ids=ids))
        return out
