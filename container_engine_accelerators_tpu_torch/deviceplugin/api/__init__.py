"""Kubelet device-plugin v1beta1 API: protoc-generated messages + hand-written
gRPC stubs, the port's copy of the JAX package's deviceplugin/api.

deviceplugin.proto and deviceplugin_pb2.py are byte for byte the JAX
package's: protobuf's default descriptor pool takes a second
registration of `deviceplugin.proto` only when its serialized bytes are
identical, and a process that imports both packages (the parity tests)
then shares one set of message classes. Regenerate messages with:
    protoc --python_out=. deviceplugin.proto
"""

from container_engine_accelerators_tpu_torch.deviceplugin.api import deviceplugin_pb2
from container_engine_accelerators_tpu_torch.deviceplugin.api.deviceplugin_grpc import (
    DevicePluginServicer,
    DevicePluginStub,
    RegistrationServicer,
    RegistrationStub,
    add_device_plugin_servicer,
    add_registration_servicer,
)

__all__ = [
    "deviceplugin_pb2",
    "DevicePluginServicer",
    "DevicePluginStub",
    "RegistrationServicer",
    "RegistrationStub",
    "add_device_plugin_servicer",
    "add_registration_servicer",
]
