"""Hand-written gRPC stubs/servicers for the kubelet device-plugin v1beta1
API, the port's copy of the JAX package's (the environment has no
grpcio-tools codegen; messages come from protoc-generated
deviceplugin_pb2, services are declared here)."""

from __future__ import annotations

import grpc

from container_engine_accelerators_tpu_torch.deviceplugin.api import (
    deviceplugin_pb2 as pb,
)

_REGISTRATION = "/v1beta1.Registration/"
_PLUGIN = "/v1beta1.DevicePlugin/"


class RegistrationStub:
    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            _REGISTRATION + "Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString)


class DevicePluginStub:
    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            _PLUGIN + "GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString)
        self.ListAndWatch = channel.unary_stream(
            _PLUGIN + "ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString)
        self.GetPreferredAllocation = channel.unary_unary(
            _PLUGIN + "GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString)
        self.Allocate = channel.unary_unary(
            _PLUGIN + "Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString)
        self.PreStartContainer = channel.unary_unary(
            _PLUGIN + "PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString)


class RegistrationServicer:
    def Register(self, request, context):
        raise NotImplementedError


class DevicePluginServicer:
    def GetDevicePluginOptions(self, request, context):
        raise NotImplementedError

    def ListAndWatch(self, request, context):
        raise NotImplementedError

    def GetPreferredAllocation(self, request, context):
        raise NotImplementedError

    def Allocate(self, request, context):
        raise NotImplementedError

    def PreStartContainer(self, request, context):
        raise NotImplementedError


def add_registration_servicer(servicer: RegistrationServicer,
                              server: grpc.Server):
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString),
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "v1beta1.Registration", handlers),))


def add_device_plugin_servicer(servicer: DevicePluginServicer,
                               server: grpc.Server):
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=pb.PreferredAllocationResponse.SerializeToString),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString),
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "v1beta1.DevicePlugin", handlers),))
