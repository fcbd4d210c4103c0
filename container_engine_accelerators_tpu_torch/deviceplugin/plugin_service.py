"""DevicePlugin gRPC service: ListAndWatch streaming, Allocate,
GetPreferredAllocation and PreStartContainer. The port's counterpart of
the JAX package's deviceplugin/plugin_service.py, and of the reference's
pluginServiceV1Beta1 (reference pkg/gpu/nvidia/beta_plugin.go:31-107).
"""

from __future__ import annotations

import logging
import queue

import grpc

from container_engine_accelerators_tpu_torch.deviceplugin import sharing
from container_engine_accelerators_tpu_torch.deviceplugin.api import (
    DevicePluginServicer,
    deviceplugin_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.deviceplugin.config import (
    TIME_SHARING,
)

log = logging.getLogger(__name__)


class DevicePluginService(DevicePluginServicer):
    def __init__(self, manager):
        self.manager = manager
        self._stopped = False

    def stop(self):
        self._stopped = True
        # Wake every stream so it sees the stop flag.
        self.manager.wake_listeners()

    # -- kubelet-facing RPCs --

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        """Stream the device snapshot on connect and again on every health
        transition (reference beta_plugin.go:36-53)."""
        q = self.manager.add_listener()
        try:
            yield pb.ListAndWatchResponse(devices=self.manager.snapshot())
            while not self._stopped and context.is_active():
                try:
                    q.get(timeout=0.5)
                except queue.Empty:
                    continue
                if self._stopped:
                    return
                yield pb.ListAndWatchResponse(devices=self.manager.snapshot())
        finally:
            self.manager.remove_listener(q)

    def Allocate(self, request, context):
        """Card nodes and control nodes, the driver mount and the
        visibility envs, per container (reference beta_plugin.go:56-93).
        An unknown ID or a request the sharing rules refuse aborts with
        INVALID_ARGUMENT."""
        sharing_on = self.manager.config.sharing.strategy == TIME_SHARING
        resp = pb.AllocateResponse()
        for creq in request.container_requests:
            ids = list(creq.devicesIDs)
            try:
                sharing.validate_request(ids, sharing_on)
                specs = self.manager.device_specs(ids)
                envs = self.manager.envs(ids)
            except (ValueError, KeyError) as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            cresp = resp.container_responses.add()
            cresp.devices.extend(specs)
            cresp.mounts.extend(self.manager.mounts())
            for k, v in envs.items():
                cresp.envs[k] = v
        return resp

    def GetPreferredAllocation(self, request, context):
        """The devices a container must get, then the available ones by
        NUMA node and lowest card index, up to the allocation size."""
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            available = list(creq.available_deviceIDs)
            must = list(creq.must_include_deviceIDs)
            size = creq.allocation_size

            def sort_key(dev_id):
                try:
                    chips = self.manager.chips_for_device(dev_id)
                except KeyError:
                    return (99, 1 << 30)
                numa = chips[0].numa_node
                return (numa if numa is not None else 99,
                        min(c.index for c in chips))

            chosen = list(must)
            for dev_id in sorted(available, key=sort_key):
                if len(chosen) >= size:
                    break
                if dev_id not in chosen:
                    chosen.append(dev_id)
            resp.container_responses.add(deviceIDs=chosen[:size])
        return resp

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()
