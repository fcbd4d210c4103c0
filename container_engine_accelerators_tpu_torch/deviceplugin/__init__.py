"""Kubelet device plugin of the port (L1): advertises `nvidia.com/gpu`,
hands each container its `/dev/nvidia<N>` nodes, the driver's control
nodes, the driver tree and its cards' UUIDs. The counterpart of the JAX
package's deviceplugin/, over NVIDIA cards."""

from container_engine_accelerators_tpu_torch.deviceplugin.config import (
    SharingConfig,
    TPUConfig,
)
from container_engine_accelerators_tpu_torch.deviceplugin.devutil import (
    Chip,
    DeviceInfo,
    MockDeviceInfo,
    SysfsDeviceInfo,
)
from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    HEALTHY,
    UNHEALTHY,
    TPUManager,
)
from container_engine_accelerators_tpu_torch.deviceplugin.plugin_service import (
    DevicePluginService,
)

__all__ = [
    "SharingConfig",
    "TPUConfig",
    "Chip",
    "DeviceInfo",
    "MockDeviceInfo",
    "SysfsDeviceInfo",
    "HEALTHY",
    "UNHEALTHY",
    "TPUManager",
    "DevicePluginService",
]
