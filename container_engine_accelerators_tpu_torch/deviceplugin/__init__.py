"""Device plugin of the port (its discovery, advertised devices and
health fan-out): the counterpart of the JAX package's deviceplugin/,
over NVIDIA cards (`/dev/nvidia<N>`)."""

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
    Device,
    TPUManager,
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
    "Device",
    "TPUManager",
]
