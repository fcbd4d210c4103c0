"""NRI device injector (L2): grants device nodes to unprivileged sidecar
containers from pod annotations. The port's copy of the JAX package's
nri/: the contract is device-agnostic (reference
nri_device_injector/nri_device_injector.go:30-40), so a GPU sidecar
names /dev/nvidia<N>, /dev/nvidiactl and /dev/nvidia-uvm where a TPU one
names /dev/accel<N>. The _pb2 modules are the JAX package's byte for
byte: protobuf's default pool takes a second registration of a file
only when its serialized descriptor is identical, and the parity tests
import both packages in one process."""

from container_engine_accelerators_tpu_torch.nri.injector import (
    ANNOTATION_PREFIX,
    Device,
    devices_for_container,
    inject_for_pod,
    parse_device_annotations,
    to_nri_device,
)

__all__ = [
    "ANNOTATION_PREFIX",
    "Device",
    "devices_for_container",
    "inject_for_pod",
    "parse_device_annotations",
    "to_nri_device",
]
