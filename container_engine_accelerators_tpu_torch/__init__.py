"""PyTorch/CUDA port of the serving, training and node health paths,
for an NVIDIA H100.

Mirrors the module names of `container_engine_accelerators_tpu` so each
counterpart is easy to find, but shares no code with it: this package
imports torch and never jax, and keeps its own copy of whatever it needs.

Entry points run on `cuda` unless the caller passes `device="cpu"`; on a
machine without CUDA they raise instead of falling back to the CPU. The
hand-written Hopper kernels live in `kernels/` and are built with nvcc on
first use (`kernels.load()`). The node health path (`deviceplugin/`,
`healthcheck/`, `cli/inject_fault.py`) and the rest of the node layer
(the kubelet device plugin, `metrics/metrics.py`, `cli/partition_tpu.py`,
`cli/runtime_ready.py`) are host code; the card metrics read NVML.
"""

# Resource name advertised to the kubelet: the reference's
# (pkg/gpu/nvidia/manager.go:67).
GPU_RESOURCE_NAME = "nvidia.com/gpu"
