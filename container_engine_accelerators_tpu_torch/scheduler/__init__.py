"""Topology-aware scheduling (L4): gate-based userspace scheduler + node
labeler, re-targeted from rack/host network locality (reference
gke-topology-scheduler/) to slice/ICI locality. The port's copy of the
JAX package's scheduler/: the same labels, distance tiers, window
search and repair, counting `nvidia.com/gpu` where the JAX package
counts `google.com/tpu`."""

from container_engine_accelerators_tpu_torch.scheduler.topology import (
    NodeTopology,
    pairwise_distance,
    topology_distance,
    topology_sort_key,
)

__all__ = [
    "NodeTopology",
    "pairwise_distance",
    "topology_distance",
    "topology_sort_key",
]
