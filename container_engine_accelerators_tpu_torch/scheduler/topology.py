"""Topology distance model: the port's copy of the JAX package's
scheduler/topology.py, with its slice and ICI labels and tiers.

The reference scores placement by a cluster/rack/host tree from GCE
`physical_host` metadata (reference gke-topology-scheduler/
schedule-daemon.py:153-172 node_topology_distance). TPU adds two levels
below the host tree: the *slice* a node belongs to and its *ICI
coordinates* inside the slice — two nodes in one slice communicate over
ICI (orders faster than DCN), and within a slice the cost scales with
torus hops.

Distance (higher = worse, dominated by the highest differing tier):
  different cluster            36
  different rack               12
  different host (DCN)          4
  different slice (DCN)         4      (same physical host tier but no ICI)
  same slice, ICI hops          manhattan(coords) / slice-diameter, < 1
  same node                     0
"""

from __future__ import annotations

import dataclasses

LABEL_CLUSTER = "topology.gke.io/cluster"
LABEL_RACK = "topology.gke.io/rack"
LABEL_HOST = "topology.gke.io/host"
LABEL_SLICE = "tpu.google.com/slice"
LABEL_ICI_COORDS = "tpu.google.com/ici-coords"   # "x-y-z"
LABEL_TPU_TOPOLOGY = "cloud.google.com/gke-tpu-topology"  # e.g. "4x4x8"


@dataclasses.dataclass(frozen=True)
class NodeTopology:
    name: str
    cluster: str = ""
    rack: str = ""
    host: str = ""
    slice_id: str = ""
    coords: tuple[int, ...] | None = None
    topology: tuple[int, ...] | None = None  # slice shape, e.g. (4, 4, 8)

    @classmethod
    def from_labels(cls, name: str, labels: dict) -> "NodeTopology":
        coords = None
        raw = labels.get(LABEL_ICI_COORDS, "")
        if raw:
            try:
                coords = tuple(int(x) for x in raw.split("-"))
            except ValueError:
                coords = None
        topo = None
        raw = labels.get(LABEL_TPU_TOPOLOGY, "")
        if raw:
            try:
                topo = tuple(int(x) for x in raw.lower().split("x"))
            except ValueError:
                topo = None
        return cls(name=name,
                   cluster=labels.get(LABEL_CLUSTER, ""),
                   rack=labels.get(LABEL_RACK, ""),
                   host=labels.get(LABEL_HOST, ""),
                   slice_id=labels.get(LABEL_SLICE, ""),
                   coords=coords, topology=topo)


def _ici_hops(a: NodeTopology, b: NodeTopology) -> float:
    if not a.coords or not b.coords or len(a.coords) != len(b.coords):
        return 0.5  # same slice, unknown position: cheap but nonzero
    shape = a.topology if a.topology and len(a.topology) == len(a.coords) \
        else None
    hops = 0
    diameter = 0
    for i, (x, y) in enumerate(zip(a.coords, b.coords)):
        d = abs(x - y)
        if shape:
            d = min(d, shape[i] - d)  # torus wraparound
            diameter += shape[i] // 2
        else:
            diameter += max(d, 1)
        hops += d
    diameter = max(diameter, 1)
    return hops / (diameter + 1)  # strictly < 1: always beats any DCN tier


def topology_distance(a: NodeTopology, b: NodeTopology) -> float:
    if a.name == b.name:
        return 0.0
    if a.cluster != b.cluster:
        return 36.0
    if a.rack != b.rack:
        return 12.0
    if a.slice_id and a.slice_id == b.slice_id:
        return _ici_hops(a, b)
    return 4.0  # same rack, different host/slice: DCN


def pairwise_distance(nodes: list[NodeTopology]) -> float:
    """Total pairwise distance of an assignment — the objective the
    scheduler minimizes (reference calculate_pods_assignment objective)."""
    total = 0.0
    for i in range(len(nodes)):
        for j in range(i + 1, len(nodes)):
            total += topology_distance(nodes[i], nodes[j])
    return total


def topology_sort_key(n: NodeTopology):
    """Sort nodes so topologically adjacent nodes are adjacent in the
    order: windows over this order are near-optimal assignments for tree
    distances (the basis of the sliding-window search)."""
    return (n.cluster, n.rack, n.slice_id or "~", n.coords or (1 << 30,),
            n.host, n.name)
