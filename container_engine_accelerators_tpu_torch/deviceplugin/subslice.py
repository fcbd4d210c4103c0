"""Subslice partitioning: a host's cards split into fixed-size groups,
each advertised as one schedulable device; the port's copy of the JAX
package's deviceplugin/subslice.py. Partition IDs keep its form,
'tpu-sub0-2' (group 0, 2 cards), so fleet tooling reads them alike.
"""

from __future__ import annotations

import dataclasses

from container_engine_accelerators_tpu_torch.deviceplugin.devutil import Chip

VALID_PARTITION_SIZES = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class Subslice:
    id: str
    chips: tuple[Chip, ...]

    @property
    def numa_node(self) -> int | None:
        nodes = {c.numa_node for c in self.chips} - {None}
        return nodes.pop() if len(nodes) == 1 else None


def partition(chips: list[Chip], chips_per_partition: int) -> list[Subslice]:
    """Group chips, sorted by index, into equal subslices."""
    if chips_per_partition not in VALID_PARTITION_SIZES:
        raise ValueError(
            f"chips_per_partition must be one of {VALID_PARTITION_SIZES}, "
            f"got {chips_per_partition}")
    chips = sorted(chips, key=lambda c: c.index)
    if len(chips) % chips_per_partition:
        raise ValueError(
            f"{len(chips)} chips not divisible into partitions of "
            f"{chips_per_partition}")
    out = []
    for g in range(len(chips) // chips_per_partition):
        group = tuple(chips[g * chips_per_partition:
                            (g + 1) * chips_per_partition])
        out.append(Subslice(id=f"tpu-sub{g}-{chips_per_partition}",
                            chips=group))
    return out


def parse_subslice_id(device_id: str) -> tuple[int, int]:
    """'tpu-sub3-2' -> (group 3, size 2); raises on malformed IDs."""
    if not device_id.startswith("tpu-sub"):
        raise ValueError(f"not a subslice ID: {device_id!r}")
    body = device_id[len("tpu-sub"):]
    group, _, size = body.partition("-")
    if not group.isdigit() or not size.isdigit():
        raise ValueError(f"malformed subslice ID: {device_id!r}")
    return int(group), int(size)
