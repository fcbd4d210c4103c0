"""Time-sharing: virtual device IDs multiplexing one physical card, the
port's copy of the JAX package's deviceplugin/sharing.py.

Virtual IDs follow the physical name: 'nvidia0/vtpu2'. With sharing on,
a container gets exactly one virtual device (more cards means more
physical parallelism, which sharing cannot provide).
"""

from __future__ import annotations

VIRTUAL_SEP = "/vtpu"


def virtual_id(physical_id: str, index: int) -> str:
    return f"{physical_id}{VIRTUAL_SEP}{index}"


def is_virtual_id(device_id: str) -> bool:
    return VIRTUAL_SEP in device_id


def virtual_to_physical(device_id: str) -> str:
    if not is_virtual_id(device_id):
        raise ValueError(f"{device_id!r} is not a virtual device ID")
    phys, _, idx = device_id.partition(VIRTUAL_SEP)
    if not phys or not idx.isdigit():
        raise ValueError(f"malformed virtual device ID {device_id!r}")
    return phys


def validate_request(device_ids: list[str], sharing_enabled: bool) -> None:
    """Reject invalid mixes: virtual IDs require sharing; sharing limits
    a container to one virtual device."""
    virtuals = [d for d in device_ids if is_virtual_id(d)]
    if not sharing_enabled:
        if virtuals:
            raise ValueError(
                f"virtual devices {virtuals} requested but chip sharing is "
                "disabled")
        return
    if len(device_ids) > 1:
        raise ValueError(
            "chip sharing allows at most one shared device per container "
            f"(requested {len(device_ids)})")
    if device_ids and not virtuals:
        raise ValueError(
            f"physical device {device_ids[0]!r} requested while chip "
            "sharing is enabled")
