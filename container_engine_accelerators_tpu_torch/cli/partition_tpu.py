"""partition_tpu — one-shot partitioner (init container) over
`/dev/nvidia<N>` cards: the port's counterpart of the JAX package's
cli/partition_tpu.py, with the same flags, config file, atomic write,
idempotence and exit codes, and the analog of the reference's
partition_gpu CLI (reference partition_gpu/partition_gpu.go:157-236):
desired-state check first (idempotent), then apply, then verify, so
reruns are no-ops.

Like the JAX tool's, the partitioning is a *plugin-level* contract: this
tool validates the layout against the discovered cards and writes
/etc/tpu/tpu_config.json, which the device plugin's card-rescan loop
picks up (advertised devices change -> server restart -> kubelet
resync). MIG through nvidia-smi, which the JAX package has no
counterpart of, is not here.

  partition_tpu --chips-per-partition 2          # apply
  partition_tpu --chips-per-partition 0          # dissolve partitions
  partition_tpu --list                           # show current layout
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile

from container_engine_accelerators_tpu_torch.deviceplugin import config as tpu_config
from container_engine_accelerators_tpu_torch.deviceplugin import subslice
from container_engine_accelerators_tpu_torch.deviceplugin.devutil import (
    DEFAULT_DEV_ROOT,
    SysfsDeviceInfo,
)

log = logging.getLogger("partition-tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chips-per-partition", type=int, default=None)
    p.add_argument("--config-file", default="/etc/tpu/tpu_config.json")
    p.add_argument("--dev-root", default=DEFAULT_DEV_ROOT)
    p.add_argument("--list", action="store_true",
                   help="print the current partition layout and exit")
    return p.parse_args(argv)


def current_config(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def write_config(path: str, cfg: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    with os.fdopen(fd, "w") as f:
        json.dump(cfg, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)  # atomic: the plugin never sees a torn file


def show_layout(chips, size: int) -> str:
    if not size:
        return "\n".join(f"{os.path.basename(c.dev_path)}  (unpartitioned)"
                         for c in chips)
    rows = []
    for sub in subslice.partition(chips, size):
        members = ",".join(os.path.basename(c.dev_path) for c in sub.chips)
        rows.append(f"{sub.id}  chips=[{members}]  numa={sub.numa_node}")
    return "\n".join(rows)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(name)s %(levelname)s %(message)s")

    chips = SysfsDeviceInfo(dev_root=args.dev_root).discover()
    if not chips:
        log.error("no cards under %s", args.dev_root)
        return 1

    existing = current_config(args.config_file)
    existing_size = int(existing.get("chipsPerPartition", 0))

    if args.list:
        print(show_layout(chips, existing_size))
        return 0

    if args.chips_per_partition is None:
        size = int(tpu_config.load(args.config_file).chips_per_partition)
    else:
        size = args.chips_per_partition

    # Desired-state check (reference partition_gpu.go:213-220): rerunning
    # with the current size must be a no-op.
    if size == existing_size:
        log.info("already partitioned at chips_per_partition=%d; nothing "
                 "to do", size)
        print(show_layout(chips, size))
        return 0

    if size:
        try:
            layout = subslice.partition(chips, size)
        except ValueError as e:
            log.error("invalid partition request: %s", e)
            return 1
        log.info("partitioning %d chips into %d subslices of %d",
                 len(chips), len(layout), size)

    new_cfg = dict(existing)
    new_cfg["chipsPerPartition"] = size
    write_config(args.config_file, new_cfg)

    # Verify: reload through the plugin's own config loader.
    verified = tpu_config.load(args.config_file)
    if verified.chips_per_partition != size:
        log.error("verification failed: wrote %d, read back %d",
                  size, verified.chips_per_partition)
        return 1
    print(show_layout(chips, size))
    log.info("partition config applied; device plugin will resync on its "
             "next chip-rescan cycle")
    return 0


if __name__ == "__main__":
    sys.exit(main())
