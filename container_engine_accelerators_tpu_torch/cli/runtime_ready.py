"""runtime-ready — node-resident readiness sidecar over `/dev/nvidia<N>`
cards: the port's counterpart of the JAX package's cli/runtime_ready.py,
with the same flags, ready file, atomic write and exit codes, and the
analog of the reference's nvidia-persistenced installer for
Confidential nodes (reference nvidia-persistenced-installer/*.go:46-94:
start persistence daemon, set GPU ready state, reboot on 'No devices
found', then idle).

Its responsibilities, the JAX tool's:
  - gate: wait until every expected card node exists and opens;
  - publish a ready-state file other components consume (the
    `nvidia-smi conf-compute -srs 1` analog);
  - watchdog: if chips vanish after being ready, either exit nonzero
    (DaemonSet restart/alerting) or — with --allow-reboot, matching the
    reference's recovery — signal PID 1 to reboot the node (reference
    nvidia_persistenced_installer.go:187-190, partition_gpu.go:297-300).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time

from container_engine_accelerators_tpu_torch.deviceplugin.devutil import (
    DEFAULT_DEV_ROOT,
    SysfsDeviceInfo,
)

log = logging.getLogger("runtime-ready")

READY_FILE = "/run/tpu/ready"


def chips_ok(info: SysfsDeviceInfo, expected: int | None) -> bool:
    chips = info.discover()
    if not chips:
        return False
    if expected is not None and len(chips) < expected:
        return False
    for c in chips:
        try:
            fd = os.open(c.dev_path, os.O_RDONLY)
            os.close(fd)
        except OSError:
            return False
    return True


def reboot_node() -> None:
    """SIGRTMIN+5 to PID 1: the systemd soft-reboot request the reference
    sends (partition_gpu.go:297-300). Requires hostPID."""
    log.error("rebooting node via signal to PID 1")
    os.kill(1, signal.SIGRTMIN + 5)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dev-root", default=DEFAULT_DEV_ROOT)
    p.add_argument("--expected-chips", type=int, default=None)
    p.add_argument("--ready-file", default=READY_FILE)
    p.add_argument("--poll-interval", type=float, default=10.0)
    p.add_argument("--startup-timeout", type=float, default=300.0)
    p.add_argument("--allow-reboot", action="store_true",
                   help="reboot the node (signal PID 1) if chips vanish "
                        "after becoming ready")
    p.add_argument("--once", action="store_true",
                   help="check once and exit (init-container mode)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    info = SysfsDeviceInfo(dev_root=args.dev_root)

    deadline = time.monotonic() + args.startup_timeout
    while not chips_ok(info, args.expected_chips):
        if time.monotonic() > deadline:
            log.error("cards never became ready")
            return 1
        if args.once:
            return 1
        log.info("waiting for cards...")
        time.sleep(args.poll_interval)

    os.makedirs(os.path.dirname(args.ready_file) or ".", exist_ok=True)
    # The readiness stamp is what node probes poll for — it must appear
    # whole or not at all (TPL003).
    tmp = f"{args.ready_file}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{len(info.discover())}\n")
    os.replace(tmp, args.ready_file)
    log.info("card runtime ready (%d cards); stamped %s",
             len(info.discover()), args.ready_file)
    if args.once:
        return 0

    # Watchdog (the signal-blocking idle of the reference, but productive).
    while True:
        time.sleep(args.poll_interval)
        if not chips_ok(info, args.expected_chips):
            log.error("cards disappeared after ready")
            try:
                os.unlink(args.ready_file)
            except OSError:
                pass
            if args.allow_reboot:
                reboot_node()
            return 2


if __name__ == "__main__":
    sys.exit(main())
