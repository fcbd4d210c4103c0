"""Card device plugin daemon: the port's counterpart of the JAX
package's cli/device_plugin_main.py and of the reference's main
(reference cmd/nvidia_gpu/nvidia_gpu.go:110-226). Parse flags, load the
config, wait for the driver's nodes, wire metrics, health and version
visibility, then run the kubelet serve loop until SIGTERM.

  python -m container_engine_accelerators_tpu_torch.cli.device_plugin_main \\
      --enable-metrics --enable-health-monitoring

The flags are the JAX plugin's, except: `--driver-host-dir` and
`--driver-container-dir` take the place of the libtpu pair, NVML takes
the place of `--sysfs-accel-root`, and `--wait-for-devices-timeout`
waits for `/dev/nvidiactl` and a card node. With `--enable-metrics` the
card metrics read NVML, and the daemon exits 1 with NVML's error where
NVML cannot be loaded or enumerates no card.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time

from container_engine_accelerators_tpu_torch.deviceplugin import (
    TPUManager,
    config as tpu_config,
)
from container_engine_accelerators_tpu_torch.deviceplugin import manager as mgr

log = logging.getLogger("gpu-device-plugin")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device-plugin-path", default=mgr.DEFAULT_PLUGIN_DIR,
                   help="kubelet device-plugin socket directory")
    p.add_argument("--driver-host-dir", default=mgr.DEFAULT_DRIVER_HOST_DIR,
                   help="host dir with the driver tree staged by the "
                        "installer")
    p.add_argument("--driver-container-dir",
                   default=mgr.DEFAULT_DRIVER_CONTAINER_DIR)
    p.add_argument("--config-file", default="/etc/tpu/tpu_config.json")
    p.add_argument("--dev-root", default=None,
                   help="override /dev (smoke tests against fake card trees)")
    p.add_argument("--enable-metrics", action="store_true",
                   help="serve Prometheus card metrics (NVML)")
    p.add_argument("--metrics-port", type=int, default=2112)
    p.add_argument("--metrics-interval", type=float, default=10.0,
                   help="seconds between NVML samples")
    p.add_argument("--podresources-socket", default=None,
                   help="override the kubelet PodResources socket")
    p.add_argument("--enable-health-monitoring", action="store_true",
                   help="run the card health checker / Node conditions")
    p.add_argument("--error-log", default=None,
                   help="override the health checker's JSONL error feed")
    p.add_argument("--runtime-log", default="",
                   help="scrape this raw runtime or kernel log as a third "
                        "health source (regex->class table from config's "
                        "runtimeLogScraper block, built-in default rules "
                        "otherwise); overrides the config path")
    p.add_argument("--publish-version-annotations", action="store_true",
                   help="publish the driver version as node annotations")
    p.add_argument("--wait-for-devices-timeout", type=float, default=0.0,
                   help="seconds to wait for /dev/nvidiactl and a card "
                        "node (0 = forever)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def devices_ready(manager: TPUManager, dev_root: str) -> bool:
    """The driver's control node and at least one card node exist (the
    reference waits on /dev/nvidiactl, nvidia_gpu.go:144-154)."""
    return (os.path.exists(os.path.join(dev_root, "nvidiactl"))
            and manager.check_device_paths())


def main(argv=None) -> int:
    """Run the daemon until SIGTERM ends the serve loop."""
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    cfg = tpu_config.load(args.config_file)
    log.info("config: %s", cfg)

    from container_engine_accelerators_tpu_torch.deviceplugin.devutil import (
        DEFAULT_DEV_ROOT,
        SysfsDeviceInfo,
    )
    from container_engine_accelerators_tpu_torch.utils.nvml import NvmlError

    dev_root = args.dev_root or DEFAULT_DEV_ROOT
    info = SysfsDeviceInfo(dev_root=dev_root)
    manager = TPUManager(
        cfg, info,
        plugin_dir=args.device_plugin_path,
        driver_host_dir=args.driver_host_dir,
        driver_container_dir=args.driver_container_dir)

    # Block until the driver installer has created the nodes.
    deadline = (time.monotonic() + args.wait_for_devices_timeout
                if args.wait_for_devices_timeout else None)
    while not devices_ready(manager, dev_root):
        if deadline and time.monotonic() > deadline:
            log.error("no nvidiactl and card node appeared under %s; "
                      "giving up", dev_root)
            return 1
        log.info("waiting for the driver's device nodes...")
        time.sleep(min(5.0, args.wait_for_devices_timeout or 5.0))

    manager.discover()
    log.info("discovered %d advertised devices", len(manager.devices))

    metric_server = None
    if args.enable_metrics:
        from container_engine_accelerators_tpu_torch.metrics.devices import (
            PodResourcesClient,
        )
        from container_engine_accelerators_tpu_torch.metrics.metrics import (
            MetricServer,
        )
        from container_engine_accelerators_tpu_torch.metrics.sampler import (
            make_sampler,
        )
        try:
            sampler = make_sampler(info.nvml())
        except NvmlError as e:
            log.error("card metrics need NVML: %s", e)
            return 1
        pod_resources = (PodResourcesClient(args.podresources_socket)
                         if args.podresources_socket else None)
        metric_server = MetricServer(manager, sampler=sampler,
                                     pod_resources=pod_resources,
                                     port=args.metrics_port,
                                     interval=args.metrics_interval)
        metric_server.start_background()
    if (args.runtime_log or cfg.runtime_log_path) \
            and not args.enable_health_monitoring:
        # A scrape target (flag or config) without the checker would be
        # silently inert.
        log.info("runtime-log scrape target implies "
                 "--enable-health-monitoring")
        args.enable_health_monitoring = True
    checker = None
    if args.enable_health_monitoring:
        from container_engine_accelerators_tpu_torch.healthcheck.health_checker import (
            DEFAULT_ERROR_LOG,
            TPUHealthChecker,
        )
        # Node conditions and Events need the API server; outside a
        # cluster the checker only flips device health.
        k8s = None
        try:
            from container_engine_accelerators_tpu_torch.k8s import (
                in_cluster_client,
            )
            k8s = in_cluster_client()
        except Exception as e:
            log.warning("no in-cluster K8s API (%s); health checker will "
                        "only flip device health, not Node conditions", e)
        if args.runtime_log:
            cfg.runtime_log_path = args.runtime_log
        # Its two counters reach /metrics on the card exporter's port.
        checker = TPUHealthChecker(
            manager, cfg, k8s=k8s,
            error_log_path=args.error_log or DEFAULT_ERROR_LOG,
            registry=metric_server.registry if metric_server else None)
        threading.Thread(target=checker.run, daemon=True,
                         name="health-checker").start()
    if args.publish_version_annotations:
        from container_engine_accelerators_tpu_torch.deviceplugin.version_visibility import (
            publish_version_annotations_forever,
        )
        threading.Thread(target=publish_version_annotations_forever,
                         kwargs={"driver_dir": args.driver_host_dir},
                         daemon=True, name="version-visibility").start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: manager.stop())
    try:
        manager.serve()
    finally:
        if checker is not None:
            checker.stop()
        if metric_server is not None:
            metric_server.stop()
    log.info("device plugin stopped after %d restarts", manager.restarts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
