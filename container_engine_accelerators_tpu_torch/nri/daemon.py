"""NRI device-injector daemon: a real containerd NRI plugin over the
multiplexed-ttrpc socket protocol (transport in nri/ttrpc.py, wire formats
from the public containerd/nri + containerd/ttrpc API specs).

Flow (mirrors the Go stub's Start, reference vendor/github.com/containerd/
nri/pkg/stub/stub.go:304-356):
  1. connect to /var/run/nri/nri.sock, wrap in the 8-byte-header mux;
  2. serve the Plugin service on conn 1 (Configure / Synchronize /
     CreateContainer / StateChange / Shutdown);
  3. open conn 2 as a ttrpc client and call Runtime.RegisterPlugin.

CreateContainer answers with device adjustments computed by
nri/injector.py from `devices.gke.io/container.<name>` pod annotations.
The port's copy of the JAX package's nri/daemon.py, with its flags: the
default --plugin-name stays `tpu-device-injector`, so a runtime's plugin
list names the same plugin whichever package serves it.

    python -m container_engine_accelerators_tpu_torch.nri.daemon \
        --nri-socket /var/run/nri/nri.sock
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
import time

from container_engine_accelerators_tpu_torch.nri import nri_api_pb2 as api
from container_engine_accelerators_tpu_torch.nri.injector import (
    devices_for_container,
)
from container_engine_accelerators_tpu_torch.nri.ttrpc import (
    PLUGIN_SERVICE_CONN,
    RUNTIME_SERVICE_CONN,
    Mux,
    TtrpcClient,
    TtrpcServer,
)

log = logging.getLogger("nri-device-injector")

NRI_SOCKET = "/var/run/nri/nri.sock"
PLUGIN_SERVICE = "nri.pkg.api.v1alpha1.Plugin"
RUNTIME_SERVICE = "nri.pkg.api.v1alpha1.Runtime"

# Event mask bit = 1 << (event - 1) (reference pkg/api/event.go:154-157).
EVENT_CREATE_CONTAINER = 4
CREATE_CONTAINER_MASK = 1 << (EVENT_CREATE_CONTAINER - 1)


class InjectorPlugin:
    """Plugin-service handlers, protobuf in/out."""

    def __init__(self):
        self.configured = False

    def configure(self, payload: bytes) -> bytes:
        req = api.ConfigureRequest.FromString(payload)
        log.info("configured by %s %s", req.runtime_name,
                 req.runtime_version)
        self.configured = True
        return api.ConfigureResponse(
            events=CREATE_CONTAINER_MASK).SerializeToString()

    def synchronize(self, payload: bytes) -> bytes:
        req = api.SynchronizeRequest.FromString(payload)
        log.info("synchronized: %d pods, %d containers",
                 len(req.pods), len(req.containers))
        return api.SynchronizeResponse().SerializeToString()

    def create_container(self, payload: bytes) -> bytes:
        req = api.CreateContainerRequest.FromString(payload)
        resp = api.CreateContainerResponse()
        devices = devices_for_container(dict(req.pod.annotations),
                                        req.container.name)
        for dev in devices:
            d = resp.adjust.linux.devices.add(
                path=dev.path, type=dev.type,
                major=dev.major, minor=dev.minor)
            if dev.uid is not None:
                d.uid.value = dev.uid
            if dev.gid is not None:
                d.gid.value = dev.gid
        if devices:
            log.info("injecting %d devices into %s/%s/%s",
                     len(devices), req.pod.namespace, req.pod.name,
                     req.container.name)
        return resp.SerializeToString()

    def state_change(self, payload: bytes) -> bytes:
        return api.Empty().SerializeToString()

    def shutdown(self, payload: bytes) -> bytes:
        log.info("runtime requested shutdown")
        return api.Empty().SerializeToString()

    def handlers(self) -> dict:
        return {PLUGIN_SERVICE: {
            "Configure": self.configure,
            "Synchronize": self.synchronize,
            "CreateContainer": self.create_container,
            "StateChange": self.state_change,
            "Shutdown": self.shutdown,
        }}


def update_containers(runtime_client: TtrpcClient,
                      updates) -> list:
    """Plugin-initiated Runtime.UpdateContainers (the client path of
    reference vendor/github.com/containerd/nri/pkg/stub/stub.go): push
    container resource updates OUTSIDE an event response — e.g. retune
    cgroup limits of running workers after a repartition. Returns the
    updates the runtime reports as failed."""
    req = api.UpdateContainersRequest(update=updates)
    payload = runtime_client.call(RUNTIME_SERVICE, "UpdateContainers",
                                  req.SerializeToString())
    resp = api.UpdateContainersResponse.FromString(payload)
    return list(resp.failed)


def serve_connection(sock: socket.socket, plugin_name: str,
                     plugin_idx: str
                     ) -> tuple[Mux, TtrpcServer, TtrpcClient]:
    """Wire one NRI connection: returns (mux, server, runtime_client)
    once registered. The client stays usable for plugin-initiated
    Runtime calls (update_containers)."""
    plugin = InjectorPlugin()
    mux = Mux(sock)
    server = TtrpcServer(mux.conn(PLUGIN_SERVICE_CONN), plugin.handlers())
    client = TtrpcClient(mux.conn(RUNTIME_SERVICE_CONN))
    client.call(RUNTIME_SERVICE, "RegisterPlugin",
                api.RegisterPluginRequest(
                    plugin_name=plugin_name,
                    plugin_idx=plugin_idx).SerializeToString())
    log.info("registered NRI plugin %s (idx %s)", plugin_name, plugin_idx)
    return mux, server, client


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nri-socket", default=NRI_SOCKET)
    p.add_argument("--plugin-name", default="tpu-device-injector")
    p.add_argument("--plugin-index", default="10")
    p.add_argument("--retry-interval", type=float, default=30.0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    while True:
        if not os.path.exists(args.nri_socket):
            log.warning("NRI socket %s absent (containerd NRI disabled?); "
                        "retrying in %.0fs", args.nri_socket,
                        args.retry_interval)
            time.sleep(args.retry_interval)
            continue
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(args.nri_socket)
            mux, server, _ = serve_connection(sock, args.plugin_name,
                                              args.plugin_index)
            mux._closed.wait()  # until containerd drops the connection
            server.stop()
            mux.close()  # also closes sock — no fd leak per reconnect
            log.warning("NRI connection closed; reconnecting")
        except Exception:
            log.exception("NRI session failed; retrying")
            sock.close()
        time.sleep(1.0)


if __name__ == "__main__":
    raise SystemExit(main())
