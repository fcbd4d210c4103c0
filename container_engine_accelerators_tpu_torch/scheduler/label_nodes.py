"""Node labeler DaemonSet body: stamp topology labels from the GCE
metadata server — the reference labels cluster/rack/host from
`physical_host` (reference gke-topology-scheduler/label-nodes-daemon.py:
27-57); the TPU build adds slice identity and ICI coordinates from the
TPU metadata attributes so the scheduler can score ICI locality. The
port's copy of the JAX package's scheduler/label_nodes.py, on the port's
k8s client.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
import urllib.request

from container_engine_accelerators_tpu_torch.scheduler.topology import (
    LABEL_CLUSTER,
    LABEL_HOST,
    LABEL_ICI_COORDS,
    LABEL_RACK,
    LABEL_SLICE,
)

log = logging.getLogger("node-labeler")

METADATA_URL = "http://metadata.google.internal/computeMetadata/v1"


def fetch_metadata(path: str, base_url: str = METADATA_URL) -> str | None:
    req = urllib.request.Request(f"{base_url}/{path}",
                                 headers={"Metadata-Flavor": "Google"})
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.read().decode().strip()
    except OSError:
        return None


def topology_labels(base_url: str = METADATA_URL) -> dict[str, str]:
    labels: dict[str, str] = {}
    physical_host = fetch_metadata(
        "instance/attributes/physical_host", base_url)
    if physical_host:
        # "/cluster/rack/host" (reference label-nodes-daemon.py:31-39).
        parts = physical_host.strip("/").split("/")
        if len(parts) == 3:
            labels[LABEL_CLUSTER] = parts[0]
            labels[LABEL_RACK] = parts[1]
            labels[LABEL_HOST] = parts[2]
    slice_id = fetch_metadata(
        "instance/attributes/tpu-env-slice-id", base_url) or \
        fetch_metadata("instance/attributes/agent-worker-network", base_url)
    if slice_id:
        labels[LABEL_SLICE] = slice_id
    coords = fetch_metadata(
        "instance/attributes/tpu-env-host-coords", base_url)
    if coords:
        labels[LABEL_ICI_COORDS] = coords.replace(",", "-")
    return labels


def update_node_labels(k8s, node_name: str,
                       base_url: str = METADATA_URL) -> dict[str, str]:
    labels = topology_labels(base_url)
    if labels:
        k8s.patch_node(node_name, {"metadata": {"labels": labels}},
                       content_type="application/merge-patch+json")
        log.info("labeled %s: %s", node_name, labels)
    else:
        log.warning("no topology metadata available for %s", node_name)
    return labels


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--interval", type=float, default=600.0)
    p.add_argument("--metadata-url", default=METADATA_URL)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from container_engine_accelerators_tpu_torch.k8s import in_cluster_client
    k8s = in_cluster_client()
    node_name = os.environ["NODE_NAME"]
    while True:
        try:
            update_node_labels(k8s, node_name, args.metadata_url)
        except Exception:
            log.exception("labeling failed")
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
