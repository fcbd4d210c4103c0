"""Stdlib Kubernetes API client: JSON REST with bearer-token auth (the
port's copy of the JAX package's k8s/client.py).

Scope: exactly the API surface this repo's daemons need —
  - node get / strategic-merge patch / status patch   (health, versions)
  - pod list / get / replace / patch / binding        (topology scheduler)
  - event create                                      (health checker)
Tests point `base_url` at an in-process HTTP server (the fake.Clientset
analog of reference health_checker_test.go:26-31).
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.parse
import urllib.request

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

MERGE_PATCH = "application/merge-patch+json"
STRATEGIC_MERGE_PATCH = "application/strategic-merge-patch+json"
JSON_PATCH = "application/json-patch+json"


class ApiError(Exception):
    def __init__(self, status: int, body: str, url: str):
        super().__init__(f"{status} from {url}: {body[:300]}")
        self.status = status
        self.body = body


class K8sClient:
    def __init__(self, base_url: str, token: str | None = None,
                 token_file: str | None = None,
                 ca_file: str | None = None, insecure: bool = False,
                 timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        # Re-read per request (client-go behavior): GKE bound SA tokens
        # expire hourly and the kubelet rotates the file in place.
        self.token_file = token_file
        self.timeout = timeout
        if base_url.startswith("https"):
            ctx = ssl.create_default_context(cafile=ca_file)
            if insecure:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ctx = ctx
        else:
            self._ctx = None

    # ---------- raw REST ----------

    def request(self, method: str, path: str, body=None,
                content_type: str = "application/json",
                params: dict | None = None):
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = None
        headers = {"Accept": "application/json"}
        token = self.token
        if self.token_file:
            try:
                with open(self.token_file) as f:
                    token = f.read().strip()
            except OSError:
                pass  # keep the cached token; better a 401 than a crash
        if token:
            headers["Authorization"] = f"Bearer {token}"
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = content_type
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout,
                                        context=self._ctx) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            raise ApiError(e.code, e.read().decode(errors="replace"),
                           url) from None
        except urllib.error.URLError as e:
            raise ApiError(0, str(e.reason), url) from None
        return json.loads(payload) if payload else None

    def get(self, path: str, params=None):
        return self.request("GET", path, params=params)

    def post(self, path: str, body):
        return self.request("POST", path, body)

    def put(self, path: str, body):
        return self.request("PUT", path, body)

    def patch(self, path: str, body, content_type=STRATEGIC_MERGE_PATCH):
        return self.request("PATCH", path, body, content_type=content_type)

    # ---------- typed helpers ----------

    def get_node(self, name: str):
        return self.get(f"/api/v1/nodes/{name}")

    def patch_node(self, name: str, patch: dict,
                   content_type=STRATEGIC_MERGE_PATCH):
        return self.patch(f"/api/v1/nodes/{name}", patch, content_type)

    def patch_node_status(self, name: str, patch: dict,
                          content_type=STRATEGIC_MERGE_PATCH):
        return self.patch(f"/api/v1/nodes/{name}/status", patch, content_type)

    def set_node_condition(self, node: str, condition: dict):
        """Strategic-merge a single entry of status.conditions (merge key:
        type), as client-go's SetNodeCondition does for the reference
        (health_checker.go:288-346)."""
        return self.patch_node_status(
            node, {"status": {"conditions": [condition]}})

    def annotate_node(self, name: str, annotations: dict):
        return self.patch_node(
            name, {"metadata": {"annotations": annotations}},
            content_type=MERGE_PATCH)

    def list_nodes(self, label_selector: str | None = None):
        params = {}
        if label_selector:
            params["labelSelector"] = label_selector
        return self.get("/api/v1/nodes", params=params or None)

    def list_pods(self, namespace: str | None = None,
                  field_selector: str | None = None,
                  label_selector: str | None = None):
        path = (f"/api/v1/namespaces/{namespace}/pods" if namespace
                else "/api/v1/pods")
        params = {}
        if field_selector:
            params["fieldSelector"] = field_selector
        if label_selector:
            params["labelSelector"] = label_selector
        return self.get(path, params=params or None)

    def get_pod(self, namespace: str, name: str):
        return self.get(f"/api/v1/namespaces/{namespace}/pods/{name}")

    def replace_pod(self, namespace: str, name: str, pod: dict):
        return self.put(f"/api/v1/namespaces/{namespace}/pods/{name}", pod)

    def patch_pod(self, namespace: str, name: str, patch: dict,
                  content_type=STRATEGIC_MERGE_PATCH):
        return self.patch(f"/api/v1/namespaces/{namespace}/pods/{name}",
                          patch, content_type)

    def delete_pod(self, namespace: str, name: str):
        return self.request("DELETE",
                            f"/api/v1/namespaces/{namespace}/pods/{name}")

    def bind_pod(self, namespace: str, name: str, node: str):
        return self.post(
            f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
            {"apiVersion": "v1", "kind": "Binding",
             "metadata": {"name": name},
             "target": {"apiVersion": "v1", "kind": "Node", "name": node}})

    def create_event(self, namespace: str, event: dict):
        return self.post(f"/api/v1/namespaces/{namespace}/events", event)


def in_cluster_client(timeout: float = 10.0) -> K8sClient:
    """Build a client from the pod serviceaccount mount (the in-cluster
    path of reference util.go:55-70)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host:
        raise RuntimeError("not running in a cluster "
                           "(KUBERNETES_SERVICE_HOST unset)")
    token_file = os.path.join(SA_DIR, "token")
    with open(token_file) as f:
        token = f.read().strip()
    return K8sClient(f"https://{host}:{port}", token=token,
                     token_file=token_file,
                     ca_file=os.path.join(SA_DIR, "ca.crt"), timeout=timeout)
