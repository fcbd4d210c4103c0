"""Minimal Kubernetes REST client over stdlib HTTP, the port's copy of the
JAX package's k8s/ (the same calls, the same errors) — the role client-go
plays for the reference (reference pkg/gpu/nvidia/util/util.go:55-70
builds the in-cluster client). No external deps: in-cluster config is
read from the serviceaccount mount, requests go over urllib with the
pod's CA bundle."""

from container_engine_accelerators_tpu_torch.k8s.client import (
    ApiError,
    K8sClient,
    in_cluster_client,
)

__all__ = ["ApiError", "K8sClient", "in_cluster_client"]
