"""The port's topology scheduler (scheduler/) against the JAX package's:
every scenario of tests/test_scheduler.py runs through both packages on
the same fake cluster (tests/fake_k8s.py), the JAX package counting
`google.com/tpu` and the port `nvidia.com/gpu`, and must give the same
distances, parsed topologies, assignments, bindings, patches, repairs
and NotReady handling; the randomized search instances must give the
same assignments pod for pod."""

import importlib
import itertools
import random
import time

import pytest

from tests.fake_k8s import FakeK8s

PACKAGES = {"jax": "container_engine_accelerators_tpu",
            "torch": "container_engine_accelerators_tpu_torch"}
RESOURCE = {"jax": "google.com/tpu", "torch": "nvidia.com/gpu"}


class Pkg:
    """One package's scheduler modules and its resource key."""

    def __init__(self, name: str):
        root = PACKAGES[name]
        self.name, self.res = name, RESOURCE[name]
        self.sd = importlib.import_module(f"{root}.scheduler.schedule_daemon")
        self.topo = importlib.import_module(f"{root}.scheduler.topology")
        self.labels = importlib.import_module(f"{root}.scheduler.label_nodes")
        self.K8sClient = importlib.import_module(f"{root}.k8s").K8sClient

    # ---- objects in this package's resource ----

    def pod(self, name, ns="default", labels=None,
            gates=("gke.io/topology-aware-auto-j",), tpus=4, node=None,
            phase="Pending", annotations=None, owner=None, cpu=None,
            memory=None):
        req = {self.res: str(tpus)}
        if cpu is not None:
            req["cpu"] = cpu
        if memory is not None:
            req["memory"] = memory
        p = {"metadata": {"name": name, "namespace": ns,
                          "labels": labels or {},
                          "annotations": annotations or {}},
             "spec": {"schedulingGates": [{"name": g} for g in gates],
                      "containers": [{"name": "main", "resources": {
                          "requests": req}}]},
             "status": {"phase": phase}}
        if owner:
            p["metadata"]["ownerReferences"] = [
                {"uid": owner, "controller": True}]
        if node:
            p["spec"]["nodeName"] = node
        return p

    def node(self, name, tpus=4, labels=None, cpu=None, memory=None):
        alloc = {self.res: str(tpus)}
        if cpu is not None:
            alloc.update(cpu=cpu, memory=memory or "32Gi")
        return {"metadata": {"name": name, "labels": labels or {}},
                "status": {"allocatable": alloc}}

    def slice_labels(self, slice_id, coords, rack="r1"):
        t = self.topo
        return {t.LABEL_CLUSTER: "c1", t.LABEL_RACK: rack, t.LABEL_HOST: "h",
                t.LABEL_SLICE: slice_id, t.LABEL_ICI_COORDS: coords,
                t.LABEL_TPU_TOPOLOGY: "4x4"}

    def T(self, name, cluster="c1", rack="r1", slice_id="", coords=None,
          topo=None):
        return self.topo.NodeTopology(name=name, cluster=cluster, rack=rack,
                                      host=f"h-{name}", slice_id=slice_id,
                                      coords=coords, topology=topo)


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return Pkg(request.param)


@pytest.fixture
def cluster(pk):
    """(fake API server, this package's client of it)."""
    srv = FakeK8s()
    yield srv, pk.K8sClient(srv.url)
    srv.stop()


def both():
    return Pkg("jax"), Pkg("torch")


def affinity(pk, fake, name):
    return pk.sd.assigned_node(fake.pods[("default", name)])


# ---------- topology model ----------

def test_distance_tiers(pk):
    T, d = pk.T, pk.topo.topology_distance
    a = T("a", slice_id="s1", coords=(0, 0, 0), topo=(4, 4, 4))
    assert d(a, a) == 0.0
    assert d(a, T("b", cluster="c2")) == 36.0
    assert d(a, T("b", rack="r2")) == 12.0
    assert d(a, T("b", slice_id="s2")) == 4.0
    near = d(a, T("b", slice_id="s1", coords=(1, 0, 0), topo=(4, 4, 4)))
    far = d(a, T("b", slice_id="s1", coords=(2, 2, 2), topo=(4, 4, 4)))
    assert 0 < near < far < 1
    assert d(a, T("b", slice_id="s1")) == 0.5
    jax_pk, torch_pk = both()
    pairs = [(a, T("b", slice_id="s1", coords=c, topo=(4, 4, 4)))
             for c in itertools.product(range(4), repeat=3)]
    assert [jax_pk.topo.topology_distance(x, y) for x, y in pairs] == [
        torch_pk.topo.topology_distance(x, y) for x, y in pairs]


def test_distance_torus_wraparound(pk):
    T, d = pk.T, pk.topo.topology_distance
    a = T("a", slice_id="s", coords=(0,), topo=(8,))
    # 0 -> 7 is one hop around the ring (as 0 -> 1), 0 -> 4 the diameter.
    assert d(a, T("b", slice_id="s", coords=(7,), topo=(8,))) == \
        d(a, T("b", slice_id="s", coords=(1,), topo=(8,))) < \
        d(a, T("c", slice_id="s", coords=(4,), topo=(8,)))


def test_from_labels_parsing(pk):
    t = pk.topo
    labels = {t.LABEL_CLUSTER: "c", t.LABEL_RACK: "r", t.LABEL_HOST: "h",
              t.LABEL_SLICE: "s0", t.LABEL_ICI_COORDS: "1-2-3",
              t.LABEL_TPU_TOPOLOGY: "4x4x8"}
    n = t.NodeTopology.from_labels("n1", labels)
    assert n.coords == (1, 2, 3) and n.topology == (4, 4, 8)
    assert t.NodeTopology.from_labels("n1", {t.LABEL_ICI_COORDS: "x-y"}
                                      ).coords is None
    jax_pk, _ = both()
    assert vars(n) == vars(jax_pk.topo.NodeTopology.from_labels("n1",
                                                                labels))
    assert (t.LABEL_SLICE, t.LABEL_ICI_COORDS, t.LABEL_TPU_TOPOLOGY) == (
        "tpu.google.com/slice", "tpu.google.com/ici-coords",
        "cloud.google.com/gke-tpu-topology")


# ---------- grouping / ordering ----------

def test_job_key_extractors(pk):
    sd, pod = pk.sd, pk.pod
    assert sd.job_key(pod("a", labels={"job-name": "j1"})) == \
        "job/default/j1"
    assert sd.job_key(pod("b", labels={
        "jobset.sigs.k8s.io/jobset-name": "js"})) == "jobset/default/js"
    assert sd.job_key(pod("c", owner="uid-1")) == "owner/uid-1"
    assert sd.job_key(pod("d", labels={"name": "helm"})) == \
        "name/default/helm"
    assert sd.job_key(pod("e")).startswith("pod/")


def test_pod_sort_key_orders_by_completion_index(pk):
    pods = [pk.pod("w-2"), pk.pod("w-0"),
            pk.pod("x", annotations={pk.sd.INDEX_ANNOTATION: "1"})]
    ordered = sorted(pods, key=pk.sd.pod_sort_key)
    assert [p["metadata"]["name"] for p in ordered] == ["w-0", "x", "w-2"]


def test_find_gate(pk):
    assert pk.sd.find_gate(pk.pod("a")) == "gke.io/topology-aware-auto-j"
    assert pk.sd.find_gate(pk.pod("b", gates=("other-gate",))) is None


# ---------- assignment ----------

def test_assign_prefers_single_slice(pk):
    sl = pk.slice_labels
    nodes = [pk.node("s1-0", labels=sl("s1", "0-0")),
             pk.node("far", labels={pk.topo.LABEL_CLUSTER: "c1",
                                    pk.topo.LABEL_RACK: "r9"}),
             pk.node("s2-0", labels=sl("s2", "0-0")),
             pk.node("s1-1", labels=sl("s1", "1-0"))]
    pods = [pk.pod("j-0", labels={"job-name": "j"}),
            pk.pod("j-1", labels={"job-name": "j"})]
    got = pk.sd.assign_pods(pods, nodes, pk.sd.free_tpus_by_node(nodes, []))
    assert {got["j-0"], got["j-1"]} == {"s1-0", "s1-1"}


def test_assign_gang_does_not_fit(pk):
    nodes = [pk.node("n0"), pk.node("n1", tpus=0)]
    pods = [pk.pod("j-0"), pk.pod("j-1")]
    assert pk.sd.assign_pods(pods, nodes,
                             pk.sd.free_tpus_by_node(nodes, [])) is None


def test_free_tpus_subtracts_running(pk):
    nodes = [pk.node("n0", tpus=4)]
    running = [pk.pod("r0", node="n0", gates=(), phase="Running", tpus=3)]
    assert pk.sd.free_tpus_by_node(nodes, running) == {"n0": 1}
    assert pk.sd._pod_tpu_request(running[0]) == 3
    # The other package's resource is not this package's: a node that
    # offers only it is no node of this scheduler's.
    other = RESOURCE["jax" if pk.name == "torch" else "torch"]
    foreign = {"metadata": {"name": "x"},
               "status": {"allocatable": {other: "4"}}}
    assert pk.sd.free_tpus_by_node([foreign], []) == {}


def test_assign_multiple_pods_share_a_node(pk):
    sl = pk.slice_labels
    nodes = [pk.node("n0", labels=sl("s1", "0-0")),
             pk.node("n1", labels=sl("s2", "0-0", rack="r2"))]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, tpus=2),
            pk.pod("j-1", labels={"job-name": "j"}, tpus=2)]
    got = pk.sd.assign_pods(pods, nodes, pk.sd.free_tpus_by_node(nodes, []))
    assert got in ({"j-0": "n0", "j-1": "n0"}, {"j-0": "n1", "j-1": "n1"})


def test_assign_mixed_demands_can_share_a_node(pk):
    sl = pk.slice_labels
    nodes = [pk.node("n0", labels=sl("s1", "0-0")),
             pk.node("n1", labels=sl("s2", "0-0", rack="r2"))]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, tpus=1),
            pk.pod("j-1", labels={"job-name": "j"}, tpus=3)]
    got = pk.sd.assign_pods(pods, nodes, pk.sd.free_tpus_by_node(nodes, []))
    assert got is not None and got["j-0"] == got["j-1"]


def test_assign_mixed_demands_spread_when_one_node_too_small(pk):
    sl = pk.slice_labels
    nodes = [pk.node("n0", labels=sl("s1", "0-0")),
             pk.node("n1", labels=sl("s1", "1-0")),
             pk.node("n2", labels=sl("s2", "0-0", rack="r2"))]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, tpus=3),
            pk.pod("j-1", labels={"job-name": "j"}, tpus=3),
            pk.pod("j-2", labels={"job-name": "j"}, tpus=1)]
    got = pk.sd.assign_pods(pods, nodes, pk.sd.free_tpus_by_node(nodes, []))
    assert set(got.values()) <= {"n0", "n1"} and got["j-0"] != got["j-1"]


def test_assign_mixed_demands_respects_full_vectors(pk):
    nodes = [pk.node("n0", cpu="2"), pk.node("n1", cpu="8")]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, tpus=1, cpu="6"),
            pk.pod("j-1", labels={"job-name": "j"}, tpus=3, cpu="1")]
    got = pk.sd.assign_pods(pods, nodes,
                            pk.sd.free_resources_by_node(nodes, []))
    assert got is not None and got["j-0"] == "n1"


def test_assign_mixed_demands_rotation_finds_crossed_packing(pk):
    nodes = [pk.node("n0", cpu="8"), pk.node("n1", cpu="2")]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, tpus=3, cpu="1"),
            pk.pod("j-1", labels={"job-name": "j"}, tpus=2, cpu="6")]
    assert pk.sd.assign_pods(pods, nodes,
                             pk.sd.free_resources_by_node(nodes, [])) == {
        "j-0": "n1", "j-1": "n0"}


def test_legacy_int_free_ignores_cpu_requests(pk):
    nodes = [pk.node("n0"), pk.node("n1")]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, cpu="2"),
            pk.pod("j-1", labels={"job-name": "j"}, cpu="2")]
    free = pk.sd.free_tpus_by_node(nodes, [])
    assert all(isinstance(v, int) for v in free.values())
    got = pk.sd.assign_pods(pods, nodes, free)
    assert got is not None and got["j-0"] != got["j-1"]


def test_parse_quantity_forms(pk):
    pq = pk.sd.parse_quantity
    assert [pq(q) for q in ("500m", "4", "4Gi", "2M", "1e3", 3, "garbage")] \
        == [0.5, 4.0, 4 * 2 ** 30, 2e6, 1000.0, 3.0, 0.0]


def test_free_resources_subtracts_all_requests(pk):
    nodes = [pk.node("n0", cpu="8", memory="32Gi")]
    running = [pk.pod("r0", node="n0", gates=(), phase="Running", tpus=2,
                      cpu="6500m", memory="8Gi")]
    free = pk.sd.free_resources_by_node(nodes, running)
    assert free["n0"][pk.res] == 2
    assert free["n0"]["cpu"] == pytest.approx(1.5)
    assert free["n0"]["memory"] == pytest.approx(24 * 2 ** 30)


def test_assign_excludes_nodes_without_cpu_headroom(pk):
    sl = pk.slice_labels
    nodes = [pk.node("starved-0", labels=sl("s1", "0-0"), cpu="8"),
             pk.node("starved-1", labels=sl("s1", "1-0"), cpu="8"),
             pk.node("ok-0", labels=sl("s2", "0-0", rack="r2"), cpu="8"),
             pk.node("ok-1", labels=sl("s2", "1-0", rack="r2"), cpu="8")]
    running = [pk.pod(f"d{i}", node=f"starved-{i}", gates=(),
                      phase="Running", tpus=0, cpu="7") for i in (0, 1)]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, cpu="2"),
            pk.pod("j-1", labels={"job-name": "j"}, cpu="2")]
    got = pk.sd.assign_pods(pods, nodes,
                            pk.sd.free_resources_by_node(nodes, running))
    assert {got["j-0"], got["j-1"]} == {"ok-0", "ok-1"}


def test_assign_gang_unplaceable_when_cpu_short_everywhere(pk):
    nodes = [pk.node("n0", cpu="1"), pk.node("n1", cpu="1")]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, cpu="2"),
            pk.pod("j-1", labels={"job-name": "j"}, cpu="2")]
    assert pk.sd.assign_pods(pods, nodes, pk.sd.free_resources_by_node(
        nodes, [])) is None


def test_uniform_slots_limited_by_scarcest_resource(pk):
    nodes = [pk.node("n0", cpu="3"), pk.node("n1", cpu="3")]
    pods = [pk.pod("j-0", labels={"job-name": "j"}, tpus=1, cpu="2"),
            pk.pod("j-1", labels={"job-name": "j"}, tpus=1, cpu="2")]
    got = pk.sd.assign_pods(pods, nodes,
                            pk.sd.free_resources_by_node(nodes, []))
    assert got is not None and got["j-0"] != got["j-1"]


# ---------- the window search against brute force, both packages ----------

def _search_instances(pk, seed, trials, make_labels):
    """Randomized instances (the JAX test's generator) as this package's
    (nodes, pods)."""
    rng = random.Random(seed)
    out = []
    for _ in range(trials):
        n = rng.randint(4, 8)
        k = rng.randint(2, min(4, n))
        nodes = [pk.node(f"n{i}", labels=make_labels(pk, rng))
                 for i in range(n)]
        pods = [pk.pod(f"j-{i}", labels={"job-name": "j"}) for i in range(k)]
        out.append((nodes, pods))
    return out


def _quality(pk, instances):
    matches, worst, assignments = 0, 1.0, []
    for nodes, pods in instances:
        got = pk.sd.assign_pods(pods, nodes, {n["metadata"]["name"]: 4
                                              for n in nodes})
        assignments.append(got)
        topo = {n["metadata"]["name"]: pk.topo.NodeTopology.from_labels(
            n["metadata"]["name"], n["metadata"]["labels"]) for n in nodes}
        score = pk.topo.pairwise_distance([topo[v] for v in got.values()])
        best = min(pk.topo.pairwise_distance(list(c)) for c in
                   itertools.combinations(topo.values(), len(pods)))
        matches += score <= best + 1e-9
        if best > 0:
            worst = max(worst, score / best)
    return matches / len(instances), worst, assignments


@pytest.mark.parametrize("seed,make_labels", [
    (7, lambda pk, rng: pk.slice_labels(
        f"s{rng.randint(0, 2)}", "", rack=f"r{rng.randint(0, 2)}")),
    (11, lambda pk, rng: pk.slice_labels(
        "s1", f"{rng.randint(0, 3)}-{rng.randint(0, 3)}"))],
    ids=["tree_metrics", "coord_metrics"])
def test_window_search_quality_equal_in_both_packages(seed, make_labels):
    results = {pk.name: _quality(pk, _search_instances(pk, seed, 60,
                                                       make_labels))
               for pk in both()}
    for match_rate, worst, _ in results.values():
        assert match_rate >= 0.95 and worst <= 1.05, (match_rate, worst)
    assert results["jax"] == results["torch"]


# ---------- full passes against the fake API ----------

def _pods_normalised(fake):
    """The API's pods with the resource key normalised: what both
    packages' passes must leave behind alike."""
    out = {}
    for key, p in fake.pods.items():
        text = repr(p)
        for res in RESOURCE.values():
            text = text.replace(res, "<res>")
        out[key] = text
    return out


def test_run_once_schedules_group(pk, cluster):
    fake, client = cluster
    sl = pk.slice_labels
    for n in [pk.node("s1-0", labels=sl("s1", "0-0")),
              pk.node("s1-1", labels=sl("s1", "1-0")),
              pk.node("other", labels=sl("s9", "0-0", rack="r2"))]:
        fake.nodes[n["metadata"]["name"]] = n
    for name in ("j-0", "j-1"):
        fake.pods[("default", name)] = pk.pod(name, labels={"job-name": "j"})
    assert pk.sd.run_once(client) == 2
    for name in ("j-0", "j-1"):
        p = fake.pods[("default", name)]
        assert p["spec"]["schedulingGates"] == []
        assert p["metadata"]["annotations"][pk.sd.PLACED_ANNOTATION] == \
            "gke.io/topology-aware-auto-j"
    assert {affinity(pk, fake, n) for n in ("j-0", "j-1")} == {"s1-0",
                                                              "s1-1"}
    assert [m for m, _ in fake.requests].count("PUT") == 2


def test_run_once_leaves_unfit_group_gated(pk, cluster):
    fake, client = cluster
    fake.nodes["n0"] = pk.node("n0")
    for name in ("j-0", "j-1"):
        fake.pods[("default", name)] = pk.pod(name, labels={"job-name": "j"})
    assert pk.sd.run_once(client) == 0
    assert fake.pods[("default", "j-0")]["spec"]["schedulingGates"]


def test_run_once_ignores_ungated(pk, cluster):
    fake, client = cluster
    fake.pods[("default", "free")] = pk.pod("free", gates=())
    assert pk.sd.run_once(client) == 0


def test_run_once_ignores_terminated_pods(pk, cluster):
    fake, client = cluster
    fake.nodes["n0"] = pk.node("n0", labels=pk.slice_labels("s1", "0-0"))
    fake.pods[("default", "old-job")] = pk.pod("old-job", gates=(),
                                               node="n0", phase="Succeeded")
    fake.pods[("default", "j-0")] = pk.pod("j-0", labels={"job-name": "j"})
    assert pk.sd.run_once(client) == 1
    assert fake.pods[("default", "j-0")]["spec"]["schedulingGates"] == []


def test_run_once_respects_cpu_headroom(pk, cluster):
    fake, client = cluster
    sl = pk.slice_labels
    for n in [pk.node("s1-0", labels=sl("s1", "0-0"), cpu="8"),
              pk.node("s2-0", labels=sl("s2", "0-0", rack="r2"), cpu="8")]:
        fake.nodes[n["metadata"]["name"]] = n
    fake.pods[("default", "hog")] = pk.pod("hog", node="s1-0", gates=(),
                                           phase="Running", tpus=0,
                                           cpu="7500m")
    fake.pods[("default", "j-0")] = pk.pod("j-0", labels={"job-name": "j"},
                                           cpu="2")
    assert pk.sd.run_once(client) == 1
    assert affinity(pk, fake, "j-0") == "s2-0"


def test_node_deletion_triggers_gang_reassignment(pk, cluster):
    fake, client = cluster
    sl = pk.slice_labels
    for n in [pk.node("s1-0", labels=sl("s1", "0-0")),
              pk.node("s1-1", labels=sl("s1", "1-0")),
              pk.node("s2-0", labels=sl("s2", "0-0", rack="r2")),
              pk.node("s2-1", labels=sl("s2", "1-0", rack="r2"))]:
        fake.nodes[n["metadata"]["name"]] = n
    for name in ("j-0", "j-1"):
        fake.pods[("default", name)] = pk.pod(name, labels={"job-name": "j"},
                                              owner="u1")
    assert pk.sd.run_once(client) == 2
    assert {affinity(pk, fake, n) for n in ("j-0", "j-1")} == {"s1-0",
                                                              "s1-1"}
    del fake.nodes["s1-0"], fake.nodes["s1-1"]
    assert pk.sd.run_once(client) == 2
    assert ("default", "j-0") not in fake.pods
    assert ("default", "j-1") not in fake.pods
    for name in ("j-0-r", "j-1-r"):
        fake.pods[("default", name)] = pk.pod(name, labels={"job-name": "j"},
                                              owner="u1")
    assert pk.sd.run_once(client) == 2
    assert {affinity(pk, fake, n) for n in ("j-0-r", "j-1-r")} == {
        "s2-0", "s2-1"}


def test_not_ready_node_triggers_repair(pk, cluster):
    fake, client = cluster
    sl = pk.slice_labels
    for n in [pk.node("s1-0", labels=sl("s1", "0-0")),
              pk.node("s2-0", labels=sl("s2", "0-0", rack="r2"))]:
        fake.nodes[n["metadata"]["name"]] = n
    fake.pods[("default", "j-0")] = pk.pod("j-0", labels={"job-name": "j"},
                                           owner="u1")
    assert pk.sd.run_once(client) == 1
    assert affinity(pk, fake, "j-0") == "s1-0"
    fake.nodes["s1-0"]["status"]["conditions"] = [
        {"type": "Ready", "status": "False"}]
    pk.sd.run_once(client)
    assert ("default", "j-0") not in fake.pods


def test_fresh_notready_flap_is_not_torn_down(pk, cluster):
    fake, client = cluster
    fake.nodes["s1-0"] = pk.node("s1-0", labels=pk.slice_labels("s1", "0-0"))
    fake.pods[("default", "j-0")] = pk.pod("j-0", labels={"job-name": "j"},
                                           owner="u1")
    assert pk.sd.run_once(client) == 1
    now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    fake.nodes["s1-0"]["status"]["conditions"] = [
        {"type": "Ready", "status": "False", "lastTransitionTime": now}]
    assert pk.sd.run_once(client) == 0
    assert ("default", "j-0") in fake.pods
    assert pk.sd.NODE_LOST_GRACE_SECONDS == 60.0
    old = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(
        time.time() - 2 * pk.sd.NODE_LOST_GRACE_SECONDS))
    fake.nodes["s1-0"]["status"]["conditions"][0]["lastTransitionTime"] = old
    assert pk.sd.run_once(client) == 1
    assert ("default", "j-0") not in fake.pods


def test_notready_node_excluded_from_placement(pk, cluster):
    fake, client = cluster
    fake.nodes["s1-0"] = pk.node("s1-0", labels=pk.slice_labels("s1", "0-0"))
    fake.nodes["s1-0"]["status"]["conditions"] = [
        {"type": "Ready", "status": "False"}]
    fake.pods[("default", "j-0")] = pk.pod("j-0", labels={"job-name": "j"},
                                           owner="u1")
    assert pk.sd.run_once(client) == 0
    assert fake.pods[("default", "j-0")]["spec"]["schedulingGates"]


def test_recreated_member_anchors_to_running_survivor(pk, cluster):
    fake, client = cluster
    sl = pk.slice_labels
    for n in [pk.node("r1-0", labels=sl("s1", "0-0", rack="r1")),
              pk.node("r2-0", labels=sl("s2", "0-0", rack="r2")),
              pk.node("r2-1", labels=sl("s2", "1-0", rack="r2"))]:
        fake.nodes[n["metadata"]["name"]] = n
    fake.pods[("default", "j-0")] = pk.pod(
        "j-0", labels={"job-name": "j"}, owner="u1", node="r2-0",
        phase="Running", gates=(), annotations={pk.sd.PLACED_ANNOTATION: "g"})
    fake.pods[("default", "j-1")] = pk.pod("j-1", labels={"job-name": "j"},
                                           owner="u1")
    assert pk.sd.run_once(client) == 1
    assert affinity(pk, fake, "j-1") == "r2-1"


def test_repair_spares_running_and_unowned(pk, cluster):
    fake, client = cluster
    fake.nodes["s2-0"] = pk.node("s2-0", labels=pk.slice_labels("s2", "0-0"))
    gone = {"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": [{
                "key": "kubernetes.io/hostname", "operator": "In",
                "values": ["gone-node"]}]}]}}}
    running = pk.pod("j-0", labels={"job-name": "j"}, owner="u1",
                     node="s2-0", phase="Running", gates=(),
                     annotations={pk.sd.PLACED_ANNOTATION: "g"})
    orphan = pk.pod("j-1", labels={"job-name": "j"}, owner="u1", gates=(),
                    annotations={pk.sd.PLACED_ANNOTATION: "g"})
    orphan["spec"]["affinity"] = gone
    foreign = pk.pod("alien", labels={"job-name": "z"}, gates=())
    foreign["spec"]["affinity"] = gone
    for p in (running, orphan, foreign):
        fake.pods[("default", p["metadata"]["name"])] = p
    pk.sd.run_once(client)
    assert ("default", "j-0") in fake.pods
    assert ("default", "j-1") not in fake.pods
    assert ("default", "alien") in fake.pods


def test_run_once_passes_leave_the_same_cluster_in_both_packages():
    """One sequence of passes (place, lose a slice, recreate, place
    again, a NotReady node) through each package on its own fake API:
    the pods left behind, and the requests made, are equal."""
    states = {}
    for pk in both():
        fake = FakeK8s()
        try:
            client = pk.K8sClient(fake.url)
            sl = pk.slice_labels
            for n in [pk.node("s1-0", labels=sl("s1", "0-0")),
                      pk.node("s1-1", labels=sl("s1", "1-0")),
                      pk.node("s2-0", labels=sl("s2", "0-0", rack="r2")),
                      pk.node("s2-1", labels=sl("s2", "1-0", rack="r2")),
                      pk.node("s3-0", labels=sl("s3", "0-0", rack="r3"))]:
                fake.nodes[n["metadata"]["name"]] = n
            for name in ("j-0", "j-1"):
                fake.pods[("default", name)] = pk.pod(
                    name, labels={"job-name": "j"}, owner="u1")
            fake.pods[("default", "k-0")] = pk.pod(
                "k-0", labels={"job-name": "k"}, owner="u2", tpus=2)
            counts = [pk.sd.run_once(client)]
            del fake.nodes["s1-0"]
            counts.append(pk.sd.run_once(client))
            for name in ("j-0-r", "j-1-r"):
                fake.pods[("default", name)] = pk.pod(
                    name, labels={"job-name": "j"}, owner="u1")
            counts.append(pk.sd.run_once(client))
            fake.nodes["s3-0"]["status"]["conditions"] = [
                {"type": "Ready", "status": "False"}]
            counts.append(pk.sd.run_once(client))
            states[pk.name] = (counts, _pods_normalised(fake), fake.requests)
        finally:
            fake.stop()
    assert states["jax"] == states["torch"]
    assert states["torch"][0][0] == 3


# ---------- node labeler ----------

class FakeMetadata:
    """A local GCE metadata stub: attribute name -> value, 403 without
    the Metadata-Flavor header."""

    def __init__(self, attrs):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                val = attrs.get(self.path.rsplit("/", 1)[-1])
                if self.headers.get("Metadata-Flavor") != "Google" or \
                        val is None:
                    self.send_response(403 if val is not None else 404)
                    self.end_headers()
                    return
                data = val.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        h, p = self.server.server_address
        return f"http://{h}:{p}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def test_topology_labels_and_update(pk, cluster):
    fake, client = cluster
    t = pk.topo
    md = FakeMetadata({"physical_host": "/cl1/rk2/hs3",
                       "tpu-env-slice-id": "slice-a",
                       "tpu-env-host-coords": "0,1,2"})
    try:
        labels = pk.labels.topology_labels(md.url)
        assert labels == {t.LABEL_CLUSTER: "cl1", t.LABEL_RACK: "rk2",
                          t.LABEL_HOST: "hs3", t.LABEL_SLICE: "slice-a",
                          t.LABEL_ICI_COORDS: "0-1-2"}
        assert pk.labels.update_node_labels(client, "node-a",
                                            md.url) == labels
        assert fake.nodes["node-a"]["metadata"]["labels"] == labels
        assert fake.requests == [("PATCH", "/api/v1/nodes/node-a")]
    finally:
        md.stop()


def test_topology_labels_no_metadata(pk, cluster):
    fake, client = cluster
    md = FakeMetadata({})
    try:
        assert pk.labels.topology_labels(md.url) == {}
        assert pk.labels.update_node_labels(client, "node-a", md.url) == {}
        assert fake.requests == []
    finally:
        md.stop()
