"""Userspace topology-aware scheduler for gated pods: the port's copy of
the JAX package's scheduler/schedule_daemon.py. It counts
GPU_RESOURCE_NAME (`nvidia.com/gpu`) wherever the JAX package counts
TPU_RESOURCE_NAME; the function names (free_tpus_by_node,
_pod_tpu_request) stay, so each has its counterpart by name.

Contract (kept compatible with the reference so existing workloads port
unchanged, reference gke-topology-scheduler/schedule-daemon.py):
  - pods opt in with a schedulingGate named `gke.io/topology-aware-auto-*`
    (:335-353)
  - pods are grouped into jobs by, in order: `job-name`/`batch.kubernetes.io/
    job-name` label, JobSet labels, controller ownerRef UID, helm `name`
    label (:54-116)
  - pods are ordered by completion index then name (:119-150)
  - the whole group is placed only when every pod fits (gang placement)
  - assignment = set nodeAffinity (mutable while gated), then drop the
    gate (:447-497); the default scheduler binds afterwards

Search: instead of the reference's exhaustive backtracking enumeration
(:500-544, combinatorial), nodes are sorted by topology_sort_key and every
contiguous window of eligible nodes is scored with pairwise_distance —
O(N^2) worst case, near-optimal for tree metrics, and it naturally prefers
filling one TPU slice before spilling over DCN. A 1-exchange local
refinement then swaps single members for out-of-window slots while the
score improves, recovering optima that are non-contiguous in the sort
order (the window search's known miss) at O(rounds*k*(N-k)) cost.
"""

from __future__ import annotations

import argparse
import calendar
import logging
import re
import time
from collections import defaultdict

from container_engine_accelerators_tpu_torch import GPU_RESOURCE_NAME
from container_engine_accelerators_tpu_torch.scheduler.topology import (
    NodeTopology,
    pairwise_distance,
    topology_distance,
    topology_sort_key,
)

log = logging.getLogger("topology-scheduler")

GATE_PREFIX = "gke.io/topology-aware-auto-"
INDEX_ANNOTATION = "batch.kubernetes.io/job-completion-index"
# Stamped when we ungate a pod; marks it as placed by this scheduler so
# the node-failure repair path can find (and safely delete) it later.
PLACED_ANNOTATION = "topology.tpu.gke.io/placed-gate"
# A node must be NotReady this long before its gang is torn down —
# kubelet restarts and upgrades flap Ready for well under a minute, and
# each premature teardown costs the Job a pod-failure count.
NODE_LOST_GRACE_SECONDS = 60.0


# ---------- pod grouping ----------

def find_gate(pod: dict) -> str | None:
    for gate in pod.get("spec", {}).get("schedulingGates", []) or []:
        name = gate.get("name", "")
        if name.startswith(GATE_PREFIX):
            return name
    return None


def job_key(pod: dict) -> str:
    meta = pod.get("metadata", {})
    labels = meta.get("labels", {}) or {}
    for label in ("job-name", "batch.kubernetes.io/job-name"):
        if labels.get(label):
            return f"job/{meta.get('namespace', 'default')}/{labels[label]}"
    if labels.get("jobset.sigs.k8s.io/jobset-name"):
        return ("jobset/" + meta.get("namespace", "default") + "/"
                + labels["jobset.sigs.k8s.io/jobset-name"])
    for ref in meta.get("ownerReferences", []) or []:
        if ref.get("controller"):
            return f"owner/{ref.get('uid')}"
    if labels.get("name"):
        return f"name/{meta.get('namespace', 'default')}/{labels['name']}"
    return f"pod/{meta.get('namespace')}/{meta.get('name')}"


def pod_sort_key(pod: dict):
    meta = pod.get("metadata", {})
    idx = (meta.get("annotations", {}) or {}).get(INDEX_ANNOTATION)
    if idx is None:
        labels = meta.get("labels", {}) or {}
        idx = labels.get(INDEX_ANNOTATION)
    if idx is not None and str(idx).isdigit():
        return (0, int(idx), meta.get("name", ""))
    # Trailing ordinal (statefulset/jobset style pod-3).
    m = re.search(r"-(\d+)$", meta.get("name", ""))
    if m:
        return (0, int(m.group(1)), meta.get("name", ""))
    return (1, 0, meta.get("name", ""))


# ---------- resource accounting ----------

_QUANT_SUFFIX = {
    "m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
    "E": 1e18, "Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30,
    "Ti": 2 ** 40, "Pi": 2 ** 50, "Ei": 2 ** 60,
}


def parse_quantity(q) -> float:
    """Kubernetes resource quantity -> float ('500m' cpu, '4Gi' memory,
    '123e6', plain ints) — the stdlib stand-in for kubernetes.utils.
    quantity the reference leans on (reference gke-topology-scheduler/
    schedule-daemon.py:245-332). Unparseable -> 0 (counts as no
    capacity / no request, never as infinite)."""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    try:
        return float(s)  # covers plain and exponent ('1e3') forms
    except ValueError:
        pass
    for suf in ("Ki", "Mi", "Gi", "Ti", "Pi", "Ei",
                "k", "M", "G", "T", "P", "E", "m"):
        if s.endswith(suf):
            try:
                return float(s[:-len(suf)]) * _QUANT_SUFFIX[suf]
            except ValueError:
                return 0.0
    return 0.0


def _pod_requests(pod: dict) -> dict[str, float]:
    """Sum of EVERY requested resource over the pod's containers — not
    just TPUs. A gang placed by chip count alone can land on nodes with
    no cpu/memory headroom and sit Pending forever after ungating (the
    failure gang-repair can't fix, because nothing is NotReady)."""
    total: dict[str, float] = {}
    for c in pod.get("spec", {}).get("containers", []) or []:
        req = (c.get("resources", {}) or {}).get("requests", {}) or {}
        for name, qty in req.items():
            total[name] = total.get(name, 0.0) + parse_quantity(qty)
    return total


def _pod_tpu_request(pod: dict) -> int:
    return int(_pod_requests(pod).get(GPU_RESOURCE_NAME, 0))


def _fits(cap: dict[str, float], demand: dict[str, float]) -> bool:
    return all(cap.get(name, 0.0) >= qty - 1e-9
               for name, qty in demand.items() if qty > 0)


def _sub_requests(cap: dict[str, float],
                  demand: dict[str, float]) -> dict[str, float]:
    out = dict(cap)
    for name, qty in demand.items():
        out[name] = out.get(name, 0.0) - qty
    return out


def free_resources_by_node(nodes: list[dict], running_pods: list[dict]
                           ) -> dict[str, dict[str, float]]:
    """Per GPU node: every allocatable resource minus the requests of
    pods already assigned there (reference :245-332 computes the same
    generic vector). Nodes without GPU capacity are omitted — this
    scheduler only places GPU gangs."""
    free: dict[str, dict[str, float]] = {}
    for node in nodes:
        alloc = (node.get("status", {}).get("allocatable", {}) or {})
        parsed = {name: parse_quantity(qty) for name, qty in alloc.items()}
        if parsed.get(GPU_RESOURCE_NAME, 0) > 0:
            free[node["metadata"]["name"]] = parsed
    for pod in running_pods:
        node = pod.get("spec", {}).get("nodeName")
        if node in free:
            free[node] = _sub_requests(free[node], _pod_requests(pod))
    return free


def free_tpus_by_node(nodes: list[dict], running_pods: list[dict]
                      ) -> dict[str, int]:
    """GPU-count view of free_resources_by_node (kept for callers that
    only track chips)."""
    return {name: int(res.get(GPU_RESOURCE_NAME, 0))
            for name, res in free_resources_by_node(
                nodes, running_pods).items()}


# ---------- assignment search ----------

def assign_pods(pods: list[dict], nodes: list[dict],
                free: dict[str, int],
                anchors: list[NodeTopology] = ()) -> dict[str, str] | None:
    """Map pod name -> node name for the whole group, or None if the gang
    does not fit.

    Uniform per-pod demand (the TPU norm — every worker asks for the same
    chip count) expands each node into free//demand slots, so several
    small workers can share one host; mixed demands go through a
    first-fit-decreasing bin-packing over a sliding node window
    (_assign_nonuniform), which can also co-locate several members on
    one node when their combined vector fits.

    `anchors` are topologies of gang members already Running (survivors
    of a partial node failure): they join the window's distance score so
    the recreated members land near the survivors instead of forming a
    cross-rack gang.

    Demands and capacities are full RESOURCE VECTORS (tpu + cpu +
    memory + anything requested), not chip counts: a node whose chips
    are free but whose cpu is spoken for must not receive a gang member
    (reference :245-332). `free` accepts either the vector form
    (free_resources_by_node) or the legacy {node: tpu_count} ints; the
    legacy form carries no cpu/memory information, so demands are
    projected to the TPU resource there — otherwise any pod that also
    requests cpu would be unplaceable against capacities that record
    cpu as zero."""
    legacy = any(not isinstance(v, dict) for v in free.values())
    free_vec = {name: (v if isinstance(v, dict)
                       else {GPU_RESOURCE_NAME: float(v)})
                for name, v in free.items()}
    demands = [(pod["metadata"]["name"], _pod_requests(pod))
               for pod in sorted(pods, key=pod_sort_key)]
    if legacy:
        demands = [(name,
                    {GPU_RESOURCE_NAME: d.get(GPU_RESOURCE_NAME, 0.0)})
                   for name, d in demands]
    uniform = len({tuple(sorted(d.items())) for _, d in demands}) == 1
    demand0 = demands[0][1] if demands else {}
    tpu_dem = demand0.get(GPU_RESOURCE_NAME, 0)

    node_caps: list[tuple[NodeTopology, dict]] = []
    for node in nodes:
        name = node["metadata"]["name"]
        cap = free_vec.get(name)
        if not cap or cap.get(GPU_RESOURCE_NAME, 0) <= 0:
            continue
        labels = node.get("metadata", {}).get("labels", {}) or {}
        node_caps.append((NodeTopology.from_labels(name, labels), cap))
    node_caps.sort(key=lambda t: topology_sort_key(t[0]))

    if not (uniform and tpu_dem > 0):
        return _assign_nonuniform(demands, node_caps, anchors)

    # Slot capacity is the resource vector the slot can still serve; on
    # the uniform path each slot IS one gang member's demand, and a node
    # contributes as many slots as its scarcest requested resource
    # allows.
    slots: list[tuple[NodeTopology, dict]] = []
    for topo, cap in node_caps:
        n_slots = min(int(cap.get(res, 0) // qty)
                      for res, qty in demand0.items() if qty > 0)
        slots.extend((topo, demand0) for _ in range(n_slots))
    if len(slots) < len(demands):
        return None

    scored: list[tuple[float, int]] = []
    n, k = len(slots), len(demands)
    for start in range(n - k + 1):
        window = slots[start:start + k]
        if any(not _fits(cap, demand) for (_, cap), (_, demand)
               in zip(window, demands)):
            continue
        score = pairwise_distance([t for t, _ in window] + list(anchors))
        scored.append((score, start))
    if not scored:
        return None
    # Refine from several starts, not just the winning window: different
    # basins escape different traps, and the extra starts are cheap next
    # to one exhaustive enumeration. Greedy nearest-neighbor growths
    # handle the case where EVERY window scores the same (torus
    # wraparound makes duplicate-coordinate clusters invisible to a
    # contiguous window) so 1-exchange has no descent direction.
    scored.sort()
    starts = [list(range(start, start + k)) for _, start in scored[:3]]
    starts.extend(_greedy_starts(slots, k, anchors))
    best_sel, best_score = None, None
    for sel0 in starts:
        sel = _refine_selection(slots, demands, anchors, sel0)
        refined = pairwise_distance(
            [slots[i][0] for i in sel] + list(anchors))
        if best_score is None or refined < best_score:
            best_sel, best_score = sel, refined
    return {pod_name: slots[i][0].name
            for (pod_name, _), i in zip(demands, best_sel)}


def _assign_nonuniform(demands: list[tuple[str, dict]],
                       node_caps: list[tuple[NodeTopology, dict]],
                       anchors) -> dict[str, str] | None:
    """Place a MIXED-demand gang by bin-packing members into nodes.

    The uniform path's slot expansion doesn't apply (slots would need a
    demand to size against), so instead: from every start position in
    the topology-sorted node list, pack members first-fit-decreasing
    (largest tpu, then cpu, then memory demand first) into the ROTATED
    node order start..n-1,0..start-1, splitting each node's remaining
    vector as members land on it — so two members CAN share one node
    whenever their combined demand fits. Rotation
    (not truncation) matters: a packing can be feasible only when a
    later member takes a node BEFORE the start position that the FFD
    leader skipped. Each feasible packing is scored by pairwise
    distance over the member topologies (a co-located pair contributes
    0) plus anchors; best start wins — scoring, not node order, is
    what keeps gangs topologically tight. Starts are deduped by
    (topology position, capacity vector) — topology_sort_key minus the
    name tiebreaker, plus the node's remaining resources, since two
    co-located nodes pack identically ONLY when their free vectors
    match too — and capped, so a large fleet costs
    O(min(N, cap) * k * N) _fits scans per pass, not O(k * N^2) —
    and the rare path: TPU gangs are uniform by construction."""
    if not demands:
        return {}
    order = sorted(
        range(len(demands)),
        key=lambda i: (-demands[i][1].get(GPU_RESOURCE_NAME, 0),
                       -demands[i][1].get("cpu", 0),
                       -demands[i][1].get("memory", 0),
                       demands[i][0]))
    n = len(node_caps)
    starts, seen_topo = [], set()
    for start in range(n):
        topo, cap = node_caps[start]
        # Drop the trailing name tiebreaker: it makes every key unique,
        # which would turn this dedup into a no-op.
        key = (topology_sort_key(topo)[:-1],
               tuple(sorted(cap.items())))
        if key not in seen_topo:
            seen_topo.add(key)
            starts.append(start)
    max_starts = 32
    if len(starts) > max_starts:
        stride = len(starts) / max_starts
        starts = [starts[int(j * stride)] for j in range(max_starts)]
    best_map, best_score = None, None
    for start in starts:
        rotated = list(range(start, n)) + list(range(start))
        remaining: dict[int, dict] = {}
        placed: dict[int, int] = {}  # demand index -> node position
        for di in order:
            for pos in rotated:
                cap = remaining.get(pos)
                if cap is None:
                    cap = dict(node_caps[pos][1])
                if _fits(cap, demands[di][1]):
                    remaining[pos] = _sub_requests(cap, demands[di][1])
                    placed[di] = pos
                    break
            else:
                break
        if len(placed) < len(demands):
            continue
        topos = [node_caps[pos][0] for pos in placed.values()]
        score = pairwise_distance(topos + list(anchors))
        if best_score is None or score < best_score:
            best_map = {demands[di][0]: node_caps[pos][0].name
                        for di, pos in placed.items()}
            best_score = score
            if best_score == 0.0:
                break  # everything co-located; no rotation beats it
    return best_map


def _greedy_starts(slots, k, anchors, max_seeds: int = 8
                   ) -> list[list[int]]:
    """Candidate selections grown greedily from distinct seed slots:
    start at a seed, repeatedly add the slot with the lowest total
    distance to the members so far (+ anchors). Only used on the
    uniform-demand path, where every slot satisfies every position.
    Seeds are spread across distinct topologies, capped at max_seeds."""
    distinct, seen = [], set()
    for i, (t, _) in enumerate(slots):
        key = topology_sort_key(t)
        if key not in seen:
            seen.add(key)
            distinct.append(i)
    if len(distinct) > max_seeds:
        stride = len(distinct) / max_seeds
        distinct = [distinct[int(j * stride)] for j in range(max_seeds)]
    starts = []
    for seed in distinct:
        sel, used = [seed], {seed}
        # Running distance-to-selection per candidate, updated by one
        # distance per (candidate, applied addition) — O(k*N) per seed
        # instead of recomputing O(k) sums inside the argmin.
        run_sum = [sum(topology_distance(t, a) for a in anchors)
                   + topology_distance(t, slots[seed][0])
                   for t, _ in slots]
        while len(sel) < k:
            best_i, best_c = None, None
            for i in range(len(slots)):
                if i in used:
                    continue
                if best_c is None or run_sum[i] < best_c:
                    best_i, best_c = i, run_sum[i]
            sel.append(best_i)
            used.add(best_i)
            t_new = slots[best_i][0]
            for i, (t, _) in enumerate(slots):
                run_sum[i] += topology_distance(t, t_new)
        starts.append(sel)
    return starts


def _refine_selection(slots, demands, anchors,
                      chosen: list[int], max_rounds: int = 64) -> list[int]:
    """Steepest-descent 1-exchange refinement of a window selection.

    The sliding window misses optima whose member set is non-contiguous
    in the sort order (e.g. slices s0,s0,s1,s2,s2 with k=4: the optimum
    skips the middle s1 node). Each round finds the single
    selected->unselected slot swap that lowers the gang's total pairwise
    distance the most (capacity-feasible for that position's demand) and
    applies it; terminates when no swap improves. This closes most of
    the measured gap to the reference's exhaustive backtracking
    (reference gke-topology-scheduler/schedule-daemon.py:500-544)
    without its combinatorial cost.

    Candidates are deduped by topology (duplicate slots from the same
    node or coordinate are interchangeable) and each group's distance to
    the current selection is cached and updated incrementally per
    applied swap, so a round costs O(k*G + G) distance evaluations for
    G distinct topologies rather than O(k^2 * N).
    """
    k = len(chosen)
    in_use = set(chosen)
    topos = [slots[i][0] for i in chosen]

    # Group slot indices by topology; within a group prefer the highest
    # TPU capacity (then cpu) so better-provisioned slots are tried
    # first; usable_index still scans the whole group, so multi-resource
    # feasibility stays exact.
    groups: dict[tuple, list[int]] = {}
    for i, (t, _) in enumerate(slots):
        groups.setdefault(topology_sort_key(t), []).append(i)
    for g in groups.values():
        g.sort(key=lambda i: (-slots[i][1].get(GPU_RESOURCE_NAME, 0),
                              -slots[i][1].get("cpu", 0)))
    rep_topo = {key: slots[g[0]][0] for key, g in groups.items()}

    def full_sum(t):
        return (sum(topology_distance(t, x) for x in topos)
                + sum(topology_distance(t, a) for a in anchors))

    # cand_sum[key]: distance from the group's topology to the WHOLE
    # current selection (incl. any selected member of the same group,
    # whose self-distance is 0) plus the anchors.
    cand_sum = {key: full_sum(t) for key, t in rep_topo.items()}
    sel_key = [topology_sort_key(t) for t in topos]

    def usable_index(key, demand):
        for i in groups[key]:
            if i not in in_use and _fits(slots[i][1], demand):
                return i
        return None

    for _ in range(max_rounds):
        best_delta, best_swap = 1e-9, None
        for pos in range(k):
            # Removing pos leaves cand_sum[key] - d(key, topos[pos]).
            old_cost = cand_sum[sel_key[pos]]  # d(t, t) term is 0
            for key, t_c in rep_topo.items():
                delta = (old_cost - cand_sum[key]
                         + topology_distance(t_c, topos[pos]))
                if delta <= best_delta:
                    continue
                cand = usable_index(key, demands[pos][1])
                if cand is None:
                    continue
                best_delta, best_swap = delta, (pos, cand, key)
        if best_swap is None:
            break
        pos, cand, key = best_swap
        t_old, t_new = topos[pos], slots[cand][0]
        in_use.discard(chosen[pos])
        in_use.add(cand)
        chosen[pos] = cand
        topos[pos] = t_new
        sel_key[pos] = key
        for gkey, t_g in rep_topo.items():
            cand_sum[gkey] += (topology_distance(t_g, t_new)
                               - topology_distance(t_g, t_old))
    return chosen


# ---------- cluster mutation ----------

def schedule_pod_on_node(k8s, namespace: str, name: str, node: str,
                         gate: str) -> None:
    """Set nodeAffinity (legal while the pod is gated), then drop the gate
    (reference :447-497 does the same via pod replace)."""
    pod = k8s.get_pod(namespace, name)
    spec = pod.setdefault("spec", {})
    spec.setdefault("affinity", {})["nodeAffinity"] = {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{
                "matchExpressions": [{
                    "key": "kubernetes.io/hostname",
                    "operator": "In",
                    "values": [node]}]}]}}
    spec["schedulingGates"] = [
        g for g in spec.get("schedulingGates", [])
        if g.get("name") != gate]
    pod.setdefault("metadata", {}).setdefault("annotations", {})[
        PLACED_ANNOTATION] = gate
    k8s.replace_pod(namespace, name, pod)
    log.info("scheduled %s/%s -> %s", namespace, name, node)


# ---------- node-failure repair ----------

def assigned_node(pod: dict) -> str | None:
    """The hostname this scheduler pinned via nodeAffinity, if any."""
    terms = (pod.get("spec", {}).get("affinity", {})
             .get("nodeAffinity", {})
             .get("requiredDuringSchedulingIgnoredDuringExecution", {})
             .get("nodeSelectorTerms", []) or [])
    for term in terms:
        for expr in term.get("matchExpressions", []) or []:
            if expr.get("key") == "kubernetes.io/hostname" \
                    and expr.get("operator") == "In":
                values = expr.get("values") or []
                if len(values) == 1:
                    return values[0]
    return None


def _ready_condition(node: dict) -> dict | None:
    conds = (node.get("status", {}) or {}).get("conditions", []) or []
    return next((c for c in conds if c.get("type") == "Ready"), None)


def _not_ready(node: dict) -> bool:
    """Currently NotReady — excluded from placement immediately (placing
    onto a flapping node just queues a future repair)."""
    ready = _ready_condition(node)
    return ready is not None and ready.get("status") != "True"


def _node_lost(node: dict, now: float | None = None) -> bool:
    """NotReady for longer than the grace period -> gang teardown."""
    ready = _ready_condition(node)
    if ready is None or ready.get("status") == "True":
        return False
    ltt = ready.get("lastTransitionTime")
    if not ltt:
        return True  # no timestamp: cannot prove it's a fresh flap
    try:
        t = calendar.timegm(time.strptime(ltt, "%Y-%m-%dT%H:%M:%SZ"))
    except ValueError:
        return True
    now = time.time() if now is None else now
    return now - t >= NODE_LOST_GRACE_SECONDS


def repair_lost_gangs(k8s, pending: list[dict], nodes: list[dict]) -> int:
    """Re-place gangs whose assigned node died after ungating.

    The K8s API forbids both re-adding a schedulingGate and mutating
    nodeAffinity on an ungated pod, so 're-gate' is implemented the only
    legal way: delete the orphaned Pending members — their controller
    (Job/JobSet) recreates them gated — and delete their Pending
    gang-mates too, so the recreated gang is placed together instead of
    half of it holding stale capacity on healthy nodes. Running members
    are untouched. Only pods this scheduler placed (PLACED_ANNOTATION)
    and that have a controller ownerReference are eligible; a bare pod
    would not come back. (The reference relies wholly on
    Job recreation here.)
    """
    node_names = {n["metadata"]["name"] for n in nodes}
    lost = {n["metadata"]["name"] for n in nodes if _node_lost(n)}

    def placed_gate(pod):
        return (pod.get("metadata", {}).get("annotations", {}) or {}).get(
            PLACED_ANNOTATION)

    def controller_owned(pod):
        return any(ref.get("controller")
                   for ref in pod.get("metadata", {}).get(
                       "ownerReferences", []) or [])

    orphaned_groups = set()
    for pod in pending:
        if find_gate(pod) or not placed_gate(pod):
            continue
        node = assigned_node(pod)
        if node and (node not in node_names or node in lost):
            orphaned_groups.add(job_key(pod))

    deleted = 0
    for pod in pending:
        if job_key(pod) not in orphaned_groups:
            continue
        if find_gate(pod) or not placed_gate(pod):
            continue
        if not controller_owned(pod):
            log.warning("orphaned pod %s has no controller; leaving it",
                        pod["metadata"].get("name"))
            continue
        ns = pod["metadata"].get("namespace", "default")
        name = pod["metadata"]["name"]
        try:
            k8s.delete_pod(ns, name)
            deleted += 1
            log.info("deleted %s/%s (gang member of a lost node; "
                     "controller will recreate it gated)", ns, name)
        except Exception:
            log.exception("failed to delete orphaned pod %s/%s", ns, name)
    return deleted


# ---------- main loop ----------

def run_once(k8s) -> int:
    """One scheduling pass; returns the pods scheduled plus orphans
    repaired (so the main loop keeps the fast interval while a gang
    recovery is in flight)."""
    pending = k8s.list_pods(field_selector="status.phase=Pending")["items"]
    nodes = k8s.list_nodes()["items"]
    repaired = repair_lost_gangs(k8s, pending, nodes)
    if repaired:
        # Deleted members will reappear gated; pick the gang up whole on
        # the next pass rather than placing a partial group now.
        pending = k8s.list_pods(
            field_selector="status.phase=Pending")["items"]
    gated = [p for p in pending if find_gate(p)]
    if not gated:
        return repaired
    # NotReady nodes never receive placements — placing there would just
    # queue the same gang for repair (delete/recreate churn, and each
    # cycle costs the Job a pod-failure count).
    ready_nodes = [n for n in nodes if not _not_ready(n)]
    running = k8s.list_pods()["items"]
    # Terminated pods keep spec.nodeName until garbage-collected but hold
    # no devices — counting them would leak capacity forever.
    assigned = [p for p in running
                if p.get("spec", {}).get("nodeName")
                and p.get("status", {}).get("phase")
                not in ("Succeeded", "Failed")]
    free = free_resources_by_node(ready_nodes, assigned)
    node_topo = {n["metadata"]["name"]: NodeTopology.from_labels(
        n["metadata"]["name"],
        n.get("metadata", {}).get("labels", {}) or {}) for n in nodes}

    scheduled = 0
    groups = defaultdict(list)
    for pod in gated:
        groups[job_key(pod)].append(pod)
    ready_names = {n["metadata"]["name"] for n in ready_nodes}
    for key, pods in sorted(groups.items()):
        # Gang members already Running (survivors of a partial failure)
        # anchor the placement so recreated members land near them. Only
        # pods on currently-Ready nodes anchor: a pod still reporting
        # Running on a NotReady/lost node is about to be repaired itself,
        # and its topology would pull the gang toward a dead node.
        anchors = [node_topo[p["spec"]["nodeName"]]
                   for p in assigned
                   if job_key(p) == key
                   and p["spec"]["nodeName"] in ready_names
                   and p["spec"]["nodeName"] in node_topo]
        assignment = assign_pods(pods, ready_nodes, dict(free),
                                 anchors=anchors)
        if assignment is None:
            log.info("group %s (%d pods) does not fit; waiting",
                     key, len(pods))
            continue
        for pod in pods:
            name = pod["metadata"]["name"]
            ns = pod["metadata"].get("namespace", "default")
            node = assignment[name]
            schedule_pod_on_node(k8s, ns, name, node, find_gate(pod))
            free[node] = _sub_requests(free[node], _pod_requests(pod))
            scheduled += 1
        log.info("group %s: scheduled %d pods", key, len(pods))
    return scheduled + repaired


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--idle-cooloff", type=float, default=30.0,
                   help="sleep when no gated pods were seen (reference "
                   "main-loop cool-offs :751-814)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from container_engine_accelerators_tpu_torch.k8s import in_cluster_client
    k8s = in_cluster_client()
    while True:
        try:
            n = run_once(k8s)
        except Exception:
            log.exception("scheduling pass failed")
            n = 0
        time.sleep(args.interval if n else args.idle_cooloff)


if __name__ == "__main__":
    main()
