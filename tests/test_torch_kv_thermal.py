"""Port of the KV thermal bookkeeping (models/decode.py PageAllocator and
PrefixIndex): each case drives the JAX package's classes and the port's
through the same calls on a clock of its own (explicit `now` where the
API takes one), and the census dicts, re-reference counts and the rest
of what the case reads must be equal. Tolerance: exact. The cases mirror
tests/test_kv_thermal.py; the last one is a seeded random sequence of
alloc, share, free, touch, set_owner, prefix insert/match and evictions.
"""

import numpy as np
import pytest

from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu_torch.models import decode as tdecode


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def timed_alloc(mod, n_pages, t=0.0):
    a = mod.PageAllocator(n_pages)
    a.clock = FakeClock(t)
    return a


def page_keys(mod, tokens, page=4):
    return mod.PrefixIndex.chain_keys(tokens, page, len(tokens) // page)


def census_buckets_and_idle(mod):
    a = timed_alloc(mod, 8)
    rows = a.alloc(3)
    a.clock.t = 5.0
    a.touch(rows[:1])
    return [a.thermal_census(hot_s=2.0, warm_s=10.0, now=6.0),
            a.thermal_census(hot_s=2.0, warm_s=10.0, now=20.0)]


def coldest_ranking_and_linkage(mod):
    a = timed_alloc(mod, 8)
    rows = a.alloc(3)
    a.set_owner(rows[:2], "alice", "chat")
    a.clock.t = 9.5
    a.touch(rows[2:])
    return a.thermal_census(hot_s=1.0, warm_s=2.0, now=10.0,
                            prefix_rows=rows[:1], top_n=2)


def reuse_distance_and_wss(mod):
    a = timed_alloc(mod, 10)
    a.REUSE_SAMPLE_EVERY = 1
    r = a.alloc(4)
    a.touch([r[0]])
    a.touch([r[1]])
    a.touch([r[0]])
    return a.thermal_census()


def wss_fallback_before_any_reuse(mod):
    a = timed_alloc(mod, 8)
    a.alloc(3)
    return a.thermal_census(hot_s=2.0, warm_s=10.0, now=1.0)


def census_empty_after_drain(mod):
    a = timed_alloc(mod, 8)
    rows = a.alloc(4)
    a.set_owner(rows, "t0")
    a.share(rows[0])
    a.free(rows)
    out = [a.thermal_census(now=100.0)]
    a.free(rows[:1])
    out.append(a.thermal_census(now=100.0))
    out.append([bool(a._alloc_ts), bool(a._last_touch), bool(a._owner),
                bool(a._stack)])
    return out


def refcount_vs_temperature(mod):
    a = timed_alloc(mod, 8)
    rows = a.alloc(3)
    return [a.thermal_census(hot_s=1.0, warm_s=2.0, now=1000.0,
                             active_rows=rows),
            a.thermal_census(hot_s=1.0, warm_s=2.0, now=1000.0)]


def owner_first_wins(mod):
    a = timed_alloc(mod, 8)
    rows = a.alloc(3)
    a.set_owner(rows[:2], "alice", "chat")
    a.set_owner(rows, "bob", "batch")
    a.set_owner(rows, None)
    out = [a.thermal_census(hot_s=10.0, warm_s=20.0, now=1.0)]
    a.free(rows[2:])
    a.alloc(1)
    out.append(a.thermal_census(hot_s=10.0, warm_s=20.0, now=1.0))
    return out


def _two_entry_index(mod, horizon):
    a = timed_alloc(mod, 8)
    idx = mod.PrefixIndex(a, cap=1, reref_horizon_s=horizon)
    k1 = page_keys(mod, [1, 2, 3, 4])[0]
    k2 = page_keys(mod, [5, 6, 7, 8])[0]
    (r1,) = a.alloc(1)
    idx.insert(k1, r1)
    a.free([r1])
    return a, idx, k1, k2


def reref_within_horizon(mod):
    a, idx, k1, k2 = _two_entry_index(mod, 10.0)
    a.clock.t = 2.0
    (r2,) = a.alloc(1)
    idx.insert(k2, r2)
    a.free([r2])
    held = (idx.pages_held(), sorted(idx.rows_held()))
    a.clock.t = 7.0
    first = idx.match([k1])
    counted = (idx.rereferences, list(idx.reref_ages))
    second = idx.match([k1])
    return [held, first, counted, second, idx.rereferences]


def reref_outside_horizon(mod):
    a, idx, k1, k2 = _two_entry_index(mod, 3.0)
    (r2,) = a.alloc(1)
    idx.insert(k2, r2)
    a.free([r2])
    a.clock.t = 50.0
    return [idx.match([k1]), idx.rereferences]


def reinsert_clears_eviction(mod):
    a, idx, k1, k2 = _two_entry_index(mod, 10.0)
    (r2,) = a.alloc(1)
    idx.insert(k2, r2)
    a.free([r2])
    (r3,) = a.alloc(1)
    idx.insert(k1, r3)
    a.free([r3])
    return [k1[0] in idx._evicted, idx.match([k1]), idx.rereferences]


def seeded_sequence(mod, seed=0, steps=400):
    """A random walk of the engine's page calls, with explicit `now`
    where the API takes one and the allocator's clock elsewhere."""
    rs = np.random.RandomState(seed)
    a = timed_alloc(mod, 24)
    a.REUSE_SAMPLE_EVERY = 3
    idx = mod.PrefixIndex(a, cap=6, reref_horizon_s=5.0)
    held: list[int] = []
    out = []
    tenants = ["alice", "bob", "carol", None]
    for step in range(steps):
        a.clock.t = round(step * 0.25, 2)
        op = rs.randint(8)
        if op == 0:
            rows = a.alloc(int(rs.randint(1, 4)))
            if rows:
                held.extend(rows)
        elif op == 1 and held:
            held.append(a.share(held[rs.randint(len(held))]))
        elif op == 2 and held:
            held.remove(r := held[rs.randint(len(held))])
            a.free([r])
        elif op == 3 and held:
            a.touch([held[rs.randint(len(held))] for _ in range(2)],
                    now=a.clock.t + float(rs.rand()))
        elif op == 4 and held:
            a.set_owner(held[-2:], tenants[rs.randint(4)],
                        ["chat", "batch"][rs.randint(2)])
        elif op == 5 and held:
            toks = [int(t) for t in rs.randint(1, 3, size=4)]
            idx.insert(page_keys(mod, toks)[0], held[rs.randint(len(held))])
        elif op == 6:
            toks = [int(t) for t in rs.randint(1, 3, size=4)]
            rows = idx.match(page_keys(mod, toks))
            held.extend(rows)
        elif op == 7:
            idx.evict_lru()
        if step % 50 == 49:
            out.append(a.thermal_census(
                hot_s=1.0, warm_s=4.0, now=a.clock.t + 0.5,
                active_rows=held[:3], prefix_rows=idx.rows_held(),
                top_n=5))
            out.append([idx.rereferences, list(idx.reref_ages),
                        idx.pages_held(), a.pages_in_use])
    return out


CASES = [census_buckets_and_idle, coldest_ranking_and_linkage,
         reuse_distance_and_wss, wss_fallback_before_any_reuse,
         census_empty_after_drain, refcount_vs_temperature,
         owner_first_wins, reref_within_horizon, reref_outside_horizon,
         reinsert_clears_eviction, seeded_sequence]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_thermal_bookkeeping_matches_jax(case):
    want = case(jdecode)
    got = case(tdecode)
    assert got == want


def test_seeded_sequence_exercises_every_census_field():
    # The random walk reaches every bucket, tenant attribution, reuse
    # samples and rereferences, so the equality above covers them.
    out = seeded_sequence(tdecode)
    censuses = out[0::2]
    assert any(c["buckets"]["cold"] for c in censuses)
    assert any(c["buckets"]["warm"] for c in censuses)
    assert any(set(c["tenants"]) - {"unowned"} for c in censuses)
    assert any(c["reuse_distance"]["samples"] for c in censuses)
    assert out[-1][0] > 0
