"""Port of the paged KV cache on the CPU: the paged attention's plain
version against the JAX package's pallas kernel (interpret mode), the
paged and slot step functions against their JAX originals on weights
carried across with interop.params_from_jax, and the host-side page
allocator and prefix index against the JAX package's copies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.ops.decode_attention import (
    paged_decode_attention as j_paged_decode_attention,
)
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.ops.decode_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)

# f32 inputs and math on both sides, sums in another order.
ATTN_TOL = 2e-5
LOGITS_TOL = 1e-4
SMALL = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
             vocab_size=128)


# ---------------------------------------------------------------- K3 plain

def _paged_inputs(seed, lens, t, page, max_pages, hq=8, hkv=2, d=128):
    """Pools whose live pages sit at shuffled rows; every other row and
    every position past a slot's live length holds large finite garbage,
    and table entries past the live pages are out-of-range garbage."""
    rs = np.random.RandomState(seed)
    s = len(lens)
    live_pages = [-(-(n + t) // page) for n in lens]
    n_pages = sum(live_pages) + 3
    perm = rs.permutation(np.arange(1, n_pages))
    tables = rs.randint(-5, n_pages + 5, size=(s, max_pages)).astype(
        np.int32)
    used = 0
    for i, n in enumerate(live_pages):
        tables[i, :n] = perm[used:used + n]
        used += n
    k_pool = (rs.randn(n_pages, page, hkv, d) * 50).astype(np.float32)
    v_pool = (rs.randn(n_pages, page, hkv, d) * 50).astype(np.float32)
    for i, n in enumerate(lens):
        for p in range(n + t):
            row = tables[i, p // page]
            k_pool[row, p % page] = rs.randn(hkv, d)
            v_pool[row, p % page] = rs.randn(hkv, d)
    q = rs.randn(s, t, hq, d).astype(np.float32)
    return q, k_pool, v_pool, np.asarray(lens, np.int32), tables


@pytest.mark.parametrize("t", [1, 5])
def test_paged_plain_matches_pallas(t):
    page, max_pages = 128, 3
    q, kp, vp, lens, tables = _paged_inputs(t, [0, 127, 128, 255], t, page,
                                            max_pages)
    want = np.asarray(j_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(tables), interpret=True))
    args = [torch.from_numpy(x) for x in (q, kp, vp, lens, tables)]
    got = paged_decode_attention_plain(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    # The dispatching entry point takes the plain version on the CPU.
    assert torch.equal(paged_decode_attention(*args), got)


def test_paged_plain_rejects_mismatched_shapes():
    q = torch.zeros(2, 1, 4, 32)
    pool = torch.zeros(5, 16, 2, 32)
    with pytest.raises(ValueError):
        paged_decode_attention_plain(q, pool, pool, 0,
                                     torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        paged_decode_attention_plain(q, pool, pool[..., :16], 0,
                                     torch.zeros(2, 4, dtype=torch.int32))


# ---------------------------------------------------------------- steps

@pytest.fixture(scope="module")
def small():
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg


def _assert_close(got, want, tol=LOGITS_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _table_row(rows, max_pages):
    return rows + [0] * (max_pages - len(rows))


def test_decode_step_paged_matches_jax_across_page_boundaries(small):
    params, jcfg, model, tcfg = small
    slots, page, max_pages, n_pages = 3, 16, 6, 16
    jcache = jdecode.init_paged_cache(jcfg, slots, n_pages, page, max_pages)
    cache = decode.init_paged_cache(tcfg, slots, n_pages, page, max_pages,
                                    "cpu")
    alloc = decode.PageAllocator(n_pages)
    jset = jdecode._jitted_set_slot_pages()
    jpre = jdecode._jitted_prefill_suffix_paged(jcfg)
    jstep = jdecode._jitted_decode_step_paged(jcfg)
    jasg = jdecode._jitted_assign_pages()

    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12]]
    allocated = []
    for s, pr in enumerate(prompts):
        rows = alloc.alloc(1)
        allocated.append(1)
        row = _table_row(rows, max_pages)
        jcache = jset(jcache, jnp.int32(s), jnp.asarray(row, jnp.int32),
                      jnp.int32(0))
        decode.set_slot_pages(cache, s, torch.tensor(row, dtype=torch.int32),
                              0)
        padded = pr + [0] * (page - len(pr))
        jl, jcache = jpre(params, jcache, jnp.int32(s),
                          jnp.asarray(padded, jnp.int32), jnp.int32(len(pr)))
        tl, cache = decode.prefill_suffix_paged(
            model, cache, s, torch.tensor(padded), len(pr), tcfg)
        _assert_close(tl, jl)

    last = np.array([5, 9, 12], np.int32)
    active = np.array([True] * slots)
    lens = [len(p) for p in prompts]
    crossings = 0
    for _ in range(40):   # crosses page boundaries at lengths 16 and 32
        mask = np.zeros(slots, bool)
        pos = np.zeros(slots, np.int32)
        rws = np.zeros(slots, np.int32)
        for s in range(slots):
            pg = lens[s] // page
            if pg >= allocated[s]:
                (row,) = alloc.alloc(1)
                allocated[s] += 1
                mask[s], pos[s], rws[s] = True, pg, row
                crossings += 1
        if mask.any():
            jcache = jasg(jcache, jnp.asarray(pos), jnp.asarray(rws),
                          jnp.asarray(mask))
            decode.assign_pages(cache, torch.from_numpy(pos),
                                torch.from_numpy(rws),
                                torch.from_numpy(mask))
        jl, jcache = jstep(params, jcache, jnp.asarray(last),
                           jnp.asarray(active))
        tl, cache = decode.decode_step_paged(
            model, cache, torch.from_numpy(last), torch.from_numpy(active),
            tcfg)
        _assert_close(tl, jl)
        np.testing.assert_array_equal(cache.tables.numpy(),
                                      np.asarray(jcache.tables))
        np.testing.assert_array_equal(cache.length.numpy(),
                                      np.asarray(jcache.length))
        last = np.array(jnp.argmax(jl, axis=-1), np.int32)
        lens = [n + 1 for n in lens]
    assert crossings >= slots * 2
    _assert_close(cache.k_pool, jcache.k_pool)


def test_inactive_slot_writes_hit_only_the_trash_row(small):
    _, _, model, cfg = small
    slots, page, max_pages, n_pages = 2, 16, 4, 6
    cache = decode.init_paged_cache(cfg, slots, n_pages, page, max_pages,
                                    "cpu")
    # Both slots point at pool row 2; slot 1 is inactive, so its write
    # must not land there, and slot 0 (also inactive) writes nowhere but
    # the trash row either.
    row = torch.tensor(_table_row([2], max_pages), dtype=torch.int32)
    padded = torch.tensor([1, 2, 3] + [0] * (page - 3))
    for s in range(slots):
        decode.set_slot_pages(cache, s, row, 0)
        _, cache = decode.prefill_suffix_paged(model, cache, s, padded, 3,
                                               cfg)
    before = cache.k_pool.clone()
    _, cache = decode.decode_step_paged(
        model, cache, torch.tensor([9, 9]), torch.tensor([False, False]),
        cfg)
    changed = (cache.k_pool != before).flatten(2).any(-1)   # [L, n_pages]
    assert changed[:, 1:].sum() == 0
    assert changed[:, 0].all()
    assert cache.length.tolist() == [3, 3]


def test_prefill_suffix_slot_matches_jax(small):
    params, jcfg, model, tcfg = small
    slots, max_len = 3, 96
    jcache = jdecode.init_slot_cache(jcfg, slots, max_len)
    cache = decode.init_slot_cache(tcfg, slots, max_len, "cpu")
    jchunk = jdecode._jitted_prefill_suffix_slot(jcfg)
    prompt = np.random.RandomState(3).randint(0, 128, size=40).tolist()
    # Two chunks into slot 1: 32 tokens, then 8 padded to 32.
    for start, chunk in ((0, prompt[:32]), (32, prompt[32:])):
        padded = chunk + [0] * (32 - len(chunk))
        new_len = start + len(chunk)
        jl, jcache = jchunk(params, jcache, jnp.int32(1),
                            jnp.asarray(padded, jnp.int32), jnp.int32(start),
                            jnp.int32(new_len))
        tl, cache = decode.prefill_suffix_slot(model, cache, 1,
                                               torch.tensor(padded), start,
                                               new_len, tcfg)
        _assert_close(tl, jl)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    _assert_close(cache.k[:, :, :40], np.asarray(jcache.k)[:, :, :40])


def test_prefill_suffix_paged_after_a_shared_prefix_matches_jax(small):
    params, jcfg, model, tcfg = small
    slots, page, max_pages, n_pages = 2, 16, 4, 8
    jcache = jdecode.init_paged_cache(jcfg, slots, n_pages, page, max_pages)
    cache = decode.init_paged_cache(tcfg, slots, n_pages, page, max_pages,
                                    "cpu")
    jset = jdecode._jitted_set_slot_pages()
    jpre = jdecode._jitted_prefill_suffix_paged(jcfg)
    prompt = np.random.RandomState(4).randint(0, 128, size=37).tolist()
    # Slot 0 prefills the whole prompt (pages 3, 5, 1); slot 1 shares its
    # first two pages and prefills only the suffix into page 6.
    for slot, rows, p_len in ((0, [3, 5, 1], 0), (1, [3, 5, 6], 32)):
        row = _table_row(rows, max_pages)
        jcache = jset(jcache, jnp.int32(slot), jnp.asarray(row, jnp.int32),
                      jnp.int32(p_len))
        decode.set_slot_pages(cache, slot,
                              torch.tensor(row, dtype=torch.int32), p_len)
        suffix = prompt[p_len:]
        padded = suffix + [0] * (-(-len(suffix) // page) * page - len(suffix))
        jl, jcache = jpre(params, jcache, jnp.int32(slot),
                          jnp.asarray(padded, jnp.int32), jnp.int32(37))
        tl, cache = decode.prefill_suffix_paged(
            model, cache, slot, torch.tensor(padded), 37, tcfg)
        _assert_close(tl, jl)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    np.testing.assert_array_equal(cache.tables.numpy(),
                                  np.asarray(jcache.tables))
    _assert_close(cache.k_pool, jcache.k_pool)


def test_table_and_token_updates_equal_jax():
    rs = np.random.RandomState(5)
    tables = rs.randint(0, 20, size=(4, 6)).astype(np.int32)
    lengths = rs.randint(0, 90, size=4).astype(np.int32)
    jcache = jdecode.PagedKVCache(k_pool=jnp.zeros((1, 2, 16, 1, 8)),
                                  v_pool=jnp.zeros((1, 2, 16, 1, 8)),
                                  tables=jnp.asarray(tables),
                                  length=jnp.asarray(lengths))
    cache = decode.PagedKVCache(k_pool=torch.zeros(1, 2, 16, 1, 8),
                                v_pool=torch.zeros(1, 2, 16, 1, 8),
                                tables=torch.from_numpy(tables.copy()),
                                length=torch.from_numpy(lengths.copy()))
    row = np.array([7, 3, 11, 0, 0, 0], np.int32)
    jcache = jdecode.set_slot_pages(jcache, jnp.int32(2), jnp.asarray(row),
                                    jnp.int32(41))
    assert decode.set_slot_pages(cache, 2, torch.from_numpy(row),
                                 41) is cache
    pos = np.array([0, 5, 2, 3], np.int32)
    rws = np.array([9, 8, 7, 6], np.int32)
    mask = np.array([True, False, True, True])
    jcache = jdecode.assign_pages(jcache, jnp.asarray(pos), jnp.asarray(rws),
                                  jnp.asarray(mask))
    decode.assign_pages(cache, torch.from_numpy(pos), torch.from_numpy(rws),
                        torch.from_numpy(mask))
    np.testing.assert_array_equal(cache.tables.numpy(),
                                  np.asarray(jcache.tables))
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))

    last = rs.randint(0, 500, size=6).astype(np.int32)
    over = rs.randint(0, 500, size=6).astype(np.int32)
    mk = np.array([False, True, True, False, False, True])
    want = jdecode.merge_tokens(jnp.asarray(last), jnp.asarray(over),
                                jnp.asarray(mk))
    got = decode.merge_tokens(torch.from_numpy(last).long(),
                              torch.from_numpy(over), torch.from_numpy(mk))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- host

def _call(obj, name, *args):
    """(result, exception type name) of obj.name(*args)."""
    try:
        return getattr(obj, name)(*args), None
    except ValueError as e:
        return None, (type(e).__name__, str(e))


def test_allocator_and_prefix_index_match_jax_op_for_op():
    ja = jdecode.PageAllocator(8)
    ta = decode.PageAllocator(8)
    ji = jdecode.PrefixIndex(ja, cap=3)
    ti = decode.PrefixIndex(ta, cap=3)
    prompt = list(range(64))
    keys = decode.PrefixIndex.chain_keys(prompt, 16, 4)
    assert keys == jdecode.PrefixIndex.chain_keys(prompt, 16, 4)
    other = decode.PrefixIndex.chain_keys(list(range(100, 116)) + prompt[16:],
                                          16, 2)
    # A forged key: the same chain hash as keys[0], other tokens.
    forged = [(keys[0][0], tuple(range(200, 216)))]

    def state():
        return (ta.free_pages, ta.pages_in_use, len(ti), ti.pages_held(),
                [ta.refcount(r) for r in range(8)])

    def jstate():
        return (ja.free_pages, ja.pages_in_use, len(ji), ji.pages_held(),
                [ja.refcount(r) for r in range(8)])

    ops = [
        ("a", "alloc", 3), ("a", "alloc", 9), ("a", "share", 2),
        ("a", "share", 7), ("a", "free", [2]), ("a", "free", [0]),
        ("i", "insert", keys[0], 1), ("i", "insert", keys[1], 2),
        ("i", "insert", keys[1], 2), ("i", "match", keys),
        ("i", "match", other), ("i", "match", forged),
        ("a", "free", [1, 2]), ("a", "alloc", 2),
        ("i", "insert", keys[2], 4), ("i", "insert", keys[3], 5),
        ("i", "match", keys), ("a", "free", [3]), ("a", "free", [3]),
        ("a", "free", [4, 9]), ("i", "evict_lru"), ("a", "alloc", 4),
        ("a", "alloc", 1), ("i", "clear"), ("i", "evict_lru"),
        ("a", "free", [1]), ("a", "alloc", 1),
    ]
    for op in ops:
        target, name, args = op[0], op[1], op[2:]
        got = _call(ta if target == "a" else ti, name, *args)
        want = _call(ja if target == "a" else ji, name, *args)
        assert got == want, op
        assert state() == jstate(), op
    with pytest.raises(ValueError):
        decode.PageAllocator(1)
