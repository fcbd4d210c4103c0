"""Port of models/decode_tp on the CPU: the port's tensor-parallel decode
path, two gloo rank processes (this one rank 0, and one follower that
decode_tp.TPRuntime spawns once for the file), held against the JAX
package's decode_tp on a 2-device mesh of the 8 virtual CPU devices.

f32 llama_tiny on weights carried across by interop.params_from_jax;
logits are held within LOGITS_RTOL of max |logit| (the two sum their
partials in other orders), tokens exactly. Mirrors tests/test_decode_tp.py
(generate, the slot and paged paths, validate_tp, the cache's KV heads
split), tests/test_decode_moe.py's tensor-parallel MoE cases (experts
replicated and sharded), int8 weights, int8 and int4 KV caches,
verify_step, and the shard plan against decode_param_specs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import decode_tp as jtp
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.ops import quant as jquant
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import decode_tp
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.ops import quant
from container_engine_accelerators_tpu_torch.parallel import distributed

TP = 2
LOGITS_RTOL = 1e-5   # of max |logit|
MOE_KW = dict(n_experts=4, moe_top_k=2, moe_dropless=True)


@pytest.fixture(scope="module")
def rt():
    """The file's one tensor-parallel group: this process rank 0, one
    follower, gloo on the CPU, two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    # A runtime forms its own group: a default group that an earlier
    # file's fabric monitor left in this worker process goes first.
    if dist.is_initialized():
        dist.destroy_process_group()
    runtime = decode_tp.TPRuntime(TP, device="cpu", threads=2)
    yield runtime
    runtime.close()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh(cpu_devices):
    return jtp.make_inference_mesh(tp=TP, devices=cpu_devices[:TP])


def _pair(seed=0, quantized=False, **kw):
    """(JAX params, JAX cfg, port model, port cfg) on the same weights."""
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **kw)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **kw)
    params = jllama.init_params(jax.random.key(seed), jcfg)
    if quantized:
        params = jquant.quantize_llama_params(params)
    return params, jcfg, interop.params_from_jax(jax.device_get(params),
                                                 tcfg), tcfg


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    bound = LOGITS_RTOL * np.abs(want).max()
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


@pytest.fixture(scope="module")
def dense(rt):
    params, jcfg, model, tcfg = _pair()
    return params, jcfg, model, tcfg, rt.shard_model(model)


PROMPT = [[5, 17, 203], [9, 1, 42]]


def test_generate_parity(dense, rt, mesh):
    params, jcfg, model, tcfg, shard = dense
    prompt = jnp.asarray(PROMPT, jnp.int32)
    want = np.asarray(jdecode.generate(
        jtp.shard_decode_params(params, mesh), prompt, jcfg,
        max_new_tokens=8, mesh=mesh))
    np.testing.assert_array_equal(
        want, np.asarray(jdecode.generate(params, prompt, jcfg,
                                          max_new_tokens=8)))
    got = rt.generate(shard, torch.tensor(PROMPT), tcfg, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # The tokens went through rank 0's sampler and the broadcast:
    # sampling from one seed gives tp 1's draws.
    gen = [torch.Generator().manual_seed(3) for _ in range(2)]
    hot = rt.generate(shard, torch.tensor(PROMPT), tcfg, 8, temperature=1.0,
                      generator=gen[0])
    assert hot.tolist() == decode.generate(
        model, torch.tensor(PROMPT), tcfg, 8, temperature=1.0,
        generator=gen[1]).tolist()


def test_slot_path_parity(dense, rt, mesh):
    params, jcfg, _, tcfg, shard = dense
    slots, max_len = 4, 64
    prompt = [3, 7, 11, 13, 17, 19, 23, 29]
    jparams = jtp.shard_decode_params(params, mesh)
    jcache = jtp.init_sharded_cache(
        lambda: jdecode.init_slot_cache(jcfg, slots, max_len), mesh)
    jlast, jcache = jtp.jitted_prefill_slot(jcfg, mesh)(
        jparams, jcache, jnp.int32(1), jnp.asarray(prompt, jnp.int32),
        jnp.int32(6))
    cache = rt.init_slot_cache(tcfg, slots, max_len)
    last, cache = rt.prefill_slot(shard, cache, 1, torch.tensor(prompt), 6,
                                  tcfg)
    _close(last, jlast, "prefill_slot")
    assert cache.length.tolist() == np.asarray(jcache.length).tolist()
    assert cache.k.shape[3] == tcfg.n_kv_heads // TP

    toks, act = [0, 31, 0, 0], [False, True, False, False]
    jlog, _ = jtp.jitted_decode_step_slots(jcfg, mesh)(
        jparams, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(act))
    log, cache = rt.decode_step_slots(shard, cache, torch.tensor(toks),
                                      torch.tensor(act), tcfg)
    _close(log[1], jlog[1], "decode_step_slots")
    assert int(log[1].argmax()) == int(jnp.argmax(jlog[1]))
    assert cache.length.tolist() == [0, 7, 0, 0]


def test_paged_path_parity(dense, rt, mesh):
    params, jcfg, _, tcfg, shard = dense
    slots, n_pages, page, max_pages = 2, 9, 8, 4
    prompt = list(range(2, 18))   # 16 tokens = 2 pages
    rows = [3, 4]
    jparams = jtp.shard_decode_params(params, mesh)
    jcache = jtp.shard_cache(jdecode.init_paged_cache(
        jcfg, slots, n_pages, page, max_pages), mesh)
    jlast, jcache = jtp.jitted_prefill_slot_paged(jcfg, mesh)(
        jparams, jcache, jnp.int32(0), jnp.asarray(rows, jnp.int32),
        jnp.asarray(prompt, jnp.int32), jnp.int32(15))
    cache = rt.init_paged_cache(tcfg, slots, n_pages, page, max_pages)
    last, cache = rt.prefill_slot_paged(shard, cache, 0, torch.tensor(rows),
                                        torch.tensor(prompt), 15, tcfg)
    _close(last, jlast, "prefill_slot_paged")

    toks, act = [101, 0], [True, False]
    jlog, jcache = jtp.jitted_decode_step_paged(jcfg, mesh)(
        jparams, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(act))
    log, cache = rt.decode_step_paged(shard, cache, torch.tensor(toks),
                                      torch.tensor(act), tcfg)
    _close(log[0], jlog[0], "decode_step_paged")

    # The page mutations are operations of the group too: a suffix on
    # freshly assigned pages continues the slot alike on both sides.
    cache = rt.assign_pages(cache, torch.tensor([2, 0]),
                            torch.tensor([5, 0]), torch.tensor([True, False]))
    jcache = jdecode.assign_pages(jcache, jnp.asarray([2, 0], jnp.int32),
                                  jnp.asarray([5, 0], jnp.int32),
                                  jnp.asarray([True, False]))
    suffix = list(range(40, 48))
    jl, _ = jtp.jitted_prefill_suffix_paged(jcfg, mesh)(
        jparams, jcache, jnp.int32(0), jnp.asarray(suffix, jnp.int32),
        jnp.int32(24))
    last, cache = rt.prefill_suffix_paged(shard, cache, 0,
                                          torch.tensor(suffix), 24, tcfg)
    _close(last, jl, "prefill_suffix_paged")


@pytest.mark.parametrize("kw", [
    dict(), dict(n_kv_heads=3, n_heads=6, d_model=192),
    dict(vocab_size=511), dict(d_ff=255), dict(n_experts=3,
                                               moe_decode_ep=True)],
    ids=["divides", "kv_heads", "vocab", "d_ff", "experts"])
def test_validate_tp_rejects_indivisible(kw):
    jcfg = jllama.llama_tiny(**kw)
    tcfg = tllama.llama_tiny(**kw)
    for tp in (2, 3):
        try:
            jtp.validate_tp(jcfg, tp)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            decode_tp.validate_tp(tcfg, tp)
        else:
            with pytest.raises(ValueError) as got:
                decode_tp.validate_tp(tcfg, tp)
            assert str(got.value) == want


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_cache_shards_kv_heads(mesh, paged, kv):
    jcfg = jllama.llama_tiny(kv_cache_dtype=kv)
    tcfg = tllama.llama_tiny(kv_cache_dtype=kv)
    if paged:
        jcache = jtp.init_sharded_cache(
            lambda: jdecode.init_paged_cache(jcfg, 2, 9, 8, 4), mesh)
        cache = decode_tp.init_sharded_cache(decode.init_paged_cache, tcfg,
                                             TP, 2, 9, 8, 4, "cpu")
    else:
        jcache = jtp.init_sharded_cache(
            lambda: jdecode.init_slot_cache(jcfg, 2, 32), mesh)
        cache = decode_tp.init_sharded_cache(decode.init_slot_cache, tcfg,
                                             TP, 2, 32, "cpu")
    layout = decode_tp.cache_layout(paged, kv != "bf16")
    for name, axis in layout.items():
        jarr, arr = getattr(jcache, name), getattr(cache, name)
        if jarr is None:
            assert arr is None and axis is None
            continue
        # The port's cache has no [L] axis on the lengths and tables
        # either; every other field is laid out as the JAX package's.
        local = jarr.addressable_shards[0].data.shape
        assert tuple(arr.shape) == tuple(local), name
        spec = jtp.cache_specs(paged, quantized=kv != "bf16")
        p = getattr(spec, name)
        assert axis == (list(p).index("tp") if "tp" in tuple(p)
                        else None), name


def _jax_split_axes(spec_tree):
    """{name: the axis the P names 'tp' on, else None} of a spec tree;
    QuantWeight specs as (values, scales)."""
    def axis(p):
        if isinstance(p, jquant.QuantWeight):
            return axis(p.values), axis(p.scales)
        return list(p).index("tp") if "tp" in tuple(p) else None
    return {k: ({n: axis(v) for n, v in spec_tree[k].items()}
                if k == "layers" else axis(spec_tree[k]))
            for k in spec_tree}


@pytest.mark.parametrize("kw, quantized", [
    (dict(), False), (dict(), True), (MOE_KW, False),
    ({**MOE_KW, "moe_decode_ep": True}, False)],
    ids=["dense", "int8", "moe_replicated", "moe_decode_ep"])
def test_shard_plan_matches_decode_param_specs(kw, quantized):
    jcfg, tcfg = jllama.llama_tiny(**kw), tllama.llama_tiny(**kw)
    want = _jax_split_axes(jtp.decode_param_specs(jcfg,
                                                  quantized=quantized))
    plan = decode_tp.decode_shard_plan(tcfg)
    for k in ("embed", "final_norm", "lm_head"):
        w = want[k][0] if quantized and k == "lm_head" else want[k]
        assert plan[k] == w, k
    assert set(plan["layers"]) == set(want["layers"])
    for name, axis in plan["layers"].items():
        w = want["layers"][name]
        if isinstance(w, tuple):     # QuantWeight: values, scales
            w, scale_axis = w
            # Scales split with values only on the output axis.
            out_axis = 2                       # [L, in, out]
            assert scale_axis == (1 if w == out_axis else None), name
        # The JAX layer weights are stacked [L, ...]: one axis further.
        assert (None if w is None else w - 1) == axis, name


def test_shards_equal_the_jax_placement(mesh):
    """shard_decode_params gives each rank the block the JAX package's
    placement puts on that device, for bf16 and int8 weights."""
    for quantized in (False, True):
        params, jcfg, model, tcfg = _pair(seed=1, quantized=quantized)
        placed = jtp.shard_decode_params(params, mesh)
        for rank in range(TP):
            shard = decode_tp.shard_decode_params(model, rank, TP)
            for name in ("wq", "wo", "w_down", "w_up"):
                jarr = placed["layers"][name]
                arrs = (jarr.values, jarr.scales) if quantized else (jarr,)
                w = getattr(shard.layers[1], name)
                got = (w.values, w.scales) if quantized else (w,)
                for j, g in zip(arrs, got):
                    block = [s.data for s in j.addressable_shards
                             if s.device == mesh.devices.flat[rank]][0]
                    np.testing.assert_array_equal(
                        np.asarray(block)[1], g.numpy(), err_msg=name)


def test_init_params_shard_and_quantize_shard_are_slices(rt):
    """A rank drawing its shard layer by layer holds the tp 1 model's
    values; quantize_shard gives the shard of the whole model's int8
    weights (row shards take the group's absmax)."""
    cfg = tllama.llama_tiny(dtype=torch.float32)
    whole = tllama.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    shard = rt.random_model(cfg, seed=4)
    want = decode_tp.shard_decode_params(whole, 0, TP)
    for a, b in zip(shard.state_dict().values(), want.state_dict().values()):
        assert torch.equal(a, b)
    q = rt.quantize(shard)
    wq = decode_tp.shard_decode_params(quant.quantize_llama_params(whole),
                                       0, TP)
    for a, b in zip(q.state_dict().values(), wq.state_dict().values()):
        assert torch.equal(a, b)
    rt.drop_model(q)
    rt.drop_model(shard)


def test_int8_weights_parity(rt, mesh):
    params, jcfg, model, tcfg = _pair(seed=2, quantized=True)
    shard = rt.shard_model(model)
    assert isinstance(shard.layers[0].wo, quant.QuantWeight)
    assert shard.layers[0].wo.scales.shape == (tcfg.d_model,)
    prompt = jnp.asarray(PROMPT, jnp.int32)
    placed = jtp.shard_decode_params(params, mesh)
    jcache = jtp.init_sharded_cache(
        lambda: jdecode.init_cache(jcfg, 2, 11), mesh)
    jl, _ = jtp.jitted_decode_step(jcfg, mesh, quantized_weights=True)(
        placed, jcache, prompt)
    cache = rt.init_cache(tcfg, 2, 11)
    tl, _ = rt.decode_step(shard, cache, torch.tensor(PROMPT), tcfg)
    _close(tl, jl, "int8 weights")
    want = np.asarray(jdecode.generate(placed, prompt, jcfg,
                                       max_new_tokens=8, mesh=mesh))
    got = rt.generate(shard, torch.tensor(PROMPT), tcfg, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    rt.drop_model(shard)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_quantized_kv_parity(dense, rt, mesh, kv):
    params, jcfg, _, tcfg, shard = dense
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    jparams = jtp.shard_decode_params(params, mesh)
    prompt = list(range(30, 46))
    jcache = jtp.init_sharded_cache(
        lambda: jdecode.init_slot_cache(jcfg, 2, 32), mesh)
    jlast, jcache = jtp.jitted_prefill_slot(jcfg, mesh)(
        jparams, jcache, jnp.int32(0), jnp.asarray(prompt, jnp.int32),
        jnp.int32(16))
    cache = rt.init_slot_cache(tcfg, 2, 32)
    assert cache.k.dtype == torch.int8 and cache.k_scales.shape[2] == 1
    last, cache = rt.prefill_slot(shard, cache, 0, torch.tensor(prompt), 16,
                                  tcfg)
    _close(last, jlast, f"{kv} prefill")
    toks = [int(jnp.argmax(jlast)), 0]
    act = [True, False]
    jlog, _ = jtp.jitted_decode_step_slots(jcfg, mesh)(
        jparams, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(act))
    log, _ = rt.decode_step_slots(shard, cache, torch.tensor(toks),
                                  torch.tensor(act), tcfg)
    _close(log[0], jlog[0], f"{kv} decode")
    assert int(log[0].argmax()) == int(jnp.argmax(jlog[0]))


@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_parity(dense, rt, mesh, paged):
    params, jcfg, _, tcfg, shard = dense
    jparams = jtp.shard_decode_params(params, mesh)
    window = [[7, 8, 9, 10, 11], [12, 13, 14, 15, 16]]
    act = [True, True]
    if paged:
        init = (lambda c: jdecode.init_paged_cache(c, 2, 9, 8, 4))
        cache = rt.init_paged_cache(tcfg, 2, 9, 8, 4)
        tables = [[1, 2, 3, 4], [5, 6, 7, 8]]
    else:
        init = (lambda c: jdecode.init_slot_cache(c, 2, 32))
        cache = rt.init_slot_cache(tcfg, 2, 32)
    jcache = jtp.init_sharded_cache(lambda: init(jcfg), mesh)
    if paged:
        for s in range(2):
            jcache = jdecode.set_slot_pages(
                jcache, s, jnp.asarray(tables[s], jnp.int32), 0)
            cache = rt.set_slot_pages(cache, s, torch.tensor(tables[s]), 0)
    jlog, jcache = jtp.jitted_verify_step(jcfg, mesh, paged=paged)(
        jparams, jcache, jnp.asarray(window, jnp.int32), jnp.asarray(act))
    log, cache = rt.verify_step(shard, cache, torch.tensor(window),
                                torch.tensor(act), tcfg)
    _close(log, jlog, "verify_step")
    assert cache.length.tolist() == [0, 0]
    cache = rt.advance_lengths(cache, torch.tensor([3, 5], dtype=torch.int32),
                               torch.tensor(act))
    jcache = jdecode.advance_lengths(jcache, jnp.asarray([3, 5], jnp.int32),
                                     jnp.asarray(act))
    assert cache.length.tolist() == np.asarray(jcache.length).tolist()
    # The committed prefix is what the next step attends to, alike.
    jlog2, _ = jtp.jitted_verify_step(jcfg, mesh, paged=paged)(
        jparams, jcache, jnp.asarray([[1], [2]], jnp.int32),
        jnp.asarray(act))
    log2, _ = rt.verify_step(shard, cache, torch.tensor([[1], [2]]),
                             torch.tensor(act), tcfg)
    _close(log2, jlog2, "verify after commit")


@pytest.fixture(scope="module")
def moe(rt):
    params, jcfg, model, tcfg = _pair(seed=3, **MOE_KW)
    return params, jcfg, model, tcfg


@pytest.mark.parametrize("ep", [False, True],
                         ids=["experts_replicated", "experts_sharded"])
def test_moe_generate_parity(moe, rt, mesh, ep):
    params, jcfg, model, tcfg = moe
    jcfg = dataclasses.replace(jcfg, moe_decode_ep=ep)
    tcfg = dataclasses.replace(tcfg, moe_decode_ep=ep)
    prompt = jnp.asarray(PROMPT, jnp.int32)
    placed = jtp.shard_decode_params(params, mesh, jcfg)
    want = np.asarray(jdecode.generate(placed, prompt, jcfg,
                                       max_new_tokens=6, mesh=mesh))
    shard = rt.shard_model(model, tcfg)
    e_loc = shard.layers[0].w_gate.shape[0]
    assert e_loc == (tcfg.n_experts // TP if ep else tcfg.n_experts)
    got = rt.generate(shard, torch.tensor(PROMPT), tcfg, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    # The slot step, serving's hot path: logits held too.
    jcache = jtp.init_sharded_cache(
        lambda: jdecode.init_slot_cache(jcfg, 2, 64), mesh)
    prompt8 = [3, 7, 11, 13, 17, 19, 23, 29]
    jlast, _ = jtp.jitted_prefill_slot(jcfg, mesh)(
        placed, jcache, jnp.int32(0), jnp.asarray(prompt8, jnp.int32),
        jnp.int32(8))
    cache = rt.init_slot_cache(tcfg, 2, 64)
    last, _ = rt.prefill_slot(shard, cache, 0, torch.tensor(prompt8), 8,
                              tcfg)
    _close(last, jlast, f"moe ep={ep} prefill")
    rt.drop_model(shard)


def test_expert_shards_need_their_group():
    cfg = tllama.llama_tiny(dtype=torch.float32, moe_decode_ep=True,
                            **MOE_KW)
    model = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shard = decode_tp.shard_decode_params(model, 1, TP)
    with pytest.raises(ValueError, match="tp group"):
        decode._moe_ffn_decode(torch.zeros(1, 1, cfg.d_model),
                               shard.layers[0], cfg)


def test_placement_rule():
    assert distributed.tp_placement(2, "cpu") == (
        "gloo", [torch.device("cpu")] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            distributed.tp_placement(2, "cuda")


def test_follower_state_is_the_group_s(rt):
    """Each rank holds the same models, its own caches by name, and its
    own process; a cache rank 0 lets go is dropped on every rank."""
    cfg = tllama.llama_tiny(dtype=torch.float32)
    m = rt.random_model(cfg, seed=5)
    cache = rt.init_slot_cache(cfg, 2, 16)
    name = cache.k._tp_name
    stats = rt.stats()
    assert [s["rank"] for s in stats] == [0, 1]
    assert stats[0]["pid"] != stats[1]["pid"]
    assert name in stats[1]["caches"] and not stats[0]["caches"]
    del cache
    import gc
    gc.collect()
    after = rt.stats()[1]["caches"]   # the drop rides on this call
    assert name not in rt.stats()[1]["caches"], after
    rt.drop_model(m)
    assert rt.describe()["pids"][1] == rt.procs[0].pid
