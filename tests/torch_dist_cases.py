"""Rank functions for the port's multi-rank CPU tests
(tests/test_torch_*_dist.py, test_torch_mesh.py, test_torch_grad_comm.py,
test_torch_sp_attention.py): each runs in a gloo rank process started by
parallel/launch.run_ranks, joins the job's world from the environment,
and returns numpy results. This module imports torch and the port only,
never JAX, so a rank starts in a few seconds."""

from __future__ import annotations

import torch

from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.models import llama
from container_engine_accelerators_tpu_torch.parallel import (
    distributed,
    grad_comm,
    mesh as tmesh,
    ring_attention,
    sharding,
    spmd_util,
    ulysses,
)
from container_engine_accelerators_tpu_torch.training import train
from container_engine_accelerators_tpu_torch.training.fused_adamw import (
    FusedAdamW,
)


def _join():
    distributed.initialize_from_env(backend=None, device="cpu")


def _mesh(axes: dict, dcn_slices=None):
    return tmesh.make_mesh(tmesh.MeshAxes(**axes), dcn_slices=dcn_slices,
                           device=torch.device("cpu"))


def _full_params(model, mesh) -> dict:
    is_moe = bool(model.cfg.n_experts)
    return {name: sharding.gather_full(
                p.detach(), sharding.param_spec(name, is_moe), mesh).numpy()
            for name, p in model.named_parameters()}


def _full_grads(model, mesh) -> dict:
    is_moe = bool(model.cfg.n_experts)
    return {name: sharding.gather_full(
                p.grad, sharding.param_spec(name, is_moe), mesh).numpy()
            for name, p in model.named_parameters()}


def mesh_layout(cases: list) -> list:
    """Each case's (axes, dcn_slices) mesh: this rank's coordinate and
    its group ranks along each axis, checked by GatherShard round trips
    over fsdp (forward against the whole tensor, backward against a
    reduce-scatter done by hand)."""
    _join()
    out = []
    for axes, slices in cases:
        m = _mesh(axes, slices)
        groups = {}
        for name in tmesh.AXIS_NAMES:
            g = m.group(name)
            groups[name] = (None if g is None else
                            torch.distributed.get_process_group_ranks(g))
        out.append({"coord": m.coord, "groups": groups, "shape": m.shape})
    m = _mesh({"fsdp": torch.distributed.get_world_size()})
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    rt = {}
    for spec in (("fsdp", None), (None, "fsdp")):
        shard = sharding.shard_param(full, spec, m).clone().requires_grad_()
        got = sharding.gather_param(shard, spec, m, torch.float32)
        weight = torch.arange(got.numel(), dtype=torch.float32).reshape(
            got.shape) * (m.rank + 1)
        (got * weight).sum().backward()
        # By hand: the sum over ranks of each rank's weight, this rank's
        # block of it.
        total = sum(torch.arange(got.numel(), dtype=torch.float32).reshape(
            got.shape) * (r + 1) for r in range(m.size))
        rt[str(spec)] = {
            "forward_equal": bool(torch.equal(got.detach(), full)),
            "grad_equal": bool(torch.equal(
                shard.grad, sharding.shard_param(total, spec, m))),
            "full_equal": bool(torch.equal(
                sharding.gather_full(shard.detach(), spec, m), full))}
    return [out, rt]


def attention(cases: list) -> list:
    """Ring or Ulysses attention on this rank's chunk of q, k, v (global
    arrays given), forward and the q/k/v grads of sum(out * w), each
    gathered back to the global sequence; None from ranks other than
    0."""
    _join()
    out = []
    for case in cases:
        m = _mesh({"sp": torch.distributed.get_world_size()})
        if case.get("form"):
            ring_attention.permute_form = lambda *a, f=case["form"]: f
        ts = {k: torch.from_numpy(case[k]) for k in ("q", "k", "v", "w")}
        local = {k: spmd_util.local_cols(t, m).clone().requires_grad_(
                     k != "w") for k, t in ts.items()}
        if case["mode"] == "ring":
            o = ring_attention.ring_attention(
                local["q"], local["k"], local["v"], m,
                causal=case["causal"])
        else:
            o = ulysses.ulysses_attention(
                local["q"], local["k"], local["v"], m,
                causal=case["causal"])
        (o * local["w"]).sum().backward()
        res = {"out": o.detach()}
        res.update({f"d{k}": local[k].grad for k in ("q", "k", "v")})
        out.append({k: spmd_util.gather_sp(v.contiguous(), m).numpy()
                    for k, v in res.items()})
    return out if torch.distributed.get_rank() == 0 else None


def _cfg(cfg_kw: dict):
    return llama.llama_tiny(dtype=torch.float32, **cfg_kw)


def train_steps(cases: list) -> list:
    """Each case's steps on its mesh from the same JAX-initialized tree:
    the step's loss, grad norm and tokens, and the gathered params after
    the last step (rank 0's; None elsewhere). A case with 'grads_only'
    runs one forward and backward and its dp reduction and returns the
    gathered gradients instead. 'mutate' breaks one rule of the step (the
    smoke's mutation check)."""
    _join()
    results = []
    for case in cases:
        m = _mesh(case["axes"], case.get("dcn_slices"))
        cfg = _cfg(case["cfg"])
        model = interop.train_params_from_jax(case["tree"], cfg, mesh=m)
        opt = lambda params, **kw: FusedAdamW(params, **case["opt"], **kw)
        dcn = (grad_comm.DcnOverlapConfig(**case["dcn"])
               if case.get("dcn") else None)
        ga = case.get("grad_accum", 1)
        with _mutated(case.get("mutate")):
            state = train.create_train_state(cfg, opt, mesh=m, model=model,
                                             dcn_overlap=dcn)
            step = train.make_train_step(cfg, state.optimizer, ga, mesh=m,
                                         dcn_overlap=dcn, state=state)
            losses, norms, tokens = [], [], []
            for batch in case["batches"]:
                local = train.to_device(train.shard_batch(
                    batch, m, ga, bool(cfg.sequence_parallel)), m.device)
                if case.get("grads_only"):
                    _grads_only(cfg, m, state, local, ga, dcn)
                    break
                metrics = step(state.model, local)
                losses.append(metrics["loss"].item())
                norms.append(metrics["grad_norm"].item())
                tokens.append(int(metrics["tokens"]))
        res = {"losses": losses, "grad_norms": norms, "tokens": tokens}
        if case.get("grads_only"):
            res["grads"] = _full_grads(state.model, m)
        else:
            res["params"] = _full_params(state.model, m)
        results.append(res)
    return results if torch.distributed.get_rank() == 0 else None


def _grads_only(cfg, m, state, local, ga, dcn):
    """One step's reduced gradients, no update."""
    if dcn is None:
        for p in state.model.parameters():
            p.grad = None
        for i in range(ga):
            mb = {k: x.chunk(ga)[i] for k, x in local.items()}
            (train.loss_fn(state.model, mb, cfg, mesh=m) / ga).backward()
        train.reduce_grads(state.model, m)
        return
    reducer = train._overlap_reducer(cfg, m, state.model, dcn, ga,
                                     state.dcn_ef).attach()
    train._make_overlap_grads(cfg, False, m, ga)(state.model, local,
                                                 reducer)
    reducer.finish()
    reducer.detach()


class _mutated:
    """One rule of the sharded step broken, for the mutation check:
    'skip_reduce_scatter' (GatherShard's backward keeps the local
    gradient), 'norm_twice' (every rank counts the replicated norms) or
    'local_count' (each rank divides its loss by its own count)."""

    def __init__(self, what: str | None):
        self.what = what
        self.saved = []

    def __enter__(self):
        import torch.distributed as dist

        if self.what == "skip_reduce_scatter":
            def backward(ctx, g):
                n = dist.get_world_size(ctx.group)
                full = g.float().movedim(ctx.dim, 0)
                i = dist.get_rank(ctx.group)
                part = full.chunk(n)[i].contiguous()
                return part.movedim(0, ctx.dim).to(ctx.shard_dtype), None, \
                    None, None
            self._swap(sharding.GatherShard, "backward",
                       staticmethod(backward))
        elif self.what == "norm_twice":
            real = train.sharded_grad_norm

            def twice(model, m):
                coord = dict(m.coord)
                m.coord = dict(coord, fsdp=0)
                try:
                    return real(model, m)
                finally:
                    m.coord = coord
            self._swap(train, "sharded_grad_norm", twice)
        elif self.what == "local_count":
            # Each rank divides by its own count: its own mean, summed
            # by the step's reduction as if it were a share.
            self._swap(train, "_loss_share", lambda mesh, axes: None)
        return self

    def _swap(self, obj, name, value):
        self.saved.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, value)

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


def fit_case(ckpt_dir: str, axes: dict, steps: int, cfg_kw: dict,
             batch: int = 4, seq: int = 32) -> dict | None:
    """fit across ranks from seed 0 with a checkpoint every step into
    `ckpt_dir` (restoring what is there): rank 0's gathered params, the
    gathered AdamW moments, the optimizer count, the step, the last loss
    and the recorder's goodput split; None elsewhere."""
    from container_engine_accelerators_tpu_torch.metrics.train_metrics import (  # noqa: E501
        TrainRecorder,
    )
    from container_engine_accelerators_tpu_torch.training import data

    _join()
    m = _mesh(axes)
    cfg = _cfg(cfg_kw)
    rec = TrainRecorder()
    state, metrics = train.fit(
        cfg, train.make_optimizer(warmup_steps=2, decay_steps=50),
        data.synthetic_batches(cfg.vocab_size, batch, seq, seed=0),
        mesh=m, max_steps=steps, ckpt_dir=ckpt_dir, save_every=1,
        recorder=rec, log_every=1)
    out = gathered_state(state, m)
    out.update(step=state.step, goodput=rec.goodput(),
               loss=float(metrics["loss"]) if metrics else None)
    return out if torch.distributed.get_rank() == 0 else None


def gathered_state(state, m) -> dict:
    """A train state's whole params and AdamW moments, by name."""
    is_moe = bool(state.model.cfg.n_experts)
    opt = {}
    for name, p in state.model.named_parameters():
        spec = sharding.param_spec(name, is_moe)
        for key, value in state.optimizer.state[p].items():
            opt[f"{name}/{key}"] = sharding.gather_full(value, spec,
                                                        m).numpy()
    return {"params": _full_params(state.model, m), "opt": opt,
            "count": state.optimizer.count}


def smoke_dist_rank(ckpt_dir: str, sz: dict, device: str = "cpu"):
    """chip_smoke.dist_rank in the CPU rehearsal: flash attention's
    plain versions counted as the card's launches, and sz['mutate']
    (if any) breaking one rule of the sharded step."""
    import chip_smoke
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    def counted(name, fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            kernels.count(name)
            return out
        return wrapper

    fa._route = lambda x, plain: "plain" if plain else "cuda"
    fa._FWD["cuda"] = counted("flash_fwd", fa.flash_fwd_plain)
    fa._BWD_DQ["cuda"] = counted("flash_bwd_dq", fa.flash_bwd_dq_plain)
    fa._BWD_DKV["cuda"] = counted("flash_bwd_dkv", fa.flash_bwd_dkv_plain)
    with _mutated(sz.get("mutate")):
        return chip_smoke.dist_rank(ckpt_dir, sz, device)
