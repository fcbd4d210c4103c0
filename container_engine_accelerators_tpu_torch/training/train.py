"""The training step and loop: the JAX package's make_optimizer,
create_train_state, loss_fn, make_train_step (and its bucketed dp
reduction, `dcn_overlap`), make_dcn_probes, shard_batch, train_loop,
fit (checkpoint and resume, the train recorder, its /metrics exporter,
heartbeats and the hang watchdog) and evaluate, on one device or across
the ranks of a mesh (parallel/mesh.py) with dp, fsdp and sp > 1.

Across ranks each process runs the same loop on its block of every
global batch (`shard_batch`): its rows along (dp, fsdp) and, under sp,
its columns. The loss is the JAX package's token-weighted mean over the
whole global batch: each rank's loss is its share, its masked sum over
the token count summed over the step's ranks, so the gradients of the
shares add up to the gradient of the mean. fsdp-sharded weights get
their gradient reduce-scattered by GatherShard's backward; what is left
is a sum over the other axes: the replicated weights (the norms) over
every rank of the step, the sharded ones over dp and sp. With
`dcn_overlap` the dp part is the bucketed reducer's
(parallel/grad_comm.py), and the loss a mean over each dp slice as in
the JAX package's overlap step. tp > 1, pp > 1 and ep > 1 raise: they
wait for ROADMAP item 12's remainder.

PyTorch idiom where JAX donates and rebuilds: the step updates the
model's parameters and the optimizer's moments in place. The step count
lives on the host, and the loop reads the device only at log boundaries
(the loss fetch), as the JAX loop does. Host batches reach the card
through pinned, non-blocking copies.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from container_engine_accelerators_tpu_torch.metrics import (
    events,
    introspection,
)
from container_engine_accelerators_tpu_torch.models import llama, moe
from container_engine_accelerators_tpu_torch.models.convert import (
    resolve_device,
)
from container_engine_accelerators_tpu_torch.parallel import (
    grad_comm,
    sharding,
    spmd_util,
)
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    SLICE_TOKEN_AXES,
    TOKEN_AXES,
    Mesh,
)
from container_engine_accelerators_tpu_torch.training.fused_adamw import (
    FusedAdamW,
    grad_norm_metric,
)
from container_engine_accelerators_tpu_torch.utils.profiling import (
    annotate,
    maybe_profile,
)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule's formula, on the host: a
    linear ramp from init to peak over warmup_steps, then a cosine from
    peak to end_value over the remaining decay_steps - warmup_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)

    return schedule


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0, warmup_steps: int = 100,
                   decay_steps: int = 10_000,
                   mu_dtype: torch.dtype | None = None
                   ) -> Callable[..., FusedAdamW]:
    """The training update rule: global-norm clip, then AdamW on a
    warmup-cosine schedule. Returns a factory: call it on the model's
    parameters to get the FusedAdamW (a torch optimizer is bound to its
    parameters; the JAX one is not)."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate,
        warmup_steps=warmup_steps, decay_steps=decay_steps,
        end_value=learning_rate * 0.1)
    return functools.partial(FusedAdamW, lr=schedule, b1=b1, b2=b2,
                             weight_decay=weight_decay, grad_clip=grad_clip,
                             mu_dtype=mu_dtype)


TP_TODO = ("training tensor parallelism (tp > 1) is not ported yet: "
           "Megatron-style tp in the train step (ROADMAP item 12's "
           "remainder: training tp and pp with parallel/pipeline.py)")
PP_TODO = ("pipeline parallelism (pp > 1) is not ported yet: "
           "parallel/pipeline.py's GPipe and circular schedules (ROADMAP "
           "item 12's remainder: training tp and pp with "
           "parallel/pipeline.py)")


def check_train_mesh(cfg: llama.LlamaConfig, mesh: Mesh | None) -> None:
    """The mesh shapes this port trains on: dp, fsdp and sp; tp, pp and
    ep > 1 raise naming what they wait for; sp > 1 needs
    cfg.sequence_parallel, and Ulysses divisible heads."""
    if mesh is None:
        return
    if mesh.axis_size("tp") > 1:
        raise NotImplementedError(TP_TODO)
    if mesh.axis_size("pp") > 1:
        raise NotImplementedError(PP_TODO)
    if mesh.axis_size("ep") > 1:
        raise NotImplementedError(moe.EP_TODO)
    sp = mesh.axis_size("sp")
    if sp > 1 and not cfg.sequence_parallel:
        raise ValueError(f"the mesh has sp={sp}: set "
                         "cfg.sequence_parallel (ring or ulysses)")
    if cfg.sequence_parallel and cfg.sequence_parallel_mode == "ulysses":
        from container_engine_accelerators_tpu_torch.parallel import (
            ulysses,
        )
        ulysses.check_heads(cfg.n_heads, cfg.n_kv_heads, sp)


def _loss_share(mesh: Mesh | None, axes: tuple):
    """(group, ranks) over which a loss is one mean, or None."""
    if mesh is None or mesh.axis_size(*axes) == 1:
        return None
    return mesh.group(*axes), mesh.axis_size(*axes)


def loss_fn(model: llama.Llama, batch: dict, cfg: llama.LlamaConfig,
            plain: bool = False, mesh: Mesh | None = None,
            loss_axes: tuple = TOKEN_AXES) -> torch.Tensor:
    """Next-token cross entropy in f32, averaged over the targets >= 0
    (negative targets are padding), plus a mixture of experts' router
    aux losses (models/llama.forward's aux; zero for a dense model).

    On a mesh, `batch` is this rank's block and the result its share of
    the mean over the ranks of `loss_axes`: its masked sum over the
    count all-reduced over them (and its share of the aux); the shares
    sum to the mean over the whole batch."""
    logits, aux = llama.forward(model, batch["inputs"], cfg, plain=plain,
                                return_aux=True, mesh=mesh,
                                loss_axes=loss_axes)
    targets = batch["targets"].reshape(-1)
    mask = (targets >= 0).float()
    losses = F.cross_entropy(logits.view(-1, logits.shape[-1]),
                             targets.clamp(min=0).long(), reduction="none")
    count = mask.sum()
    share = _loss_share(mesh, loss_axes)
    if share is not None:
        dist.all_reduce(count, group=share[0])
    return (losses * mask).sum() / count.clamp(min=1.0) + aux


def reduce_grads(model: llama.Llama, mesh: Mesh) -> None:
    """Sum each gradient over the axes it is not yet summed over: a
    weight replicated over fsdp over every rank of the step, an
    fsdp-sharded one (its fsdp sum done by GatherShard's backward) over
    dp and sp. One flat all-reduce a group."""
    is_moe = bool(model.cfg.n_experts)
    replicated, sharded = [], []
    for name, p in model.named_parameters():
        spec = sharding.param_spec(name, is_moe)
        (sharded if sharding.fsdp_dim(spec, mesh) is not None
         else replicated).append(p.grad)
    for grads, groups in ((replicated, [mesh.group(*TOKEN_AXES)]),
                          (sharded, [mesh.group("dp"), mesh.group("sp")])):
        groups = [g for g in groups if g is not None]
        if not grads or not groups:
            continue
        flat = torch._utils._flatten_dense_tensors(grads)
        for g in groups:
            dist.all_reduce(flat, group=g)
        for dst, src in zip(grads, torch._utils._unflatten_dense_tensors(
                flat, grads)):
            dst.copy_(src)


def sharded_grad_norm(model: llama.Llama, mesh: Mesh):
    """FusedAdamW's `norm_of` on a mesh: the global norm of the whole
    model's gradients from this rank's shards, each parameter counted
    once (an fsdp shard on every fsdp rank, a weight replicated over
    fsdp on fsdp rank 0; everything on dp and sp coordinate 0 only, as
    the reduced gradients agree there), then an all-reduce over every
    rank."""
    is_moe = bool(model.cfg.n_experts)
    first = mesh.coord["dp"] == 0 and mesh.coord["sp"] == 0
    counted = {id(p) for name, p in model.named_parameters()
               if first and (mesh.coord["fsdp"] == 0 or sharding.fsdp_dim(
                   sharding.param_spec(name, is_moe), mesh) is not None)}

    def norm_of(params) -> torch.Tensor:
        mine = [p.grad for p in params if id(p) in counted]
        sq = (torch.stack(torch._foreach_norm(mine)).square().sum()
              if mine else torch.zeros((), device=mesh.device))
        sq = sq.float()
        if mesh.size > 1:
            dist.all_reduce(sq)
        return sq.sqrt()
    return norm_of


def make_train_step(cfg: llama.LlamaConfig, optimizer: torch.optim.Optimizer,
                    grad_accum: int = 1, plain: bool = False,
                    mesh: Mesh | None = None, dcn_overlap=None,
                    state=None):
    """`step(model, batch) -> metrics`: loss and gradients, one optimizer
    update in place, and {'loss', 'grad_norm', 'tokens'} as device
    scalars (on one device nothing waits for it).

    `grad_accum > 1` splits the batch's leading dim into that many equal
    microbatches and averages their gradients before the one update.
    `plain=True` runs flash attention's plain versions (the on-card
    reference for the kernels).

    On a `mesh` the batch is this rank's block (shard_batch) and the
    metrics are the whole step's: the loss and tokens all-reduced over
    its ranks. `dcn_overlap` (a grad_comm.DcnOverlapConfig) reduces over
    dp through the bucketed reducer instead, its error feedback in
    `state.dcn_ef` (create_train_state)."""
    check_train_mesh(cfg, mesh)
    if dcn_overlap is not None:
        return _make_overlap_step(cfg, optimizer, grad_accum, plain, mesh,
                                  dcn_overlap, state)
    on_mesh = mesh is not None and mesh.size > 1

    def step(model: llama.Llama, batch: dict) -> dict:
        optimizer.zero_grad(set_to_none=True)
        rows = batch["inputs"].shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{grad_accum} microbatches")
        losses = []
        for i in range(grad_accum):
            mb = {key: x.chunk(grad_accum)[i] for key, x in batch.items()}
            loss = loss_fn(model, mb, cfg, plain=plain, mesh=mesh)
            (loss / grad_accum).backward()
            losses.append(loss.detach())
        if on_mesh:
            reduce_grads(model, mesh)
        optimizer.step()
        grads = [p.grad for p in model.parameters()]
        loss = torch.stack(losses).mean()
        tokens = (batch["targets"] >= 0).sum()
        if on_mesh:
            loss, tokens = _step_totals(loss, tokens, mesh, TOKEN_AXES)
        return {"loss": loss,
                "grad_norm": grad_norm_metric(optimizer, grads),
                "tokens": tokens}

    return step


def _step_totals(loss, tokens, mesh: Mesh, loss_axes: tuple,
                 slices: int = 1):
    """The step's loss (the shares summed over `loss_axes`, then the mean
    over `slices` dp slices) and its tokens (summed over every rank of
    the step), in one all-reduce a group."""
    both = torch.stack([loss.float(), tokens.float()])
    group = mesh.group(*loss_axes)
    if group is not None:
        dist.all_reduce(both, group=group)
    if slices > 1:
        dist.all_reduce(both, group=mesh.group("dp"))
        both[0] = both[0] / slices
    return both[0], both[1].long()


def _overlap_reducer(cfg, mesh: Mesh, model, dcn, grad_accum: int,
                     error_feedback):
    return grad_comm.BucketReducer(
        mesh, list(model.named_parameters()), dcn,
        denom=mesh.axis_size(dcn.axis) * grad_accum,
        moe=bool(cfg.n_experts), error_feedback=error_feedback)


def _make_overlap_grads(cfg, plain: bool, mesh: Mesh, grad_accum: int):
    """grads(model, batch, reducer) -> the microbatches' losses: each
    microbatch's forward and backward with the loss a mean over its dp
    slice, gradients summed over microbatches, `reducer` (or None: the
    compute alone) armed to launch its buckets during the last
    microbatch's backward. The reducer's finish() completes the step's
    reduction."""

    def grads(model, batch, reducer) -> list:
        for p in model.parameters():
            p.grad = None
        losses = []
        for i in range(grad_accum):
            if reducer is not None:
                reducer.arm(final=i == grad_accum - 1)
            mb = {key: x.chunk(grad_accum)[i] for key, x in batch.items()}
            loss = loss_fn(model, mb, cfg, plain=plain, mesh=mesh,
                           loss_axes=SLICE_TOKEN_AXES)
            loss.backward()
            losses.append(loss.detach())
        return losses

    return grads


def _make_overlap_step(cfg, optimizer, grad_accum: int, plain: bool,
                       mesh: Mesh, dcn, state):
    """make_train_step's `dcn_overlap` branch: each slice's gradient
    through GatherShard, then the bucketed dp reduction
    (grad_comm.BucketReducer), launched bucket by bucket during the
    last microbatch's backward and waited for before the update."""
    grad_comm.validate_mesh_for_overlap(
        mesh, dcn, sequence_parallel=bool(cfg.sequence_parallel))
    grads = _make_overlap_grads(cfg, plain, mesh, grad_accum)
    reducer = None
    n_slices = mesh.axis_size(dcn.axis)

    def step(model: llama.Llama, batch: dict) -> dict:
        nonlocal reducer
        if reducer is None:
            ef = None if state is None else state.dcn_ef
            reducer = _overlap_reducer(cfg, mesh, model, dcn, grad_accum,
                                       ef).attach()
            step.reducer = reducer
        losses = grads(model, batch, reducer)
        reducer.finish()
        optimizer.step()
        grad_list = [p.grad for p in model.parameters()]
        loss, tokens = _step_totals(
            torch.stack(losses).mean(), (batch["targets"] >= 0).sum(),
            mesh, SLICE_TOKEN_AXES, slices=n_slices)
        return {"loss": loss,
                "grad_norm": grad_norm_metric(optimizer, grad_list),
                "tokens": tokens}

    step.reducer = None
    return step


def make_dcn_probes(cfg, mesh: Mesh, dcn, model, batch: dict,
                    grad_accum: int = 1, ef: dict | None = None,
                    plain: bool = False):
    """Attribution probes over the same gradients and buckets the
    overlap step runs (grad_comm.AttributionProbes): calibrate() times
    the compute alone, the full step's gradients and reduction, and each
    bucket's reduction alone, on a scratch copy of the error feedback.
    `batch` is this rank's block on the device. One-shot, never on the
    step path; every rank must call it (its probes hold collectives)."""
    grad_comm.validate_mesh_for_overlap(
        mesh, dcn, sequence_parallel=bool(cfg.sequence_parallel))
    grads = _make_overlap_grads(cfg, plain, mesh, grad_accum)

    def make_reducer():
        scratch = (None if ef is None
                   else {k: v.clone() for k, v in ef.items()})
        return _overlap_reducer(cfg, mesh, model, dcn, grad_accum,
                                scratch).attach()

    return grad_comm.AttributionProbes(
        make_reducer, lambda reducer: grads(model, batch, reducer),
        mesh.device)


def shard_batch(batch: dict, mesh: Mesh, grad_accum: int = 1,
                sequence_parallel: bool = False) -> dict:
    """This rank's block of a global host batch [B, S] (the JAX
    package's batch_spec placement): of each of the grad_accum
    microbatches its rows along (dp, fsdp), and under sequence
    parallelism its columns along sp."""
    out = {}
    for key, x in batch.items():
        x = np.asarray(x)
        b = x.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{grad_accum} microbatches")
        micro = x.reshape(grad_accum, b // grad_accum, *x.shape[1:])
        rows = spmd_util.local_rows(micro, mesh, dim=1)
        x = rows.reshape(-1, *x.shape[1:])
        if sequence_parallel:
            x = spmd_util.local_cols(x, mesh, dim=1)
        out[key] = np.ascontiguousarray(x)
    return out


@dataclasses.dataclass
class TrainState:
    step: int                       # optimizer steps taken (host count)
    model: llama.Llama
    optimizer: torch.optim.Optimizer
    tokens: int = 0                 # targets trained on (host count)
    seconds: float = 0.0            # the loop's wall time, to its last fence
    # int8 dp reduction's error feedback (grad_comm.init_error_feedback):
    # {param name: f32 like the rank's shard}; never checkpointed.
    dcn_ef: dict | None = None
    mesh: Mesh | None = None


def create_train_state(cfg: llama.LlamaConfig, optimizer, *,
                       mesh: Mesh | None = None, seed: int = 0,
                       device: str | torch.device | None = None,
                       dcn_overlap=None, model: llama.Llama | None = None
                       ) -> TrainState:
    """Random f32 masters from `seed` (or `model`), the optimizer bound
    to them. On a mesh each rank keeps its shards: every weight is drawn
    whole on the rank's device and only the rank's block kept
    (parallel/sharding.shard_param), so every topology starts from the
    same values; the optimizer's norm is then sharded_grad_norm. With
    an int8 `dcn_overlap`, the error feedback starts at zeros."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    check_train_mesh(cfg, mesh)
    if model is None:
        keep = None
        if mesh is not None and mesh.size > 1:
            is_moe = bool(cfg.n_experts)

            def keep(name, w):
                full = name if name in ("embed", "final_norm", "lm_head") \
                    else f"layers.0.{name}"
                return sharding.shard_param(
                    w, sharding.param_spec(full, is_moe), mesh).clone()
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = llama.init_train_params(cfg, gen, dev, keep=keep)
    kw = {}
    if mesh is not None and mesh.size > 1:
        kw["norm_of"] = sharded_grad_norm(model, mesh)
    state = TrainState(step=0, model=model,
                       optimizer=optimizer(model.parameters(), **kw),
                       mesh=mesh)
    if dcn_overlap is not None:
        state.dcn_ef = grad_comm.init_error_feedback(
            list(model.named_parameters()), dcn_overlap)
    return state


def to_device(batch: dict, device: torch.device) -> dict:
    """Host arrays as tensors on `device`; on the card through pinned
    memory without blocking, so the copy does not wait for queued work."""
    out = {}
    for key, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def _host_token_count(batch) -> int:
    """Non-padding targets, counted on the host batch before it is
    placed, so no step waits on the device for it."""
    return int(np.sum(np.asarray(batch["targets"]) >= 0))


def _fabric_sweep(step: int, log_fn) -> None:
    """The active fabric health monitor's step-synchronized sweep
    (metrics/fabric_health.py): every rank reaches the same step and
    probes in lockstep, so the collectives stay matched. A failed sweep
    is logged and training carries on."""
    from container_engine_accelerators_tpu_torch.metrics import (
        fabric_health,
    )
    mon = fabric_health.get_active()
    if mon is None or mon.train_every <= 0:
        return
    with annotate("train/fabric_sweep"):
        try:
            mon.maybe_sweep_step(step)
        except Exception as e:
            log_fn(f"fabric sweep failed: {e}")


def _run_steps(state: TrainState, it: Iterator, step_fn, *, cfg,
               max_steps: int | None, log_every: int, log_fn, recorder,
               context: str, mngr=None, ckpt_async: bool = False,
               fabric_sweeps: bool = False, prepare=None,
               after_first=None):
    """The host loop shared by train_loop and fit: data wait, step
    dispatch, (checkpoint save), the loss fetch at log boundaries (the
    loop's only wait on the device besides a save), and the recorder's
    step edges; with `cfg`, the recorder's MFU and the saves' config
    record; with `fabric_sweeps` (fit), the fabric monitor's sweeps.
    `prepare(host batch)` gives the rank's block on a mesh (the tokens
    counted are the whole batch's); `after_first(batch on the device)`
    runs once after the first step (fit's dp calibration). The data
    wait, step and save are train/* regions (annotate). Returns (state,
    last metrics)."""
    device = state.model.device
    mesh = state.mesh
    n_chips = mesh.size if mesh is not None else 1
    metrics = None
    t_start = time.perf_counter()
    i = 0
    while max_steps is None or state.step < max_steps:
        t0 = time.perf_counter()
        try:
            with annotate("train/data_wait"):
                batch = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        tokens = _host_token_count(batch)
        if recorder is not None and not recorder.model_configured \
                and cfg is not None:
            from container_engine_accelerators_tpu_torch.metrics.train_metrics import (  # noqa: E501
                detect_peak_flops,
            )
            recorder.configure_model(
                cfg.train_flops_per_token(batch["targets"].shape[-1]),
                peak_flops_per_chip=detect_peak_flops(device),
                n_chips=n_chips)
        with annotate("train/step"), introspection.oom_forensics(context):
            local = to_device(prepare(batch) if prepare else batch, device)
            metrics = step_fn(state.model, local)
        t2 = time.perf_counter()
        state.step += 1
        state.tokens += tokens
        saved, save_dt = False, 0.0
        if mngr is not None:
            with annotate("train/ckpt_save"):
                ts = time.perf_counter()
                saved = mngr.save(state.step, state, cfg=cfg)
                save_dt = time.perf_counter() - ts
        loss = None
        if log_every and i % log_every == 0:
            ts = time.perf_counter()
            loss, gnorm = torch.stack(
                [metrics["loss"], metrics["grad_norm"]]).tolist()
            if recorder is not None:
                recorder.record_host_sync(time.perf_counter() - ts)
            log_fn(f"step {state.step} loss {loss:.4f} "
                   f"grad_norm {gnorm:.3f}")
        if recorder is not None:
            recorder.record_step(state.step, compute_s=t2 - t1,
                                 tokens=tokens, data_wait_s=t1 - t0,
                                 loss=loss, first=(i == 0))
            if saved:
                recorder.record_checkpoint_save(save_dt,
                                                async_mode=ckpt_async)
        if i == 0 and after_first is not None:
            after_first(local)
        if fabric_sweeps:
            _fabric_sweep(state.step, log_fn)
        i += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    state.seconds += time.perf_counter() - t_start
    return state, metrics


def train_loop(state: TrainState, batches: Iterator, step_fn,
               max_steps: int | None = None, log_every: int = 10,
               log_fn=print, recorder=None
               ) -> tuple[TrainState, dict | None]:
    """Run `step_fn` over `batches` until they end or `state.step`
    reaches `max_steps`; returns the state and the last metrics. Every
    `log_every` steps (counted from this call's first) the loss and grad
    norm are fetched, the loop's only wait on the device, and logged.
    With a `recorder` (metrics/train_metrics.TrainRecorder) every step
    edge is recorded: data wait against dispatch, tokens, the loss at
    log boundaries."""
    return _run_steps(state, iter(batches), step_fn, cfg=None,
                      max_steps=max_steps, log_every=log_every,
                      log_fn=log_fn, recorder=recorder,
                      context="train_loop/step")


def _join_async_save(mngr, rec, step: int) -> None:
    """Wait for the async save in flight, charging the wait to the
    recorder's ckpt_async bucket."""
    ts = time.perf_counter()
    in_flight = mngr.async_in_flight
    mngr.wait_async()
    if rec is not None and in_flight:
        rec.record_badput("ckpt_async", time.perf_counter() - ts,
                          {"join": True, "step": step})


def fit(cfg: llama.LlamaConfig, optimizer: Callable[..., FusedAdamW],
        batches: Iterator, *, device: str | torch.device = "cuda",
        max_steps: int | None = None, seed: int = 0, log_every: int = 10,
        log_fn=print, ckpt_dir: str | None = None, save_every: int = 100,
        ckpt_async: bool = False, recorder=None,
        metrics_port: int | None = None, metrics_host: str = "",
        metrics_log: str | None = None, heartbeat_dir: str | None = None,
        watchdog_threshold_s: float = 300.0, mesh: Mesh | None = None,
        dcn_overlap=None) -> tuple[TrainState, dict | None]:
    """Train with checkpoint and auto-resume: random masters from `seed`
    (create_train_state), `optimizer` (a make_optimizer factory) bound
    to them, then the loop over `batches` up to `max_steps`. Runs on the
    card unless `device` says otherwise; asking for CUDA without it
    raises. Returns (state, last metrics).

    Across ranks, give the `mesh` (parallel/mesh.make_mesh, after
    parallel/distributed.initialize_from_env; cli/train.py does both):
    every rank runs this loop in lockstep over the same global
    `batches`, each stepping on its block (shard_batch); `log_fn` runs
    on rank 0 only. `dcn_overlap` (grad_comm.DcnOverlapConfig) reduces
    over dp through the bucketed reducer, and after the first step
    every rank runs the one-shot `train/dcn_calibrate` probe
    (make_dcn_probes) whose attribution goes to the recorder
    (record_dcn_attribution) and through `log_fn`.

    With `ckpt_dir`, the newest checkpoint there is restored onto the
    device (falling back past a torn newest step) and the batch stream
    fast-forwarded by the restored step, so `batches` must be the same
    deterministic stream from step 0 (the package's streams are); a step
    is saved every `save_every` steps and at the end. A checkpoint
    saved under another topology (say fsdp 2, restored at fsdp 1) is
    resharded on restore and charged to the recorder's `reshard`
    bucket. `ckpt_async` moves the write off the step path: the loop
    pays the pinned snapshot and whatever of the previous write the
    steps since a save did not cover (a due save joins it, and so does
    the end of the run), all charged to the `ckpt_async` goodput bucket;
    it takes one rank only.

    Observability (metrics/train_metrics.py): a `recorder`, passed in or
    built here when any of `metrics_port` / `metrics_log` /
    `heartbeat_dir` is set, sees every step edge, accumulates goodput
    across resumes (restore and fast-forward are badput), appends a
    crash-safe JSONL step log and touches a per-process heartbeat that a
    HangWatchdog watches (`heartbeat_dir`, `watchdog_threshold_s`).
    `metrics_port` serves it on /metrics (0 = ephemeral; the bound port
    goes through `log_fn`). A resume is a `train/resume` instant on the
    flight recorder. What fit builds, fit closes.

    Telemetry: TPU_PROFILE_DIR captures the step loop with
    torch.profiler (utils/profiling.maybe_profile), its train/data_wait,
    train/step, train/ckpt_save and train/fabric_sweep regions also on
    the flight recorder; an active fabric health monitor
    (fabric_health.set_active, `train --fabric-health`) sweeps at the
    steps its maybe_sweep_step picks, every rank in step lockstep."""
    from container_engine_accelerators_tpu_torch.metrics import (
        train_metrics,
    )
    from container_engine_accelerators_tpu_torch.training.checkpoint import (
        CheckpointManager,
        current_topology,
    )

    on_mesh = mesh is not None and mesh.size > 1
    if on_mesh and ckpt_async:
        raise NotImplementedError(
            "ckpt_async with more than one rank is not ported yet: each "
            "rank's background write would need a collective commit off "
            "the step thread; save synchronously")
    if on_mesh and mesh.rank != 0:
        log_fn = _quiet
    rec = recorder
    own_rec = rec is None
    if rec is None and (metrics_port is not None or metrics_log
                        or heartbeat_dir):
        rec = train_metrics.TrainRecorder(log_path=metrics_log,
                                          heartbeat_dir=heartbeat_dir)
    watchdog = exporter = mngr = None
    try:
        if rec is not None and heartbeat_dir:
            watchdog = train_metrics.HangWatchdog(
                heartbeat_dir, threshold_s=watchdog_threshold_s,
                registry=rec.registry)
            watchdog.start()
        if rec is not None and metrics_port is not None:
            exporter = train_metrics.TrainMetricsExporter(
                rec, port=metrics_port, host=metrics_host,
                watchdog=watchdog)
            exporter.start_background()
            log_fn(f"train metrics on :{exporter.bound_port}/metrics")
        if on_mesh:
            log_fn(f"fit on {mesh.size} ranks: mesh {mesh.shape}, "
                   f"{mesh.backend} on {mesh.device}")

        state = create_train_state(cfg, optimizer, mesh=mesh, seed=seed,
                                   device=device, dcn_overlap=dcn_overlap)
        if ckpt_dir:
            mngr = CheckpointManager(ckpt_dir,
                                     save_interval_steps=save_every,
                                     async_save=ckpt_async, mesh=mesh)
            t0 = time.perf_counter()
            if mngr.restore(state, topology=current_topology(mesh)) \
                    is not None:
                info = mngr.last_restore_info or {}
                if rec is not None:
                    rec.record_restore(
                        time.perf_counter() - t0, step=state.step,
                        resharded=bool(info.get("topology_changed")))
                # Resumes anchor cross-incident forensics: mark them on
                # the flight recorder even without a recorder.
                if events.enabled():
                    events.instant("train/resume", "train",
                                   {"step": state.step})
                log_fn(f"resumed from step {state.step}"
                       + (" (resharded)" if info.get("topology_changed")
                          else ""))
        it = iter(batches)
        if state.step:
            # Skip the batches already trained on, eagerly, so the
            # replay is charged to restore and not to the first step's
            # data wait.
            t0 = time.perf_counter()
            skipped = sum(1 for _ in itertools.islice(it, state.step))
            if rec is not None:
                rec.record_fast_forward(time.perf_counter() - t0,
                                        batches=skipped)
        prepare = after_first = None
        if on_mesh:
            prepare = functools.partial(
                shard_batch, mesh=mesh,
                sequence_parallel=bool(cfg.sequence_parallel))
        if (dcn_overlap is not None and on_mesh
                and mesh.axis_size(dcn_overlap.axis) > 1):
            def after_first(local):
                _dcn_calibrate(cfg, mesh, dcn_overlap, state, local, rec,
                               log_fn)
        step_fn = make_train_step(cfg, state.optimizer, mesh=mesh,
                                  dcn_overlap=dcn_overlap, state=state)
        with maybe_profile():
            state, metrics = _run_steps(
                state, it, step_fn, cfg=cfg,
                max_steps=max_steps, log_every=log_every, log_fn=log_fn,
                recorder=rec, context="fit/step", mngr=mngr,
                ckpt_async=ckpt_async, fabric_sweeps=True, prepare=prepare,
                after_first=after_first)
        if mngr is not None:
            # An in-flight async save must land before latest_step can
            # say whether the last step still needs saving, and the last
            # save before fit returns. The run waits for each, so the
            # waits are charged to ckpt_async.
            _join_async_save(mngr, rec, state.step)
            if mngr.latest_step() != state.step:
                ts = time.perf_counter()
                mngr.save(state.step, state, force=True, cfg=cfg)
                if rec is not None:
                    rec.record_checkpoint_save(time.perf_counter() - ts,
                                               async_mode=ckpt_async)
            _join_async_save(mngr, rec, state.step)
    finally:
        if mngr is not None:
            mngr.close()
        if rec is not None:
            rec.goodput()
        if exporter is not None:
            exporter.stop()
        if watchdog is not None:
            watchdog.stop()
        if own_rec and rec is not None:
            rec.close()
    return state, metrics


def _quiet(*_args, **_kw) -> None:
    """log_fn of the ranks other than 0."""


def _dcn_calibrate(cfg, mesh: Mesh, dcn, state: TrainState, local: dict,
                   rec, log_fn) -> None:
    """The one-shot attribution after the first step, on every rank (its
    probes hold dp collectives). Advisory: a failed calibration is
    logged and training carries on."""
    with annotate("train/dcn_calibrate"):
        try:
            attr = make_dcn_probes(cfg, mesh, dcn, state.model, local,
                                   ef=state.dcn_ef).calibrate()
        except Exception as e:
            log_fn(f"dcn attribution calibration failed: {e}")
            return
    log_fn(f"dcn overlap: {attr['overlap_fraction']:.0%} overlapped, "
           f"{attr['n_buckets']} buckets, busBW "
           f"{attr['busbw_bytes_per_second'] / 1e9:.2f} GB/s")
    if rec is not None:
        rec.record_dcn_attribution(attr)
    from container_engine_accelerators_tpu_torch.metrics import (
        fabric_health,
    )
    mon = fabric_health.get_active()
    if mon is not None:
        # The training traffic's busBW beside the active probes'.
        mon.observe_passive(dcn.axis, attr["busbw_bytes_per_second"])


@torch.no_grad()
def evaluate(model: llama.Llama, cfg: llama.LlamaConfig,
             batches: Iterator) -> dict:
    """Average next-token loss and perplexity over an eval stream,
    through loss_fn on the model's device (flash attention's forward on
    the card). Reads the loss back once a batch."""
    total, count = 0.0, 0
    for batch in batches:
        with introspection.oom_forensics("eval/step"):
            total += loss_fn(model, to_device(batch, model.device),
                             cfg).item()
        count += 1
    mean = total / max(count, 1)
    return {"eval_loss": mean, "perplexity": math.exp(min(mean, 30.0)),
            "batches": count}
