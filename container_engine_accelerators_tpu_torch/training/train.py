"""The training step and loop on one device: the JAX package's
make_optimizer, loss_fn, make_train_step, train_loop, fit (checkpoint
and resume, the train recorder, its /metrics exporter, heartbeats and
the hang watchdog) and evaluate, without the mesh (ROADMAP slice 10).

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
import torch.nn.functional as F

from container_engine_accelerators_tpu_torch.metrics import (
    events,
    introspection,
)
from container_engine_accelerators_tpu_torch.models import llama
from container_engine_accelerators_tpu_torch.models.convert import (
    resolve_device,
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


def loss_fn(model: llama.Llama, batch: dict, cfg: llama.LlamaConfig,
            plain: bool = False) -> torch.Tensor:
    """Next-token cross entropy in f32, averaged over the targets >= 0
    (negative targets are padding), plus a mixture of experts' router
    aux losses (models/llama.forward's aux; zero for a dense model)."""
    logits, aux = llama.forward(model, batch["inputs"], cfg, plain=plain,
                                return_aux=True)
    targets = batch["targets"].reshape(-1)
    mask = (targets >= 0).float()
    losses = F.cross_entropy(logits.view(-1, logits.shape[-1]),
                             targets.clamp(min=0).long(), reduction="none")
    return (losses * mask).sum() / mask.sum().clamp(min=1.0) + aux


def make_train_step(cfg: llama.LlamaConfig, optimizer: torch.optim.Optimizer,
                    grad_accum: int = 1, plain: bool = False):
    """`step(model, batch) -> metrics`: loss and gradients, one optimizer
    update in place, and {'loss', 'grad_norm', 'tokens'} as device
    scalars (nothing waits for the device).

    `grad_accum > 1` splits the batch's leading dim into that many equal
    microbatches and averages their gradients before the one update.
    `plain=True` runs flash attention's plain versions (the on-card
    reference for the kernels)."""

    def step(model: llama.Llama, batch: dict) -> dict:
        optimizer.zero_grad(set_to_none=True)
        rows = batch["inputs"].shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{grad_accum} microbatches")
        losses = []
        for i in range(grad_accum):
            mb = {key: x.chunk(grad_accum)[i] for key, x in batch.items()}
            loss = loss_fn(model, mb, cfg, plain=plain)
            (loss / grad_accum).backward()
            losses.append(loss.detach())
        optimizer.step()
        grads = [p.grad for p in model.parameters()]
        return {"loss": torch.stack(losses).mean(),
                "grad_norm": grad_norm_metric(optimizer, grads),
                "tokens": (batch["targets"] >= 0).sum()}

    return step


@dataclasses.dataclass
class TrainState:
    step: int                       # optimizer steps taken (host count)
    model: llama.Llama
    optimizer: torch.optim.Optimizer
    tokens: int = 0                 # targets trained on (host count)
    seconds: float = 0.0            # the loop's wall time, to its last fence


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
               fabric_sweeps: bool = False):
    """The host loop shared by train_loop and fit: data wait, step
    dispatch, (checkpoint save), the loss fetch at log boundaries (the
    loop's only wait on the device besides a save), and the recorder's
    step edges; with `cfg`, the recorder's MFU and the saves' config
    record; with `fabric_sweeps` (fit), the fabric monitor's sweeps.
    The data wait, step and save are train/* regions (annotate).
    Returns (state, last metrics)."""
    device = state.model.device
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
                peak_flops_per_chip=detect_peak_flops(device), n_chips=1)
        with annotate("train/step"), introspection.oom_forensics(context):
            metrics = step_fn(state.model, to_device(batch, device))
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
        watchdog_threshold_s: float = 300.0
        ) -> tuple[TrainState, dict | None]:
    """Train on one device with checkpoint and auto-resume: random
    masters from `seed` (init_train_params), `optimizer` (a
    make_optimizer factory) bound to them, then the loop over `batches`
    up to `max_steps`. Runs on the card unless `device` says otherwise;
    asking for CUDA without it raises. Returns (state, last metrics).

    With `ckpt_dir`, the newest checkpoint there is restored onto the
    device (falling back past a torn newest step) and the batch stream
    fast-forwarded by the restored step, so `batches` must be the same
    deterministic stream from step 0 (the package's streams are); a step
    is saved every `save_every` steps and at the end. `ckpt_async`
    moves the write off the step path: the loop pays the pinned
    snapshot and whatever of the previous write the steps since a save
    did not cover (a due save joins it, and so does the end of the
    run), all charged to the `ckpt_async` goodput bucket.

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
    steps its maybe_sweep_step picks."""
    from container_engine_accelerators_tpu_torch.metrics import (
        train_metrics,
    )
    from container_engine_accelerators_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )

    dev = resolve_device(device)
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

        gen = torch.Generator(device=dev).manual_seed(seed)
        model = llama.init_train_params(cfg, gen, dev)
        state = TrainState(step=0, model=model,
                           optimizer=optimizer(model.parameters()))
        if ckpt_dir:
            mngr = CheckpointManager(ckpt_dir,
                                     save_interval_steps=save_every,
                                     async_save=ckpt_async)
            t0 = time.perf_counter()
            if mngr.restore(state) is not None:
                if rec is not None:
                    rec.record_restore(time.perf_counter() - t0,
                                       step=state.step)
                # Resumes anchor cross-incident forensics: mark them on
                # the flight recorder even without a recorder.
                if events.enabled():
                    events.instant("train/resume", "train",
                                   {"step": state.step})
                log_fn(f"resumed from step {state.step}")
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
        with maybe_profile():
            state, metrics = _run_steps(
                state, it, make_train_step(cfg, state.optimizer), cfg=cfg,
                max_steps=max_steps, log_every=log_every, log_fn=log_fn,
                recorder=rec, context="fit/step", mngr=mngr,
                ckpt_async=ckpt_async, fabric_sweeps=True)
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
