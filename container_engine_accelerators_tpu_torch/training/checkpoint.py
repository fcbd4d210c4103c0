"""Checkpoint and resume for training on one device: the JAX package's
CheckpointManager without orbax (which imports jax), writing tensors as
raw bytes in the safetensors layout (utils/safetensors.py). torch.save's
zip writer checksums every byte: 0.64-0.85 GB/s into RAM on the card's
host, against a memory copy's rate for raw bytes.

Layout, the JAX package's so that `models/convert.load_model` detects
either kind by the same rule (numeric step directories holding
`state/`):

    <dir>/<step>/state/model.safetensors      the model's f32 masters
    <dir>/<step>/state/optimizer.safetensors  optimizer state, <name>/<key>
    <dir>/<step>/state/meta.json              format, step, tokens,
                                              optimizer count and other
                                              values, config (JSON),
                                              file sizes

A step is written into `<dir>/<step>.tmp-<pid>-<n>`, every file and
directory fsynced, then renamed into place and the directory fsynced:
a crash leaves either the whole step or none of it (the tmp dir, swept
by the next manager). Restore of the newest step falls back to the one
before when the newest is torn or unreadable, and moves the torn one
aside (`<step>.corrupt`). A sync save streams each tensor to the file
through one small pinned staging buffer; async mode snapshots the state
into pinned host buffers on the step path and writes them on a
background thread, at most one save in flight.

Left out (ROADMAP slice 10): the topology tag and the relayout or
reshard of a saved state, the elastic pre-restart hook and the
multi-process collective save.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import shutil
import threading
import time

import torch

from container_engine_accelerators_tpu_torch.metrics import events
from container_engine_accelerators_tpu_torch.utils import safetensors

log = logging.getLogger(__name__)

FORMAT_VERSION = 1
STATE_DIR = "state"
MODEL_FILE, OPTIMIZER_FILE, META_FILE = (
    "model.safetensors", "optimizer.safetensors", "meta.json")
_TMP_RE = re.compile(r"^\d+\.tmp-")
_tmp_ids = itertools.count()


def _fsync_dir(path: str) -> None:
    """fsync a directory: a rename lives in the directory's metadata, and
    without this a host loss right after the commit can bring back the
    pre-rename state. Best-effort on filesystems that refuse O_RDONLY on
    directories."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        log.debug("directory fsync failed for %s", path, exc_info=True)
    finally:
        os.close(fd)


def _write_file(path: str, write) -> int:
    """`write(f)` into `path`, flushed and fsynced; returns its bytes."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path)


def step_dirs(directory: str) -> list[int]:
    """The committed steps under `directory`, oldest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names if n.isdigit() and os.path.isdir(
        os.path.join(directory, n, STATE_DIR)))


def state_tensors(state) -> dict[str, dict]:
    """The saved tensors of a TrainState: the model's parameters by name,
    and each parameter's optimizer state as `<name>/<key>`."""
    named = list(state.model.named_parameters())
    names = {id(p): name for name, p in named}
    opt = {}
    for p, st in state.optimizer.state.items():
        for key, value in st.items():
            opt[f"{names[id(p)]}/{key}"] = value
    return {MODEL_FILE: {name: p.detach() for name, p in named},
            OPTIMIZER_FILE: opt}


def read_meta(step_dir: str) -> dict:
    with open(os.path.join(step_dir, STATE_DIR, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"{step_dir}: checkpoint format "
                         f"{meta.get('format')!r}, want {FORMAT_VERSION}")
    return meta


def state_file(step_dir: str, name: str, meta: dict) -> str:
    """The path of one state file, after its size is held against the
    size recorded at commit (a truncated or grown file is torn)."""
    path = os.path.join(step_dir, STATE_DIR, name)
    size = os.path.getsize(path)
    if size != meta["files"][name]:
        raise ValueError(f"{path}: {size} bytes, {meta['files'][name]} "
                         "recorded at commit (torn)")
    return path


def _header(path: str) -> tuple[dict, int]:
    with open(path, "rb") as f:
        return safetensors.read_header(f)


class CheckpointManager:
    """Save every N steps, keep the last K, restore the newest.

    In-process single writer per directory: two concurrent saves into
    one directory (two managers, or two threads on one) raise instead of
    interleaving step dirs. Leaked tmp dirs of a killed writer are swept
    when the manager is built, before it returns.

    `async_save=True`: a `save` that is due copies the state into
    pinned host buffers on the step path and a background thread
    serializes, fsyncs and commits it. A step that is not due returns at
    once; a due one first joins the previous write, so at most one
    snapshot is ever held. The caller's timed region around `save` is
    the step-path stall (the `ckpt_async` goodput bucket): the snapshot,
    plus whatever of the previous write the steps between did not
    cover."""

    _inflight_lock = threading.Lock()
    _inflight: dict[str, int] = {}

    def __init__(self, directory: str, save_interval_steps: int = 100,
                 max_to_keep: int = 3, async_save: bool = False):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._save_interval = max(1, int(save_interval_steps))
        self._max_to_keep = max_to_keep
        self.async_save = bool(async_save)
        self._async_thread: threading.Thread | None = None
        self._async_step: int | None = None
        self._async_error: Exception | None = None
        self._pinned: dict[tuple[str, str], torch.Tensor] = {}
        # {"step", "bytes", "snapshot_s", "write_s"} of the last commit
        # (snapshot_s 0 for a sync save, which copies as it writes),
        # {"step", "bytes", "seconds"} of the last restore.
        self.last_save_info: dict | None = None
        self.last_restore_info: dict | None = None
        self._sweep_tmp_dirs()

    def _sweep_tmp_dirs(self) -> None:
        swept = False
        for name in os.listdir(self._dir):
            if _TMP_RE.match(name):
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)
                log.warning("swept leaked checkpoint tmp dir %s", name)
                swept = True
        if swept:
            _fsync_dir(self._dir)

    def all_steps(self) -> list[int]:
        return step_dirs(self._dir)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int, force: bool = False) -> bool:
        """Every `save_interval_steps`-th step past the newest saved one
        (an async save in flight counts as saved), or any step with
        `force`. Never waits for an async save."""
        if force:
            return True
        if step % self._save_interval:
            return False
        pending = (self._async_step if self._async_thread is not None
                   else None)
        latest = max((s for s in (self.latest_step(), pending)
                      if s is not None), default=None)
        return latest is None or step > latest

    # ---------- save ----------

    def save(self, step: int, state, force: bool = False,
             cfg=None) -> bool:
        """Save `state` (training/train.TrainState) as `step` when the
        interval (or `force`) says so; returns whether it saved (async:
        whether a write was launched). `cfg` (a LlamaConfig) is recorded
        as JSON, so the checkpoint is self-describing for
        load_serving_params."""
        if self.async_save:
            return self._save_async(step, state, force, cfg)
        if not self.should_save(step, force):
            return False
        self._acquire_inflight()
        try:
            # Nothing runs on the state while a sync save writes, so the
            # live tensors are written as they are (a card tensor through
            # safetensors.write's pinned staging chunk).
            self._commit(step, state_tensors(state),
                         self._meta(step, state, cfg), 0.0)
        finally:
            self._release_inflight()
        return True

    def _acquire_inflight(self) -> None:
        with CheckpointManager._inflight_lock:
            if CheckpointManager._inflight.get(self._dir) is not None:
                raise RuntimeError(
                    f"concurrent checkpoint save into {self._dir} "
                    "(another save is in flight in this process): the "
                    "save path is single-writer per directory")
            CheckpointManager._inflight[self._dir] = id(self)

    def _release_inflight(self) -> None:
        with CheckpointManager._inflight_lock:
            CheckpointManager._inflight.pop(self._dir, None)

    @staticmethod
    def _meta(step: int, state, cfg) -> dict:
        meta = {"format": FORMAT_VERSION, "step": int(step),
                "tokens": int(state.tokens),
                "optimizer_count": getattr(state.optimizer, "count", None),
                "cfg": None}
        if cfg is not None:
            from container_engine_accelerators_tpu_torch.models.llama import (
                cfg_to_json_dict,
            )
            meta["cfg"] = cfg_to_json_dict(cfg)
        return meta

    def _snapshot(self, state) -> dict[str, dict]:
        """Host copies of every saved tensor for an async write, in
        buffers this manager owns and reuses until `close` (pinned for
        card tensors, so the copies run at the link's rate). The training
        step updates the live tensors in place, so a writer behind it
        needs copies that nothing else touches."""
        snap: dict[str, dict] = {}
        on_card = False
        for fname, tensors in state_tensors(state).items():
            out = {}
            for key, t in tensors.items():
                if not isinstance(t, torch.Tensor):
                    out[key] = t
                    continue
                buf = self._pinned.get((fname, key))
                if buf is None or buf.shape != t.shape \
                        or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=t.is_cuda)
                    self._pinned[(fname, key)] = buf
                buf.copy_(t, non_blocking=t.is_cuda)
                on_card |= t.is_cuda
                out[key] = buf
            snap[fname] = out
        if on_card:
            torch.cuda.synchronize()
        return snap

    def _commit(self, step: int, snap: dict, meta: dict,
                snapshot_s: float) -> None:
        """Write a snapshot as `step`: tmp dir, fsync of each file and
        directory, rename, fsync of the parent; then drop the steps past
        max_to_keep. A failure removes the tmp dir and raises, leaving
        no partial step visible."""
        final = os.path.join(self._dir, str(step))
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"in {self._dir}")
        t0 = time.perf_counter()
        tmp = os.path.join(self._dir,
                           f"{step}.tmp-{os.getpid()}-{next(_tmp_ids)}")
        state_dir = os.path.join(tmp, STATE_DIR)
        try:
            os.makedirs(state_dir)
            meta = dict(meta, files={}, optimizer_values={})
            for fname, tensors in snap.items():
                meta["optimizer_values"].update(
                    {k: v for k, v in tensors.items()
                     if not isinstance(v, torch.Tensor)})
                tensors = {k: v for k, v in tensors.items()
                           if isinstance(v, torch.Tensor)}
                meta["files"][fname] = _write_file(
                    os.path.join(state_dir, fname),
                    lambda f, t=tensors: safetensors.write(f, t))
            _write_file(os.path.join(state_dir, META_FILE),
                        lambda f: f.write(json.dumps(meta).encode()))
            _fsync_dir(state_dir)
            _fsync_dir(tmp)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(self._dir)
        self._drop_old_steps()
        self.last_save_info = {
            "step": step, "bytes": sum(meta["files"].values()),
            "snapshot_s": snapshot_s, "write_s": time.perf_counter() - t0}

    def _drop_old_steps(self) -> None:
        steps = self.all_steps()
        for s in steps[:max(len(steps) - self._max_to_keep, 0)]:
            shutil.rmtree(os.path.join(self._dir, str(s)),
                          ignore_errors=True)
        _fsync_dir(self._dir)

    # ---------- async mode ----------

    def _save_async(self, step: int, state, force: bool, cfg) -> bool:
        if not self.should_save(step, force):
            return False
        # The previous save lands before the next snapshot: the
        # single-writer registry and the one-snapshot bound both hang off
        # this join. It costs the step path only what of the previous
        # write the steps since did not cover.
        self._join_previous()
        self._acquire_inflight()
        try:
            t0 = time.perf_counter()
            snap = self._snapshot(state)
            snapshot_s = time.perf_counter() - t0
        except BaseException:
            self._release_inflight()
            raise
        self._async_step = step
        if events.enabled():
            events.instant("ckpt/async_save", "train",
                           {"phase": "start", "step": step})
        self._async_thread = threading.Thread(
            target=self._async_commit,
            args=(step, snap, self._meta(step, state, cfg), snapshot_s),
            daemon=True, name=f"ckpt-async-save-{step}")
        self._async_thread.start()
        return True

    def _async_commit(self, step: int, snap: dict, meta: dict,
                      snapshot_s: float) -> None:
        """Background half of an async save. A failure is recorded for
        the next save to report (the tmp dir is already gone)."""
        try:
            self._commit(step, snap, meta, snapshot_s)
            if events.enabled():
                events.instant("ckpt/async_save", "train",
                               {"phase": "end", "step": step, "ok": True})
        except Exception as e:
            self._async_error = e
            log.exception("async checkpoint save of step %d failed", step)
            if events.enabled():
                events.instant("ckpt/async_save", "train",
                               {"phase": "end", "step": step, "ok": False,
                                "error": str(e)[:200]})
        finally:
            self._release_inflight()

    def _join_previous(self) -> None:
        """Wait for the async save in flight and report its failure."""
        self.wait_async()
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            log.warning("previous async checkpoint save (step %s) failed "
                        "and left no step: %s: %s", self._async_step,
                        type(err).__name__, str(err)[:200])

    def wait_async(self, timeout_s: float | None = None) -> bool:
        """Join the in-flight async save (no-op when none). False only
        on a timeout: the save is then still running."""
        t = self._async_thread
        if t is None:
            return True
        t.join(timeout=timeout_s)
        if t.is_alive():
            return False
        self._async_thread = None
        return True

    @property
    def async_in_flight(self) -> bool:
        t = self._async_thread
        return t is not None and t.is_alive()

    def wait(self) -> None:
        self.wait_async()

    # ---------- restore ----------

    def restore(self, state, step: int | None = None):
        """Load a step into `state` in place (the model's parameters and
        the optimizer's state on the devices they live on, the host step
        and token counts) and return it; None when there is no step.

        With `step=None` (the newest), a newest step that is torn or
        unreadable is moved aside (`<step>.corrupt`) with a logged reason
        and a `ckpt/restore_fallback` instant, and the step before it is
        tried. An explicit `step` fails loudly. Every file of a step is
        checked (its size against the commit's, its header against the
        state) before any tensor of `state` is written."""
        self.last_restore_info = None
        candidates = [step] if step is not None else self.all_steps()[::-1]
        if not candidates:
            return None
        t0 = time.perf_counter()
        for i, s in enumerate(candidates):
            try:
                meta, files = self._check_step(s, state)
            except Exception as e:
                if step is not None or i == len(candidates) - 1:
                    raise
                log.warning("checkpoint step %d in %s is unreadable (%s: "
                            "%s); falling back to step %d", s, self._dir,
                            type(e).__name__, str(e)[:200],
                            candidates[i + 1])
                if events.enabled():
                    events.instant("ckpt/restore_fallback", "train",
                                   {"bad_step": s,
                                    "fallback_step": candidates[i + 1],
                                    "error": str(e)[:200]})
                self._quarantine_step(s)
                continue
            self._load_into(state, meta, files)
            self.last_restore_info = {
                "step": s, "bytes": sum(meta["files"].values()),
                "seconds": time.perf_counter() - t0}
            return state
        raise AssertionError("unreachable: every candidate raised")

    def _check_step(self, step: int, state):
        """(meta, {file: (path, header, data offset)}) of a step whose
        files hold what was committed and fit `state`; raises
        otherwise."""
        step_dir = os.path.join(self._dir, str(step))
        meta = read_meta(step_dir)
        files = {}
        for fname in (MODEL_FILE, OPTIMIZER_FILE):
            path = state_file(step_dir, fname, meta)
            files[fname] = (path, *_header(path))
        want = {k: (list(v.shape), v.dtype) for k, v in
                state_tensors(state)[MODEL_FILE].items()}
        got = {k: (info["shape"], safetensors.DTYPES[info["dtype"]])
               for k, info in files[MODEL_FILE][1].items()}
        params = dict(state.model.named_parameters())
        if got != want or any(k.rpartition("/")[0] not in params
                              for k in files[OPTIMIZER_FILE][1]):
            raise ValueError(f"checkpoint step {step} in {self._dir} does "
                             "not match the model's parameters")
        return meta, files

    @staticmethod
    @torch.no_grad()
    def _load_into(state, meta: dict, files: dict) -> None:
        """Each tensor read into host memory and copied onto the device
        of the parameter it belongs to."""
        params = dict(state.model.named_parameters())
        opt = state.optimizer
        opt.state.clear()
        for fname, (path, header, start) in files.items():
            with open(path, "rb") as f:
                for key, info in header.items():
                    t = safetensors.read_tensor(f, info, start)
                    if fname == MODEL_FILE:
                        params[key].copy_(t)
                        continue
                    name, _, field = key.rpartition("/")
                    opt.state[params[name]][field] = t.to(
                        params[name].device)
        for key, value in meta.get("optimizer_values", {}).items():
            name, _, field = key.rpartition("/")
            opt.state[params[name]][field] = value
        if meta.get("optimizer_count") is not None:
            opt.count = meta["optimizer_count"]
        state.step = meta["step"]
        state.tokens = meta["tokens"]

    def _quarantine_step(self, step: int) -> None:
        """Move a torn step out of the numeric namespace: the resumed run
        saves this step again. It stays on disk as evidence."""
        src = os.path.join(self._dir, str(step))
        dst = os.path.join(self._dir, f"{step}.corrupt")
        i = 0
        while os.path.exists(dst):
            i += 1
            dst = os.path.join(self._dir, f"{step}.corrupt.{i}")
        try:
            os.rename(src, dst)
            _fsync_dir(self._dir)
            log.warning("quarantined torn checkpoint step %d -> %s",
                        step, dst)
        except OSError:
            log.exception("could not quarantine torn checkpoint %s", src)

    def close(self) -> None:
        self._join_previous()
        self._pinned = {}


def serving_state_file(directory: str, step: int | None = None):
    """(the model's state file, cfg) of a training checkpoint's step (the
    newest by default), for inference: the file holds the f32 masters
    under Llama.named_parameters() names, and the LlamaConfig is the
    one recorded with them. Needs a checkpoint saved with a config
    (CheckpointManager.save(..., cfg=cfg))."""
    from container_engine_accelerators_tpu_torch.models.llama import (
        cfg_from_json_dict,
    )

    directory = os.path.abspath(directory)
    if step is None:
        steps = step_dirs(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps in {directory}")
        step = steps[-1]
    step_dir = os.path.join(directory, str(step))
    meta = read_meta(step_dir)
    if not meta.get("cfg"):
        raise ValueError(
            f"checkpoint step {step} in {directory} has no cfg record; "
            "re-save with CheckpointManager.save(..., cfg=cfg) or serve "
            "from an HF export")
    return (state_file(step_dir, MODEL_FILE, meta),
            cfg_from_json_dict(meta["cfg"]))


def load_serving_params(directory: str, step: int | None = None):
    """(weights, cfg) from a training checkpoint for inference: the
    model's f32 masters as {name: CPU tensor} and the LlamaConfig
    recorded with them (serving_state_file). The optimizer's state is
    never read."""
    path, cfg = serving_state_file(directory, step)
    return safetensors.read(path), cfg
