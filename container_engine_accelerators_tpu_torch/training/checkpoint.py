"""Checkpoint and resume for training: the JAX package's
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

A state sharded over a mesh's fsdp axis (training/train.py on several
ranks) is saved as one pair of files a shard,
`model-<i>-of-<n>.safetensors` and `optimizer-<i>-of-<n>.safetensors`,
by the ranks at dp and sp coordinate 0: shard i holds fsdp rank i's
block of each sharded tensor, and shard 0 also the replicated ones
(the norms). meta.json records `fsdp_shards` n. Every step's meta also
records the topology it was saved under (`current_topology`: processes,
devices, mesh axes).

A step is written into `<dir>/<step>.tmp-<pid>-<n>`, every file and
directory fsynced, then renamed into place and the directory fsynced:
a crash leaves either the whole step or none of it (the tmp dir, swept
by the next manager). On several ranks the save is collective: every
rank calls it at the same step, rank 0 names the tmp dir, each writer
writes its shards there, and after every rank has reported its files
rank 0 alone writes the meta and commits by the rename. Restore reads
any topology's shards into the current mesh's blocks (a checkpoint
saved at fsdp 2 restores bit for bit at fsdp 1, and back) and reports
`topology_changed` in last_restore_info. Restore of the newest step
falls back to the one before when the newest is torn or unreadable, and
rank 0 alone moves the torn one aside (`<step>.corrupt`). In-process,
saving into one directory is single-writer. A sync save streams each
tensor to the file through one small pinned staging buffer; async mode
(one rank) snapshots the state into pinned host buffers on the step
path and writes them on a background thread, at most one save in
flight.

Left out: the relayout of the circular pipeline's interleaved layer
order (it waits for parallel/pipeline.py; a checkpoint that records it
raises) and the elastic pre-restart hook (training/elastic.py).
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
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.metrics import events
from container_engine_accelerators_tpu_torch.parallel import sharding
from container_engine_accelerators_tpu_torch.utils import safetensors

log = logging.getLogger(__name__)

FORMAT_VERSION = 1
STATE_DIR = "state"
MODEL_FILE, OPTIMIZER_FILE, META_FILE = (
    "model.safetensors", "optimizer.safetensors", "meta.json")
_TMP_RE = re.compile(r"^\d+\.tmp-")
_tmp_ids = itertools.count()


PIPELINE_TODO = ("this checkpoint stores its layers in the circular "
                 "pipeline's interleaved order; relaying them out waits "
                 "for parallel/pipeline.py (ROADMAP item 12's remainder: "
                 "training tp and pp with parallel/pipeline.py)")


def shard_files(i: int, n: int) -> tuple[str, str]:
    """The model and optimizer files of fsdp shard i of n."""
    return (f"model-{i}-of-{n}.safetensors",
            f"optimizer-{i}-of-{n}.safetensors")


def current_topology(mesh=None) -> dict:
    """The topology tag every save records: the job's processes and
    devices (one a process here) and, with a mesh, its axis sizes."""
    procs = dist.get_world_size() if dist.is_initialized() else 1
    t = {"processes": procs, "devices": procs}
    if mesh is not None:
        t["axes"] = {name: int(size) for name, size in mesh.shape.items()}
        t["devices"] = int(mesh.size)
    return t


def topology_changed(saved: dict | None, current: dict | None) -> bool:
    """True when a checkpoint written under `saved` restores into a run
    shaped `current`; a missing tag makes no claim."""
    if not saved or not current:
        return False
    keys = ("processes", "devices", "axes")
    return any(saved.get(k) != current.get(k) for k in keys
               if k in saved and k in current)


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


def _fsdp_entry(spec: tuple) -> int:
    """The dim of `spec` that fsdp shards (whatever the mesh's size)."""
    for dim, entry in enumerate(spec):
        if entry == "fsdp" or (isinstance(entry, tuple) and "fsdp" in entry):
            return dim
    raise ValueError(f"spec {spec} has no fsdp dim")


def _saved_shape(pieces: list, spec: tuple) -> list:
    """The global shape a saved tensor's shards assemble to."""
    shape = list(pieces[0][1]["shape"])
    if len(pieces) > 1:
        dim = _fsdp_entry(spec)
        shape[dim] = sum(info["shape"][dim] for _, info, _ in pieces)
    return shape


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
                 max_to_keep: int = 3, async_save: bool = False,
                 mesh=None, process_index: int | None = None):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._mesh = mesh
        if process_index is None:
            process_index = (mesh.rank if mesh is not None
                             else dist.get_rank() if dist.is_initialized()
                             else 0)
        self._rank = process_index
        self._sharded = mesh is not None and mesh.size > 1
        if self._sharded and async_save:
            raise NotImplementedError(
                "async saves of a state sharded over several ranks are "
                "not ported yet; save synchronously")
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
        if self._rank == 0:
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
             cfg=None, topology: dict | None = None) -> bool:
        """Save `state` (training/train.TrainState) as `step` when the
        interval (or `force`) says so; returns whether it saved (async:
        whether a write was launched). `cfg` (a LlamaConfig) is recorded
        as JSON, so the checkpoint is self-describing for
        load_serving_params; `topology` (default current_topology of the
        manager's mesh) as the tag a restore compares. On several ranks
        every rank calls it at the same step (the module docstring)."""
        meta = self._meta(step, state, cfg, topology)
        if self.async_save:
            return self._save_async(step, state, force, meta)
        if not self.should_save(step, force):
            return False
        self._acquire_inflight()
        try:
            # Nothing runs on the state while a sync save writes, so the
            # live tensors are written as they are (a card tensor through
            # safetensors.write's pinned staging chunk).
            if self._sharded:
                self._commit_sharded(step, state, meta)
            else:
                self._commit(step, state_tensors(state), meta, 0.0)
        finally:
            self._release_inflight()
        return True

    def saved_topology(self, step: int) -> dict | None:
        """The topology tag a committed step was saved under."""
        return read_meta(os.path.join(self._dir, str(step))).get(
            "topology")

    def _commit_sharded(self, step: int, state, meta: dict) -> None:
        """The collective save (the module docstring): rank 0 names the
        tmp dir, the writers (dp and sp coordinate 0) write their shard
        files, every rank reports, and rank 0 commits or, when any rank
        failed, removes the tmp dir; every rank raises on a failure."""
        mesh = self._mesh
        n, i = mesh.axis_size("fsdp"), mesh.coord["fsdp"]
        name = [None]
        if self._rank == 0:
            name[0] = os.path.join(
                self._dir, f"{step}.tmp-{os.getpid()}-{next(_tmp_ids)}")
            os.makedirs(os.path.join(name[0], STATE_DIR))
        dist.broadcast_object_list(name, src=0)
        tmp = name[0]
        state_dir = os.path.join(tmp, STATE_DIR)
        writer = all(c == 0 for axis, c in mesh.coord.items()
                     if axis != "fsdp")
        t0 = time.perf_counter()
        report = {"ok": True, "files": {}, "values": {}}
        try:
            if writer:
                is_moe = bool(state.model.cfg.n_experts)
                for fname, tensors in zip(shard_files(i, n),
                                          state_tensors(state).values()):
                    keep = {}
                    for key, value in tensors.items():
                        if not isinstance(value, torch.Tensor):
                            if i == 0:
                                report["values"][key] = value
                            continue
                        spec = sharding.param_spec(
                            key.partition("/")[0], is_moe)
                        if i == 0 or sharding.fsdp_dim(spec, mesh) \
                                is not None:
                            keep[key] = value
                    report["files"][fname] = _write_file(
                        os.path.join(state_dir, fname),
                        lambda f, t=keep: safetensors.write(f, t))
        except Exception as e:  # reported to every rank below
            report = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        reports = [None] * dist.get_world_size()
        dist.all_gather_object(reports, report)
        errors = [r["error"] for r in reports if not r["ok"]]
        landed = [False]
        if self._rank == 0:
            if errors:
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                files = {k: v for r in reports for k, v in r["files"].items()}
                values = {k: v for r in reports
                          for k, v in r["values"].items()}
                self._finish_commit(step, tmp, dict(
                    meta, files=files, optimizer_values=values,
                    fsdp_shards=n), t0)
                landed[0] = True
        dist.broadcast_object_list(landed, src=0)
        if errors or not landed[0]:
            raise RuntimeError(f"checkpoint step {step} was not saved: "
                               f"{errors or 'rank 0 failed to commit'}")

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

    def _meta(self, step: int, state, cfg, topology: dict | None) -> dict:
        meta = {"format": FORMAT_VERSION, "step": int(step),
                "tokens": int(state.tokens),
                "optimizer_count": getattr(state.optimizer, "count", None),
                "cfg": None,
                # Depth order: the circular pipeline's interleaved order
                # (state_layer_layout in the JAX package) waits for
                # parallel/pipeline.py, and pp > 1 raises before a save.
                "layout": {"interleaved": False},
                "topology": (topology if topology is not None
                             else current_topology(self._mesh))}
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
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._finish_commit(step, tmp, meta, t0, snapshot_s)

    def _finish_commit(self, step: int, tmp: str, meta: dict, t0: float,
                       snapshot_s: float = 0.0) -> None:
        """Write the meta into a tmp step whose state files are written,
        fsync, rename it into place, fsync the parent, drop old steps."""
        final = os.path.join(self._dir, str(step))
        if os.path.exists(final):
            shutil.rmtree(tmp, ignore_errors=True)
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"in {self._dir}")
        state_dir = os.path.join(tmp, STATE_DIR)
        try:
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

    def _save_async(self, step: int, state, force: bool, meta: dict) -> bool:
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
            args=(step, snap, meta, snapshot_s),
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

    def restore(self, state, step: int | None = None,
                topology: dict | None = None):
        """Load a step into `state` in place (the model's parameters and
        the optimizer's state on the devices they live on, each rank its
        blocks under the state's mesh, the host step and token counts)
        and return it; None when there is no step. last_restore_info
        says whether the step was saved under another topology than
        `topology` (default current_topology of the state's mesh):
        `topology_changed`, `saved_topology`.

        With `step=None` (the newest), a newest step that is torn or
        unreadable is moved aside (`<step>.corrupt`, by rank 0 only) with
        a logged reason and a `ckpt/restore_fallback` instant, and the
        step before it is tried. An explicit `step` fails loudly. Every
        file of a step is checked (its size against the commit's, its
        header against the state) before any tensor of `state` is
        written."""
        self.last_restore_info = None
        candidates = [step] if step is not None else self.all_steps()[::-1]
        if not candidates:
            return None
        mesh = self._mesh if self._mesh is not None else getattr(
            state, "mesh", None)
        if topology is None:
            topology = current_topology(mesh)
        t0 = time.perf_counter()
        for i, s in enumerate(candidates):
            try:
                meta, index = self._check_step(s, state, mesh)
            except NotImplementedError:
                raise
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
                if self._rank == 0:
                    self._quarantine_step(s)
                continue
            self._load_into(state, meta, index, mesh)
            saved = meta.get("topology")
            self.last_restore_info = {
                "step": s, "bytes": sum(meta["files"].values()),
                "seconds": time.perf_counter() - t0,
                "saved_topology": saved,
                "topology_changed": topology_changed(saved, topology)}
            return state
        raise AssertionError("unreachable: every candidate raised")

    def _check_step(self, step: int, state, mesh):
        """(meta, {key: [(path, header info, data offset), ...] by shard})
        of a step whose files hold what was committed and whose tensors
        assemble to the state's global shapes; raises otherwise."""
        step_dir = os.path.join(self._dir, str(step))
        meta = read_meta(step_dir)
        if meta.get("layout", {}).get("interleaved"):
            raise NotImplementedError(PIPELINE_TODO)
        n = meta.get("fsdp_shards", 0)
        names = ([(MODEL_FILE, OPTIMIZER_FILE)] if not n
                 else [shard_files(i, n) for i in range(n)])
        index: dict[str, list] = {}
        for pair in names:
            for fname in pair:
                path = state_file(step_dir, fname, meta)
                header, start = _header(path)
                for key, info in header.items():
                    index.setdefault(key, []).append((path, info, start))
        params = dict(state.model.named_parameters())
        is_moe = bool(state.model.cfg.n_experts)
        for name, p in params.items():
            spec = sharding.param_spec(name, is_moe)
            want = (list(p.shape) if mesh is None else list(
                sharding.global_shape(p.shape, spec, mesh)))
            pieces = index.get(name)
            got = None if pieces is None else _saved_shape(pieces, spec)
            if got != want or any(
                    safetensors.DTYPES[info["dtype"]] != p.dtype
                    for _, info, _ in pieces):
                raise ValueError(f"checkpoint step {step} in {self._dir} "
                                 "does not match the model's parameters "
                                 f"({name}: {got}, want {want})")
        if any(k.rpartition("/")[0] not in params for k in index if "/" in k) \
                or any(k not in params for k in index if "/" not in k):
            raise ValueError(f"checkpoint step {step} in {self._dir} does "
                             "not match the model's parameters")
        return meta, index

    @staticmethod
    @torch.no_grad()
    def _load_into(state, meta: dict, index: dict, mesh) -> None:
        """Each saved tensor assembled from its shards on the host, this
        rank's block of it (under the state's mesh) copied onto the
        device of the parameter it belongs to."""
        params = dict(state.model.named_parameters())
        is_moe = bool(state.model.cfg.n_experts)
        opt = state.optimizer
        opt.state.clear()
        for key, pieces in index.items():
            name, _, field = key.partition("/")
            spec = sharding.param_spec(name, is_moe)
            parts = []
            for path, info, start in pieces:
                with open(path, "rb") as f:
                    parts.append(safetensors.read_tensor(f, info, start))
            t = (parts[0] if len(parts) == 1
                 else torch.cat(parts, dim=_fsdp_entry(spec)))
            if mesh is not None:
                t = sharding.shard_param(t, spec, mesh)
            if not field:
                params[key].copy_(t)
                continue
            opt.state[params[name]][field] = t.to(
                params[name].device).clone()
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
