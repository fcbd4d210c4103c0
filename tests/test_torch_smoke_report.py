"""chip_smoke.py's report of which decode-attention body a K1/K3 call
runs, and that body's registers and spill bytes, read from ptxas's -v
output in the kernel library's build log. The card runs of the smoke
gate on these numbers (the prefill body must not spill), so the report
is held here against a build log written in ptxas's format, with every
instantiation of both bodies in it."""

import itertools
import json
import os
import subprocess
import sys
import threading

import pytest

import chip_smoke
from container_engine_accelerators_tpu_torch import kernels

BODIES = ("decode_split_kernel", "prefill_mma_kernel")
PAYLOADS = ("Bf16", "Int8", "Int4")
KEYS = ("Contiguous", "Paged")
HEAD_DIMS = (32, 64, 128)


def _mangled(body: str, payload: str, d: int, keys: str) -> str:
    """The Itanium name nvcc gives an instantiation in the file's
    anonymous namespace."""
    ns = "_GLOBAL__N__51b7076f_19_decode_attention_cu_95940b72"
    return (f"_ZN{len(ns)}{ns}{len(body)}{body}INS_{len(payload) + 7}"
            f"{payload}PayloadELi{d}ENS_{len(keys) + 4}{keys}KeysEEEvPK13"
            "__nv_bfloat16PKvS6_PKfS8_PKiPS0_iiiifS2_")


def _build_log(path):
    """A build log with every instantiation, each with its own register
    count and, but for head_dim 128, spill bytes; returns the counts."""
    counts, lines = {}, ["== decode_attention.cu (rc 0)"]
    for i, (body, payload, d, keys) in enumerate(itertools.product(
            BODIES, PAYLOADS, HEAD_DIMS, KEYS)):
        name = _mangled(body, payload, d, keys)
        regs, spill = 64 + i, 0 if d == 128 else 8 * (i + 1)
        counts[body, payload, d, keys] = regs
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers, "
            "416 bytes cmem[0]"]
    path.write_text("\n".join(lines) + "\n")
    return counts


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("t,body,splits", [
    (1, "decode_split_kernel", 9),     # 4 rows a KV head: decode
    (2, "prefill_mma_kernel", 1),      # 8 rows: the prefill body
    (512, "prefill_mma_kernel", 1),
])
def test_decode_kernel_info_names_the_body_that_runs(monkeypatch, tmp_path,
                                                     payload, keys, t, body,
                                                     splits):
    log = tmp_path / "libport_kernels-0.log"
    counts = _build_log(log)
    monkeypatch.setattr(kernels, "build_log", lambda: log)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    info = chip_smoke.decode_kernel_info(None, "cuda", payload, keys, t, 8,
                                         32, 8, 2048)
    assert info == {"kernel": body, "splits": splits,
                    "registers": counts[body, payload, 128, keys],
                    "spill_bytes": 0}


def _k2_build_log(path):
    """A build log with every instantiation of kernels/int8_matmul.cu's
    two bodies, each with its own register count; returns the counts."""
    ns = "_GLOBAL__N__783171d2_14_int8_matmul_cu_03ece3dc"
    names = {("int8_wgmma_kernel", 128, "bf16"):
             f"_ZN47{ns}17int8_wgmma_kernelEPK13__nv_bfloat16PKaPKfPS0_PfPiiiii"}
    for nt in (8, 16, 32, 64, 128):
        names["int8_mma_kernel", nt, "bf16"] = (
            f"_ZN47{ns}15int8_mma_kernelILi{nt}E13__nv_bfloat16EEvPKT0_PKaPKf"
            "PS2_PfPiiiiii")
        names["int8_mma_kernel", nt, "f32"] = (
            f"_ZN47{ns}15int8_mma_kernelILi{nt}EfEEvPKT0_PKaPKfPS1_PfPiiiiii")
    counts, lines = {}, ["== int8_matmul.cu (rc 0)"]
    for i, (key, name) in enumerate(sorted(names.items())):
        counts[key] = 90 + i
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads",
            f"ptxas info    : Used {90 + i} registers, used 1 barriers, "
            "128 bytes smem"]
    path.write_text("\n".join(lines) + "\n")
    return counts


@pytest.mark.parametrize("t,d,f,kind,body,tokens,splits", [
    (8, 4096, 14336, "bf16", "int8_mma_kernel", 8, 5),    # decode
    (8, 4096, 1024, "bf16", "int8_mma_kernel", 8, 32),
    (8, 4096, 128256, "f32", "int8_mma_kernel", 8, 1),    # the lm_head
    (16, 4096, 4096, "bf16", "int8_mma_kernel", 16, 16),
    (1024, 4096, 14336, "bf16", "int8_wgmma_kernel", 128, 1),   # prefill
    (1024, 4096, 1024, "bf16", "int8_wgmma_kernel", 128, 4),
    (1024, 4096, 128256, "f32", "int8_mma_kernel", 128, 1),
])
def test_k2_kernel_info_names_the_body_that_runs(monkeypatch, tmp_path, t, d,
                                                 f, kind, body, tokens,
                                                 splits):
    log = tmp_path / "libport_kernels-0.log"
    counts = _k2_build_log(log)
    monkeypatch.setattr(kernels, "build_log", lambda: log)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    info = chip_smoke.k2_kernel_info("cuda", t, d, f, kind)
    assert info == {"kernel": body, "tokens": tokens, "splits": splits,
                    "registers": counts[body, tokens, kind],
                    "spill_bytes": 0, "ptxas_serialized_wgmma": False}


def test_k2_ms_sums_both_bodies_and_the_older_kernels():
    # A prefill runs the wgmma body for bf16 x and the mma.sync body for
    # the f32 lm_head; an older checkout's K2 was int8_matmul_partial and
    # int8_matmul_finish. Every other kernel is left out.
    profile = {"kernels": {
        "(anonymous namespace)::int8_wgmma_kernel(CUtensorMap_st, CUt": 29.5,
        "void (anonymous namespace)::int8_mma_kernel<128, float>(floa": 7.75,
        "void (anonymous namespace)::int8_matmul_partial<__nv_bfloat1": 0.5,
        "void (anonymous namespace)::int8_matmul_finish<__nv_bfloat16": 0.25,
        "nvjet_tst_320x128_64x3_1x4_h_bz_coopB_NNT": 10.0,
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_": 3.0,
    }}
    assert chip_smoke.k2_ms(profile) == 38.0
    assert chip_smoke.k2_ms({"kernels": None}) is None


def _dump(order_by_rid: dict) -> dict:
    events = [{"name": "process_name", "ph": "M"}]
    for rid, names in order_by_rid.items():
        for name in names:
            events.append({"name": name, "cat": "req", "ph": "b",
                           "id": str(rid)})
            events.append({"name": name, "cat": "req", "ph": "e",
                           "id": str(rid)})
        events.append({"name": "request", "cat": "serve", "ph": "b",
                       "id": str(rid)})
    return {"traceEvents": events}


def test_observe_span_check_reads_the_trace_dump():
    # The observe phase's trace check: every traced request's first
    # queue, prefill, prefill_chunk, fetch and stream begins in that
    # order (admission's lookup and allocation spans may come between),
    # and every request traced.
    good = ["req/queue", "req/prefix_lookup", "req/page_alloc",
            "req/prefill", "req/prefill_chunk", "req/prefill_chunk",
            "req/fetch", "req/stream", "req/fetch", "req/stream"]
    assert chip_smoke._spans_in_order(_dump({1: good, 2: good}), 2) == 2
    with pytest.raises(chip_smoke.SmokeFailure, match="out of order"):
        chip_smoke._spans_in_order(
            _dump({1: good, 2: ["req/queue", "req/prefill", "req/fetch",
                                "req/prefill_chunk", "req/stream"]}), 2)
    with pytest.raises(chip_smoke.SmokeFailure, match="out of order"):
        chip_smoke._spans_in_order(_dump({1: good[:-3]}), 1)
    with pytest.raises(chip_smoke.SmokeFailure, match="traced requests"):
        chip_smoke._spans_in_order(_dump({1: good}), 2)


def test_observe_scrape_keys_samples_by_labels():
    text = ('# TYPE serve_requests counter\n'
            'serve_requests_total{outcome="ok"} 64.0\n'
            '# TYPE serve_ttft_seconds histogram\n'
            'serve_ttft_seconds_bucket{le="+Inf"} 64.0\n'
            'serve_ttft_seconds_count 64.0\n'
            'serve_ttft_seconds_sum 12.5\n')
    got = chip_smoke._scrape(text)
    assert got["serve_requests_total{outcome=ok}"] == 64.0
    assert got["serve_ttft_seconds_count"] == 64.0
    assert got["serve_ttft_seconds_bucket{le=+Inf}"] == 64.0


def test_divergence_rule_allows_only_near_ties():
    # The spec and pools phases' token check: each row's first
    # divergence from the plain run must sit at a top-two margin within
    # 2 D; later tokens are not compared (the contexts differ there).
    prompts = [[1, 2], [3, 4], [5, 6]]
    plain = [[1, 2, 7, 8, 9], [3, 4, 7, 8, 9], [5, 6, 7, 8, 9]]
    margins = [[0.5, 0.01, 0.5], [0.5, 0.5, 0.5], [0.03, 0.5, 0.5]]
    got = [[1, 2, 7, 0, 0], [3, 4, 7, 8, 9], [5, 6, 0, 8, 9]]
    rule = chip_smoke.divergence_rule(plain, got, prompts, margins, 0.02,
                                      "t")
    assert rule["divergences"] == 2 and rule["two_D"] == 0.04
    assert rule["diverged_at"] == [{"row": 0, "token": 1, "margin": 0.01},
                                   {"row": 2, "token": 0, "margin": 0.03}]
    with pytest.raises(chip_smoke.SmokeFailure, match="exceeds 2 D"):
        chip_smoke.divergence_rule(plain, got, prompts, margins, 0.01, "t")
    with pytest.raises(chip_smoke.SmokeFailure, match="malformed"):
        chip_smoke.divergence_rule(plain, [[9, 2, 7, 8, 9]] * 3, prompts,
                                   margins, 1.0, "t")


def test_pattern_prompts_repeat_a_seeded_pattern():
    import numpy as np

    from container_engine_accelerators_tpu_torch.models.llama import (
        llama_tiny,
    )

    a = chip_smoke._pattern_prompts(np, llama_tiny(), 3, 4)
    assert a == chip_smoke._pattern_prompts(np, llama_tiny(), 3, 4)
    assert len(a) == 4 and all(len(p) == 128 for p in a)
    assert all(p[16:32] == p[:16] == p[112:] for p in a)
    assert len({tuple(p[:16]) for p in a}) == 4


# ---------- the training phases, rehearsed at llama_tiny size ----------

CKPT_KEYS = {"phase", "model", "n_layers", "params", "batch", "seq",
             "resume_rtol", "uninterrupted_losses", "sync", "async",
             "async_step_path_over_sync", "torn", "ckpt_dir", "launches"}
CKPT_MODE_KEYS = {"bit_identical", "max_param_rel_diff",
                  "last_loss_rel_diff", "last_loss", "steps_on_disk",
                  "step_path_s", "save_call_s", "end_join_s", "saves",
                  "bytes_per_save",
                  "save_gb_per_s", "restore", "restore_gb_per_s", "fit_s",
                  "launches"}
OBSERVE_TRAIN_KEYS = {"phase", "model", "n_layers", "batch", "seq", "steps",
                      "watchdog_threshold_s", "stall_s", "jsonl_step_lines",
                      "heartbeat", "max_train_stalled", "scrapes",
                      "scrape_mfu", "scrape_tokens_per_sec", "recorder_mfu",
                      "wall_clock_mfu", "peak_flops", "summary",
                      "launches"}
EVAL_KEYS = {"phase", "eval_loss", "perplexity", "batches", "weight_dtype",
             "loss_fn", "rel_diff", "rtol", "n_layers", "batch", "seq",
             "seconds", "launches"}
SERVE_CKPT_KEYS = {"phase", "n_layers", "prompt_len", "new_tokens", "bf16",
                   "int8", "cli_generate_equal", "launches"}


@pytest.fixture
def counted_kernels(monkeypatch):
    """The card's entries pointed at their plain versions, each counted
    as a launch, and the card-only calls stubbed: the smoke's training
    phases then run on the CPU as they run on the card."""
    import torch

    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    def counted(name, fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            kernels.count(name)
            return out
        return wrapper

    monkeypatch.setattr(fa, "_route",
                        lambda x, plain: "plain" if plain else "cuda")
    monkeypatch.setitem(fa._FWD, "cuda",
                        counted("flash_fwd", fa.flash_fwd_plain))
    monkeypatch.setitem(fa._BWD_DQ, "cuda",
                        counted("flash_bwd_dq", fa.flash_bwd_dq_plain))
    monkeypatch.setitem(fa._BWD_DKV, "cuda",
                        counted("flash_bwd_dkv", fa.flash_bwd_dkv_plain))
    for name in ("decode_attention", "paged_decode_attention",
                 "int8_matmul"):
        monkeypatch.setattr(decode, name,
                            counted(name, getattr(decode, name)))
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    from container_engine_accelerators_tpu_torch.models import llama
    return llama.llama_tiny(vocab_size=512, d_model=256, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq_len=2048,
                            use_flash=True, remat_policy="dots")


def test_training_phase_reports_hold_their_keys(counted_kernels, tmp_path,
                                                capsys):
    import numpy as np
    import torch

    cfg, dev = counted_kernels, torch.device("cpu")
    ck = chip_smoke.ckpt_phase(torch, dev, np, str(tmp_path), str(tmp_path),
                               cfg, batch=1, seq=256)
    assert set(ck) == CKPT_KEYS
    for mode in ("sync", "async"):
        assert set(ck[mode]) == CKPT_MODE_KEYS, mode
        assert ck[mode]["bit_identical"] and ck[mode]["steps_on_disk"] == [
            4, 6]
    assert ck["torn"]["steps_on_disk"] == ["4", "6", "6.corrupt"]
    assert ck["launches"]["flash_fwd"] > 0
    ob = chip_smoke.observe_train_phase(torch, dev, np, str(tmp_path), cfg,
                                        batch=1, seq=256, threshold_s=0.5,
                                        stall_s=1.5)
    assert set(ob) == OBSERVE_TRAIN_KEYS
    assert ob["heartbeat"] == ["0", "6"] and ob["max_train_stalled"] == 1.0
    assert ob["launches"]["flash_fwd"] == 6 * 2 * cfg.n_layers   # 'dots'
    ev = chip_smoke.eval_phase(torch, dev, np, ck["ckpt_dir"],
                               str(tmp_path), batch=1, seq=256)
    assert set(ev) == EVAL_KEYS and ev["rel_diff"] == 0.0
    sc = chip_smoke.serve_ckpt_phase(torch, dev, np, ck["ckpt_dir"],
                                     n_new=4)
    assert set(sc) == SERVE_CKPT_KEYS
    assert sc["bf16"]["tokens_equal_generate"]
    # The kernels line sums these phases' flash launches and serve_ckpt's
    # K1-K3: each report carries its launches.
    assert all("launches" in r for r in (ck, ob, ev, sc))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == [
        "ckpt", "observe_train", "eval", "serve_ckpt"]


def test_ckpt_room_sweeps_dead_roots_and_checks_shm_and_memory(
        monkeypatch, tmp_path):
    from collections import namedtuple

    usage = namedtuple("usage", "total used free")
    sizes = {}
    monkeypatch.setattr(chip_smoke.shutil, "disk_usage",
                        lambda p: usage(0, 0, sizes[p]))
    shm = tmp_path / "shm"
    shm.mkdir()
    # A root whose smoke is gone is swept; a live one (this process's)
    # and another name stay.
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    for name in (f"chip_smoke_ckpt-{dead.pid}-ab", f"chip_smoke_ckpt-"
                 f"{os.getpid()}-cd", "other"):
        (shm / name).mkdir()
    step2 = 17_842_814_976       # 1.49 B parameters x 12 bytes
    sizes.update({str(tmp_path): 10 ** 12, str(shm): 60 << 30})
    monkeypatch.setattr(chip_smoke, "_mem_available_bytes",
                        lambda: 100 << 30)
    room = chip_smoke.ckpt_room(str(tmp_path), str(shm))
    assert room["n_layers"] == 2 and room["where"] == str(shm)
    assert room["state_bytes"] == step2
    assert room["swept"] == [f"chip_smoke_ckpt-{dead.pid}-ab"]
    assert sorted(os.listdir(shm)) == [
        f"chip_smoke_ckpt-{os.getpid()}-cd", "other"]
    monkeypatch.setattr(chip_smoke, "_mem_available_bytes",
                        lambda: 50 << 30)
    with pytest.raises(chip_smoke.SmokeFailure, match="MemAvailable"):
        chip_smoke.ckpt_room(str(tmp_path), str(shm))
    monkeypatch.setattr(chip_smoke, "_mem_available_bytes",
                        lambda: 100 << 30)
    sizes[str(shm)] = 40 << 30
    with pytest.raises(chip_smoke.SmokeFailure, match="must hold"):
        chip_smoke.ckpt_room(str(tmp_path), str(shm))


def test_step_path_extra_counts_the_steps_a_save_slows():
    # The loop logs each step; a save's cost shows as the gaps and the
    # tail beyond the uninterrupted run's, wherever the save splits it.
    ref = {"logs": [f"step {i} loss 1" for i in range(1, 7)],
           "log_times": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], "end": 6.5}
    run = {"logs": ["step 1 loss 1", "step 2 loss 1", "step 3 loss 1",
                    "step 4 loss 1"],
           "log_times": [10.0, 11.5, 12.5, 16.0], "end": 18.0}
    # gaps +0.5, 0, +2.5; tail 2.0 against 0.5
    assert chip_smoke._step_path_extra(run, ref) == pytest.approx(4.5)
    resumed = {"logs": ["resumed from step 4", "step 5 loss 1",
                        "step 6 loss 1"],
               "log_times": [0.0, 3.0, 4.0], "end": 4.5}
    assert chip_smoke._step_path_extra(resumed, ref) == pytest.approx(0.0)


def test_wall_clock_mfu_skips_the_first_and_the_stalled_step():
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama_tiny,
    )

    cfg = llama_tiny()
    times = [0.0, 1.0, 2.0, 9.0, 10.0]        # step 4 stalled 6 s
    mfu = chip_smoke._wall_mfu(cfg, times, 100, 16, {4}, 1e6)
    assert mfu == pytest.approx(100 * 3 / 3.0 * cfg.train_flops_per_token(16)
                                / 1e6)


NODE_KEYS = {"phase", "nvidia_smi", "nvml", "nodes", "torch_card_minor",
             "trouble", "dev_root", "chip_generation", "registration_s",
             "allocate_ms", "preferred", "allocate", "container", "metrics",
             "flip_s", "health_poll_s", "socket_reregister_s", "kubelet_reregister_s",
             "restarts", "stop_s", "partition_listing", "runtime_ready_rc",
             "host_runtime_ready_rc", "driver_version", "launches"}

# The container of the rehearsal: no device work; the fake card is busy
# while its marker file exists.
NODE_CHILD = r"""
import json, os, sys, time
marker = os.environ["NODE_MARKER"]
open(marker, "w").close()
print(json.dumps({"running": True}), flush=True)
time.sleep(float(sys.argv[2]))
os.remove(marker)
print(json.dumps({"uuid": os.environ["CUDA_VISIBLE_DEVICES"],
                  "device_count": 1, "launches": 3, "iters": 3,
                  "seconds": float(sys.argv[2]), "finite": True,
                  "held_bytes": int(sys.argv[1])}), flush=True)
"""


class ThreadPlugin:
    """chip_smoke.PluginProcess's interface over device_plugin_main.main
    in a thread: stop() stops the manager it built, as SIGTERM does."""

    managers: list = []

    def __init__(self, argv, log_path):
        import logging

        from container_engine_accelerators_tpu_torch.cli import (
            device_plugin_main,
        )

        self.log_path = log_path
        self.handler = logging.FileHandler(log_path)
        self.root = logging.getLogger()
        self.level = self.root.level
        self.root.setLevel(logging.INFO)
        self.root.addHandler(self.handler)
        self.rc = None

        def run():
            self.rc = device_plugin_main.main(argv)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def alive(self):
        return self.thread.is_alive()

    def stop(self, timeout_s):
        self.managers[-1].stop()
        self.thread.join(timeout_s)
        self.root.removeHandler(self.handler)
        self.root.setLevel(self.level)
        self.handler.close()
        return None if self.thread.is_alive() else self.rc

    def log(self):
        with open(self.log_path) as f:
            return f.read()


def test_node_phase_rehearses_its_report_keys(monkeypatch, tmp_path):
    """The node phase on the CPU over a fake /dev, a fake NVML table that
    names one of its two card nodes (the other a node NVML does not
    name, which sends the phase to a dev root of links), the daemon in a
    thread and a container that does no device work: every step and key
    of the card run."""
    import types

    import torch

    from container_engine_accelerators_tpu_torch.cli import (
        device_plugin_main,
    )
    from container_engine_accelerators_tpu_torch.healthcheck import (
        health_checker,
    )
    from container_engine_accelerators_tpu_torch.utils import nvml
    from tests.test_torch_node_metrics import MODEL, FakeCard, FakeNvmlTable

    uuid = "8b6ea3a9-3970-f056-d6e0-96d726a1740f"
    marker = tmp_path / "busy"
    card = FakeCard(7, uuid=f"GPU-{uuid}", used=2 << 20, samples_rc=3,
                    util=lambda: (99, 30) if marker.exists() else (0, 0))
    table = FakeNvmlTable([card])
    monkeypatch.setattr(nvml, "load_library", lambda path=None: table)
    lib = tmp_path / "lib" / "libnvidia-ml.so.580.159.03"
    lib.parent.mkdir()
    lib.touch()
    monkeypatch.setattr(chip_smoke, "loaded_library_path", lambda: str(lib))
    props = types.SimpleNamespace(uuid=uuid, pci_bus_id=0xdb,
                                  pci_domain_id=0, pci_device_id=0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda ordinal: props)

    def gpu_query(fields, which):
        assert which == card.uuid
        return {"utilization.gpu,memory.used": [
            str(card.util()[0]), str(card.used >> 20)],
            "driver_version": ["580.159.03"]}[fields]

    monkeypatch.setattr(chip_smoke, "gpu_query", gpu_query)
    monkeypatch.setattr(chip_smoke, "nvidia_smi_line",
                        lambda: f"{MODEL}, 700.00 W")
    monkeypatch.setattr(chip_smoke, "PluginProcess", ThreadPlugin)

    class Recorded(device_plugin_main.TPUManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            ThreadPlugin.managers.append(self)

    monkeypatch.setattr(device_plugin_main, "TPUManager", Recorded)

    class FastChecker(health_checker.TPUHealthChecker):
        # The daemon's checker polls every 5 s; the rehearsal's every
        # 0.05 s.
        def __init__(self, *a, **k):
            super().__init__(*a, poll_interval=0.05, **k)

    monkeypatch.setattr(health_checker, "TPUHealthChecker", FastChecker)
    monkeypatch.setenv("NODE_MARKER", str(marker))
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidia0", "nvidia7", "nvidiactl", "nvidia-uvm",
                 "nvidia-uvm-tools"):
        (dev / name).touch()
    work = tmp_path / "w"
    work.mkdir()
    result = chip_smoke.node_phase(torch, torch.device("cpu"), str(work),
                                   dev_root=str(dev), child_code=NODE_CHILD,
                                   child_seconds=3.0, child_bytes=1 << 20)
    assert set(result) == NODE_KEYS
    assert result["trouble"] == ["nvidia0"]
    assert result["torch_card_minor"] == 7
    assert result["dev_root"] == str(work / "dev")
    assert [(n["node"], n["in_nvml"], n["torch_card"])
            for n in result["nodes"]] == [("nvidia0", False, False),
                                          ("nvidia7", True, True)]
    assert result["allocate"]["envs"] == {
        "CUDA_VISIBLE_DEVICES": f"GPU-{uuid}",
        "GPU_CHIP_GENERATION": MODEL}
    assert [os.path.basename(p) for p in result["allocate"]["devices"]] == [
        "nvidia7", "nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"]
    assert result["container"]["uuid"] == f"GPU-{uuid}"
    busy, idle = result["metrics"]["busy"], result["metrics"]["idle"]
    assert busy["duty_cycle"] == 99.0 and idle["duty_cycle"] == 0.0
    assert result["health_poll_s"] == 5.0 and result["flip_s"] < 5.0
    assert result["metrics"]["duty_cycle_sources"] == [
        "nvmlDeviceGetUtilizationRates"]
    assert result["restarts"] >= 2
    assert result["driver_version"]["read"] == "580.159.03"
    assert result["runtime_ready_rc"] == 0
    assert result["host_runtime_ready_rc"] == 0   # a plain file opens here
    assert result["launches"] == {"flash_fwd": 3}
    assert ThreadPlugin.managers[-1].devices["nvidia7"].health == "Unhealthy"


def test_node_phase_refuses_to_run_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    proc = subprocess.run([sys.executable, "chip_smoke.py", "node"],
                          cwd=repo, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


DOCTOR_SCENARIOS = {"engine_hang", "worker_kill", "prefill_pool_kill",
                    "hbm_exhaustion_fabricated", "hbm_exhaustion_real",
                    "health_storm", "data_stall", "straggler",
                    "replica_kill"}
DOCTOR_KEYS = {"phase", "model", "n_layers", "fleet", "scenarios", "seconds",
               "launches", "launches_not_counted", "nvidia_smi"}
DOCTOR_RUN_KEYS = {"incidents", "window_s", "clean_warmup_s", "ring_emitted",
                   "ring_dropped", "tap_received", "tap_dropped"}
DOCTOR_TINY = {
    "hang_new_tokens": 256, "kill_new_tokens": 256, "pool_new_tokens": 16,
    "fan_new_tokens": 256, "hbm_step_bytes": 4 << 30, "hbm_step_s": 0.25,
    "fit": {"batch": 1, "seq": 256, "steps": 6}, "stall_s": 2.0,
    "trainer": ["--preset", "tiny", "--batch-size", "2", "--seq-len", "32"],
    "trainer_steps": (30, 2), "watchdog_s": 3.0, "straggler_delay_s": 4.0,
    "fleet_layers": 1, "ready_timeout_s": 240.0}


class FakeCard:
    """An 80 GiB card whose memory the real climb's allocations fill:
    HbmPoller reads it, card_alloc takes from it and raises the CUDA
    out-of-memory error when it is full."""

    limit = 80 << 30

    def __init__(self):
        self.used = 20 << 30

    def stats(self):
        return [{"device": "cuda:0", "bytes_in_use": self.used,
                 "peak_bytes_in_use": self.used, "bytes_limit": self.limit}]

    def alloc(self, torch, dev, n_bytes):
        if self.used + n_bytes > self.limit:
            raise torch.cuda.OutOfMemoryError("fake card full")
        self.used += n_bytes
        card = self

        class Held:
            def __del__(self):
                card.used -= n_bytes

        return Held()


def test_doctor_phase_rehearses_its_report_keys(counted_kernels, monkeypatch,
                                                tmp_path, capsys):
    """The doctor phase on the CPU at llama_tiny size: the in-process
    engines and fit count the plain kernels as launches, a fake card
    takes the real climb, the trainers and the replicas are processes on
    the CPU. Every scenario names what the card run must name."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.metrics.introspection import (  # noqa: E501
        HbmPoller,
    )
    from container_engine_accelerators_tpu_torch.models.llama import (
        init_params,
    )

    card = FakeCard()
    # The trainers and replicas are CPU processes beside this one: two
    # threads each keep them from crowding the host.
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(chip_smoke, "hbm_poller", lambda reg: HbmPoller(
        registry=reg, stats_fn=card.stats, devices=[0]))
    monkeypatch.setattr(chip_smoke, "card_alloc", card.alloc)
    monkeypatch.setattr(chip_smoke, "DOCTOR_HANG_S", 3.0)
    monkeypatch.setattr(chip_smoke, "DOCTOR_HANG_AFTER_S", 1.0)
    monkeypatch.setattr(chip_smoke, "nvidia_smi_line", lambda: "cpu")
    cfg, dev = counted_kernels, torch.device("cpu")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = chip_smoke.doctor_phase(torch, dev, np, str(tmp_path),
                                      model=model, cfg=cfg,
                                      sizes=DOCTOR_TINY, shm=str(tmp_path))
    finally:
        torch.set_num_threads(threads)
    assert set(res) == DOCTOR_KEYS
    sc = res["scenarios"]
    assert set(sc) == DOCTOR_SCENARIOS
    verdicts = {name: [(i["class"], i["subject"]) for i in s["incidents"]]
                for name, s in sc.items()}
    assert verdicts == {
        "engine_hang": [("engine_hang", "serve")], "worker_kill": [],
        "prefill_pool_kill": [],
        "hbm_exhaustion_fabricated": [("oom_precursor", "injected:0")],
        "hbm_exhaustion_real": [("oom_precursor", "cuda:0")],
        "health_storm": [("health_storm", "HBM_ECC_UNCORRECTABLE")],
        "data_stall": [], "straggler": [("straggler", "process-1")],
        "replica_kill": [("replica_down", "r1")]}
    for name in DOCTOR_SCENARIOS - {"straggler", "replica_kill"}:
        assert DOCTOR_RUN_KEYS <= set(sc[name]), name
    real = sc["hbm_exhaustion_real"]
    assert real["projected_tte_s"] > 0 and real["actual_tte_s"] > 0
    assert card.used == 20 << 30                     # the climb freed
    assert sc["replica_kill"]["replayed"] == [
        {"class": "replica_down", "subject": "r1"}]
    assert sc["data_stall"]["stall_step_data_wait_s"] >= 2.0
    assert all(res["launches"].get(k, 0) > 0 for k in (
        "decode_attention", "paged_decode_attention", "flash_fwd",
        "flash_bwd_dq", "flash_bwd_dkv"))
    summary = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"phase": "doctor_summary"')]
    assert set(summary[0]) - {"phase"} == DOCTOR_SCENARIOS
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith(chip_smoke.CKPT_ROOT_PREFIX)]


def test_doctor_phase_refuses_to_run_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    proc = subprocess.run([sys.executable, "chip_smoke.py", "doctor"],
                          cwd=repo, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr
