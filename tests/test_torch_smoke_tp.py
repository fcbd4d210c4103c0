"""chip_smoke.py's tp phase rehearsed on the CPU at a small size: the
ranks placed on the CPU (gloo), a narrow 2-layer model in place of
llama3_8b, the card's kernel entries counted on their plain versions,
and the CLI processes started with --device cpu on its HF export."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from container_engine_accelerators_tpu_torch.models import llama
from container_engine_accelerators_tpu_torch.utils import hbm_plan
from tests.torch_smoke_fixtures import (  # noqa: F401
    counted_kernels,
    two_torch_threads,
)

ENGINES = ("window", "continuous", "paged", "int8_weights", "int8_kv")


@pytest.fixture
def small_tp(counted_kernels, monkeypatch):
    free = [1 << 30]

    def mem_get_info(*a):
        free[0] += 1       # the card's memory comes back after the kill
        return free[0], 80 << 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(hbm_plan, "plan_serving", functools.partial(
        hbm_plan.plan_serving, hbm_bytes=80e9, chip="cpu"))
    toy = dict(vocab_size=512, d_model=256, n_heads=2, n_kv_heads=2,
               d_ff=256, max_seq_len=2048)
    monkeypatch.setattr(llama, "llama3_8b", lambda **kw: llama.LlamaConfig(
        **{**toy, "n_layers": 2, **kw}))
    for name, value in (("TP_DEVICE", "cpu"), ("TP_LAYERS", 2),
                        ("TP_PROMPT_LENS", (128, 128, 128, 128, 256, 256)),
                        ("TP_NEW_TOKENS", 6), ("TP_MOE_LAYERS", 2),
                        ("TP_CHECK_CHUNK", 128)):
        monkeypatch.setattr(chip_smoke, name, value)
    # The phase forms its own group: a default group an earlier file's
    # fabric monitor left in this worker process goes first.
    if dist.is_initialized():
        dist.destroy_process_group()


def test_tp_phase_report_holds_its_checks(small_tp, capsys,
                                          two_torch_threads):
    res = chip_smoke.tp_phase(torch, torch.device("cpu"), np)
    assert res["group"]["backend"] == "gloo" and res["group"]["tp"] == 2
    assert all(r is True for c in res["probe"]["results"].values()
               for r in c.values())
    assert len(res["kernel_checks"]) == 2
    assert set(res["engines"]) == set(ENGINES)
    for name, run in res["engines"].items():
        assert run["rows"] == 6 and run["tokens_per_s"] > 0, name
    # The followers' launches count: every engine ran a kernel entry.
    assert res["launches"]["decode_attention"] > 0
    assert res["launches"]["paged_decode_attention"] > 0
    assert res["launches"]["int8_matmul"] > 0
    cli = res["serve_cli"]
    assert cli["state_tp"]["backend"] == "gloo"
    assert cli["kill"]["server_exit_code"] == 3
    assert cli["kill"]["server_exit_s"] <= chip_smoke.TP_KILL_WITHIN_S
    assert res["tick"]["tp2"]["collectives_a_tick"] == 2 * 2 + 1
    # D and the first step are held to tp 1's own drift.
    assert res["first_step_logits"]["max_abs_diff"] <= res["limit"]["limit"]
    assert res["drift"]["D"] <= res["limit"]["limit"]
    assert res["moe"]["drift"]["R"] <= res["moe"]["limit"]["limit_R"]
    assert res["moe"]["experts_a_rank"] == 4
    assert res["moe"]["routes"]["routings_compared"] > 0
    assert [r["rank"] for r in res["memory"]["ranks"]] == [0, 1]
    out = capsys.readouterr().out
    assert '"phase": "tp_kernel_checks"' in out
