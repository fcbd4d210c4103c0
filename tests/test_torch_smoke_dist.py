"""CPU rehearsal of chip_smoke.py's dist_train phase: the same code at
a head_dim-128 toy size in f32 (two gloo rank processes on the CPU,
flash attention's plain versions counted as launches, the CLI with
--device cpu), so a wrong path, shape or rule shows here before the
card. f32, because the CPU's bf16 embedding backward accumulates in
bf16: a rank holding half the tokens sums its part more exactly than
one rank holding all of them (embed's gradient norm 10% apart at this
size), a difference of the one-rank path that the card does not
share. Then
the mutation check: with a reduce-scatter skipped, a replicated norm
counted on every fsdp rank, or each rank's loss divided by its own
token count, the phase's rule (each rank-vs-one-rank figure within 2x
the gap between two one-rank runs of the same global batch) fails by a
wide margin; the rehearsal prints by how much."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.torch_smoke_fixtures import (  # noqa: F401
    counted_kernels,
    two_torch_threads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SZ = {"preset": "tiny",
      "cfg": dict(n_layers=2, d_model=512, n_heads=4, n_kv_heads=2,
                  d_ff=512, vocab_size=512, max_seq_len=1024,
                  use_flash=True, remat_policy="dots", dtype=torch.float32),
      "batch": 2, "seq": 256, "steps": 3, "sp_batch": 2, "sp_seq": 512,
      "sp_train_modes": ("ring", "ulysses"),
      "bucket_mb": 0.25,
      "cli_args": ["--preset", "tiny", "--steps", "3", "--batch-size", "4",
                   "--seq-len", "32"]}


@pytest.fixture
def rehearsal(monkeypatch, counted_kernels, two_torch_threads):
    monkeypatch.setattr(cs, "DIST_RANK_TARGET",
                        "tests.torch_dist_cases:smoke_dist_rank")
    monkeypatch.setattr(cs, "port_root", lambda: REPO)


def _line(out: str) -> dict:
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith('{"phase": "dist_train"')][-1]


def test_dist_train_phase_rehearses(rehearsal, capsys):
    res = cs.dist_train_phase(torch, torch.device("cpu"), np, sz=SZ,
                              device="cpu", flash_check=False)
    line = _line(capsys.readouterr().out)
    assert line["worst_rule_ratio"] == res["worst_rule_ratio"]
    assert max(res["worst_rule_ratio"].values()) <= 1.0
    assert res["restore"]["bit_identical"]
    assert res["restore"]["reshard_s"] > 0
    assert res["dp"]["int8_bound"]["held"]
    for mode in ("none", "int8"):
        assert res["dp"]["reducers"][mode]["n_buckets"] > 1
    attr = res["dp"]["attribution"]
    assert attr["compress"] == "int8" and attr["n_slices"] == 2
    assert attr["gauges"]["train_dcn_wire_bytes_per_step"] == (
        res["dp"]["reducers"]["int8"]["wire_bytes_per_step"])
    # The dots policy: each layer's K4 twice a step (the backward's
    # recompute), K5 and K6 once, on each rank.
    for r in res["by_rank"]:
        assert r["fsdp_launches_per_step"][0] == {
            "flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert all(res["launches"][k] > 0 for k in cs.FLASH_REPLACES)
    print("dist_train rehearsal worst ratios:", res["worst_rule_ratio"])


@pytest.mark.parametrize("mutate", ["skip_reduce_scatter", "norm_twice",
                                    "local_count"])
def test_mutations_fail_the_rule_by_a_wide_margin(rehearsal, capsys,
                                                  mutate):
    sz = dict(SZ, parts=(), mutate=mutate)
    with pytest.raises(cs.SmokeFailure, match="outside"):
        cs.dist_train_phase(torch, torch.device("cpu"), np, sz=sz,
                            device="cpu", flash_check=False)
    worst = max(_line(capsys.readouterr().out)["worst_rule_ratio"].values())
    with capsys.disabled():
        print(f"\ndist_train mutation {mutate}: worst rule ratio {worst:.3g}"
              " (1 is the limit)")
    assert worst > 10.0
