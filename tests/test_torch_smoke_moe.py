"""chip_smoke.py's moe phase rehearsed on the CPU at a small size: a
head_dim-128 mixture of experts in place of Llama-3-8B's widths, the
card's kernel entries counted on their plain versions, and the serve
CLI started with --device cpu. Also the divergence rule's routing
flips and how the engines' routings are matched to the plain run's."""

import functools
import json

import numpy as np
import pytest
import torch

import chip_smoke
from container_engine_accelerators_tpu_torch.models import llama
from container_engine_accelerators_tpu_torch.utils import hbm_plan
from tests.torch_smoke_fixtures import (  # noqa: F401
    counted_kernels,
    two_torch_threads,
)

SERVE_KEYS = {"model", "n_layers", "n_experts", "top_k", "params", "init_s",
              "drift",
              "plan_serving", "max_memory_allocated_bytes", "prompt_lens",
              "new_tokens", "reference_s", "engines", "prefill_vs_forward",
              "ffn_paths", "check_launches",
              "tick_wall_ms_8_slots", "tick_busy_ms_8_slots",
              "tick_idle_share", "tick_top_kernels_ms", "tick_launches",
              "ffn_share_of_tick", "prefill_tokens", "prefill_wall_ms",
              "prefill_busy_ms", "prefill_top_kernels_ms",
              "ffn_share_of_prefill", "launches"}
ENGINE_KEYS = {"burst_s", "generated_tokens_per_s", "D", "two_D", "R",
               "two_R", "rows", "divergences", "diverged_at", "routes",
               "launches"}
TRAIN_RUN_KEYS = {"routing", "capacity_factor", "losses", "aux",
                  "dropped_fraction", "step_ms_median_fit", "step_ms",
                  "busy_ms", "busy_share", "top_kernels_ms",
                  "mfu_one_ffn_a_token", "allocated_before_bytes",
                  "max_memory_allocated_bytes", "launches"}


@pytest.fixture
def small_moe(counted_kernels, monkeypatch):
    toy = dict(counted_kernels.__dict__)
    for key in ("n_layers", "n_experts", "moe_top_k", "moe_dropless",
                "remat_policy"):
        toy.pop(key)
    monkeypatch.setattr(llama, "llama3_8b", lambda **kw: llama.LlamaConfig(
        **{**toy, "n_layers": 2, **kw}))
    for name in ("plan_serving", "plan_training"):
        monkeypatch.setattr(hbm_plan, name, functools.partial(
            getattr(hbm_plan, name), hbm_bytes=80e9, chip="cpu"))
    monkeypatch.setattr(chip_smoke, "MOE_SERVE_LAYERS", 2)
    monkeypatch.setattr(chip_smoke, "MOE_PROMPT_LENS", (40, 128, 136, 256))
    monkeypatch.setattr(chip_smoke, "MOE_NEW_TOKENS", 4)
    monkeypatch.setattr(chip_smoke, "MOE_CLI_NEW_TOKENS", 4)
    for name, value in (("MOE_TRAIN_BATCH", 1), ("MOE_TRAIN_SEQ", 256),
                        ("MOE_TRAIN_STEPS", 3)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_moe_phase_report_holds_its_keys(small_moe, capsys,
                                         two_torch_threads):
    res = chip_smoke.moe_phase(torch, torch.device("cpu"), np,
                               serve_flags=("--device", "cpu"))
    serve, train, cli = res["serve"], res["train"], res["cli"]
    assert set(serve) == SERVE_KEYS
    assert set(serve["engines"]) == {"window", "continuous", "paged",
                                     "paged_ngram"}
    for name, run in serve["engines"].items():
        assert ENGINE_KEYS <= set(run), name
        assert run["rows"] == 4
        # Every prompt's routings, at least, were matched and compared.
        assert run["routes"]["routings_compared"] >= 2 * sum(
            chip_smoke.MOE_PROMPT_LENS), name
    assert serve["drift"]["rows"] == 2     # the prompts past 132 tokens
    assert serve["drift"]["positions_measured"] > 0
    fwd = serve["prefill_vs_forward"]
    assert fwd["rows_within"] == fwd["tokens"] == 256
    assert fwd["routings"] == 2 * 256
    assert [row["tokens"] for row in serve["ffn_paths"]] == list(
        chip_smoke.MOE_FFN_TOKENS)
    assert all(row[f"{path}_rel_err"] <= chip_smoke.MOE_FFN_RTOL
               for row in serve["ffn_paths"]
               for path in ("every_expert", "routed"))
    # The reference runs' and checks' launches stay off the kernels line.
    assert serve["check_launches"]["flash_fwd"] > 0
    assert "flash_fwd" not in serve["launches"]
    assert serve["engines"]["paged_ngram"]["spec_ticks"] > 0
    assert serve["launches"]["decode_attention"] > 0
    assert serve["launches"]["paged_decode_attention"] > 0
    for routing in ("dropless", "capacity"):
        assert set(train[routing]) == TRAIN_RUN_KEYS
        assert len(train[routing]["losses"]) == 3
    assert train["dropless"]["dropped_fraction"] == [0.0, 0.0]
    assert train["n_layers"] == 2 and train["cut"] is None
    assert train["launches"]["flash_bwd_dkv"] > 0
    assert cli["int8_exit_code"] == 2
    assert chip_smoke.MOE_INT8_REFUSAL in cli["int8_message"]
    assert cli["rows"] == 2
    assert res["launches"]["decode_attention"] > 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == [
        "moe_serve", "moe_train_plan", "moe_train", "moe_cli", "moe"]
    assert set(res["seconds"]) == {"cli_launch", "serve", "train", "cli"}


def test_divergence_rule_admits_router_near_ties():
    plain = [[1, 2, 3, 4], [1, 2, 3, 4]]
    got = [[1, 2, 3, 9], [1, 2, 5, 4]]
    prompts = [[1, 2], [1, 2]]
    margins = [[0.5, 0.5], [0.5, 0.5]]
    flip = {"position": 1, "layer": 0, "margin": 1e-6}
    rule = chip_smoke.divergence_rule(plain, got, prompts, margins, 0.01,
                                      "t", flips=[[flip], [flip]], r=1e-5)
    assert rule["divergences"] == 2 and rule["two_R"] == 2e-5
    assert rule["diverged_at"][0] == {"row": 0, "token": 1, "margin": 0.5,
                                      "flip": flip}
    # A flip only admits a part after it: row 1 parts at position 2,
    # which a flip at position 2 cannot have moved.
    late = {"position": 2, "layer": 0, "margin": 1e-6}
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="row 1 .* no routing on its path flipped"):
        chip_smoke.divergence_rule(plain, got, prompts, margins, 0.01, "t",
                                   flips=[[flip], [late]], r=1e-5)
    with pytest.raises(chip_smoke.SmokeFailure, match="no routing"):
        chip_smoke.divergence_rule(plain, got, prompts, margins, 0.01, "t",
                                   flips=[[], []], r=1e-5)
    # Without flips, the dense rule is unchanged.
    with pytest.raises(chip_smoke.SmokeFailure, match="exceeds 2 D = 0.02$"):
        chip_smoke.divergence_rule(plain, got, prompts, margins, 0.01, "t")


def _call(positions, tokens, experts, probs, live=None):
    """A route_recorder call: experts [L, B*T, k], probs [L, B*T, E]."""
    b = len(tokens)
    return {"positions": torch.tensor(positions),
            "tokens": torch.tensor(tokens),
            "live": torch.tensor([True] * b if live is None else live),
            "experts": list(torch.tensor(experts)),
            "probs": list(torch.tensor(probs))}


P_AB = [0.5, 0.3, 0.15, 0.05]       # experts 0 and 1, margin 0.15
P_AC = [0.5, 0.15, 0.3, 0.05]       # experts 0 and 2


def test_routes_of_matches_rows_to_requests_by_their_tokens():
    seqs = [[7, 8, 9, 5, 6], [3, 4, 5, 6, 2]]
    calls = [
        # A padded prefill of request 0: the pad token 0 matches nothing.
        _call([[0, 1, 2, 3]], [[7, 8, 9, 0]], [[[0, 1]] * 4],
              [[P_AB] * 4]),
        # One decode tick: request 1 at 3, request 0 at 3, a dead slot.
        _call([[3], [3], [3]], [[6], [5], [5]], [[[1, 0], [2, 0], [0, 1]]],
              [[P_AB, P_AC, P_AB]], live=[True, True, False]),
        # A one-token row inside request 1's prompt is no decode step of
        # it, and a row that fits nothing is left out.
        _call([[1], [2]], [[4], [42]], [[[0, 1], [0, 1]]], [[P_AB, P_AB]]),
    ]
    routes = chip_smoke.routes_of(torch, calls, seqs, [3, 3])
    assert sorted(routes[0]) == [(0, 0), (1, 0), (2, 0), (3, 0)]
    [(experts, margin, probs)] = routes[0][(3, 0)]
    assert experts == (0, 2) and margin == pytest.approx(0.15)
    assert probs == pytest.approx(P_AC)
    assert sorted(routes[1]) == [(3, 0)]
    assert routes[1][(3, 0)][0][0] == (0, 1)
    # By row: row i of every call is request i, whatever its tokens.
    by_row = chip_smoke.routes_of(torch, calls[2:], [[], []], None,
                                  by_row=True)
    assert sorted(by_row[0]) == [(1, 0)] and sorted(by_row[1]) == [(2, 0)]


def test_route_flips_keeps_the_flips_rounding_can_make():
    def rec(experts, margin=0.01, probs=(0.5, 0.3, 0.2)):
        return (experts, margin, list(probs))

    plain = {(p, li): [rec((0, 1))] for p in range(4) for li in range(3)}
    got = {key: [rec((0, 1), probs=(0.5, 0.29, 0.21))] for key in plain}
    got[(1, 1)] = [rec((0, 2), margin=0.002)]     # primary
    got[(2, 2)] = [rec((1, 2), margin=0.4)]       # reached by (1, 1)
    got[(3, 0)] = [rec((0, 2))]                   # past `upto`
    f = chip_smoke.route_flips(plain, got, upto=3)
    assert f["compared"] == 9 and f["flips"] == 2
    assert [(x["position"], x["layer"]) for x in f["primary"]] == [(1, 1)]
    assert f["primary"][0]["margin"] == 0.01
    assert f["primary"][0]["engine_experts"] == [0, 2]
    # (2, 2) and (1, 2) lie above the flip; the rest moved by 0.01.
    assert f["max_prob_gap"] == pytest.approx(0.01)


def test_moe_route_check_refuses_a_flip_rounding_cannot_make():
    cfg = llama.llama_tiny(n_layers=1)
    seqs = [[7, 8, 9, 5]]
    plain = [_call([[0, 1, 2]], [[7, 8, 9]], [[[0, 1]] * 3], [[P_AB] * 3]),
             _call([[3]], [[5]], [[[0, 1]]], [[P_AB]])]
    near = [0.5, 0.2501, 0.2499, 0.0]
    # The same experts everywhere: nothing to hold.
    flips, summary = chip_smoke.moe_route_check(
        torch, cfg, plain, plain, seqs, seqs, [[7, 8, 9]], 1e-3, "t")
    assert flips == [[]] and summary["routings_compared"] == 4
    # A flip at the plain run's margin 0.15 is more than rounding.
    got = [_call([[0, 1, 2]], [[7, 8, 9]], [[[0, 1], [0, 2], [0, 1]]],
                 [[P_AB, P_AC, P_AB]]), plain[1]]
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="position 1 layer 0 to \\[0, 2\\]"):
        chip_smoke.moe_route_check(torch, cfg, plain, got, seqs, seqs,
                                   [[7, 8, 9]], 1e-3, "t")
    # At a margin within 2 R it is a near tie, and it is reported.
    plain[0]["probs"] = list(torch.tensor([[P_AB, near, P_AB]]))
    flips, summary = chip_smoke.moe_route_check(
        torch, cfg, plain, got, seqs, seqs, [[7, 8, 9]], 1e-3, "t")
    assert [f["position"] for f in flips[0]] == [1]
    assert summary["primary_flips"][0]["row"] == 0
    # Routings the engine never showed fail the check.
    with pytest.raises(chip_smoke.SmokeFailure, match="compared"):
        chip_smoke.moe_route_check(torch, cfg, plain, plain[1:], seqs,
                                   seqs, [[7, 8, 9]], 1e-3, "t")
