"""Port of the load generator (cli/loadgen.py) and the trace CLI: the
port's tenant_tokens equals the JAX package's for the same arguments;
the port's loadgen and the JAX package's, each run against the port's
`cli/serve.main` in a process of its own (`--tiny --device cpu --engine
paged --metrics-port 0 --trace-dump DIR`), give summaries with the same
keys; /metrics counts the requests, /debugz?kv=1 serves the thermal
census, `trace dump --pid` makes the server write its ring, and `trace
merge` turns it into one timeline with each sampled request's spans."""

import argparse
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from container_engine_accelerators_tpu.cli import loadgen as jloadgen
from container_engine_accelerators_tpu_torch.cli import loadgen as tloadgen
from container_engine_accelerators_tpu_torch.cli import trace as ttrace_cli

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("tenants,idle,churn,prefix,long_len", [
    (4, 0, 0, 256, 1024), (3, 0, 0, 64, 256), (8, 2, 2, 32, 40),
    (5, 1, 0, 0, 7)])
def test_tenant_tokens_matches_jax(tenants, idle, churn, prefix, long_len):
    args = jloadgen.make_parser().parse_args([
        "--tenants", str(tenants), "--idle-tenants", str(idle),
        "--churn-tenants", str(churn), "--tenant-prefix-len", str(prefix),
        "--long-prompt-len", str(long_len), "--prompt-len", "128"])
    targs = tloadgen.make_parser().parse_args([
        "--tenants", str(tenants), "--idle-tenants", str(idle),
        "--churn-tenants", str(churn), "--tenant-prefix-len", str(prefix),
        "--long-prompt-len", str(long_len), "--prompt-len", "128"])
    assert vars(targs) == vars(args)
    for i in range(3 * tenants + 5):
        assert tloadgen.tenant_tokens(targs, i) == jloadgen.tenant_tokens(
            args, i)
        t = i % tenants
        assert (tloadgen.tenant_class(t, targs)
                == jloadgen.tenant_class(t, args))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _keys(obj, prefix=""):
    """Every key path of a nested dict, tenant and target ids folded."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            k = "*" if prefix.endswith(("tenants.", "targets.")) else k
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture
def server(tmp_path):
    """The port's serve.main in a process of its own; yields (url,
    metrics url, dump dir, process)."""
    port = _free_port()
    dump = tmp_path / "traces"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cli.serve", "--tiny",
         "--device", "cpu", "--engine", "paged", "--port", str(port),
         "--metrics-port", "0", "--metrics-host", "127.0.0.1",
         "--trace-dump", str(dump) + "/", "--trace-sample-rate", "0",
         "--max-batch", "4", "--page-size", "16",
         "--thermal-interval-s", "0.1"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    log, found = [], threading.Event()
    metrics = {}

    def read():
        for line in proc.stderr:
            log.append(line)
            m = re.search(r"request metrics on :(\d+)/metrics", line)
            if m:
                metrics["port"] = int(m.group(1))
            if "(/generate, /healthz)" in line:
                found.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        assert found.wait(120), "".join(log)
        yield (f"http://127.0.0.1:{port}",
               f"http://127.0.0.1:{metrics['port']}", dump, proc)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)


def _args(mod, url):
    return mod.make_parser().parse_args([
        "--url", url, "--requests", "8", "--concurrency", "4",
        "--tenants", "2", "--tenant-prefix-len", "32", "--prompt-len", "8",
        "--long-prompt-len", "24", "--max-new-tokens", "4", "--stream",
        "--trace-sample-rate", "1.0", "--slo-ttft-p99-ms", "60000"])


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def test_loadgen_summary_keys_match_jax_against_the_port(server, tmp_path,
                                                         capsys):
    url, metrics_url, dump, proc = server
    t_summary, t_rc = tloadgen.run(_args(tloadgen, url))
    j_summary, j_rc = jloadgen.run(_args(jloadgen, url))
    assert (t_rc, j_rc) == (0, 0)
    assert t_summary["errors"] == 0 and t_summary["requests_ok"] == 8
    assert _keys(t_summary) == _keys(j_summary)
    assert set(t_summary["tenants"]) == {"0", "1"}

    # The scrape counts both runs' requests; the paged pool's census
    # attributes every page (loadgen tags each request with its tenant).
    text = _get(metrics_url + "/metrics")
    assert re.search(r'serve_requests_total\{outcome="ok"\} 16\.0', text)
    assert re.search(r"serve_ttft_seconds_count 16\.0", text)
    assert re.search(r"serve_prefix_hits_total [1-9]", text)
    kv = json.loads(_get(metrics_url + "/debugz?kv=1"))["kv"]
    assert sum(kv["buckets"].values()) == kv["pages_in_use"]
    assert set(kv["tenants"]) <= {"0", "1"}

    # SIGUSR2 through `trace dump --pid`: the server writes its ring.
    assert ttrace_cli.main(["dump", "--pid", str(proc.pid)]) == 0
    deadline = time.monotonic() + 30
    dumps = []
    while not dumps and time.monotonic() < deadline:
        dumps = [p for p in dump.glob("trace-*.json")]
        time.sleep(0.1)
    assert dumps
    out = tmp_path / "merged.json"
    assert ttrace_cli.main(["merge", str(dumps[0]), "-o", str(out)]) == 0
    merged = json.loads(out.read_text())
    by_rid: dict = {}
    for e in merged["traceEvents"]:
        if e.get("cat") == "req" and e["ph"] == "b":
            by_rid.setdefault(e["id"], []).append(e["name"])
    assert len(by_rid) == 16
    for names in by_rid.values():
        order = [n for n in names if n in ("req/queue", "req/prefill",
                                           "req/fetch", "req/stream")]
        assert order[:2] == ["req/queue", "req/prefill"], names
        assert "req/fetch" in order and order[-1] == "req/stream"
    capsys.readouterr()


def test_trace_cli_refuses_what_is_not_ported(tmp_path, capsys):
    # `trace doctor` is ported: on an unreadable trace it answers as the
    # JAX package's does, exit code and message alike.
    from container_engine_accelerators_tpu.cli import trace as jtrace_cli

    missing = str(tmp_path / "x.json")
    answers = []
    for cli in (ttrace_cli, jtrace_cli):
        rc = cli.main(["doctor", missing, "--window", "3"])
        answers.append((rc, capsys.readouterr().err))
    assert answers[0] == answers[1]
    assert answers[0][0] == 2 and "cannot read" in answers[0][1]
    # Train step logs are ported: merge takes one.
    log = tmp_path / "steps.jsonl"
    log.write_text(json.dumps({"kind": "step", "step": 1, "t": 10.0,
                               "compute_s": 0.5, "data_wait_s": 0.1,
                               "tokens": 8}) + "\n")
    out = tmp_path / "o.json"
    assert ttrace_cli.main(["merge", "--train-jsonl", str(log),
                            "-o", str(out)]) == 0
    names = [e["name"] for e in json.loads(out.read_text())["traceEvents"]]
    assert "train/step" in names and "train/data_wait" in names


def test_loadgen_main_refuses_bad_flag_mixes():
    with pytest.raises(SystemExit):
        tloadgen.main(["--slo-ttft-p99-ms", "5"])     # needs --stream
    with pytest.raises(SystemExit):
        tloadgen.main(["--tenants", "2", "--idle-tenants", "3"])
    assert isinstance(tloadgen.make_parser(), argparse.ArgumentParser)
