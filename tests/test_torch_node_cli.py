"""The port's partition_tpu and runtime_ready against the JAX package's:
the same steps on fake /dev trees (`accel<N>` for JAX, `nvidia<N>` for
the port) give the same exit codes, config files, ready files and
output, after renaming accel -> nvidia. And the port's Kubernetes
client sends the JAX client's requests."""

import json
import os

import pytest

from container_engine_accelerators_tpu.cli import partition_tpu as jpartition
from container_engine_accelerators_tpu.cli import runtime_ready as jready
from container_engine_accelerators_tpu_torch.cli import (
    partition_tpu,
    runtime_ready,
)


def _side(tmp_path, name, prefix, chips, config=None):
    root = tmp_path / name
    dev = root / "dev"
    dev.mkdir(parents=True)
    for i in chips:
        (dev / f"{prefix}{i}").touch()
    for noise in ("null", f"{prefix}X", "nvidiactl", "nvidia-uvm"):
        (dev / noise).touch()
    cfg = root / "etc" / "tpu_config.json"
    if config is not None:
        cfg.parent.mkdir(parents=True)
        cfg.write_text(json.dumps(config))
    return str(dev), str(cfg)


def _run(main, capsys, argv):
    rc = main(argv)
    return rc, capsys.readouterr().out.replace("accel", "nvidia")


def _file(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


PARTITION_CASES = {
    "apply2": ([0, 1, 2, 3], None, [["--chips-per-partition", "2"]]),
    "rerun_is_a_noop": ([0, 1, 2, 3], {"chipsPerPartition": 2,
                                       "healthCriticalErrors": ["CHIP_LOST"]},
                        [["--chips-per-partition", "2"]]),
    "repartition": ([0, 1, 2, 3], {"chipsPerPartition": 2,
                                   "healthCriticalErrors": ["CHIP_LOST"]},
                    [["--chips-per-partition", "4"]]),
    "dissolve": ([0, 1, 2, 3], None, [["--chips-per-partition", "2"],
                                      ["--chips-per-partition", "0"]]),
    "invalid_size": ([0, 1, 2, 3], None, [["--chips-per-partition", "3"]]),
    "indivisible": ([0, 1], None, [["--chips-per-partition", "4"]]),
    "no_cards": ([], None, [["--chips-per-partition", "2"]]),
    "list": ([0, 1, 2, 3], None, [["--chips-per-partition", "2"],
                                  ["--list"]]),
    "list_unpartitioned": ([0, 2], None, [["--list"]]),
    "size_from_config": ([0, 1, 2, 3], {"chipsPerPartition": 1}, [[]]),
    "one_card": ([7], None, [["--chips-per-partition", "1"], ["--list"]]),
}


@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partition_tpu_matches_jax(tmp_path, capsys, case):
    chips, config, steps = PARTITION_CASES[case]
    jdev, jcfg = _side(tmp_path, "j", "accel", chips, config)
    tdev, tcfg = _side(tmp_path, "t", "nvidia", chips, config)
    for step in steps:
        jmtime = os.stat(jcfg).st_mtime_ns if os.path.exists(jcfg) else None
        tmtime = os.stat(tcfg).st_mtime_ns if os.path.exists(tcfg) else None
        want = _run(jpartition.main, capsys,
                    ["--config-file", jcfg, "--dev-root", jdev, *step])
        got = _run(partition_tpu.main, capsys,
                   ["--config-file", tcfg, "--dev-root", tdev, *step])
        assert got == want, step
        assert _file(tcfg) == _file(jcfg)
        # A no-op rewrites nothing, on both sides.
        assert ((os.stat(tcfg).st_mtime_ns if os.path.exists(tcfg) else None)
                == tmtime) == ((os.stat(jcfg).st_mtime_ns
                                if os.path.exists(jcfg) else None) == jmtime)


READY_CASES = {
    "ready": ([0, 1], []),
    "no_cards": ([], []),
    "expected_more": ([0, 1], ["--expected-chips", "4"]),
    "expected_met": ([0, 1, 5], ["--expected-chips", "3"]),
}


@pytest.mark.parametrize("case", sorted(READY_CASES))
def test_runtime_ready_once_matches_jax(tmp_path, capsys, case):
    chips, extra = READY_CASES[case]
    jdev, _ = _side(tmp_path, "j", "accel", chips)
    tdev, _ = _side(tmp_path, "t", "nvidia", chips)
    jfile, tfile = tmp_path / "j" / "run" / "ready", tmp_path / "t" / "run" / \
        "ready"
    want = _run(jready.main, capsys, ["--dev-root", jdev, "--once",
                                      "--ready-file", str(jfile), *extra])
    got = _run(runtime_ready.main, capsys, ["--dev-root", tdev, "--once",
                                            "--ready-file", str(tfile),
                                            *extra])
    assert got == want
    assert _file(tfile) == _file(jfile)
    assert not os.path.exists(f"{tfile}.tmp.{os.getpid()}")


def test_symlinked_nodes_are_followed_as_jax_does(tmp_path, capsys):
    # A dev root of symlinks to the real nodes (the card smoke's root of
    # the nodes NVML names) is discovered and opened through the links;
    # a dangling link is no card, on either side.
    real = tmp_path / "real"
    real.mkdir()
    (real / "card").touch()
    outs = []
    for prefix, ready, part in (("accel", jready, jpartition),
                                ("nvidia", runtime_ready, partition_tpu)):
        dev = tmp_path / prefix
        dev.mkdir()
        os.symlink(real / "card", dev / f"{prefix}7")
        os.symlink(tmp_path / "absent", dev / f"{prefix}1")
        stamp = tmp_path / f"{prefix}.ready"
        outs.append((ready.main(["--dev-root", str(dev), "--once",
                                 "--ready-file", str(stamp),
                                 "--expected-chips", "1"]),
                     _file(stamp),
                     _run(part.main, capsys, [
                         "--dev-root", str(dev), "--config-file",
                         str(tmp_path / prefix / "cfg.json"),
                         "--chips-per-partition", "1"])))
    assert outs[0] == outs[1] == (0, "1\n", outs[0][2])
    assert outs[0][2][0] == 0 and "tpu-sub0-1" in outs[0][2][1]


# ---------------------------------------------------------------- k8s client

class _Api:
    """An API server on an ephemeral port that records each request and
    answers JSON, 404 under /missing."""

    def __init__(self):
        import http.server
        import threading

        seen = self.seen = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def _answer(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n).decode() if n else None
                seen.append((self.command, self.path, body,
                             self.headers.get("Content-Type"),
                             self.headers.get("Authorization")))
                code = 404 if self.path.startswith("/missing") else 200
                payload = json.dumps({"path": self.path}).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _answer

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


K8S_CALLS = [
    ("get_node", ("n1",)),
    ("patch_node", ("n1", {"metadata": {"labels": {"a": "b"}}})),
    ("patch_node_status", ("n1", {"status": {}})),
    ("set_node_condition", ("n1", {"type": "TpuCriticalError"})),
    ("annotate_node", ("n1", {"cloud.google.com/x": "1"})),
    ("list_nodes", ("a=b",)),
    ("list_pods", ("ns", "spec.nodeName=n1", "app=x")),
    ("list_pods", ()),
    ("get_pod", ("ns", "p")),
    ("replace_pod", ("ns", "p", {"metadata": {"name": "p"}})),
    ("patch_pod", ("ns", "p", {"metadata": {}})),
    ("delete_pod", ("ns", "p")),
    ("bind_pod", ("ns", "p", "n1")),
    ("create_event", ("ns", {"reason": "x"})),
]


def test_k8s_client_sends_what_jaxs_sends(tmp_path, monkeypatch):
    from container_engine_accelerators_tpu import k8s as jk8s
    from container_engine_accelerators_tpu_torch import k8s

    token = tmp_path / "token"
    token.write_text("tok-1\n")
    api = _Api()
    try:
        answers = []
        for mod in (jk8s, k8s):
            client = mod.K8sClient(api.url, token="fixed",
                                   token_file=str(token))
            answers.append([getattr(client, name)(*args)
                            for name, args in K8S_CALLS])
            with pytest.raises(mod.ApiError) as err:
                client.get("/missing/x")
            answers[-1].append(err.value.status)
        n = len(K8S_CALLS) + 1
        assert answers[0] == answers[1]
        assert api.seen[:n] == api.seen[n:]
        assert all(auth == "Bearer tok-1" for *_, auth in api.seen)
    finally:
        api.stop()
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for mod in (jk8s, k8s):
        with pytest.raises(RuntimeError, match="not running in a cluster"):
            mod.in_cluster_client()
