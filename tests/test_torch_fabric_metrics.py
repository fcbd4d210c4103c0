"""The port's fabric metrics exporter (metrics/fabric.py) held against the
JAX package's on the CPU: each case of the JAX package's
tests/test_fabric_metrics.py on the same fabricated sysfs tree, the
/metrics sample lines of both exporters equal (HELP text and creation
stamps aside). Where JAX reads /sys/class/accel/<chip>/ici_errors, the
port reads NVLink error counters through an injected NVML function table
(utils/nvml.py), and the same count comes out under the same family.
Tolerance: exact."""

import ctypes
import socket
import threading
import urllib.request

import pytest
import torch.distributed as dist
from prometheus_client import generate_latest

from container_engine_accelerators_tpu.metrics import events as jevents
from container_engine_accelerators_tpu.metrics.fabric import (
    FabricMetricServer as JServer,
)
from container_engine_accelerators_tpu_torch.metrics import events as tevents
from container_engine_accelerators_tpu_torch.metrics.fabric import (
    FabricMetricServer as TServer,
)
from container_engine_accelerators_tpu_torch.ops import collectives
from container_engine_accelerators_tpu_torch.utils import nvml
from tests.test_torch_node_metrics import FakeCard, FakeNvmlTable

NOT_SUPPORTED, INVALID_ARGUMENT = 3, 2


class NvLinkTable(FakeNvmlTable):
    """FakeNvmlTable with NVLink: `links[minor]` maps a link to (active,
    [five error counters]); a card absent from `links` answers Not
    Supported; a link past a card's last answers Invalid Argument."""

    def __init__(self, cards, links):
        super().__init__(cards)
        self.links = links

    def nvmlDeviceGetNvLinkState(self, handle, link, state):
        card = self._card(handle)
        if card.minor not in self.links:
            return NOT_SUPPORTED
        if link not in self.links[card.minor]:
            return INVALID_ARGUMENT
        state._obj.value = int(self.links[card.minor][link][0])
        return 0

    def nvmlDeviceGetNvLinkErrorCounter(self, handle, link, counter, value):
        card = self._card(handle)
        value._obj.value = self.links[card.minor][link][1][counter]
        return 0


def no_cards():
    return nvml.Nvml(NvLinkTable([], {}))


def make_fake_net(tmp_path, stats):
    net = tmp_path / "net"
    for iface, values in stats.items():
        d = net / iface / "statistics"
        d.mkdir(parents=True)
        for stat, val in values.items():
            (d / stat).write_text(f"{val}\n")
    (net / "lo" / "statistics").mkdir(parents=True)
    (net / "lo" / "statistics" / "tx_bytes").write_text("1\n")
    return str(net)


def servers(tmp_path, **kw):
    """(JAX's, the port's) over the same sysfs tree; no chips on either
    (an empty accel dir, an NVML without cards)."""
    kw.setdefault("sysfs_net", str(tmp_path / "net"))
    return (JServer(sysfs_accel=str(tmp_path / "accel"), **kw),
            TServer(nvml=no_cards(), **kw))


def samples(srv) -> list[str]:
    return sorted(line for line in generate_latest(srv.registry).decode()
                  .splitlines()
                  if line and not line.startswith("#")
                  and "_created" not in line)


def test_nic_counters_and_throughput(tmp_path):
    net = make_fake_net(tmp_path, {
        "eth0": {"tx_bytes": 1000, "rx_bytes": 500, "tx_packets": 10,
                 "rx_packets": 5, "tx_dropped": 0, "rx_dropped": 1}})
    pair = servers(tmp_path, sysfs_net=net)
    for srv in pair:
        srv.poll_once(now=100.0)
    assert samples(pair[1]) == samples(pair[0])
    text = "\n".join(samples(pair[1]))
    assert 'tpu_dcn_nic_stat{interface="eth0",stat="tx_bytes"} 1000.0' \
        in text
    assert 'interface="lo"' not in text
    (tmp_path / "net" / "eth0" / "statistics" / "tx_bytes").write_text(
        "5000\n")
    for srv in pair:
        srv.poll_once(now=102.0)
    assert samples(pair[1]) == samples(pair[0])
    assert ('tpu_dcn_throughput_bytes_per_sec{direction="tx",'
            'interface="eth0"} 2000.0') in samples(pair[1])


def test_counter_reset_clamps_to_zero(tmp_path):
    make_fake_net(tmp_path, {"eth0": {"tx_bytes": 9000}})
    pair = servers(tmp_path)
    for srv in pair:
        srv.poll_once(now=1.0)
    (tmp_path / "net" / "eth0" / "statistics" / "tx_bytes").write_text(
        "100\n")
    for srv in pair:
        srv.poll_once(now=2.0)
    assert samples(pair[1]) == samples(pair[0])
    assert ('tpu_dcn_throughput_bytes_per_sec{direction="tx",'
            'interface="eth0"} 0.0') in samples(pair[1])


def test_nvlink_error_counters_as_jaxs_ici_errors(tmp_path):
    """7 errors on accel0's sysfs file; the same 7 over card 0's active
    NVLinks (2 + 5; an inactive link's counters are not read, the walk
    ends at the first link past the card's last); card 1 answers Not
    Supported and, like accel1 without the file, is not exported."""
    accel = tmp_path / "accel"
    (accel / "accel0").mkdir(parents=True)
    (accel / "accel0" / "ici_errors").write_text("7\n")
    (accel / "accel1").mkdir()
    jsrv = JServer(sysfs_net=str(tmp_path / "net"), sysfs_accel=str(accel))
    table = NvLinkTable([FakeCard(0), FakeCard(1)], {0: {
        0: (True, [1, 0, 1, 0, 0]), 1: (False, [50, 50, 50, 50, 50]),
        2: (True, [0, 5, 0, 0, 0])}})
    tsrv = TServer(sysfs_net=str(tmp_path / "net"), nvml=nvml.Nvml(table))
    jsrv.poll_once(now=1.0)
    tsrv.poll_once(now=1.0)
    jlines = [line for line in samples(jsrv) if "tpu_ici_error_count" in line]
    tlines = [line for line in samples(tsrv) if "tpu_ici_error_count" in line]
    assert jlines == ['tpu_ici_error_count{tpu_chip="accel0"} 7.0']
    assert tlines == ['tpu_ici_error_count{tpu_chip="nvidia0"} 7.0']
    assert tsrv.nvlink_answers["nvidia0"] == "ok"
    assert "Not Supported" in tsrv.nvlink_answers["nvidia1"]
    # Link 1 (inactive) was asked its state, never its counters.
    assert table.calls.count("nvmlDeviceGetNvLinkErrorCounter") == 10


def test_nvlink_binding_declares_its_calls():
    assert nvml.SIGNATURES["nvmlDeviceGetNvLinkState"][1] is ctypes.c_uint
    assert nvml.SIGNATURES["nvmlDeviceGetNvLinkErrorCounter"][2] is \
        ctypes.c_int
    assert nvml.NVLINK_ERROR_COUNTERS == {
        "dl_replay": 0, "dl_recovery": 1, "dl_crc_flit": 2,
        "dl_crc_data": 3, "dl_ecc_data": 4}
    with nvml.Nvml(NvLinkTable([FakeCard(3)], {})) as session:
        with pytest.raises(nvml.NvmlError, match="Not Supported"):
            session.nvlink_errors(session.handle(0))


def test_probe_rtt(tmp_path):
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(2)

    def accept():
        for _ in range(2):
            try:
                conn, _ = listener.accept()
                conn.close()
            except OSError:
                return

    t = threading.Thread(target=accept)
    t.start()
    pair = servers(tmp_path, probe_addr=listener.getsockname())
    for srv in pair:
        srv.poll_once(now=1.0)
    rtts = [float(next(line for line in samples(srv)
                       if line.startswith("tpu_dcn_probe_rtt_seconds"))
                  .split()[-1]) for srv in pair]
    assert all(0.0 <= r < 1.0 for r in rtts)
    assert "tpu_dcn_probe_up 1.0" in samples(pair[1])
    t.join(timeout=5)
    listener.close()
    down = servers(tmp_path, probe_addr=("127.0.0.1", 1))
    for srv in down:
        srv.poll_once(now=1.0)
    assert samples(down[1]) == samples(down[0])
    assert "tpu_dcn_probe_up 0.0" in samples(down[1])
    assert not any("tpu_dcn_probe_rtt_seconds" in line
                   for line in samples(down[1]))


def test_http_server_serves_metrics(tmp_path):
    net = make_fake_net(tmp_path, {"eth0": {"tx_bytes": 42}})
    srv = TServer(sysfs_net=net, nvml=no_cards(), port=0, interval=3600)
    srv.start_background()
    try:
        srv.poll_once(now=1.0)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.bound_port}/metrics",
            timeout=5).read().decode()
        assert "tpu_dcn_nic_stat" in body
        assert "tpu_fabric_poll_total" in body
    finally:
        srv.stop()


def test_collective_busbw_probe_hook_rate_limited(tmp_path):
    calls = {"jax": [], "torch": []}

    def hook_for(pkg):
        def hook():
            calls[pkg].append(1)
            return [("all_reduce", "tp", "ici", 1.5e9),
                    ("all_reduce", "dp", "dcn", 0.1e9),
                    ("all_gather", "tp", 2.5e9)]   # legacy 3-tuple
        return hook

    jsrv = JServer(sysfs_net=str(tmp_path / "net"),
                   sysfs_accel=str(tmp_path / "accel"),
                   collective_probe=hook_for("jax"),
                   collective_probe_interval=600.0)
    tsrv = TServer(sysfs_net=str(tmp_path / "net"), nvml=no_cards(),
                   collective_probe=hook_for("torch"),
                   collective_probe_interval=600.0)
    for now in (100.0, 300.0, 701.0):
        for srv in (jsrv, tsrv):
            srv.poll_once(now=now)
        assert samples(tsrv) == samples(jsrv)
    assert calls["torch"] == calls["jax"] == [1, 1]
    assert ('fabric_collective_busbw_bytes_per_second{axis="dp",'
            'collective="all_reduce",fabric="dcn"} 1e+08') in samples(tsrv)

    def bad_hook():
        calls["torch"].append("bad")
        raise RuntimeError("fabric down")

    tsrv.collective_probe = bad_hook
    tsrv.poll_once(now=1400.0)
    assert calls["torch"][-1] == "bad"
    assert any("tpu_fabric_poll_total" in line for line in samples(tsrv))


def test_collective_probe_disabled_by_default(tmp_path):
    pair = servers(tmp_path)
    for srv in pair:
        srv.poll_once(now=1.0)
    assert samples(pair[1]) == samples(pair[0])
    assert not any(line.startswith("fabric_collective_busbw")
                   for line in samples(pair[1]))


def test_probe_interval_change_takes_effect_next_cycle(tmp_path):
    got = {}
    for name, srv_type, extra in (
            ("jax", JServer, {"sysfs_accel": str(tmp_path / "accel")}),
            ("torch", TServer, {"nvml": no_cards()})):
        calls = []
        srv = srv_type(sysfs_net=str(tmp_path / "net"),
                       collective_probe=lambda calls=calls: calls.append(1)
                       or [], collective_probe_interval=100.0, **extra)
        seen = []
        for now, interval in ((0.0, None), (50.0, 10.0), (100.0, None),
                              (105.0, None), (110.0, None)):
            if interval is not None:
                srv.collective_probe_interval = interval
            srv.poll_once(now=now)
            seen.append(len(calls))
        got[name] = seen
    assert got["torch"] == got["jax"] == [1, 1, 2, 2, 3]


def test_probe_error_counts_and_marks_timeline(tmp_path):
    def boom():
        raise RuntimeError("link down")

    got = {}
    for name, ev, srv_type, extra in (
            ("jax", jevents, JServer, {"sysfs_accel": str(tmp_path / "a")}),
            ("torch", tevents, TServer, {"nvml": no_cards()})):
        ev._reset_for_tests()
        bus = ev.enable(capacity=64, process_name="fabric-err-test")
        try:
            srv = srv_type(sysfs_net=str(tmp_path / "net"),
                           collective_probe=boom,
                           collective_probe_interval=10.0, **extra)
            for now in (0.0, 5.0, 10.0):
                srv.poll_once(now=now)
            got[name] = (samples(srv), [(e[3], e[4], e[7])
                                        for e in bus.snapshot()
                                        if e[3] == "fabric/probe_error"])
        finally:
            ev._reset_for_tests()
    assert got["torch"] == got["jax"]
    text, errs = got["torch"]
    assert "tpu_fabric_probe_errors_total 2.0" in text
    assert "tpu_fabric_poll_total 3.0" in text
    assert len(errs) == 2 and errs[0][2]["error"] == "RuntimeError"


def test_probe_hook_fabric_resolved_per_invocation(monkeypatch):
    """make_probe_hook reads axis_fabric when the hook runs: a hook built
    before the job spanned hosts must not keep 'ici' for dp."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        hook = collectives.make_probe_hook(
            dist.group.WORLD, "dp", collectives=("all_reduce", "ppermute"),
            size_bytes=1 << 10, warmup=1, iters=1)
        rows = hook()
        assert [r[2] for r in rows] == ["ici", "ici"]
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        rows = hook()
        assert [r[2] for r in rows] == ["dcn", "dcn"]
        # One rank: all_reduce's busBW is 0, ppermute's a copy's.
        assert rows[0][3] == 0.0 and rows[1][3] > 0
    finally:
        dist.destroy_process_group()
