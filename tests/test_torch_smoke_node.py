"""chip_smoke.py's node phase rehearsed on the CPU: a fake /dev, a fake
NVML table, the device plugin daemon in a thread and a container that
does no device work; and the phase's refusal to run without CUDA."""

import os
import subprocess
import sys
import threading

import pytest

import chip_smoke

NODE_KEYS = {"phase", "nvidia_smi", "nvml", "nodes", "torch_card_minor",
             "trouble", "dev_root", "chip_generation", "registration_s",
             "allocate_ms", "preferred", "allocate", "container", "metrics",
             "flip_s", "health_poll_s", "socket_reregister_s", "kubelet_reregister_s",
             "restarts", "stop_s", "partition_listing", "runtime_ready_rc",
             "host_runtime_ready_rc", "driver_version", "nri", "scheduler",
             "launches"}
NRI_KEYS = {"registration_s", "plugin", "create_container_ms", "injected",
            "absent_node_error"}
# Char devices any user may stat, in the place of the card's nodes.
NRI_NODES = ["/dev/null", "/dev/zero", "/dev/full"]

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
                                   child_seconds=3.0, child_bytes=1 << 20,
                                   nri_nodes=NRI_NODES)
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
    nri = result["nri"]
    assert set(nri) == NRI_KEYS and nri["registration_s"] > 0
    assert nri["plugin"] == ["tpu-device-injector", "10"]
    assert [(d["path"], d["type"], d["major"], d["minor"])
            for d in nri["injected"]] == [
        (p, "c", os.major(os.stat(p).st_rdev), os.minor(os.stat(p).st_rdev))
        for p in NRI_NODES]
    assert "rpc error 13" in nri["absent_node_error"]
    sched = result["scheduler"]
    assert sched["run_once"] == 2 and sched["n_cards"] == 1
    assert sorted(sched["placed"].values()) == sorted(
        [sched["node"], "fake-near"])
    assert sched["labels"]["tpu.google.com/slice"] == "slice-0"


def test_nri_step_fails_on_a_node_that_is_no_device(tmp_path):
    """The injector refuses a regular file; the step then fails with the
    runtime's RPC error, never injecting what is no device."""
    plain = tmp_path / "nvidia0"
    plain.touch()
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.nri_step(str(tmp_path), [str(plain)])


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
