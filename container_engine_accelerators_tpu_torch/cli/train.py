"""train — train a Llama-3-family model on one device.

  python -m container_engine_accelerators_tpu_torch.cli.train \
      --preset tiny --steps 20 --ckpt-dir /tmp/ckpt --metrics-port 0 \
      --metrics-log /tmp/steps.jsonl --heartbeat-dir /tmp/hb

Runs `training/train.py` `fit` (checkpoint and auto-resume included)
over synthetic data (or a token file from `training/dataset.py`,
`--data`) from random weights, with:

  --ckpt-dir        restore the newest step there and save every
                    --save-every steps and at the end (--ckpt-async:
                    the write runs on a background thread; the loop
                    pays only a pinned host snapshot)
  --metrics-port    the train recorder on /metrics (0 = ephemeral):
                    step/data-wait/ckpt histograms, tokens/s, MFU,
                    goodput buckets, watchdog gauges
  --metrics-log     crash-safe JSONL step log (one line a step,
                    parseable at any truncation point)
  --heartbeat-dir   per-process heartbeat files + HangWatchdog: a
                    stalled process trips `train_stalled` with its id
  --trace-dump      the flight recorder's ring as a Chrome trace on
                    exit, crash and SIGUSR2
  --doctor          the streaming doctor (metrics/doctor.py) over this
                    process, with the train recorder and the heartbeat
                    dir: straggler, goodput-burn and OOM-precursor
                    verdicts as incident bundles (--doctor-dir) and
                    tpu_doctor_* families on the metrics port
  --fault-listen    chaos/test runs: tail a fault-command file written
                    by `inject_fault --kind data-stall|straggler|...`
  --fabric-health   the fabric health monitor (metrics/fabric_health.py)
                    over this process's group, its probe sweeps every
                    --fabric-health-every steps from the step loop (every
                    rank of a job sweeps in lockstep)
  TPU_PROFILE_DIR   a torch.profiler capture of the run (utils/
                    profiling.py) with its train/* regions

On the card the run records the utils/hbm_plan budget it should fit
(plan_training), which OOM bundles and oom_precursor verdicts carry.

Runs on the GPU unless `--device cpu` is given; without CUDA it exits
with an error instead of falling back. Prints one JSON line at the end:
the recorder's summary (steps and tokens of this run, tokens_per_sec
over productive time without the first step, MFU, step percentiles,
the goodput split), final_step, the last step's loss and, with
--doctor, doctor_incidents. The remat
policy comes with the preset's config ('dots'); multi-device meshes are
not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging

log = logging.getLogger(__name__)

PRESETS = ("tiny", "1b", "8b")


def build_config(preset: str, vocab_size: int | None,
                 n_layers: int | None = None):
    from container_engine_accelerators_tpu_torch.models import llama

    depth = {"n_layers": n_layers} if n_layers else {}
    if preset == "tiny":
        return llama.llama_tiny(
            **({"vocab_size": vocab_size} if vocab_size else {}), **depth)
    if preset == "1b":
        return llama.llama3_1b(**depth)
    return llama.llama3_8b(**depth)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=PRESETS, default="tiny")
    p.add_argument("--vocab-size", type=int, default=None,
                   help="tiny preset only: override vocab (synthetic "
                        "data draws tokens below it)")
    p.add_argument("--n-layers", type=int, default=None,
                   help="cut the preset's depth to this many layers, "
                        "its widths kept (a full-width run on one card)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--data", default=None,
                   help="token file (training/dataset.py format); "
                        "synthetic data when absent")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--ckpt-async", action="store_true",
                   help="asynchronous checkpoint saves: the step loop "
                        "pays only a pinned host snapshot (charged to "
                        "the ckpt_async badput bucket); serialize and "
                        "commit run on a background thread")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve training metrics on this port; 0 binds "
                        "an ephemeral port (logged at startup); omit "
                        "to disable the exporter")
    p.add_argument("--metrics-host", default="",
                   help="bind host for the metrics exporter (default: "
                        "all interfaces)")
    p.add_argument("--metrics-log", default=None,
                   help="append one JSON line per step to this file "
                        "(line-buffered; survives any kill)")
    p.add_argument("--heartbeat-dir", default=None,
                   help="per-process heartbeat files + hang watchdog")
    p.add_argument("--watchdog-threshold", type=float, default=300.0,
                   help="seconds a heartbeat may age before "
                        "train_stalled fires")
    p.add_argument("--trace-dump", default=None,
                   help="enable the flight-recorder EventBus and write "
                        "its ring as Chrome-trace JSON to this path on "
                        "exit/crash and on SIGUSR2 (a directory gets a "
                        "per-pid file); TPU_TRACE_DUMP env is the "
                        "flagless equivalent")
    p.add_argument("--doctor", action="store_true",
                   help="run the streaming doctor (metrics/doctor.py) "
                        "over this process: straggler / OOM-precursor / "
                        "goodput-burn detectors emit deduplicated "
                        "incident bundles and tpu_doctor_incidents_total "
                        "/ tpu_slo_burn_rate on the metrics port; "
                        "enables the EventBus if --trace-dump didn't")
    p.add_argument("--doctor-dir", default=None,
                   help="directory for doctor incident bundles "
                        "(default: TPU_DOCTOR_DIR env, else next to the "
                        "trace dump, else the cwd)")
    p.add_argument("--fault-listen", default=None,
                   help="CHAOS/TEST ONLY: tail this JSONL fault-command "
                        "file (written by `inject_fault --kind "
                        "data-stall|straggler|... --fault-log`) and "
                        "inject the faults into this process: data-"
                        "loader stalls, slow-straggler delays, health-"
                        "pipeline storms")
    p.add_argument("--fabric-health", action="store_true",
                   help="run a FabricHealthMonitor over this process's "
                        "group (metrics/fabric_health.py): probe sweeps "
                        "every --fabric-health-every steps, driven from "
                        "the step loop so every rank probes in lockstep")
    p.add_argument("--fabric-health-every", type=int, default=20,
                   help="steps between fabric probe sweeps")
    p.add_argument("--fabric-health-baseline", default=None,
                   help="FABRIC_BASELINE.json to seed busBW baselines "
                        "from")
    p.add_argument("--fabric-health-history", default=None,
                   help="append probe-history JSONL rows here "
                        "(tools/fabric_report.py input)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from container_engine_accelerators_tpu_torch.metrics import events
    if args.trace_dump:
        events.enable(dump_path=args.trace_dump, signals=True,
                      process_name="train")
        log.info("flight recorder on; trace dump -> %s", args.trace_dump)
    else:
        events.configure_from_env(process_name="train")

    from container_engine_accelerators_tpu_torch.metrics.train_metrics import (  # noqa: E501
        TrainRecorder,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
    )

    cfg = build_config(args.preset, args.vocab_size, args.n_layers)
    if args.data:
        from container_engine_accelerators_tpu_torch.training.dataset import (
            token_file_batches,
        )
        batches = token_file_batches(args.data, args.batch_size,
                                     args.seq_len, seed=args.seed)
    else:
        from container_engine_accelerators_tpu_torch.training.data import (
            synthetic_batches,
        )
        batches = synthetic_batches(cfg.vocab_size, args.batch_size,
                                    args.seq_len, seed=args.seed)

    # Asking for CUDA without it raises here, before any thread starts.
    from container_engine_accelerators_tpu_torch.models.convert import (
        resolve_device,
    )
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # The budget this run should fit under, embedded in any OOM
        # bundle and the doctor's oom_precursor evidence.
        from container_engine_accelerators_tpu_torch.metrics import (
            introspection,
        )
        from container_engine_accelerators_tpu_torch.utils.hbm_plan import (
            plan_training,
        )
        introspection.set_expected_hbm(plan_training(
            cfg, batch_size=args.batch_size, seq_len=args.seq_len,
            device=dev))
    # The CLI owns the recorder (fit would build one too) so the summary
    # can be printed after fit returns.
    recorder = TrainRecorder(log_path=args.metrics_log,
                             heartbeat_dir=args.heartbeat_dir)
    doc = listener = None
    if args.doctor:
        from container_engine_accelerators_tpu_torch.metrics import (
            doctor as doctor_mod,
        )
        if not events.enabled():
            events.enable(process_name="train")
        doc = doctor_mod.Doctor(
            registry=recorder.registry, train_recorder=recorder,
            heartbeat_dir=args.heartbeat_dir,
            out_dir=args.doctor_dir if args.doctor_dir else "auto")
        doc.start()
        doctor_mod.set_active(doc)
    if args.fault_listen:
        from container_engine_accelerators_tpu_torch.metrics.doctor import (
            FaultListener,
        )
        listener = FaultListener(args.fault_listen)
        listener.start()
    fmon = None
    if args.fabric_health:
        from container_engine_accelerators_tpu_torch.metrics import (
            fabric_health,
        )
        # No poll thread: the probes of a job of several ranks are
        # matched collectives, so sweeps run in step lockstep; fit's
        # loop drives maybe_sweep_step through the active registry.
        fmon = fabric_health.FabricHealthMonitor(
            size_bytes=1 << 14, warmup=1, iters=2,
            baseline_path=args.fabric_health_baseline,
            history_path=args.fabric_health_history,
            registry=recorder.registry,
            backend="gloo" if dev.type == "cpu" else "nccl", device=dev)
        fmon.train_every = max(args.fabric_health_every, 1)
        fabric_health.set_active(fmon)
        log.info("fabric health monitor on (sweep every %d steps)",
                 fmon.train_every)
    try:
        state, metrics = fit(
            cfg, make_optimizer(), batches, device=args.device,
            max_steps=args.steps, seed=args.seed,
            log_every=args.log_every, log_fn=log.info,
            ckpt_dir=args.ckpt_dir, save_every=args.save_every,
            ckpt_async=args.ckpt_async, recorder=recorder,
            metrics_port=args.metrics_port, metrics_host=args.metrics_host,
            heartbeat_dir=args.heartbeat_dir,
            watchdog_threshold_s=args.watchdog_threshold)
        summary = recorder.summary()
        if doc is not None:
            doc.poll_once()  # a final evaluation over the run's tail
            summary["doctor_incidents"] = len(doc.incidents)
        if fmon is not None:
            summary["fabric_sweeps"] = fmon.sweeps
    finally:
        if fmon is not None:
            fmon.stop()
        if listener is not None:
            listener.stop()
        if doc is not None:
            doc.stop()
        recorder.close()
    summary["final_step"] = state.step
    summary["loss"] = (float(metrics["loss"]) if metrics is not None
                       else None)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
