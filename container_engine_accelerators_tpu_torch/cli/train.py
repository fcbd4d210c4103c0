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

Runs on the GPU unless `--device cpu` is given; without CUDA it exits
with an error instead of falling back. Prints one JSON line at the end:
the recorder's summary (steps and tokens of this run, tokens_per_sec
over productive time without the first step, MFU, step percentiles,
the goodput split), final_step and the last step's loss. The remat
policy comes with the preset's config ('dots'); multi-device meshes are
not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging

log = logging.getLogger(__name__)

PRESETS = ("tiny", "1b", "8b")


def build_config(preset: str, vocab_size: int | None):
    from container_engine_accelerators_tpu_torch.models import llama

    if preset == "tiny":
        return llama.llama_tiny(
            **({"vocab_size": vocab_size} if vocab_size else {}))
    if preset == "1b":
        return llama.llama3_1b()
    return llama.llama3_8b()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=PRESETS, default="tiny")
    p.add_argument("--vocab-size", type=int, default=None,
                   help="tiny preset only: override vocab (synthetic "
                        "data draws tokens below it)")
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

    cfg = build_config(args.preset, args.vocab_size)
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

    # The CLI owns the recorder (fit would build one too) so the summary
    # can be printed after fit returns.
    recorder = TrainRecorder(log_path=args.metrics_log,
                             heartbeat_dir=args.heartbeat_dir)
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
    finally:
        recorder.close()
    summary["final_step"] = state.step
    summary["loss"] = (float(metrics["loss"]) if metrics is not None
                       else None)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
