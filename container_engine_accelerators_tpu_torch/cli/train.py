"""train — train a Llama-3-family model on one device.

  python -m container_engine_accelerators_tpu_torch.cli.train \
      --preset tiny --steps 20

Runs `training/train.py` `fit` over synthetic data (or a token file
from `training/dataset.py`, `--data`) from random weights. Runs on the
GPU unless `--device cpu` is given; without CUDA it exits with an error
instead of falling back. Prints one JSON line at the end: final_step,
steps, tokens (targets trained on), tokens_per_sec (tokens over the
loop's wall time, to its last device fence) and the last step's loss.
Checkpoints, the metrics exporter, heartbeats and multi-device meshes
are not ported yet.
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
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

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

    state, metrics = fit(cfg, make_optimizer(), batches, device=args.device,
                         max_steps=args.steps, seed=args.seed,
                         log_every=args.log_every, log_fn=log.info)
    loss = float(metrics["loss"]) if metrics is not None else None
    print(json.dumps({
        "final_step": state.step,
        "steps": state.step,
        "tokens": state.tokens,
        "tokens_per_sec": state.tokens / state.seconds if state.seconds
        else 0.0,
        "loss": loss,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
