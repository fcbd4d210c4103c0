"""eval — perplexity over a token corpus (training/train.evaluate behind
a CLI), completing the train / eval / serve loop.

  python -m container_engine_accelerators_tpu_torch.cli.eval \
      --checkpoint /ckpt/run1 --data corpus.bin --batches 50

`--checkpoint` is a training checkpoint dir (training/checkpoint.py) or
an HF Llama export; without it, a random llama_tiny. `--weight-dtype
int8` evaluates through the int8 quantize / dequantize round trip, the
quality gate for serving with `--weight-dtype int8`. Runs on the GPU
unless `--device cpu` is given; without CUDA it exits with an error
instead of falling back. Prints one JSON line: eval_loss, perplexity,
batches, weight_dtype.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="training checkpoint dir or HF Llama export "
                        "(default: random tiny)")
    p.add_argument("--data", required=True,
                   help="token file written by training/dataset.py")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batches", type=int, default=50)
    p.add_argument("--weight-dtype", choices=["bf16", "int8"],
                   default="bf16",
                   help="int8: evaluate through the int8 quantize/"
                        "dequantize round trip of the served weights")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )
    from container_engine_accelerators_tpu_torch.training.dataset import (
        token_file_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        evaluate,
    )

    model, cfg = load_model(args.checkpoint, device=args.device)
    if args.weight_dtype == "int8":
        from container_engine_accelerators_tpu_torch.ops.quant import (
            dequantize_llama_params,
            quantize_llama_params,
        )
        model = dequantize_llama_params(quantize_llama_params(model),
                                        cfg.param_dtype)
    batches = token_file_batches(args.data, args.batch_size, args.seq_len,
                                 num_batches=args.batches)
    report = evaluate(model, cfg, batches)
    report["weight_dtype"] = args.weight_dtype
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
