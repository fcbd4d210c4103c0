"""generate — token generation CLI over the KV-cache decode path.

  python -m container_engine_accelerators_tpu_torch.cli.generate --tiny \
      --prompt-ids 1,5,42 --max-new-tokens 8
  python -m container_engine_accelerators_tpu_torch.cli.generate \
      --checkpoint /ckpt/llama3-8b --prompt-ids 1,5,42
  python -m container_engine_accelerators_tpu_torch.cli.generate --tiny \
      --prompt-ids 5,9,7,5,9,7 --speculate ngram --spec-k 4
  python -m container_engine_accelerators_tpu_torch.cli.generate --tiny \
      --prompt-ids 1,5,42 --tp 2

`--tp N` runs tensor-parallel over N rank processes, this one rank 0
(models/decode_tp.py): each rank builds its own shard (`--tiny` draws
it from `--seed`; under `--checkpoint` each rank reads the file one
weight at a time and keeps its part), and rank 0 prints the tokens.
Speculation does not run under --tp (as in the JAX package).

Runs on the GPU unless `--device cpu` is given; without CUDA it exits
with an error instead of falling back.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="a training checkpoint dir (training/"
                        "checkpoint.py) or an HF Llama export")
    p.add_argument("--tiny", action="store_true",
                   help="random llama_tiny instead of --checkpoint")
    p.add_argument("--prompt-ids", default="1",
                   help="comma-separated token ids")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--speculate", choices=["off", "ngram", "draft"],
                   default="off",
                   help="speculative decoding (greedy only; the tokens "
                        "are those of off - models/spec.py)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens per verify pass")
    p.add_argument("--draft-layers", type=int, default=2,
                   help="--speculate draft: layers in the truncated "
                        "self-draft model")
    p.add_argument("--weight-dtype", choices=["bf16", "int8"],
                   default="bf16",
                   help="int8: per-output-channel weight quantization, "
                        "dequantized inside the matmul kernel")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (models/decode_tp.py; "
                        "placement as in cli/serve.py)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not (args.tiny or args.checkpoint):
        p.error("pass --checkpoint DIR or --tiny")
    if args.tp < 1:
        p.error("--tp must be >= 1")
    if args.tp > 1 and args.speculate != "off":
        p.error("--speculate does not run under --tp > 1 (the serving "
                "engines run tp speculative decoding)")

    import torch

    from container_engine_accelerators_tpu_torch.models import decode as dec
    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    rt = None
    try:
        if args.tp > 1:
            model, cfg, rt = _tp_model(p, args)
        else:
            model, cfg = load_model(None if args.tiny else args.checkpoint,
                                    seed=args.seed, device=args.device)
        if args.weight_dtype == "int8":
            model = (rt.quantize(model) if rt is not None
                     else quantize_llama_params(model))
        ops = rt or dec
        ids = [int(x) for x in args.prompt_ids.split(",")]
        prompt = torch.tensor([ids], dtype=torch.long, device=model.device)
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        t0 = time.perf_counter()
        out = ops.generate(model, prompt, cfg, args.max_new_tokens,
                           temperature=args.temperature, generator=gen,
                           speculate=args.speculate, spec_k=args.spec_k,
                           draft_layers=args.draft_layers)
        out_ids = out[0].tolist()
        dt = time.perf_counter() - t0
    finally:
        if rt is not None:
            rt.close()
    print("token ids:", out_ids)
    print(f"# {args.max_new_tokens} tokens in {dt:.2f}s "
          f"({args.max_new_tokens / dt:.1f} tok/s)", file=sys.stderr)
    return 0


def _tp_model(p, args):
    """(rank 0's shard, cfg, the TPRuntime): the kernels built before the
    followers spawn, then every rank builds its own shard."""
    import torch

    from container_engine_accelerators_tpu_torch.models import decode_tp
    from container_engine_accelerators_tpu_torch.models.convert import (
        checkpoint_weights,
    )
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama_tiny,
    )

    if args.checkpoint and not args.tiny:
        # The config alone: no weight is read here.
        _, cfg = checkpoint_weights(args.checkpoint)
    else:
        cfg = llama_tiny()
    try:
        decode_tp.validate_tp(cfg, args.tp)
    except ValueError as e:
        p.error(str(e))
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--tp on the card needs CUDA, and "
                               "torch.cuda.is_available() is False; pass "
                               "--device cpu to run on the CPU")
        from container_engine_accelerators_tpu_torch import kernels
        kernels.load()
    rt = decode_tp.TPRuntime(args.tp, device=args.device)
    try:
        if args.checkpoint and not args.tiny:
            model, cfg = rt.checkpoint_model(args.checkpoint)
        else:
            model = rt.random_model(cfg, seed=args.seed)
    except BaseException:
        rt.close()
        raise
    return model, cfg, rt


if __name__ == "__main__":
    sys.exit(main())
