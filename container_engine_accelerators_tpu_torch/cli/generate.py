"""generate — token generation CLI over the KV-cache decode path.

  python -m container_engine_accelerators_tpu_torch.cli.generate --tiny \
      --prompt-ids 1,5,42 --max-new-tokens 8
  python -m container_engine_accelerators_tpu_torch.cli.generate --tiny \
      --prompt-ids 5,9,7,5,9,7 --speculate ngram --spec-k 4

Runs on the GPU unless `--device cpu` is given; without CUDA it exits
with an error instead of falling back.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tiny", action="store_true",
                   help="random llama_tiny (the only model this port "
                        "loads so far; required)")
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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.tiny:
        p.error("checkpoints are not ported yet; pass --tiny")

    import torch

    from container_engine_accelerators_tpu_torch.models import decode as dec
    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    model, cfg = load_model(seed=args.seed, device=args.device)
    if args.weight_dtype == "int8":
        model = quantize_llama_params(model)
    ids = [int(x) for x in args.prompt_ids.split(",")]
    prompt = torch.tensor([ids], dtype=torch.long, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out = dec.generate(model, prompt, cfg, args.max_new_tokens,
                       temperature=args.temperature, generator=gen,
                       speculate=args.speculate, spec_k=args.spec_k,
                       draft_layers=args.draft_layers)
    out_ids = out[0].tolist()
    dt = time.perf_counter() - t0
    print("token ids:", out_ids)
    print(f"# {args.max_new_tokens} tokens in {dt:.2f}s "
          f"({args.max_new_tokens / dt:.1f} tok/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
