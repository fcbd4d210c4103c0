"""Speculative decoding: the drafters and the acceptance rule, on the host.

Draft-then-verify (Leviathan et al. 2023) splits a decode tick into a
cheap proposal of k tokens and one model pass that scores all k+1
positions (models/decode.verify_step). This module runs on the host
between device steps, as page allocation does: the device sees [B, k+1]
verify batches, and the accepted counts go back to it as data
(advance_lengths).

Two drafters:
  ngram_draft      prompt lookup: match the context's suffix against its
                   own history and propose what followed. No weights and
                   no device work; acceptance is high where decoding
                   repeats itself (extraction, code, structured output).
  truncate_params  self-draft: the first n layers of the same model,
                   sharing its embedding, final norm and lm_head, as a
                   small proposer on the same card.

A drafter may propose any tokens, and fewer than k (callers pad). Greedy
verification accepts the longest prefix that matches the full model's
argmax and then always emits one bonus token from the verify logits, so
a bad drafter costs compute, never correctness: the token stream is the
one plain greedy decoding gives, up to the last bits in which a verify
pass and single-token steps sum their logits in different orders.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from container_engine_accelerators_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
)

__all__ = ["ngram_draft", "greedy_verify", "truncate_params",
           "draft_config"]


def ngram_draft(context, k: int, max_ngram: int = 3,
                min_ngram: int = 1) -> list[int]:
    """Propose up to `k` tokens by prompt lookup: find the most recent
    earlier occurrence of the context's trailing n-gram (longest n first,
    n in [min_ngram, max_ngram]) and return the tokens that followed it.
    Returns [] when no n-gram recurs; the caller then runs a plain (or
    padded) tick.

    context: 1-D int sequence (prompt and tokens so far, the latest
    emitted token included). O(len * max_ngram) a call."""
    ctx = np.asarray(context, dtype=np.int64).ravel()
    n = ctx.size
    if k < 1 or n < min_ngram + 1:
        return []
    for g in range(min(max_ngram, n - 1), min_ngram - 1, -1):
        suffix = ctx[n - g:]
        # The most recent earlier occurrence wins: it tracks the current
        # phrase, not a stale one from the prompt's start.
        for s in range(n - g - 1, -1, -1):
            if np.array_equal(ctx[s:s + g], suffix):
                cont = ctx[s + g:s + g + k]
                if cont.size:
                    return [int(t) for t in cont]
    return []


def greedy_verify(greedy: np.ndarray,
                  tokens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The acceptance rule of one verify pass.

    greedy: [B, k+1] argmax of verify_step's logits; tokens: [B, k+1]
    the verified inputs [last, d_1..d_k]. Row i accepts the longest draft
    prefix where greedy[i, j] == tokens[i, j+1] (the model, given the
    tokens up to d_j's predecessor, would itself emit d_j). Returns
    (counts [B] = accepted + 1 tokens to commit, bonus [B] =
    greedy[i, accepted], the model's own next token at the first
    disagreement)."""
    greedy = np.asarray(greedy)
    tokens = np.asarray(tokens)
    b, k1 = tokens.shape
    k = k1 - 1
    if k:
        matches = greedy[:, :k] == tokens[:, 1:]
        a = np.where(matches.all(axis=1), k, np.argmin(matches, axis=1))
    else:
        a = np.zeros(b, dtype=np.int64)
    counts = (a + 1).astype(np.int32)
    bonus = greedy[np.arange(b), a].astype(np.int32)
    return counts, bonus


def draft_config(cfg: LlamaConfig, n_layers: int) -> LlamaConfig:
    """The self-draft model's config: cfg with its first n_layers."""
    return dataclasses.replace(cfg, n_layers=n_layers)


def truncate_params(model: Llama, n_layers: int) -> Llama:
    """Self-draft proposer: a Llama over the first `n_layers` of `model`'s
    layers. The layers, the embedding, the final norm and the lm_head
    (QuantWeight modules included) are the same tensors, not copies, so
    the draft costs no weight memory, only its own KV cache."""
    return Llama(draft_config(model.cfg, n_layers), embed=model.embed,
                 layers=list(model.layers[:n_layers]),
                 final_norm=model.final_norm, lm_head=model.lm_head)
