"""Mixture-of-experts FFN on one device: the JAX package's capacity and
expert-choice routing, and its dropless token-choice variant.

A layer's weights: the router w_router [D, E] and the expert stacks
w_gate, w_up [E, D, F] and w_down [E, F, D]. The router runs in f32
(softmax, top-k, renormalized gates), whatever the activations' dtype.

Capacity routing (`moe_mlp`, `route`) is the JAX package's one-hot
dispatch and combine: each expert takes at most C = capacity(...)
tokens a batch row, earlier positions first and every token's first
choice before any second choice; an overflowing token passes through the
residual. Expert-choice routing (`route_expert_choice`) lets each expert
take its top-C tokens instead, which is non-causal over the sequence.
Both feed the same [B, S, E, C] einsums.

Dropless routing (`moe_mlp_dropless`) computes every routed (token,
expert) pair. The rows are sorted by expert (stably, so each expert's
rows keep token order), each expert's span goes through the SwiGLU FFN
as three matmuls (the JAX package's three ragged_dot calls), and the
combine inverts the sort and sums each token's k rows in rank order, so
its result does not depend on atomics. The spans come from a bincount
read on the host: one device sync a layer.

Across ranks (fsdp, dp or sp > 1, models/llama.forward's `share`) the
routing stays per batch row and local; the router's aux and z losses,
means over every token of the step in the JAX package, become each
rank's additive share of those means: its token sums over the step's
token count, with the first choices' expert fractions all-reduced (they
carry no gradient). The shares summed over the ranks are the JAX
package's values, and their gradients its gradients.

Expert parallelism (ep > 1, the JAX package's `_moe_dropless_ep`) waits
for ROADMAP item 12's remainder.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist
import torch.nn.functional as F

EP_TODO = ("expert parallelism (ep > 1) is not ported yet: MoE's ep > 1, "
           "the JAX package's _moe_dropless_ep (ROADMAP item 12's "
           "remainder)")


@dataclasses.dataclass(frozen=True)
class MoeMetrics:
    aux_loss: torch.Tensor          # load-balance loss (scalar)
    router_z_loss: torch.Tensor     # router logit magnitude control
    dropped_fraction: torch.Tensor


def capacity(seq_len: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    c = int(capacity_factor * seq_len * top_k / n_experts)
    return max(c, top_k)


def _router_logits(h: torch.Tensor, lp) -> torch.Tensor:
    return h.float() @ lp.w_router.float()


def _gating(router_logits: torch.Tensor, top_k: int):
    """Softmax, top-k and gate renormalization: (probs, gate values
    [..., k], expert indices [..., k]), the one gating every path
    shares."""
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(
        min=1e-9)
    return probs, gate_vals, expert_idx


def _router(h: torch.Tensor, lp, top_k: int):
    """(logits [B, S, E] f32, probs, gate values [B, S, k], expert
    indices [B, S, k])."""
    router_logits = _router_logits(h, lp)
    return (router_logits, *_gating(router_logits, top_k))


def _token_mean(x: torch.Tensor, share=None, dims=None) -> torch.Tensor:
    """x's mean over its token dims (all of them, or `dims`), or with a
    `share` (group, ranks) this rank's part of the mean over every
    rank's tokens: its sum over the step's token count."""
    dims = tuple(range(x.ndim)) if dims is None else dims
    if share is None:
        return x.mean(dim=dims)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return x.sum(dim=dims) / (n * share[1])


def _z_loss(router_logits, share=None) -> torch.Tensor:
    return _token_mean(torch.logsumexp(router_logits, dim=-1) ** 2, share)


def _aux_losses(router_logits, probs, expert_idx, n_experts: int,
                share=None):
    """The Switch load-balancing loss E * sum(f_i * P_i) over first
    choices, and the router z-loss; with a `share`, this rank's share
    of each (see the module docstring)."""
    onehot0 = F.one_hot(expert_idx[..., 0], n_experts).float()
    if share is None:
        frac_tokens = onehot0.mean(dim=(0, 1))
    else:
        counts = onehot0.sum(dim=(0, 1))
        dist.all_reduce(counts, group=share[0])
        frac_tokens = counts / (onehot0.shape[0] * onehot0.shape[1]
                                * share[1])
    mean_probs = _token_mean(probs, share, dims=(0, 1))
    aux = n_experts * (frac_tokens * mean_probs).sum()
    return aux, _z_loss(router_logits, share)


def route(router_logits: torch.Tensor, n_experts: int, top_k: int,
          cap: int, share=None):
    """router_logits [B, S, E] f32 -> (dispatch, combine, metrics), with
    dispatch and combine [B, S, E, C]. Earlier positions claim an
    expert's capacity first, and first choices before second ones."""
    b, s, e = router_logits.shape
    probs, gate_vals, expert_idx = _gating(router_logits, top_k)
    onehot = F.one_hot(expert_idx, e).float()                # [B,S,k,E]
    # Rank-major order, so every position's first choice outranks any
    # second choice; the running count is f32, as in the JAX package.
    rank_major = onehot.transpose(1, 2).reshape(b, top_k * s, e)
    pos = torch.cumsum(rank_major, dim=1) - 1.0
    pos = pos.reshape(b, top_k, s, e).transpose(1, 2)        # [B,S,k,E]
    within = (pos < cap).float() * onehot
    slot = (pos * within).sum(dim=-1)                        # [B,S,k]
    slot_oh = F.one_hot(slot.long(), cap).float()            # [B,S,k,C]
    kept = within.sum(dim=-1, keepdim=True)                  # [B,S,k,1]
    dispatch = torch.einsum("bske,bskc->bsec", within, slot_oh * kept)
    combine = torch.einsum("bske,bskc->bsec",
                           within * gate_vals[..., None], slot_oh)
    aux, z = _aux_losses(router_logits, probs, expert_idx, e, share)
    dropped = 1.0 - dispatch.sum() / (b * s * top_k)
    return dispatch, combine, MoeMetrics(aux, z, dropped)


def route_expert_choice(router_logits: torch.Tensor, cap: int,
                        share=None):
    """Expert-choice routing: each expert takes its top-`cap` tokens of
    the row (cap clamped to S). Returns (dispatch, combine, metrics) in
    route's shapes; the aux loss is zero (every expert is full) and
    dropped_fraction is the share of tokens no expert picked."""
    b, s, e = router_logits.shape
    cap = min(cap, s)
    probs = torch.softmax(router_logits, dim=-1)
    scores = probs.transpose(1, 2)                           # [B,E,S]
    gate_vals, token_idx = torch.topk(scores, cap, dim=-1)   # [B,E,C]
    slot_token = F.one_hot(token_idx, s).float()             # [B,E,C,S]
    dispatch = slot_token.permute(0, 3, 1, 2)                # [B,S,E,C]
    combine = torch.einsum("becs,bec->bsec", slot_token, gate_vals)
    z = _z_loss(router_logits, share)
    picked = dispatch.sum(dim=(2, 3)).clamp(0.0, 1.0)
    unrouted = 1.0 - picked.mean()
    return dispatch, combine, MoeMetrics(
        torch.zeros((), dtype=torch.float32, device=router_logits.device),
        z, unrouted)


def moe_mlp(h: torch.Tensor, lp, cfg, share=None):
    """h [B, S, D] normalized activations -> (out [B, S, D], metrics),
    through capacity (cfg.moe_router 'token_choice') or expert-choice
    routing and the one-hot dispatch and combine einsums."""
    b, s, d = h.shape
    e = cfg.n_experts
    dt = h.dtype
    cap = capacity(s, e, cfg.moe_top_k, cfg.moe_capacity_factor)
    router_logits = _router_logits(h, lp)
    if cfg.moe_router == "expert_choice":
        if s > 1:
            warnings.warn(
                "moe_router='expert_choice' routes non-causally over the "
                "sequence: training a causal LM with it leaks future "
                "positions into the router and creates train/decode skew. "
                "Use token_choice (optionally moe_dropless) for causal "
                "training.", stacklevel=2)
        dispatch, combine, metrics = route_expert_choice(router_logits, cap,
                                                         share)
    elif cfg.moe_router == "token_choice":
        dispatch, combine, metrics = route(router_logits, e, cfg.moe_top_k,
                                           cap, share)
    else:
        raise ValueError(f"unknown moe_router {cfg.moe_router!r}; valid: "
                         f"token_choice, expert_choice")
    expert_in = torch.einsum("bsec,bsd->becd", dispatch.to(dt), h)
    gate = F.silu(torch.einsum("becd,edf->becf", expert_in,
                               lp.w_gate.to(dt)))
    up = torch.einsum("becd,edf->becf", expert_in, lp.w_up.to(dt))
    expert_out = torch.einsum("becf,efd->becd", gate * up,
                              lp.w_down.to(dt))
    out = torch.einsum("bsec,becd->bsd", combine.to(dt), expert_out)
    return out, metrics


def sum_top_k(per_tok: torch.Tensor,
              gate_vals: torch.Tensor) -> torch.Tensor:
    """Each token's k expert outputs [N, k, D] weighted by its gates
    [N, k] and summed in rank order, in the outputs' dtype: [N, D]. No
    atomics, so the sum is the same from run to run."""
    gates = gate_vals.to(per_tok.dtype)
    out = per_tok[:, 0] * gates[:, :1]
    for j in range(1, per_tok.shape[1]):
        out = out + per_tok[:, j] * gates[:, j:j + 1]
    return out


def dropless_ffn(x: torch.Tensor, lp, n_experts: int,
                 gate_vals: torch.Tensor,
                 expert_idx: torch.Tensor) -> torch.Tensor:
    """Every routed (token, expert) pair of x [N, D], whose gates and
    experts are [N, k]: the rows sorted by expert; expert i takes the
    next counts[i] rows (counts read on the host) through the SwiGLU FFN,
    one matmul a weight (the JAX package's three ragged_dot calls); the
    sort inverted (a gather, not a scatter-add) and sum_top_k. An
    expert index of n_experts marks a pair computed on another rank: its
    output row is zero.

    Each stack is cast once and unbound, so the backward stacks the
    experts' gradients into one [E, ...] tensor; indexing the stack per
    expert would make each expert's backward a zeroed stack-sized
    gradient (1.88 GB in f32 at Mixtral-8x7B's widths)."""
    n_tok, k = expert_idx.shape
    expert_flat = expert_idx.reshape(-1)
    order = torch.argsort(expert_flat, stable=True)
    rows = x[order // k]
    counts = torch.bincount(expert_flat, minlength=n_experts).tolist()
    w_gate, w_up, w_down = (w.to(x.dtype).unbind(0)
                            for w in (lp.w_gate, lp.w_up, lp.w_down))
    outs = []
    start = 0
    for i, n in enumerate(counts[:n_experts]):
        if n:
            r = rows[start:start + n]
            gate = F.silu(r @ w_gate[i])
            outs.append((gate * (r @ w_up[i])) @ w_down[i])
            start += n
    if start < order.numel():
        # Pairs of index n_experts sort last: another rank computes
        # them (expert-sharded decode), and their rows stay zero here.
        outs.append(x.new_zeros(order.numel() - start, x.shape[-1]))
    down = torch.cat(outs)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return sum_top_k(down[inv].view(n_tok, k, -1), gate_vals)


def moe_mlp_dropless(h: torch.Tensor, lp, cfg, ep: int = 1, share=None):
    """Dropless token-choice MoE: h [B, S, D] -> (out, metrics), the
    router and weights of moe_mlp, every routed token computed
    (dropped_fraction 0)."""
    if ep > 1:
        raise NotImplementedError(EP_TODO)
    b, s, d = h.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    router_logits, probs, gate_vals, expert_idx = _router(h, lp, k)
    out = dropless_ffn(h.reshape(b * s, d), lp, e,
                       gate_vals.reshape(b * s, k),
                       expert_idx.reshape(b * s, k))
    aux, z = _aux_losses(router_logits, probs, expert_idx, e, share)
    return out.view(b, s, d), MoeMetrics(
        aux, z, torch.zeros((), dtype=torch.float32, device=h.device))
