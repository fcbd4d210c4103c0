"""Ring attention: causal attention over a sequence split on the 'sp'
mesh axis, the JAX package's parallel/ring_attention.py over ranks.

Each sp rank holds one contiguous chunk of the sequence's q, k and v.
The k and v chunks travel around the ring (`ppermute`, rank i to i + 1)
while each rank folds every chunk into an f32 online softmax over its
own q chunk (`_chunk_attn`, `_combine`): sp chunk products, sp - 1 hops.
KV heads are repeated to the q heads first, as in the JAX package, and
under the causal mask a chunk wholly above the diagonal is skipped.

The chunk math is plain torch, as the JAX body is jnp (no Pallas, so no
kernel is owed for it). `ppermute` is an autograd function whose
backward is the reverse permutation. Its form follows the placement,
once: gloo ends the process on a send or receive of a CUDA tensor, so
on gloo with CUDA tensors (ranks sharing one card) a hop is an
all_to_all_single whose only non-empty split goes to the neighbour; on
NCCL, or gloo on the CPU, it is batch_isend_irecv.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.ops.attention import repeat_kv
from container_engine_accelerators_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def permute_form(backend: str | None, device: torch.device) -> str:
    """'all_to_all' for gloo on CUDA tensors, else 'p2p'."""
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "all_to_all"
    return "p2p"


def _permute(x: torch.Tensor, group, shift: int, form: str) -> torch.Tensor:
    """Rank i's x to rank i + shift of `group`; returns what rank
    i - shift sent."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    dst, src = (r + shift) % n, (r - shift) % n
    x = x.contiguous()
    out = torch.empty_like(x)
    if form == "all_to_all":
        send = [0] * n
        recv = [0] * n
        send[dst] = recv[src] = x.numel()
        dist.all_to_all_single(out.view(-1), x.view(-1), recv, send,
                               group=group)
        return out
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class PPermute(torch.autograd.Function):
    """ppermute(x): each rank's x to the next rank of the ring; the
    backward sends the gradient back the other way."""

    @staticmethod
    def forward(ctx, x, group, form: str):
        ctx.group, ctx.form = group, form
        return _permute(x, group, 1, form)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -1, ctx.form), None, None


def _chunk_attn(q, k, v, row_offset: int, col_offset: int, causal: bool):
    """Unnormalised blockwise attention. q [B, Sq, H, D], k/v [B, Sk, H,
    D] -> (acc [B, Sq, H, D] f32, m [B, Sq, H] f32, l [B, Sq, H] f32)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = row_offset + torch.arange(logits.shape[2],
                                         device=q.device)[:, None]
        cols = col_offset + torch.arange(logits.shape[3],
                                         device=q.device)[None, :]
        logits = torch.where(rows >= cols, logits,
                             torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)                            # [B, H, Sq]
    # A fully masked row: exp(logits - m) would be 1 everywhere.
    m_safe = torch.clamp(m, min=0.5 * NEG_INF)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(m[..., None] <= 0.5 * NEG_INF, torch.zeros_like(p), p)
    l = p.sum(dim=-1)                                  # [B, H, Sq]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc, m_safe.transpose(1, 2), l.transpose(1, 2)


def _combine(acc1, m1, l1, acc2, m2, l2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, l1 * a1 + l2 * a2


def ring_attention(q, k, v, mesh: Mesh, causal: bool = True):
    """This sp rank's block of attention over the whole sequence. q
    [B, S/sp, Hq, D], k/v [B, S/sp, Hkv, D]: the rank's chunk (chunk i
    of the sequence on sp coordinate i); returns [B, S/sp, Hq, D] in
    q.dtype."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    n = mesh.axis_size("sp")
    idx = mesh.coord["sp"]
    chunk = q.shape[1]
    group = mesh.group("sp")
    form = permute_form(mesh.backend, q.device)
    # K and V travel as one tensor: one hop a step, and the hops form one
    # chain, so every rank runs their backwards in the same order.
    kv = torch.stack([k, v])
    acc = m = l = None
    for step in range(n):
        if step:
            kv = PPermute.apply(kv, group, form)
        # After `step` hops this rank holds the chunk of rank idx - step.
        src = (idx - step) % n
        if not causal or src <= idx:
            part = _chunk_attn(q, kv[0], kv[1], idx * chunk, src * chunk,
                               causal)
            acc, m, l = part if acc is None else _combine(acc, m, l, *part)
        elif step == n - 1:
            # A skipped last chunk: its hop stays in the graph with a zero
            # gradient, so every rank's backward sends it back.
            l = l + 0.0 * kv.flatten()[0].float()
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
