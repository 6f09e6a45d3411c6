"""Plain torch versions of every kernel: they define the semantics.

Each hand-written kernel is held against its plain version here: the CPU
tests compare these with the JAX package's oracles, and ``chip_smoke.py``
compares each CUDA kernel with them on the card.  The dispatcher
(``kernels/ops.py``) takes them for tensors that lie on the CPU.  All
accumulate in float32, as the reference does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(
    q: torch.Tensor,  # (b, hq, sq, d)
    k: torch.Tensor,  # (b, hkv, sk, d)
    v: torch.Tensor,  # (b, hkv, sk, d)
    *,
    causal: bool = True,
    window: int = 0,          # 0 = full; >0 = sliding window (causal)
    scale: float | None = None,
    q_offset: int = 0,        # absolute position of q[0] (decode steps)
    kv_offset: int = 0,       # absolute position of k[0] (ring-rotated blocks)
) -> torch.Tensor:
    """Multi-head (grouped-query) attention, numerically-safe softmax."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    qs = q.reshape(b, hkv, g, sq, d).to(torch.float32) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.to(torch.float32))
    keep = _mask(sq, sk, q_offset, kv_offset, causal, window, q.device)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))

    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / l, v.to(torch.float32))
    return o.reshape(b, hq, sq, d).to(q.dtype)


def attention_tiled(
    q: torch.Tensor,  # (b, hq, sq, d)
    k: torch.Tensor,  # (b, hkv, sk, d)
    v: torch.Tensor,  # (b, hkv, sk, d)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """``attention`` with the tile skipping of the TPU kernel, which is what
    the forward kernels compute.  q rows fall in blocks of ``min(128, sq)``
    and keys in blocks of ``min(128, sk)``, block ``i`` starting at offset +
    ``i`` * block size; a pair of blocks in which every (q, k) pair is
    masked is skipped.  Keys of a skipped pair weigh 0; masked keys of a
    pair that is not skipped score the finite -1e30.  Equal to ``attention``
    on every row that sees at least one key.  A row that sees none gets 0
    where all its pairs are skipped, else the mean of v over the keys of
    the pairs that are not.  Where sq or sk does not divide its block the
    last block is partial, and its nominal extent decides whether it is
    skipped."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    qs = q.reshape(b, hkv, g, sq, d).to(torch.float32) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.to(torch.float32))
    keep = _mask(sq, sk, q_offset, kv_offset, causal, window, q.device)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    visited = _blocks_relevant(sq, sk, q_offset, kv_offset, causal, window, q.device)
    s = torch.where(visited, s, torch.full_like(s, -torch.inf))

    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # rows no pair visits
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / l, v.to(torch.float32))
    return o.reshape(b, hq, sq, d).to(q.dtype)


def _blocks_relevant(sq, sk, q_offset, kv_offset, causal, window, device=None):
    """(sq, sk): whether the TPU kernel's grid visits the pair of blocks
    that holds (q row i, key j) (see ``attention_tiled``)."""
    bq, bk = min(128, sq), min(128, sk)
    q_lo = (torch.arange(sq, device=device) // bq) * bq + q_offset
    k_lo = (torch.arange(sk, device=device) // bk) * bk + kv_offset
    q_hi, k_hi = q_lo + bq - 1, k_lo + bk - 1
    rel = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        rel &= k_lo[None, :] <= q_hi[:, None]
    if window:
        rel &= k_hi[None, :] > q_lo[:, None] - window
    return rel


def _mask(sq, sk, q_offset, kv_offset, causal, window, device=None):
    """(sq, sk) keep-mask for a (q block, kv block) pair at absolute
    positions ``q_offset`` / ``kv_offset``."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device) + kv_offset
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_step(
    q: torch.Tensor,  # (b, hq, sq, d)
    k: torch.Tensor,  # (b, hkv, sk_blk, d)  — one kv block
    v: torch.Tensor,  # (b, hkv, sk_blk, d)
    carry: tuple | None = None,  # (m, l, acc) from previous blocks, or None
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax step over a kv block: fold the block's scores into
    the carried state ``(m, l, acc)`` (running max (b,hq,sq), normalizer
    (b,hq,sq), unnormalized accumulator (b,hq,sq,d), all f32).  Chaining it
    over every kv block (any order, matching ``kv_offset``) and finalizing
    with ``attention_finalize`` reproduces ``attention``."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    f32 = torch.float32

    qs = q.reshape(b, hkv, g, sq, d).to(f32) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.to(f32))
    keep = _mask(sq, sk, q_offset, kv_offset, causal, window, q.device)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF)).reshape(b, hq, sq, sk)

    if carry is None:
        m_prev = torch.full((b, hq, sq), NEG_INF, dtype=f32, device=q.device)
        l_prev = torch.zeros((b, hq, sq), dtype=f32, device=q.device)
        acc_prev = torch.zeros((b, hq, sq, d), dtype=f32, device=q.device)
    else:
        m_prev, l_prev, acc_prev = carry

    m_new = torch.maximum(m_prev, torch.amax(s, dim=-1))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])                  # (b, hq, sq, sk)
    l_new = l_prev * alpha + torch.sum(p, dim=-1)
    pv = torch.einsum("bhgqk,bhkd->bhgqd",
                      p.reshape(b, hkv, g, sq, sk), v.to(f32))
    acc_new = acc_prev * alpha[..., None] + pv.reshape(b, hq, sq, d)
    return m_new, l_new, acc_new


def attention_finalize(carry: tuple, dtype=torch.float32) -> torch.Tensor:
    """(m, l, acc) -> normalized output (b, hq, sq, d); ``l == 0`` yields 0,
    matching the kernels' convention."""
    _, l, acc = carry
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) in f32 accumulation."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped (expert) matmul on capacity-padded buffers:
    (e, c, k) @ (e, k, n) -> (e, c, n), f32 accumulation."""
    return torch.einsum("eck,ekn->ecn", x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)


def vjp(plain, saved, needs, ct) -> tuple:
    """The cotangents of ``plain(*saved)`` for the inputs flagged in
    ``needs`` (None for the others): the plain version recomputed from the
    saved inputs and differentiated by autograd.  The backward of every
    kernel wrapper's ``torch.autograd.Function``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        out = plain(*ins)
        wrt = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(out, wrt, ct))
    return tuple(next(got) if t.requires_grad else None for t in ins)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * g.to(torch.float32)).to(x.dtype)
