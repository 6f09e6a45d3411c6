"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-
parallel) and sLSTM (scalar memory, inherently sequential).

The mLSTM runs in *chunkwise* form, as in the reference: a Python loop
over chunks of ``chunk`` positions carries the (b, h, d, d) matrix memory
C, the normalizer N and the log-space stabilizer M; within a chunk the
quadratic (L x L) gate-decay matrix is formed whole.  M starts at -inf:
``exp(Fc + M - m)`` is then an exact 0, and no gradient reaches a -inf
(every max over it picks a finite branch).  The last chunk may be shorter
than ``chunk`` (the reference asserts ``s % chunk == 0``); the stabilizer
is the running log-max of the whole history however the chunks fall, so
the function is the reference's wherever the reference runs.

The sLSTM loops over positions in Python (the reference's ``lax.scan``).
Its input projection ``x_t @ w_in`` does not depend on the recurrence, so
it is taken out of the loop as one (b·s, D) @ (D, 4D) product; ``h @ r``
stays inside.  The sums then run in another order than the reference's
per-step product: in float32 the block's output moves by about 1e-6 on
outputs of order 1 (``tests/test_torch_zoo.py`` holds it at rtol 1e-4 /
atol 1e-5).

Plain torch, as the reference is plain ``jnp``: no kernel.  Gating follows
the paper's stabilized exponential form: i and f in log space, a running
max m subtracted before exponentiation.

Under a mesh of more than one rank (``x`` a DTensor) every path runs on
each rank's batch rows (``gspmd.run_rows``: the rows split as the policy
splits ``b``, the sequence whole, as the reference notes it is never
sharded), with the parameters gathered whole and their gradients summed
over the rows' axes.  The sLSTM's per-position loop then runs on plain
local tensors: at DTensor's dispatch cost an op, 32k positions of it
would take hours.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.common import ParamFactory, on_rows, rmsnorm

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (b, h, d, d) matrix memory
    n: torch.Tensor   # (b, h, d)    normalizer
    m: torch.Tensor   # (b, h)       running log-max (stabilizer)


def init_mlstm(pf: ParamFactory, cfg) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    return {
        "w_up": pf.dense(D, 2 * D),      # -> (mlstm input, output gate z)
        "wq": pf.dense(D, D),
        "wk": pf.dense(D, D),
        "wv": pf.dense(D, D),
        "w_if": pf.dense(D, 2 * H),      # input & forget gate preacts per head
        "w_down": pf.dense(D, D),
        "norm": pf.ones(D),
    }


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h).transpose(1, 2)       # (b, h, s, dh)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


def _mlstm_chunk(carry: MLSTMState, qq, kk, vv, ii, ff):
    """One chunk: (new carry, h (b, h, L, dh)).  qq, kk, vv (b, h, L, dh);
    the gates ii, ff (b, h, L), ff in log space."""
    C, N, M = carry
    L = qq.shape[2]
    Fc = torch.cumsum(ff, dim=-1)                           # cumulative log f
    # stabilizer: m_t = max(Fc_t + M, max_{j<=t}(Fc_t - Fc_j + i_j))
    a = Fc + M[..., None]                                   # inter contribution
    blog = Fc[..., :, None] - Fc[..., None, :] + ii[..., None, :]  # (b,h,L,L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=qq.device))
    blog = torch.where(tri, blog, torch.full_like(blog, float("-inf")))
    m_t = torch.maximum(a, torch.amax(blog, dim=-1))        # (b,h,L)
    Ddec = torch.exp(blog - m_t[..., None])                 # intra decay matrix
    inter_w = torch.exp(a - m_t)                            # (b,h,L)
    s_qk = torch.einsum("bhld,bhjd->bhlj", qq, kk)
    h_intra = torch.einsum("bhlj,bhjd->bhld", s_qk * Ddec, vv)
    h_inter = torch.einsum("bhld,bhde->bhle", qq, C) * inter_w[..., None]
    # normalizer: n_t = sum_j decay * k_j  (intra)  +  inter_w * N
    n_intra = torch.einsum("bhlj,bhjd->bhld", Ddec, kk)
    n_t = n_intra + inter_w[..., None] * N[:, :, None, :]
    h_num = h_intra + h_inter
    denom = torch.maximum(torch.abs(torch.einsum("bhld,bhld->bhl", qq, n_t)),
                          torch.exp(-m_t))[..., None]
    h_out = h_num / denom                                   # (b,h,L,dh)
    # carry update to the end of the chunk
    last = Fc[..., -1:] - Fc + ii
    m_new = torch.maximum(Fc[..., -1] + M, torch.amax(last, dim=-1))
    wgt = torch.exp(last - m_new[..., None])                # (b,h,L)
    fw = torch.exp(Fc[..., -1] + M - m_new)
    C_new = (fw[..., None, None] * C
             + torch.einsum("bhl,bhld,bhle->bhde", wgt, kk, vv))
    N_new = fw[..., None] * N + torch.einsum("bhl,bhld->bhd", wgt, kk)
    return MLSTMState(C_new, N_new, m_new), h_out


def mlstm_forward(p: dict, x: torch.Tensor, cfg, *, chunk: int = 256,
                  policy=None, mesh=None) -> tuple[torch.Tensor, MLSTMState]:
    if isinstance(x, DTensor):
        return on_rows(lambda p, x, _: mlstm_forward(p, x, cfg, chunk=chunk),
                       p, x, None, policy, mesh)
    b, s, D = x.shape
    H = cfg.n_heads
    dh = D // H
    f32 = torch.float32
    up = torch.einsum("bsd,de->bse", x, p["w_up"])
    xm, z = torch.chunk(up, 2, dim=-1)
    q = _heads(torch.einsum("bsd,de->bse", xm, p["wq"]), H).to(f32)
    k = _heads(torch.einsum("bsd,de->bse", xm, p["wk"]), H).to(f32) * dh ** -0.5
    v = _heads(torch.einsum("bsd,de->bse", xm, p["wv"]), H).to(f32)
    gates = torch.einsum("bsd,dg->bsg", xm, p["w_if"]).to(f32)
    i_pre = gates[..., :H].transpose(1, 2)                  # (b, h, s)
    logf = _log_sigmoid(gates[..., H:].transpose(1, 2))

    carry = init_mlstm_state(cfg, b, device=x.device)
    hs = []
    # split, not a slice per chunk: the backward of each slice would make a
    # zero gradient of the whole sequence, quadratic work in the chunks
    for qq, kk, vv, ii, ff in zip(q.split(chunk, 2), k.split(chunk, 2), v.split(chunk, 2),
                                  i_pre.split(chunk, -1), logf.split(chunk, -1)):
        carry, h = _mlstm_chunk(carry, qq, kk, vv, ii, ff)
        hs.append(h)
    h = torch.cat(hs, dim=2)                                # (b,h,s,dh)
    h = h.transpose(1, 2).reshape(b, s, D).to(x.dtype)
    h = rmsnorm(h, p["norm"])
    out = torch.einsum("bsd,de->bse", h * F.silu(z), p["w_down"])
    return out, carry


def init_mlstm_state(cfg, batch: int, device=None) -> MLSTMState:
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    f32 = torch.float32
    return MLSTMState(
        torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        torch.zeros((batch, H, dh), dtype=f32, device=device),
        torch.full((batch, H), float("-inf"), dtype=f32, device=device))


def mlstm_decode(p: dict, x: torch.Tensor, state: MLSTMState, cfg, *,
                 policy=None, mesh=None) -> tuple[torch.Tensor, MLSTMState]:
    """One-token recurrent step (exact xLSTM eqs. 19-27).  Returns a new
    state; the one given is not written."""
    if isinstance(x, DTensor):
        return on_rows(lambda p, x, st: mlstm_decode(p, x, st, cfg), p, x,
                       state, policy, mesh)
    b, _, D = x.shape
    H = cfg.n_heads
    dh = D // H
    f32 = torch.float32
    up = torch.einsum("bsd,de->bse", x, p["w_up"])
    xm, z = torch.chunk(up, 2, dim=-1)

    def proj(w):
        return torch.einsum("bsd,de->bse", xm, w)[:, 0].reshape(b, H, dh).to(f32)

    q, k, v = proj(p["wq"]), proj(p["wk"]) * dh ** -0.5, proj(p["wv"])
    gates = torch.einsum("bsd,dg->bsg", xm, p["w_if"])[:, 0].to(f32)
    i_pre, f_pre = gates[..., :H], gates[..., H:]
    logf = _log_sigmoid(f_pre)
    m_new = torch.maximum(logf + state.m, i_pre)
    fw = torch.exp(logf + state.m - m_new)
    iw = torch.exp(i_pre - m_new)
    C = fw[..., None, None] * state.c + iw[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    N = fw[..., None] * state.n + iw[..., None] * k
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, N)),
                          torch.exp(-m_new))[..., None]
    h = torch.einsum("bhd,bhde->bhe", q, C) / denom
    h = h.reshape(b, 1, D).to(x.dtype)
    h = rmsnorm(h, p["norm"])
    out = torch.einsum("bsd,de->bse", h * F.silu(z), p["w_down"])
    return out, MLSTMState(C, N, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (b, d)
    n: torch.Tensor   # (b, d)
    h: torch.Tensor   # (b, d)
    m: torch.Tensor   # (b, d)


def init_slstm(pf: ParamFactory, cfg) -> dict:
    D = cfg.d_model
    return {
        "w_in": pf.dense(D, 4 * D),     # z, i, f, o preacts from x
        "r": pf.dense(D, 4 * D, scale=D ** -0.5),  # recurrent (block approx)
        "w_down": pf.dense(D, D),
        "norm": pf.ones(D),
    }


def _slstm_gates(pre: torch.Tensor, st: SLSTMState) -> SLSTMState:
    """The cell's update from its (b, 4D) float32 pre-activations."""
    z, i_pre, f_pre, o = torch.chunk(pre, 4, dim=-1)
    logf = _log_sigmoid(f_pre)
    m_new = torch.maximum(logf + st.m, i_pre)
    fw = torch.exp(logf + st.m - m_new)
    iw = torch.exp(i_pre - m_new)
    c = fw * st.c + iw * torch.tanh(z)
    n = fw * st.n + iw
    h = torch.sigmoid(o) * c / torch.clamp_min(n, 1.0)
    return SLSTMState(c, n, h, m_new)


def _slstm_cell(p, x_t, st: SLSTMState) -> SLSTMState:
    f32 = torch.float32
    return _slstm_gates(x_t @ p["w_in"].to(f32) + st.h @ p["r"].to(f32), st)


def init_slstm_state(cfg, batch: int, device=None) -> SLSTMState:
    D = cfg.d_model
    z = torch.zeros((batch, D), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, torch.full((batch, D), float("-inf"),
                                          dtype=torch.float32, device=device))


def slstm_forward(p: dict, x: torch.Tensor, cfg, *, policy=None, mesh=None
                  ) -> tuple[torch.Tensor, SLSTMState]:
    if isinstance(x, DTensor):
        return on_rows(lambda p, x, _: slstm_forward(p, x, cfg), p, x, None,
                       policy, mesh)
    b, s, D = x.shape
    f32 = torch.float32
    # x_t @ w_in for every t in one product; h @ r stays in the loop
    px = (x.to(f32).reshape(b * s, D) @ p["w_in"].to(f32)).reshape(b, s, 4 * D)
    r = p["r"].to(f32)
    st = init_slstm_state(cfg, b, device=x.device)
    hs = []
    # unbind, not px[:, t]: the backward of one select per position would
    # make a zero (b, s, 4D) gradient each, s^2 work in all
    for px_t in px.unbind(1):
        st = _slstm_gates(px_t + st.h @ r, st)
        hs.append(st.h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = rmsnorm(h, p["norm"])
    return torch.einsum("bsd,de->bse", h, p["w_down"]), st


def slstm_decode(p: dict, x: torch.Tensor, state: SLSTMState, cfg, *,
                 policy=None, mesh=None) -> tuple[torch.Tensor, SLSTMState]:
    """One-token step.  Returns a new state; the one given is not written."""
    if isinstance(x, DTensor):
        return on_rows(lambda p, x, st: slstm_decode(p, x, st, cfg), p, x,
                       state, policy, mesh)
    st = _slstm_cell(p, x[:, 0].to(torch.float32), state)
    h = st.h[:, None].to(x.dtype)
    h = rmsnorm(h, p["norm"])
    return torch.einsum("bsd,de->bse", h, p["w_down"]), st
