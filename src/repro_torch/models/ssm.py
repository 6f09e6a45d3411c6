"""Selective SSM (Mamba-style) used by the Hymba hybrid blocks.

The recurrence h_t = a_t ⊙ h_{t-1} + b_t runs *chunkwise*, as in the
reference: a Python loop over chunks of ``chunk`` positions carries the
(b, di, n) float32 state, and inside a chunk a log-depth (Hillis–Steele)
doubling scan over the (decay, drive) pairs gives every prefix at once —
8 doubling steps for 256 positions, where the reference runs
``lax.associative_scan``.  The per-position features (decay, drive) are
formed one chunk at a time, so live memory holds one chunk's expanded
(b, chunk, di, n) state, never the whole sequence's.  The last chunk may
be shorter than ``chunk`` (the reference asserts ``s % chunk == 0``): the
recurrence is the same however the positions are cut, so the function is
the reference's wherever the reference runs.

Plain torch, as the reference is plain ``jnp``: no kernel.  The float32
casts sit where the reference puts them (the feature projection, ``a``,
``decay``, ``drive``, the ``d_skip`` term, and the cast back before the
``silu(z)`` gate).  The combine order inside a chunk is not XLA's, so the
state agrees with the reference to float32 rounding, not bit for bit.

Simplifications vs. Mamba (the reference's): dt is a scalar per position
(x_proj emits 2n+1 features: B, C, dt) and the inner width equals
d_model.

Under a mesh of more than one rank (``x`` a DTensor) both paths run on
each rank's batch rows (``gspmd.run_rows``, the rows split as the policy
splits ``b``) with the inner width whole: the conv and the scan are per
(row, channel), but ``x_proj``'s B, C and dt features contract over the
channels, so a split inner width would need a sum there; the reference
leaves that choice to XLA, and the port keeps the channels whole.  The
parameters are gathered whole on every rank, their gradients summed over
the rows' axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.common import ParamFactory, on_rows


class SSMState(NamedTuple):
    h: torch.Tensor      # (b, di, n) float32
    conv: torch.Tensor   # (b, k-1, di) — causal-conv tail


def init_ssm(pf: ParamFactory, cfg) -> dict:
    D = cfg.d_model
    di = D
    n = cfg.ssm_state
    kc = cfg.ssm_conv
    return {
        "in_proj": pf.dense(D, 2 * di),
        "conv_w": pf.dense(kc, di, scale=kc ** -0.5),
        "x_proj": pf.dense(di, 2 * n + 1),
        "a_log": pf.ones(di, n),
        "d_skip": pf.ones(di),
        "out_proj": pf.dense(di, D),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor):
    """Depthwise causal conv along s.  x (b, s, di); w (k, di); tail
    (b, k-1, di) = the last k-1 inputs from the previous call."""
    k = w.shape[0]
    s = x.shape[1]
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    return out, xp[:, -(k - 1):]


def _ssm_features(p: dict, xin: torch.Tensor, n: int):
    f32 = torch.float32
    feats = torch.einsum("bsd,df->bsf", xin, p["x_proj"]).to(f32)
    B, C, dt = feats[..., :n], feats[..., n:2 * n], feats[..., 2 * n]
    dt = F.softplus(dt)[..., None]                          # (b, s, 1)
    a = -torch.exp(p["a_log"].to(f32))                      # (di, n)
    decay = torch.exp(dt[..., None] * a)                    # (b, s, di, n)
    drive = (dt * B)[..., None, :] * xin.to(f32)[..., None]
    return decay, drive, C


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of h_t = a_t h_{t-1} + b_t from h = 0:
    returns (A, B) with A_t = a_t ... a_0 and B_t the state after t.
    Hillis–Steele doubling: ceil(log2 L) steps, each combining every
    position with the one ``off`` before it."""
    L = a.shape[1]
    off = 1
    while off < L:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :off], a_cur * a_prev], dim=1)
        off *= 2
    return a, b


def ssm_forward(p: dict, x: torch.Tensor, cfg, *, chunk: int = 256,
                policy=None, mesh=None) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence path.  x: (b, s, D) -> (y, final state); on DTensors
    on each rank's batch rows (module docstring)."""
    if isinstance(x, DTensor):
        return on_rows(lambda p, x, _: ssm_forward(p, x, cfg, chunk=chunk),
                       p, x, None, policy, mesh)
    b, s, D = x.shape
    n = cfg.ssm_state
    di = D
    f32 = torch.float32
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)
    tail0 = torch.zeros((b, cfg.ssm_conv - 1, di), dtype=x.dtype, device=x.device)
    xin, tail = _causal_conv(xin, p["conv_w"], tail0)
    xin = F.silu(xin)

    h = torch.zeros((b, di, n), dtype=f32, device=x.device)
    ys = []
    for xc in xin.split(chunk, 1):  # split: one slice's backward is sequence-long
        decay, drive, C = _ssm_features(p, xc, n)
        A, Bd = _prefix_scan(decay, drive)                  # (b, L, di, n)
        hs = A * h[:, None] + Bd
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, C))     # contract state
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + xin.to(f32) * p["d_skip"].to(f32)
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"])
    return out, SSMState(h, tail)


def init_ssm_state(cfg, batch: int, dtype, device=None) -> SSMState:
    di = cfg.d_model
    return SSMState(
        torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device))


def ssm_decode(p: dict, x: torch.Tensor, state: SSMState, cfg, *,
               policy=None, mesh=None) -> tuple[torch.Tensor, SSMState]:
    """One-token step.  x: (b, 1, D).  Returns a new state; the one given
    is not written.  On DTensors on each rank's batch rows."""
    if isinstance(x, DTensor):
        return on_rows(lambda p, x, st: ssm_decode(p, x, st, cfg), p, x,
                       state, policy, mesh)
    n = cfg.ssm_state
    f32 = torch.float32
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)
    xin, tail = _causal_conv(xin, p["conv_w"], state.conv)
    xin = F.silu(xin)
    decay, drive, C = _ssm_features(p, xin, n)
    h = decay[:, 0] * state.h + drive[:, 0]                 # (b, di, n)
    y = torch.einsum("bdn,bn->bd", h, C[:, 0])[:, None]
    y = y + xin.to(f32) * p["d_skip"].to(f32)
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"])
    return out, SSMState(h, tail)
