"""Shared model components: norms, RoPE, embeddings, init.

Parameters are plain dicts of tensors; layer stacks carry a leading axis of
units (one per pattern period), the reference's layout, so a parameter tree
of the JAX package maps leaf for leaf (``transformer.from_reference_params``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype


def dtype_of(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    card.  Never drops to the CPU unless asked to."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (--device "
                "cpu) to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device "
                           "is available")
    return dev


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


class ParamFactory:
    """Makes seeded, fan-in scaled params on one device.

    ``stack`` > 0 gives every leaf a leading axis of that many units (the
    scanned layer stack); the fan-in is that of one unit's shape.  Values
    come from the explicit ``generator`` (which must live on ``device``),
    so one seed gives one set of weights per device type."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device, stack: int = 0):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.stack = stack

    def _shape(self, shape):
        return ((self.stack,) if self.stack else ()) + tuple(shape)

    def dense(self, *shape: int, scale: float | None = None) -> torch.Tensor:
        fan_in = shape[0] if len(shape) >= 2 else 1
        s = scale if scale is not None else fan_in ** -0.5
        w = torch.randn(self._shape(shape), generator=self.generator,
                        dtype=torch.float32, device=self.device)
        return (w.mul_(s)).to(self.dtype)

    def zeros(self, *shape: int) -> torch.Tensor:
        return torch.zeros(self._shape(shape), dtype=self.dtype,
                           device=self.device)

    def ones(self, *shape: int) -> torch.Tensor:
        return torch.ones(self._shape(shape), dtype=self.dtype,
                          device=self.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in f32, cast back, *then* scale by ``g`` in x's dtype (the
    model stack's order; ``kernels/ref.rmsnorm`` scales before the cast)."""
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * g


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., s, h, hd); positions: (s,) or broadcastable to x[..., :, 0, 0].
    Computed in f32, cast back to x's dtype."""
    from repro_torch.core.gspmd import replicate_like

    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.to(torch.float32)[..., None] * freqs    # (..., s, hd/2)
    cos = replicate_like(torch.cos(ang)[..., None, :], x)   # (..., s, 1, hd/2)
    sin = replicate_like(torch.sin(ang)[..., None, :], x)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def lm_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x (b, s, d) @ head (d, v) -> (b, s, v)."""
    from repro_torch.core.gspmd import matmul

    return matmul(x, head)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_real: int | None = None, *, mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy, f32 logsumexp, padded ids masked.

    On DTensors (``mesh`` the ``launch.mesh.Mesh`` they live on) each rank
    keeps its (batch, sequence, vocabulary) block: the logsumexp and the
    gold logit of its tokens combine across the vocabulary's axes (the
    running max by an all-reduce of max, the sums of the shifted
    exponentials and of the gold logits by all-reduces of their partial
    sums; float32 sums in another order than one rank's), each rank sums
    its block's token losses, and the sum over ranks, divided by the token
    count, is the mean, replicated.  No rank holds a float32 copy of the
    whole vocabulary's logits."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        return _xent_placed(logits, labels, vocab_real, mesh)
    return torch.mean(_xent_terms(logits, labels, vocab_real))


def _xent_placed(logits, labels, vocab_real, mesh):
    from repro_torch.core import gspmd

    spec = gspmd.spec_of_placements(
        [p if p.is_shard() else gspmd.Replicate() for p in logits.placements],
        logits.ndim, mesh)
    rows, v_axes = spec[:2], gspmd.entry_axes(spec[2])
    lf = gspmd.constrain(logits, mesh, spec).to_local().to(torch.float32)
    lb = gspmd.constrain(labels, mesh, rows).to_local().long()
    vl = lf.shape[-1]
    v0 = mesh.linear_index(v_axes) * vl
    if vocab_real is not None and vocab_real < logits.shape[-1]:
        cols = torch.arange(v0, v0 + vl, device=lf.device)
        lf = lf + torch.where(cols < vocab_real, 0.0, -1e30)

    m = torch.amax(lf.detach(), dim=-1)
    if v_axes:
        m = gspmd.constrain(gspmd.wrap_block(m, mesh, rows, [(a, "max") for a in v_axes]),
                            mesh, rows).to_local()
    se = torch.sum(torch.exp(lf - m[..., None]), dim=-1)
    lse = m + torch.log(gspmd.psum(se, mesh, v_axes, rows))
    inside = (lb >= v0) & (lb < v0 + vl)
    gold = torch.gather(lf, -1, torch.where(inside, lb - v0, 0)[..., None])[..., 0]
    gold = gspmd.psum(torch.where(inside, gold, 0.0), mesh, v_axes, rows)
    # each rank's sum as one entry of a (batch shards, sequence shards)
    # grid; the sum over the grid is the total, and its gradient reaches
    # every rank's sum with weight one
    local = torch.sum(lse - gold).reshape(1, 1)
    grid = gspmd.wrap_block(local, mesh, rows)
    return gspmd.constrain(torch.sum(grid), mesh, ()) / labels.numel()


def _xent_terms(logits, labels, vocab_real):
    """Per-token ``logsumexp - gold logit`` in f32."""
    lf = logits.to(torch.float32)
    if vocab_real is not None and vocab_real < lf.shape[-1]:
        pad = lf.shape[-1] - vocab_real
        mask = torch.cat([torch.zeros(vocab_real, dtype=torch.float32,
                                      device=lf.device),
                          torch.full((pad,), -1e30, dtype=torch.float32,
                                     device=lf.device)])
        lf = lf + mask
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return lse - gold


def on_rows(fn, p, x, state, policy, mesh):
    """``fn(p, x, state) -> (out, new state)`` of a recurrent block on this
    rank's batch rows, split as ``policy`` splits ``b`` on ``mesh``
    (``gspmd.run_rows``)."""
    from repro_torch.core.gspmd import run_rows
    from repro_torch.models.policy import batch_entry

    return run_rows(fn, p, x, state, mesh, batch_entry(policy, mesh, x.shape[0]))


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
        "relu2": lambda x: torch.square(torch.clamp_min(x, 0)),
        "relu": lambda x: torch.clamp_min(x, 0),
    }[name]
