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
    sums the token losses of its (batch, sequence) block with the whole
    vocabulary gathered — a logsumexp DTensor cannot propagate on every
    torch this runs on — and the sum over ranks, divided by the token
    count, is the mean, replicated."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        return _xent_placed(logits, labels, vocab_real, mesh)
    return torch.mean(_xent_terms(logits, labels, vocab_real))


def _xent_placed(logits, labels, vocab_real, mesh):
    from repro_torch.core import gspmd

    # keep the batch and sequence shards; gather the vocabulary
    spec = gspmd.spec_of_placements(
        [p if p.is_shard() and p.dim < 2 else gspmd.Replicate()
         for p in logits.placements], logits.ndim, mesh)
    lf = gspmd.constrain(logits, mesh, spec).to_local()
    lb = gspmd.constrain(labels, mesh, spec[:2]).to_local()
    # each rank's sum as one entry of a (batch shards, sequence shards)
    # grid; the sum over the grid is the total, and its gradient reaches
    # every rank's sum with weight one
    local = torch.sum(_xent_terms(lf, lb, vocab_real)).reshape(1, 1)
    grid = gspmd.wrap_block(local, mesh, spec[:2])
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
