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
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.to(torch.float32)[..., None] * freqs    # (..., s, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., s, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
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
    return torch.matmul(x, head)


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
        "relu2": lambda x: torch.square(torch.clamp_min(x, 0)),
        "relu": lambda x: torch.clamp_min(x, 0),
    }[name]
