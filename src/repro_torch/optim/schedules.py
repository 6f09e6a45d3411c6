"""LR schedules: cosine (llama-style) and WSD (warmup-stable-decay — the
MiniCPM schedule its config asks for).  The reference's float32 arithmetic
on 0-d tensors."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, stable: int,
                 decay: int, floor_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> stable plateau -> short exponential-ish decay (MiniCPM)."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
    # the base made on the device (a fill, not a host copy: legal under a
    # CUDA graph's capture)
    dec = peak_lr * torch.pow(torch.full_like(step, floor_frac), prog)
    return torch.where(step < warmup, warm,
                       torch.where(step < warmup + stable,
                                   torch.full_like(step, peak_lr), dec))
