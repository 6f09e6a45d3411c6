"""AdamW with global-norm clipping and an optional bf16 stochastic-rounding
gradient-compression transform — the reference's optimizer
(``repro/optim/adamw.py``) over trees of tensors.

Plain tree implementation (no ``torch.optim``): the moments are f32, one
per parameter leaf, and the update is the reference's arithmetic leaf by
leaf.  It runs under ``torch.no_grad()`` and writes the parameters and the
moments in place, so a step holds one f32 working copy of one leaf at a
time beside the state.  Trees are nested dicts, lists and tuples of
tensors; leaves are visited in the reference's flattening order
(``core/tree.py``), so the global norm sums in the same order.

On a mesh the parameters, gradients and moments are DTensors of one
placement per leaf: the moments are made beside the parameters' blocks,
each leaf's sum of squares is taken over the whole tensor (DTensor reduces
it across the ranks that split it) before the global norm sums the
leaves, and the update runs on each rank's blocks.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from torch.distributed.tensor import DTensor

from repro_torch.core import tree
from repro_torch.core.gspmd import full, replicate_like


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero f32 moments beside every parameter, on its device; step 0."""
    leaves = tree.leaves(params)
    dev = leaves[0].device if leaves else None

    def zero(p):
        if isinstance(p, DTensor):  # the parameter's placements
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree.map(zero, params), tree.map(zero, params))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, each back in
    its own dtype, the norm before clipping)."""
    g2 = sum(full(torch.sum(torch.square(g.to(torch.float32))))
             for g in tree.leaves(grads))
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    return tree.map(lambda g: (g.to(torch.float32)
                               * replicate_like(scale, g)).to(g.dtype),
                    grads), norm


def compress_grads(grads, generator: torch.Generator):
    """bf16 stochastic rounding: the all-reduce then moves half the bytes.
    Noise uniform in [-0.5, 0.5) from ``generator`` (which lives on the
    gradients' device) times 2^-8 |g|.  Off by default, as in the
    reference."""
    def one(g):
        gf = g.to(torch.float32)
        noise = torch.rand(gf.shape, generator=generator, dtype=torch.float32,
                           device=gf.device) - 0.5
        scale = 2.0 ** -8  # bf16 mantissa step at unit scale
        return (gf + noise * scale * torch.abs(gf)).to(torch.bfloat16)

    return tree.map(one, grads)


def adamw_update(params, grads, state: AdamWState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step with global-norm clipping.  Writes the parameters,
    the moments and the step counter in place (where the reference
    donates them: a captured step replays on the same tensors, so a new
    counter would never advance) and returns ``(params, AdamWState, grad
    norm)``.  ``lr`` is a float or a 0-d tensor."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state.step.add_(1)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.full_like(stepf, b1) ** stepf
        b2c = 1 - torch.full_like(stepf, b2) ** stepf
        lr = (lr.to(device=stepf.device, dtype=torch.float32)
              if isinstance(lr, torch.Tensor) else torch.full_like(stepf, lr))
        for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                              tree.leaves(state.m), tree.leaves(state.v)):
            p, g, m, v = (_local(t) for t in (p, g, m, v))
            gf = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            del gf  # one f32 working copy of a leaf at a time
            update = (m / b1c).div_(torch.sqrt(v / b2c).add_(eps))
            pf = p.to(torch.float32)
            pf = pf - lr * (update.add_(weight_decay * pf))
            p.copy_(pf)
    return params, AdamWState(step, state.m, state.v), gnorm


def _local(t):
    """A DTensor's block on this rank (an alias: writes land in it)."""
    return t.to_local() if isinstance(t, DTensor) else t
