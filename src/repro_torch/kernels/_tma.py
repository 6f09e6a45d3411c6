"""What the Tensor Memory Accelerator can address: the shape rule that
picks a kernel's design before launch.

A TMA tensor map describes a tensor by its base address, its dims and the
byte strides of every dim but the innermost, which must be contiguous.  The
base must be 16-byte aligned and each stride a positive multiple of 16
bytes below 2**40.  A dim of size 1 is never stepped over, so its stride
does not matter (the C side hands TMA a valid one in its place).  The
float32 ``"ffma"`` designs' 16-byte ``cp.async`` copies and float4 loads
take the same rule.

``DESIGNS`` names every design: ``"wgmma"`` (bf16 through TMA and wgmma:
the forward attention, the ring step, matmul and gmm), ``"ffma"`` (float32
through cp.async and register-tiled f32 FMAs: the forward attention and the
ring step at head dim 64 and 128, matmul and gmm) and ``"template"`` (the
first designs, which take any strides).
"""
from __future__ import annotations

import torch

DESIGNS = ("wgmma", "ffma", "template")


def addressable(shape, strides, itemsize: int, ptr: int, inner: int) -> bool:
    """True where TMA can load a tensor of ``shape`` / element ``strides``
    at byte address ``ptr`` with dim ``inner`` innermost."""
    if ptr % 16:
        return False
    for dim, (size, stride) in enumerate(zip(shape, strides)):
        if size == 1:
            continue
        if dim == inner:
            if stride != 1:
                return False
        elif stride <= 0 or (stride * itemsize) % 16 or stride * itemsize >= 1 << 40:
            return False
    return True


def tensor_addressable(t: torch.Tensor, inner: int) -> bool:
    return addressable(t.shape, t.stride(), t.element_size(), t.data_ptr(), inner)
