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

The rule reads no memory: an abstract tensor (a fake or a meta tensor, as
the dry run's blocks are, which have none) is placed at its storage offset
from a base the caching allocator aligns to 512 bytes, so it takes the
design a real tensor of the same layout takes.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

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


def base_address(t: torch.Tensor) -> int:
    """``t.data_ptr()``; for a fake or meta tensor, which has no memory,
    its byte offset into its storage (the allocator aligns a storage's
    base)."""
    if isinstance(t, FakeTensor) or t.device.type == "meta":
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def tensor_addressable(t: torch.Tensor, inner: int) -> bool:
    return addressable(t.shape, t.stride(), t.element_size(), base_address(t), inner)
