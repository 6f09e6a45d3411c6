"""What one rank's step costs, read off the ops it dispatches: FLOPs,
bytes, collectives and live memory — the dry run's counterpart of XLA's
cost and memory analyses (``launch/dryrun.py``).

``StepCosts`` is a ``TorchDispatchMode`` that steps aside for DTensor, so
it sees every op on this rank's local blocks, real or fake: per-device
numbers, as the reference's SPMD-partitioned module gives them.

  * FLOPs: ``FlopCounterMode``'s formulas (``flop_counter.flop_registry``:
    the matrix products, convolutions, SDPA, and the kernels' operators,
    ``kernels/ops.py``) on the local shapes; an op without a formula is
    decomposed where it has a composite form, as ``FlopCounterMode`` does.
  * Bytes: each op's input and output bytes, summed — every operand read
    and every result written once an op, with no fusion and no reuse
    across ops: the upper bound that XLA's "bytes accessed" is too.  Views
    and allocations move nothing and count nothing.
  * Collectives: a ``hlo_analysis.CollectiveLog``.
  * Live memory: every storage an op creates, from its creation until its
    last reference dies (a weak reference on the storage tells), on top of
    the storages ``track`` was given (the step's arguments); its peak.  The
    result of a collective's wait, or of its async wrapper, is its input on
    a card: a storage those ops make joins their input's buffer, which
    lives until the last of them dies.  With ``tag_buffers`` each buffer is
    also tagged with the op that made it and the innermost line of the
    port's model code on the stack, and ``peak_buffers`` lists the buffers
    live when the peak was last raised (``tools/dryrun_peak.py`` prints
    them by tag).

DTensor derives an op's output metadata by running the op once more on
fake tensors of the global shape
(``ShardingPropagator._propagate_tensor_meta_non_cached``); those runs are
no part of the rank's step, and the mode skips them.
"""
from __future__ import annotations

import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.hlo_analysis import CollectiveLog

#: ops that allocate without writing, or hand their input back
_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "empty_like", "wait_tensor", "_wrap_tensor_autograd"}

#: ops whose result is their input on a card (an async collective's
#: wrapper and its wait), whatever storage a fake or meta kernel gives it
_ALIASING = {"wait_tensor", "_wrap_tensor_autograd"}

#: metadata queries, which FlopCounterMode leaves to the tensor itself
_METADATA = {torch.ops.aten.is_contiguous.default, torch.ops.aten.sym_size.default,
             torch.ops.aten.sym_stride.default, torch.ops.aten.numel.default,
             torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default,
             torch.ops.aten.stride.default, torch.ops.aten.size.default,
             torch.ops.aten.storage_offset.default,
             torch.ops.aten.sym_storage_offset.default, torch.ops.prim.layout.default}

_shadow = [0]  # > 0 while DTensor propagates an op's metadata
_depth = [0]   # StepCosts modes entered
_unwrapped: list = []  # the unwrapped propagation, while _depth > 0


def _watch_propagation(on: bool) -> None:
    """Wrap DTensor's metadata propagation (once, however deep the modes
    nest) so that ``_shadow`` tells when it runs; unwrap at the last
    exit."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator as SP

    if on:
        if _depth[0] == 0:
            orig = SP._propagate_tensor_meta_non_cached
            _unwrapped.append(orig)

            def propagate(self, op_schema):
                _shadow[0] += 1
                try:
                    return orig(self, op_schema)
                finally:
                    _shadow[0] -= 1
            SP._propagate_tensor_meta_non_cached = propagate
        _depth[0] += 1
    else:
        _depth[0] -= 1
        if _depth[0] == 0:
            SP._propagate_tensor_meta_non_cached = _unwrapped.pop()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _model_line() -> str:
    """The innermost frame of the port's model code (not this module's,
    not DTensor's helpers) on the stack, as ``file:line function``."""
    for fr in reversed(traceback.extract_stack()):
        name = fr.filename.replace("\\", "/")
        if "/repro_torch/" in name and not name.endswith(("launch/costs.py", "core/gspmd.py")):
            return f"{name.rsplit('/', 1)[-1]}:{fr.lineno} {fr.name}"
    return "?"


class StepCosts(TorchDispatchMode):
    """Counts one rank's step (see the module docstring).  ``track(tree)``
    before the step registers its arguments' storages; ``output(tree)``
    after it splits the live bytes into argument, output and temporary
    bytes (``memory()``).  ``tag_buffers``: see the module docstring."""

    def __init__(self, tag_buffers: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveLog()
        self.live = 0
        self.peak = 0
        self._next = 0
        self._buffer_of: dict[int, int] = {}   # live storage -> its buffer
        self._buffers: dict[int, list] = {}    # buffer -> [bytes, live storages]
        self._refs: dict[int, weakref.ref] = {}
        self._arguments: set[int] = set()      # buffers
        self.argument_bytes = 0
        self.output_bytes = 0
        self._made: dict[int, tuple] | None = {} if tag_buffers else None
        self.peak_buffers: list[tuple[tuple[str, str], int]] = []  # ((op, line), bytes)

    # -- storages ------------------------------------------------------------

    def _add(self, t: torch.Tensor, alias_of: torch.Tensor | None = None,
             op: str = "argument") -> int:
        """The buffer of ``t``'s storage, counted from now on where it is
        new (made by ``op``).  With ``alias_of``, a new storage joins that
        tensor's buffer instead of adding bytes: the result of an op that
        hands its input back (a collective's wait, its async wrapper),
        which on a card is the same memory."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._buffer_of:
            return self._buffer_of[key]
        other = None if alias_of is None else alias_of.untyped_storage()._cdata
        if other in self._buffer_of:
            buf = self._buffer_of[other]
        else:  # a new id: a storage's address is reused once it is freed
            buf = self._next
            self._next += 1
            self._buffers[buf] = [st.nbytes(), 0]
            self.live += st.nbytes()
            if self._made is not None:
                self._made[buf] = (op, _model_line() if op != "argument" else "")
                if self.live > self.peak:
                    self.peak_buffers = [(self._made[b], e[0])
                                         for b, e in self._buffers.items()]
            self.peak = max(self.peak, self.live)
        self._buffer_of[key] = buf
        self._buffers[buf][1] += 1
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._free(key))
        return buf

    def _free(self, key: int) -> None:
        self._refs.pop(key, None)
        buf = self._buffer_of.pop(key, None)
        if buf is None:
            return
        entry = self._buffers[buf]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._buffers[buf]
            if self._made is not None:
                del self._made[buf]

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        return t.to_local() if isinstance(t, DTensor) else t

    def track(self, tree) -> None:
        """Count the storages of every tensor in ``tree`` (DTensors by their
        local blocks) as the step's arguments, live from now on."""
        for t in _tensors(tree):
            buf = self._add(self._local(t))
            if buf not in self._arguments:
                self._arguments.add(buf)
                self.argument_bytes += self._buffers[buf][0]

    def output(self, tree) -> None:
        """Record the bytes of the buffers the step returned that are not
        its arguments (those updated in place are argument bytes)."""
        seen = set()
        for t in _tensors(tree):
            buf = self._buffer_of.get(self._local(t).untyped_storage()._cdata)
            if buf is not None and buf not in self._arguments and buf not in seen:
                seen.add(buf)
                self.output_bytes += self._buffers[buf][0]

    def memory(self) -> dict[str, int]:
        """``{"argument", "output", "temp", "peak"}`` bytes of this rank:
        ``peak`` is the most that was live at once, ``temp`` what the peak
        held beyond the arguments and the outputs."""
        return {"argument": self.argument_bytes, "output": self.output_bytes,
                "temp": self.peak - self.argument_bytes - self.output_bytes,
                "peak": self.peak}

    # -- the mode ------------------------------------------------------------------

    def __enter__(self):
        _watch_propagation(True)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _watch_propagation(False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types) or func in _METADATA:
            return NotImplemented
        if _shadow[0]:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self._formulas and func is not torch.ops.prim.device.default:
            with self:  # a composite op: count what it decomposes into
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in self._formulas:
            self.flops += self._formulas[packet](*args, **kwargs, out_val=out)
        self.collectives.record(func, args, out)
        outs = _tensors(out)
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC and outs:
            self.bytes += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                           + sum(_nbytes(t) for t in outs))
        src = args[0] if packet.__name__ in _ALIASING else None
        for t in outs:
            self._add(t, alias_of=src, op=packet.__name__)
        return out
