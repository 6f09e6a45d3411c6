"""Collective wire bytes of a step, from the collectives it issues.

The reference parses the compiled HLO module (``parse_collectives``):
XLA's cost analysis counts a while body once, so its walker multiplies
each loop body's collectives by the loop's trip count.  The port has no
HLO and no rolled loops: it runs eagerly, so every collective of a step
is dispatched once each time it runs, and a recorder over the dispatched
ops counts every trip by construction.  ``parse_collectives`` and its
walker have no counterpart.

``CollectiveLog`` records the functional collectives DTensor issues
(``_c10d_functional``) and point-to-point sends, by the reference's kind
names; ``CollectiveRecorder`` is a ``TorchDispatchMode`` that feeds one.
For each op, R is the bytes of its result and k the size of its group,
priced by the reference's ring model, kept verbatim as ``_wire_bytes``:

  all-reduce          2 (k-1)/k R     (ring = reduce-scatter + all-gather)
  all-gather          (k-1)/k R       (R = gathered output)
  reduce-scatter      (k-1) R         (input = k R moves (k-1)/k of itself)
  all-to-all          (k-1)/k R
  collective-permute  R               (a send: R = the bytes sent)

``result()`` returns what ``parse_collectives`` returns: ``(wire bytes
per device, wire bytes by kind, plain sum of the result bytes)``.
"""
from __future__ import annotations

from collections import Counter

from torch.utils._python_dispatch import TorchDispatchMode

#: functional collective -> the reference's kind name
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


def _wire_bytes(kind: str, result_bytes: int, k: int) -> float:
    if k <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k * result_bytes
    if kind == "all-gather":
        return (k - 1) / k * result_bytes
    if kind == "reduce-scatter":
        return float((k - 1) * result_bytes)
    if kind == "all-to-all":
        return (k - 1) / k * result_bytes
    return float(result_bytes)  # collective-permute


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


def collective_of(func, args, out) -> tuple[str, int, int] | None:
    """``(kind, result bytes R, group size k)`` of a dispatched op, or None
    where it is no collective."""
    ns, name = func.namespace, func._overloadpacket.__name__
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            k = int(args[1] if name == "all_gather_into_tensor" else args[2])
        else:
            k = _group_size(args[-1])
        return _FUNCTIONAL[name], _nbytes(out), k
    if ns == "c10d" and name == "send":  # (tensors, process_group, dst, tag)
        return "collective-permute", sum(_nbytes(t) for t in args[0]), 2
    return None


class CollectiveLog:
    """Collectives of one rank's step, by kind: their count, result bytes
    and wire bytes (``_wire_bytes``)."""

    def __init__(self):
        self.counts: Counter = Counter()
        self.result_bytes: Counter = Counter()
        self.wire: Counter = Counter()

    def record(self, func, args, out) -> None:
        found = collective_of(func, args, out)
        if found is None:
            return
        kind, r, k = found
        self.counts[kind] += 1
        self.result_bytes[kind] += r
        self.wire[kind] += _wire_bytes(kind, r, k)

    def result(self) -> tuple[float, dict[str, float], float]:
        """``(wire_bytes_per_device, by_kind, plain_operand_sum)``, the
        triple of the reference's ``parse_collectives``."""
        return (float(sum(self.wire.values())), dict(self.wire),
                float(sum(self.result_bytes.values())))

    def summary(self) -> dict[str, dict]:
        """``{kind: {"count", "bytes", "wire_bytes"}}``."""
        return {k: {"count": self.counts[k], "bytes": self.result_bytes[k],
                    "wire_bytes": self.wire[k]} for k in sorted(self.counts)}


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched under it into ``self.log``.  It
    steps aside for DTensor (returns ``NotImplemented``), so it sees the
    collectives DTensor issues on the local blocks."""

    def __init__(self):
        super().__init__()
        self.log = CollectiveLog()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.log.record(func, args, out)
        return out

    def result(self) -> tuple[float, dict[str, float], float]:
        return self.log.result()

