"""Lazy symbolic tensors: the paper's declarative notation as Python values.

The paper's whole pitch (§1–3) is that the *programming abstraction* is a
fully declarative extended einsum — the user writes

    Z[l_Z]  <-  AGG_{l_agg}  COMBINE( X[l_X], Y[l_Y] )

and never talks about devices, partitionings, or node ids.  This module is
that surface: ``tensor(...)`` declares a named input, ``einsum(...)`` an
extended (⊗,⊕) node, operator overloading covers the elementwise ⊗ forms
(``x + y``, ``x * y``, ``x - y``, ``x / y``, scalar broadcasts as ``map``
nodes), and ``opaque(...)`` admits fused ops the notation cannot express
(flash attention, MoE dispatch, recurrent scans) while still carrying the
label metadata EinDecomp needs.

Expressions are *lazy*: building one does no numerics, it only records
structure.  ``trace(outputs)`` emits the reachable expressions into the
existing ``core.einsum.EinGraph`` IR — inputs keep their declared **names**
(the graph is then fed by name, not node id) and emission follows expression
*creation order*.  Creation order is topological (operands are constructed
before their consumers), and it reproduces node-for-node the sequence an
imperative ``EinGraph`` builder writing the same computation would produce,
so canonical graph keys (``core/canon.py``) — and therefore plan-cache
entries — are identical across the two surfaces.
"""
from __future__ import annotations

import itertools
import os
import sys
from typing import Any, Iterable, Sequence

import numpy as np

from repro_torch.core.einsum import EinGraph, EinSpec, parse_einsum, _as_labels

_UID = itertools.count()

_FRONTEND_DIR = os.path.dirname(os.path.abspath(__file__))


def _caller_srcloc() -> str:
    """``"path/to/file.py:line"`` of the first stack frame *outside* this
    package — the user (or model-zoo) line that built the expression.  The
    static analyzer (the reference's ``analysis`` package, a later slice of
    the port) reports findings at these locations; canonical graph hashing
    never sees them (``canon.node_struct`` enumerates hashed Node fields
    explicitly)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.dirname(os.path.abspath(fn)) != _FRONTEND_DIR:
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return ""


class Expr:
    """One node of a lazy expression DAG (input | einsum | map | opaque).

    Carries exactly the information its ``EinGraph`` node will carry —
    labels, shape, dtype, spec/op/params — plus references to its operand
    expressions instead of integer node ids.
    """

    __slots__ = ("uid", "kind", "name", "labels", "shape", "dtype", "args",
                 "spec", "op", "params", "shardable", "in_labels", "srcloc")

    def __init__(self, kind: str, labels: tuple[str, ...],
                 shape: tuple[int, ...], dtype: Any, *,
                 name: str = "", args: tuple["Expr", ...] = (),
                 spec: EinSpec | None = None, op: str = "",
                 params: dict | None = None,
                 shardable: frozenset[str] | None = None,
                 in_labels: tuple[tuple[str, ...], ...] = ()):
        self.uid = next(_UID)
        self.kind = kind
        self.name = name
        self.labels = tuple(labels)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.args = tuple(args)
        self.spec = spec
        self.op = op
        self.params = dict(params or {})
        self.shardable = shardable
        self.in_labels = tuple(tuple(ls) for ls in in_labels)
        self.srcloc = _caller_srcloc()

    # -- structure -----------------------------------------------------------

    @property
    def rank(self) -> int:
        return len(self.shape)

    def __repr__(self):
        lbl = " ".join(self.labels)
        op = self.spec.pretty() if self.spec else (self.op or self.kind)
        nm = f" {self.name!r}" if self.name else ""
        return f"<Expr{nm} {self.kind} [{lbl}] {self.shape} {op}>"

    # -- elementwise sugar ---------------------------------------------------
    # Binary ops between label-aligned expressions lower to elementwise
    # einsum nodes (agg=""); scalars lower to map nodes so constants never
    # become graph inputs (core/einsum.py map rationale).

    def _ew(self, other, combine: str, reverse: bool = False):
        if isinstance(other, Expr):
            if self.labels != other.labels:
                raise ValueError(
                    f"elementwise {combine}: labels {self.labels} vs "
                    f"{other.labels}; use einsum(...) for non-aligned operands")
            a, b = (other, self) if reverse else (self, other)
            s = " ".join(self.labels)
            return einsum(f"{s}, {s} -> {s}", a, b, combine=combine, agg="")
        return NotImplemented

    def __add__(self, other):
        if isinstance(other, (int, float)):
            return self.map("add_const", c=float(other))
        return self._ew(other, "add")

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, (int, float)):
            return self.map("add_const", c=-float(other))
        return self._ew(other, "sub")

    def __rsub__(self, other):
        if isinstance(other, (int, float)):
            return self.map("neg").map("add_const", c=float(other))
        return self._ew(other, "sub", reverse=True)

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return self.map("scale", c=float(other))
        return self._ew(other, "mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, (int, float)):
            return self.map("scale", c=1.0 / float(other))
        return self._ew(other, "div")

    def __rtruediv__(self, other):
        if isinstance(other, Expr):
            return self._ew(other, "div", reverse=True)
        return NotImplemented

    def __neg__(self):
        return self.map("neg")

    def __pow__(self, e):
        if e == 2:
            return self.map("square")
        return NotImplemented

    def map(self, fn: str, *, name: str = "", **params) -> "Expr":
        """Unary elementwise map (``relu``, ``scale``, … — the map-category
        ops of the OpDef registry, ``opdef.list_ops("map")``)."""
        return Expr("map", self.labels, self.shape, self.dtype,
                    name=name, args=(self,), op=fn, params=params)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def tensor(name: str, labels: str | Sequence[str], shape: Sequence[int],
           dtype=np.float32) -> Expr:
    """Declare a named input tensor: ``tensor("x", "b s a", (4, 128, 256))``.

    The name is the feed key of the compiled program — inputs are name-based
    end to end, never integer node ids.
    """
    if not name:
        raise ValueError("tensor: inputs must be named (they are fed by name)")
    labels = _as_labels(labels)
    shape = tuple(int(s) for s in shape)
    if len(labels) != len(shape):
        raise ValueError(f"{name}: {len(labels)} labels vs rank {len(shape)}")
    return Expr("input", labels, shape, dtype, name=name)


def einsum(expr: str, *args: Expr, combine: str | None = None,
           agg: str | None = None, name: str = "") -> Expr:
    """Extended einsum over expressions: ``einsum("b s a, a f -> b s f", x,
    w)``, with the paper's full (⊗,⊕) generality via ``combine=``/``agg=``
    (``agg=""`` means elementwise — no aggregation).

    Defaults mirror the IR: binary nodes combine with ``mul``, unary with
    ``id``; ``agg`` defaults to ``sum`` when any label is contracted, else
    elementwise.
    """
    in_labels, out_labels = parse_einsum(expr)
    if len(args) != len(in_labels):
        raise ValueError(f"{expr}: expected {len(in_labels)} args, got {len(args)}")
    for a in args:
        if not isinstance(a, Expr):
            raise TypeError(f"{expr}: operands must be Exprs, got {type(a).__name__}")
    if combine is None:
        combine = "mul" if len(in_labels) == 2 else "id"
    tmp = EinSpec(in_labels, out_labels, combine, "sum")
    if agg is None:
        agg = "sum" if tmp.agg_labels else ""
    spec = EinSpec(in_labels, out_labels, combine, agg)
    bounds: dict[str, int] = {}
    for ls, a in zip(in_labels, args):
        if len(ls) != a.rank:
            raise ValueError(f"{expr}: operand rank {a.rank} vs labels {ls}")
        for l, b in zip(ls, a.shape):
            if bounds.setdefault(l, b) != b:
                raise ValueError(f"{expr}: label {l} bound mismatch "
                                 f"{bounds[l]} vs {b}")
    shape = tuple(bounds[l] for l in out_labels)
    return Expr("einsum", out_labels, shape, args[0].dtype,
                name=name, args=args, spec=spec)


def opaque(kind: str, args: Sequence[Expr],
           out_labels: str | Sequence[str] | None = None,
           out_shape: Sequence[int] | None = None, *,
           in_labels: Sequence[Sequence[str]] = (),
           shardable: Iterable[str] | None = None, dtype=None,
           name: str = "", **params) -> Expr:
    """A fused op the notation cannot express (flash attention, MoE
    dispatch, recurrent scan).

    For a kind registered through :func:`defop` (``ein.defop`` /
    ``@ein.op``), everything is inferred from the OpDef's label signature:
    output labels and shape, dtype, and the ``shardable`` set — all renamed
    into the caller's instance labels (pass ``in_labels`` to rename, e.g.
    flash attention's ring label ``l`` becomes ``s`` in prefill and ``t``
    in decode; omit it to use the signature's labels verbatim).  Label
    bounds are cross-validated against every argument at build time, and
    any explicitly-passed ``out_labels``/``out_shape`` is checked against
    the inference instead of trusted.  The comm declaration and shard rule
    live on the OpDef and are resolved at plan time — they are no longer
    embedded per call.

    Unregistered kinds fall back to the historical fully-explicit form
    (``out_labels`` + ``out_shape`` required).
    """
    from repro_torch.core import opdef as _opdef

    args = tuple(args)
    od = _opdef.get(kind)
    if od is not None and od.signature is not None:
        bound = _opdef.bind_call(
            od, [a.shape for a in args], in_labels=in_labels,
            out_labels=_as_labels(out_labels) if out_labels is not None
            else None, params=params)
        if out_shape is not None and tuple(int(s) for s in out_shape) != \
                bound["out_shape"]:
            raise _opdef.OpDefError(
                f"{kind}: caller-supplied out_shape "
                f"{tuple(int(s) for s in out_shape)} contradicts the "
                f"signature-inferred {bound['out_shape']}")
        out_labels = bound["out_labels"]
        out_shape = bound["out_shape"]
        in_labels = bound["in_labels"]
        if shardable is None:
            shardable = bound["shardable"]
        if dtype is None and od.out_dtype is not None:
            dtype = od.out_dtype
    elif out_labels is None or out_shape is None:
        raise ValueError(
            f"opaque({kind!r}): kind is not registered (or has no "
            "signature) — pass out_labels and out_shape explicitly, or "
            f"declare the op once with ein.defop({kind!r}, '<signature>', "
            "fn=...)")
    out_labels = _as_labels(out_labels)
    dtype = dtype if dtype is not None else args[0].dtype
    return Expr("opaque", out_labels, tuple(int(s) for s in out_shape), dtype,
                name=name, args=args, op=kind, params=params,
                shardable=frozenset(shardable) if shardable is not None else None,
                in_labels=tuple(tuple(ls) for ls in in_labels))


def maximum(x: Expr, y: Expr, name: str = "") -> Expr:
    """Elementwise max of two label-aligned expressions."""
    if not isinstance(y, Expr):
        raise TypeError(f"maximum: operands must be Exprs, got "
                        f"{type(y).__name__}")
    out = x._ew(y, "maximum")
    if name:
        out.name = name
    return out


def map_(fn: str, x: Expr, *, name: str = "", **params) -> Expr:
    """Function form of ``Expr.map`` (``map`` shadows the builtin)."""
    return x.map(fn, name=name, **params)


def defop(kind: str, signature: str | None = None, **kw):
    """Declare one op kind as a single record — signature, dense impl,
    kernel dispatcher, VJP rule, comm declaration, shard rule (the unified
    ``core.opdef.defop``; see its docstring for every field)::

        ein.defop("my_fused", "b s f, f -> b s f",
                  fn=my_dense_impl, vjp="auto",
                  shardable="b s", shard_rule="local")

    After this single declaration, ``ein.opaque("my_fused", [x, g])``
    infers shapes/labels, ``Program.grad`` differentiates through it, the
    DP prices its declared comm, and the shard_map executor lowers it via
    its bound rule — no edits anywhere else.
    """
    from repro_torch.core import opdef as _opdef

    return _opdef.defop(kind, signature, **kw)


def op(kind: str, signature: str | None = None, **kw):
    """Decorator sugar for :func:`defop`: the decorated function becomes
    the op's dense reference implementation::

        @ein.op("l2norm", "b s f -> b s f", shardable="b s",
                shard_rule="local", vjp="auto")
        def l2norm(x, eps=1e-6):
            ...
    """

    def wrap(fn):
        defop(kind, signature, fn=fn, **kw)
        return fn

    return wrap


def register_opaque(name: str, fn) -> None:
    """Deprecated: use :func:`defop` — one declarative record (signature,
    impl, kernel, vjp, comm, shard rule) instead of a bare impl."""
    from repro_torch.core import opdef as _opdef

    _opdef.register_legacy(name, fn, surface="frontend.register_opaque")


# ---------------------------------------------------------------------------
# Tracing: Expr DAG -> EinGraph
# ---------------------------------------------------------------------------


def trace(outputs: Sequence[Expr], name: str = "program"
          ) -> tuple[EinGraph, dict[Expr, int]]:
    """Emit every expression reachable from ``outputs`` into an EinGraph.

    Returns ``(graph, {expr: node id})``.  Inputs keep their declared names
    and must be unique within one program (they are the feed keys).  Nodes
    are emitted in expression *creation order* — topological by
    construction, and identical to what an imperative builder writing the
    same calls would produce, so canonical keys and plan-cache entries are
    shared across the two surfaces.
    """
    reachable: dict[int, Expr] = {}
    stack = list(outputs)
    while stack:
        e = stack.pop()
        if not isinstance(e, Expr):
            raise TypeError(f"trace: outputs must be Exprs, got {type(e).__name__}")
        if e.uid in reachable:
            continue
        reachable[e.uid] = e
        stack.extend(e.args)

    g = EinGraph(name)
    ids: dict[Expr, int] = {}
    input_names: dict[str, Expr] = {}
    for e in sorted(reachable.values(), key=lambda e: e.uid):
        if e.kind == "input":
            prev = input_names.get(e.name)
            if prev is not None and prev is not e:
                raise ValueError(
                    f"trace: duplicate input name {e.name!r} — inputs are "
                    "fed by name and must be unique within a program")
            input_names[e.name] = e
            nid = g.input(e.name, e.labels, e.shape, e.dtype)
        elif e.kind == "einsum":
            nid = g.einsum(e.spec.pretty(), *[ids[a] for a in e.args],
                           combine=e.spec.combine, agg=e.spec.agg, name=e.name)
        elif e.kind == "map":
            nid = g.map(e.op, ids[e.args[0]], name=e.name, **e.params)
        else:
            nid = g.opaque(e.op, [ids[a] for a in e.args], e.labels, e.shape,
                           in_labels=e.in_labels, shardable=e.shardable,
                           dtype=e.dtype, name=e.name, **e.params)
        g.nodes[nid].srcloc = e.srcloc
        ids[e] = nid
    return g, ids
