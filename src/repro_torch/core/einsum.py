"""EinSum IR: the paper's declarative language as a small graph IR.

The paper (§3) defines a binary EinSum expression

    Z[l_Z]  <-  AGG_{l_agg}  COMBINE( X[l_X], Y[l_Y] )

with an arbitrary associative+commutative aggregation ``AGG`` and scalar
combiner ``COMBINE``.  A complex computation is an EinGraph: a DAG of such
nodes (§5).  Nodes come in four kinds:

  * ``input``  — a tensor fed into the computation (no EinSum, per §5).
  * ``einsum`` — a unary or binary extended-einsum node.
  * ``map``    — a unary elementwise function with static params (a unary
                 einsum with no aggregation; split out so params like scale
                 factors don't need to be graph inputs).
  * ``opaque`` — a fused op the notation cannot express at scale (flash
                 attention, top-k routing, recurrent scan, gather).  Opaque
                 nodes still carry *label metadata* so the decomposition
                 algorithm can reason about which dimensions are shardable
                 (DESIGN.md §2, third adaptation).

Labels are node-local, exactly as in the paper: producers and consumers are
linked positionally through edges, and repartitioning cost is computed on
positional partitioning vectors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Combine (⊗) and aggregation (⊕) registries.
# ---------------------------------------------------------------------------

# Binary scalar combiners.  Each maps (x, y) -> scalar, vectorised over
# broadcast-aligned arrays by the engine / TRA runtime.
COMBINE2: dict[str, Callable] = {
    "mul": lambda x, y: x * y,
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "div": lambda x, y: x / y,
    "sqdiff": lambda x, y: (x - y) ** 2,
    "absdiff": lambda x, y: abs(x - y),
    "maximum": lambda x, y: np.maximum(x, y) if isinstance(x, np.ndarray) else _jmax(x, y),
    "expsub": lambda x, y: _exp(x - y),   # e^(x-y): the softmax E node (§3)
}

# Unary maps (for einsum nodes with a single input, ⊗ is a unary map).
COMBINE1: dict[str, Callable] = {
    "id": lambda x: x,
    "exp": lambda x: _exp(x),
    "neg": lambda x: -x,
    "abs": lambda x: abs(x),
    "square": lambda x: x * x,
}

# Associative + commutative aggregations (§3 requires assoc+comm).
AGGS = ("sum", "max", "min", "prod")

_AGG_NP = {"sum": np.add, "max": np.maximum, "min": np.minimum, "prod": np.multiply}
_AGG_INIT = {"sum": 0.0, "max": -np.inf, "min": np.inf, "prod": 1.0}


def _exp(x):
    import torch

    return np.exp(x) if isinstance(x, (np.ndarray, float, np.floating)) \
        else torch.exp(torch.as_tensor(x))


def _jmax(x, y):
    import torch

    return torch.maximum(torch.as_tensor(x), torch.as_tensor(y))


# ---------------------------------------------------------------------------
# EinSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EinSpec:
    """Labels + operator choice for one (unary or binary) EinSum node."""

    in_labels: tuple[tuple[str, ...], ...]  # one tuple per input (1 or 2)
    out_labels: tuple[str, ...]
    combine: str = "mul"
    agg: str = "sum"  # "" means elementwise (no aggregation)

    def _spec_str(self) -> str:
        """The offending spec rendered as a parseable string — included in
        every validation error so messages are self-locating (and, with the
        sorted lists below, byte-deterministic across runs)."""
        ins = ", ".join(" ".join(ls) for ls in self.in_labels)
        return f"'{ins} -> {' '.join(self.out_labels)}'"

    def __post_init__(self):
        if len(self.in_labels) not in (1, 2):
            raise ValueError(
                f"EinSpec {self._spec_str()}: supports unary and binary "
                "expressions only")
        for ls in self.in_labels:
            if len(set(ls)) != len(ls):
                raise ValueError(
                    f"EinSpec {self._spec_str()}: repeated label within one "
                    f"input: {ls}")
        if self.agg and self.agg not in AGGS:
            raise ValueError(
                f"EinSpec {self._spec_str()}: aggregation {self.agg!r} not "
                f"in {AGGS}")
        reg = COMBINE2 if len(self.in_labels) == 2 else COMBINE1
        if self.combine not in reg:
            raise ValueError(
                f"EinSpec {self._spec_str()}: combine {self.combine!r} not "
                "registered")
        known = set(self.all_labels)
        for l in self.out_labels:
            if l not in known:
                raise ValueError(
                    f"EinSpec {self._spec_str()}: broadcast output label "
                    f"{l!r} unsupported (§3: no broadcasts)")
        if not self.agg and self.agg_labels:
            raise ValueError(
                f"EinSpec {self._spec_str()}: labels {self.agg_labels} "
                "aggregated but agg=''")

    # ℓ_XY with duplicates removed in order of first appearance (the ⊙ of §4)
    @property
    def all_labels(self) -> tuple[str, ...]:
        seen: list[str] = []
        for ls in self.in_labels:
            for l in ls:
                if l not in seen:
                    seen.append(l)
        return tuple(seen)

    # ℓ_agg: labels in inputs but not output (§3)
    @property
    def agg_labels(self) -> tuple[str, ...]:
        out = set(self.out_labels)
        return tuple(l for l in self.all_labels if l not in out)

    @property
    def is_contraction(self) -> bool:
        return self.combine == "mul" and self.agg == "sum"

    def einsum_str(self) -> str:
        """jnp.einsum subscripts (valid only when every label fits one char
        after canonical renaming)."""
        alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
        ren = {l: alphabet[i] for i, l in enumerate(self.all_labels)}
        ins = ",".join("".join(ren[l] for l in ls) for ls in self.in_labels)
        return f"{ins}->{''.join(ren[l] for l in self.out_labels)}"

    def pretty(self) -> str:
        """The spec's labels as a ``parse_einsum``-able string, preserving
        the original label names: ``"b s e, e h d -> b s h d"``.

        One irreducible ambiguity: if some label is multi-character but
        *every* side holds at most one label, no side contains a space and
        the parser would read characters — fall back to the canonical
        single-char rendering (``einsum_str``) for that corner.
        """
        sides = [" ".join(ls) for ls in self.in_labels]
        sides.append(" ".join(self.out_labels))
        multi = any(len(l) > 1 for l in self.all_labels)
        if multi and not any(" " in s for s in sides):
            return self.einsum_str()
        return f"{', '.join(sides[:-1])} -> {sides[-1]}"


def parse_einsum(expr: str) -> tuple[tuple[tuple[str, ...], ...], tuple[str, ...]]:
    """Parse "b s e, e h d -> b s h d" (space-separated multi-char labels) or
    "bse,ehd->bshd" (single-char labels).

    Word mode is decided for the *whole expression*: if any side contains a
    space, every side is split on whitespace — so a spaceless side inside a
    spaced expression ("b s e, e -> b s") is one single label, never a run
    of characters.  A fully spaceless expression parses per character.
    """
    lhs, rhs = expr.split("->")
    sides = [s.strip() for s in lhs.split(",")] + [rhs.strip()]
    word_mode = any(" " in s for s in sides)

    def side(s: str) -> tuple[str, ...]:
        return tuple(s.split()) if word_mode else tuple(s)

    return tuple(side(s) for s in sides[:-1]), side(sides[-1])


# ---------------------------------------------------------------------------
# Nodes + graph
# ---------------------------------------------------------------------------


#: Node params consumed by the planner only (cost declarations), never
#: forwarded to the op's executable implementation.
PLANNER_ONLY_PARAMS = frozenset({"comm"})


@dataclass
class Node:
    nid: int
    name: str
    kind: str  # input | einsum | map | opaque
    labels: tuple[str, ...]  # output labels
    shape: tuple[int, ...]
    dtype: Any
    inputs: tuple[int, ...] = ()
    spec: EinSpec | None = None
    op: str = ""  # map fn / opaque kind
    params: dict = field(default_factory=dict)
    # opaque: labels that may be partitioned (None = all); agg-like labels
    # that behave as contracted (cost as aggregation) when partitioned.
    shardable: frozenset[str] | None = None
    # For opaque nodes: labels of each input, for repartition reasoning.
    in_labels: tuple[tuple[str, ...], ...] = ()
    # "file.py:line" of the frontend expression that built this node ("" for
    # imperatively-built graphs).  Diagnostics only: canonical hashing
    # (canon.node_struct) enumerates hashed fields explicitly and never
    # sees it, so identical programs traced from different files share plan
    # cache entries.
    srcloc: str = ""

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def call_params(self) -> dict:
        """Params to pass the executable op (planner declarations dropped)."""
        return {k: v for k, v in self.params.items()
                if k not in PLANNER_ONLY_PARAMS}

    def bound_of(self, label: str) -> int:
        return self.shape[self.labels.index(label)]


class EinGraph:
    """A DAG of EinSum nodes (the paper's EinGraph, §5)."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: list[Node] = []

    # -- construction -------------------------------------------------------

    def _add(self, node: Node) -> int:
        self.nodes.append(node)
        return node.nid

    def input(self, name: str, labels: str | Sequence[str], shape: Sequence[int],
              dtype=np.float32) -> int:
        labels = _as_labels(labels)
        shape = tuple(int(s) for s in shape)
        if len(labels) != len(shape):
            raise ValueError(f"{name}: {len(labels)} labels vs rank {len(shape)}")
        return self._add(Node(len(self.nodes), name, "input", labels, shape, dtype))

    def einsum(self, expr: str, *args: int, combine: str | None = None,
               agg: str | None = None, name: str = "") -> int:
        in_labels, out_labels = parse_einsum(expr)
        if len(args) != len(in_labels):
            raise ValueError(f"{expr}: expected {len(in_labels)} args, got {len(args)}")
        if combine is None:
            combine = "mul" if len(in_labels) == 2 else "id"
        # default agg: sum if anything is contracted, else elementwise
        tmp = EinSpec(in_labels, out_labels, combine, "sum")
        if agg is None:
            agg = "sum" if tmp.agg_labels else ""
        spec = EinSpec(in_labels, out_labels, combine, agg)
        bounds: dict[str, int] = {}
        for ls, a in zip(in_labels, args):
            node = self.nodes[a]
            if len(ls) != node.rank:
                raise ValueError(
                    f"{expr}: input {node.name} rank {node.rank} vs labels {ls}")
            for l, b in zip(ls, node.shape):
                if bounds.setdefault(l, b) != b:
                    raise ValueError(f"{expr}: label {l} bound mismatch {bounds[l]} vs {b}")
        shape = tuple(bounds[l] for l in out_labels)
        dtype = self.nodes[args[0]].dtype
        return self._add(Node(len(self.nodes), name or f"ein{len(self.nodes)}",
                              "einsum", out_labels, shape, dtype, tuple(args), spec))

    def map(self, fn: str, arg: int, name: str = "", **params) -> int:
        node = self.nodes[arg]
        return self._add(Node(len(self.nodes), name or f"{fn}{len(self.nodes)}",
                              "map", node.labels, node.shape, node.dtype, (arg,),
                              None, fn, dict(params)))

    def opaque(self, kind: str, args: Sequence[int], out_labels: str | Sequence[str],
               out_shape: Sequence[int], *, in_labels: Sequence[Sequence[str]] = (),
               shardable: Iterable[str] | None = None, dtype=None,
               name: str = "", **params) -> int:
        out_labels = _as_labels(out_labels)
        dtype = dtype if dtype is not None else self.nodes[args[0]].dtype
        return self._add(Node(
            len(self.nodes), name or f"{kind}{len(self.nodes)}", "opaque",
            out_labels, tuple(int(s) for s in out_shape), dtype, tuple(args),
            None, kind, dict(params),
            frozenset(shardable) if shardable is not None else None,
            tuple(tuple(ls) for ls in in_labels)))

    # -- structure ----------------------------------------------------------

    def topo_order(self) -> list[int]:
        return [n.nid for n in self.nodes]  # construction order is topological

    def consumers(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {n.nid: [] for n in self.nodes}
        for n in self.nodes:
            for a in n.inputs:
                out[a].append(n.nid)
        return out

    def outputs(self) -> list[int]:
        cons = self.consumers()
        return [nid for nid, cs in cons.items() if not cs]

    def input_ids(self) -> list[int]:
        return [n.nid for n in self.nodes if n.kind == "input"]

    # labels of node `a` as seen by consumer node `v` (positional match).
    def edge_labels(self, v: int, a: int) -> tuple[tuple[str, ...], ...]:
        node = self.nodes[v]
        res = []
        if node.kind == "einsum":
            for i, inp in enumerate(node.inputs):
                if inp == a:
                    res.append(node.spec.in_labels[i])
        elif node.kind in ("map",):
            for inp in node.inputs:
                if inp == a:
                    res.append(node.labels)
        elif node.kind == "opaque" and node.in_labels:
            for i, inp in enumerate(node.inputs):
                if inp == a:
                    res.append(node.in_labels[i])
        return tuple(res)

    def __repr__(self):
        lines = [f"EinGraph({self.name}, {len(self.nodes)} nodes)"]
        for n in self.nodes:
            src = f" <- {n.inputs}" if n.inputs else ""
            op = n.spec.einsum_str() if n.spec else n.op
            lines.append(f"  [{n.nid:3d}] {n.kind:6s} {n.name:20s} {op:24s} "
                         f"{n.labels} {n.shape}{src}")
        return "\n".join(lines)


def _as_labels(labels: str | Sequence[str]) -> tuple[str, ...]:
    if isinstance(labels, str):
        return tuple(labels.split()) if " " in labels else tuple(labels)
    return tuple(labels)


# ---------------------------------------------------------------------------
# Feed resolution: name-keyed (or node-id-keyed) feeds -> {nid: value}
# ---------------------------------------------------------------------------


def resolve_feeds(g: EinGraph, feeds: dict) -> dict[int, Any]:
    """Resolve a feed dict keyed by input *names* (or node ids, or a mix)
    into ``{node id: value}``.

    The reference runtimes and the frontend agree on I/O keys through this
    one function: names resolve once, a name shared by two input nodes is an
    error (ambiguous), an unknown name is an error, and any graph input left
    unfed is an error listing what is missing.  Integer keys pass through
    untouched (the historical surface), including extras for non-input
    nodes, which evaluation simply ignores.
    """
    by_name: dict[str, int] = {}
    dups: set[str] = set()
    for n in g.nodes:
        if n.kind != "input":
            continue
        if n.name in by_name:
            dups.add(n.name)
        by_name[n.name] = n.nid
    out: dict[int, Any] = {}
    for k, v in feeds.items():
        if isinstance(k, str):
            if k in dups:
                raise ValueError(
                    f"feed name {k!r} is ambiguous: multiple input nodes "
                    "share it — feed by node id or rename the inputs")
            if k not in by_name:
                raise KeyError(
                    f"unknown input name {k!r}; graph inputs are "
                    f"{sorted(by_name)}")
            out[by_name[k]] = v
        else:
            out[int(k)] = v
    missing = sorted(n.name for n in g.nodes
                     if n.kind == "input" and n.nid not in out)
    if missing:
        raise ValueError(f"missing feeds for inputs {missing}")
    return out


# ---------------------------------------------------------------------------
# Dense reference evaluation (numpy) — the semantic ground truth used by the
# TRA equivalence tests.  Slow and simple on purpose.
# ---------------------------------------------------------------------------


def eval_einsum_dense(spec: EinSpec, *arrays: np.ndarray) -> np.ndarray:
    """Evaluate one EinSum node densely per the §3 semantics."""
    all_labels = spec.all_labels
    # broadcast every input up to the full joint index space I(b_XY)
    def lift(arr: np.ndarray, labels: tuple[str, ...]) -> np.ndarray:
        perm_src = list(labels)
        expanded = arr
        for l in all_labels:
            if l not in perm_src:
                expanded = expanded[..., None]
                perm_src.append(l)
        order = [perm_src.index(l) for l in all_labels]
        return np.transpose(expanded, order)

    lifted = [lift(a, ls) for a, ls in zip(arrays, spec.in_labels)]
    if len(lifted) == 2:
        joined = COMBINE2[spec.combine](lifted[0], lifted[1])
    else:
        joined = COMBINE1[spec.combine](lifted[0])
    # aggregate out agg labels
    if spec.agg:
        axes = tuple(i for i, l in enumerate(all_labels) if l in spec.agg_labels)
        if axes:
            red = {"sum": np.sum, "max": np.max, "min": np.min, "prod": np.prod}[spec.agg]
            joined = red(joined, axis=axes)
    kept = [l for l in all_labels if l not in spec.agg_labels]
    order = [kept.index(l) for l in spec.out_labels]
    return np.transpose(joined, order)


def eval_graph_dense(g: EinGraph, feeds: dict,
                     map_fns: dict[str, Callable] | None = None,
                     opaque_fns: dict[str, Callable] | None = None) -> dict[int, np.ndarray]:
    """Dense numpy evaluation of the whole graph (reference oracle).

    ``feeds`` may be keyed by input *name* or node id (see resolve_feeds).
    """
    from repro_torch.core import opdef as _opdef  # late import: the op registry

    feeds = resolve_feeds(g, feeds)
    vals: dict[int, np.ndarray] = {}
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.kind == "input":
            vals[nid] = np.asarray(feeds[nid])
        elif n.kind == "einsum":
            vals[nid] = eval_einsum_dense(n.spec, *[vals[a] for a in n.inputs])
        elif n.kind == "map":
            fn = (map_fns or {}).get(n.op) or _opdef.MAP_FNS[n.op]
            vals[nid] = np.asarray(fn(vals[n.inputs[0]], **n.params))
        else:
            fn = (opaque_fns or {}).get(n.op) or _opdef.OPAQUE_FNS[n.op]
            vals[nid] = np.asarray(fn(*[vals[a] for a in n.inputs],
                                      **n.call_params))
    return vals
