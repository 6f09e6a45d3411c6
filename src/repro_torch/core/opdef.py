"""OpDef: one declarative record per op kind — the unified op registry.

The paper's central extensibility claim (§5) is that the extended einsum
notation is *closed under extension*: any fused/opaque op can participate
in the tensor-relational rewrite as long as it declares its index semantics
and communication behavior.  Historically that declaration was scattered
over five private registries in three layers — ``engine.OPAQUE_FNS`` (dense
impl), ``engine.MAP_FNS`` + ``autodiff.GRAD_MAPS`` (elementwise forwards +
derivative links), ``opaque_rules.RULES`` bindings via hand-embedded
``comm`` param dicts, and per-call ``out_shape``/``shardable`` metadata in
the model builders — so adding one op meant editing five files and nothing
cross-validated that the five entries agreed.

An :class:`OpDef` bundles, per op kind:

  (a) an einsum-style **label signature** (``"b h s d, b k l d, b k l d ->
      b h s d"``) driving shape/dtype inference and plan-time label
      validation, so ``frontend.expr.opaque`` no longer needs a
      caller-supplied ``out_shape``;
  (b) the **dense reference implementation** (torch; numpy inputs are
      accepted and converted);
  (c) an optional **accelerator kernel dispatcher** (the ``kernels/ops.py``
      pattern: the CUDA kernel for a CUDA tensor, the plain torch version
      for a CPU tensor) — preferred at execution time when present;
  (d) a **VJP rule** (``"auto"`` = generic ``torch.func.vjp`` of the impl
      as derived ``<kind>@vjp<i>`` opaque nodes; or a custom graph builder),
      unifying the map-op ``grad`` links with opaque gradients so
      ``Program.grad`` works through opaque nodes;
  (e) the **comm declaration** the §7 DP prices
      (``decomp._opaque_comm_cost`` consults the OpDef, renamed into the
      node's instance labels, instead of raw node params);
  (f) the bound **shard rule** name (``core/opaque_rules``) with
      registration-time precondition checks (rule must exist, comm kinds
      must be known, comm rules must agree with the bound rule).

Registration happens through :func:`defop` (frontend sugar: ``ein.defop`` /
``@ein.op``).  Registration-time cross-validation replaces the old silent
drift: duplicate kinds are rejected, the dense impl is invoked on tiny
signature-shaped inputs and its output shape is checked against the
signature, and comm/shard-rule references are resolved eagerly.

The legacy registries survive as **live views** over this registry
(:data:`MAP_FNS`, :data:`OPAQUE_FNS`, :data:`GRAD_MAPS` — re-exported from
their historical homes) so in-core callers and tests keep working; direct
use outside ``core/`` is lint-banned (pyproject ``flake8-tidy-imports``).
"""
from __future__ import annotations

import warnings
from collections.abc import MutableMapping
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.einsum import parse_einsum

#: comm kinds the DP knows how to price (decomp._opaque_comm_cost).
COMM_KINDS = ("ring", "a2a")

#: tag separating a base kind from its derived auto-VJP kinds
#: (``flash_attention@vjp0`` = grad wrt input 0).
VJP_TAG = "@vjp"


class OpDefError(ValueError):
    """Raised on invalid op registration or on label/shape inference
    failures against a registered signature."""


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------


@dataclass
class OpDef:
    """One registered op kind.  See the module docstring for field roles.

    ``signature=None`` admits fully-dynamic ops (``broadcast_to``) that
    carry their metadata per call; such ops get no inference and no impl
    check.  ``category`` is ``"opaque"`` (fused op, EinGraph ``opaque``
    node) or ``"map"`` (unary elementwise, EinGraph ``map`` node; ``grad``
    names its derivative map).
    """

    kind: str
    category: str = "opaque"
    signature: str | None = None
    in_labels: tuple[tuple[str, ...], ...] = ()
    out_labels: tuple[str, ...] = ()
    fn: Callable | None = None
    kernel: Callable | None = None
    vjp: Any = None                      # None | "auto" | callable(gg, node, dz)
    # why vjp is (deliberately) None — required by the OpDef-completeness
    # lint (tests/test_analysis.py) for any op that is neither
    # differentiable via vjp nor, for maps, via a grad link
    vjp_reason: str | None = None
    grad: str | None = None              # map category: derivative map kind
    comm: tuple[dict, ...] = ()          # template over signature labels
    shard_rule: str | None = None
    shardable: frozenset[str] | None = None
    param_bounds: dict = field(default_factory=dict)  # out-only label -> param
    out_dtype: Any = None                # None = dtype of first argument
    in_dtypes: tuple = ()                # impl-check input dtypes (None=f32)
    impl_override: Callable | None = None  # legacy dict-surface override
    implicit: bool = False               # created through a legacy shim

    @property
    def executable(self) -> Callable | None:
        """The callable execution uses: a test/legacy override wins, then
        the accelerator kernel dispatcher, then the dense reference."""
        if self.impl_override is not None:
            return self.impl_override
        return self.kernel if self.kernel is not None else self.fn

    @property
    def labels(self) -> tuple[str, ...]:
        """Every signature label, inputs first, in order of appearance."""
        seen: list[str] = []
        for ls in self.in_labels + (self.out_labels,):
            for l in ls:
                if l not in seen:
                    seen.append(l)
        return tuple(seen)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, OpDef] = {}
_builtins_loaded = False


def _ensure_builtins() -> None:
    """Load the built-in op catalog on first registry access (lazily, so
    importing core/opdef.py alone stays dependency-free)."""
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    from repro_torch.core import opdefs_builtin  # noqa: F401  (registers on import)


def get(kind: str) -> OpDef | None:
    _ensure_builtins()
    return _REGISTRY.get(kind)


def require(kind: str) -> OpDef:
    od = get(kind)
    if od is None:
        raise OpDefError(
            f"op kind {kind!r} is not registered — declare it with "
            "ein.defop(kind, signature, fn=...)")
    return od


def list_ops(category: str | None = None) -> list[str]:
    _ensure_builtins()
    return sorted(k for k, od in _REGISTRY.items()
                  if category is None or od.category == category)


def unregister(kind: str) -> None:
    """Remove a registered op (tests / the legacy dict surface)."""
    _ensure_builtins()
    _REGISTRY.pop(kind, None)


# ---------------------------------------------------------------------------
# Registration + cross-validation
# ---------------------------------------------------------------------------


def _as_labels(labels) -> tuple[str, ...]:
    if labels is None:
        return ()
    if isinstance(labels, str):
        return tuple(labels.split()) if " " in labels else tuple(labels)
    return tuple(labels)


def _validate_comm(kind: str, comm: Sequence[Mapping], in_labels, out_labels,
                   shard_rule) -> tuple[dict, ...]:
    known = set()
    for ls in in_labels:
        known.update(ls)
    known.update(out_labels)
    rules = set()
    out = []
    for entry in comm:
        entry = dict(entry)
        ckind = entry.get("kind")
        if ckind not in COMM_KINDS:
            raise OpDefError(
                f"defop({kind!r}): comm kind {ckind!r} unknown "
                f"(expected one of {sorted(COMM_KINDS)})")
        label = entry.get("label")
        if in_labels and label not in known:
            raise OpDefError(
                f"defop({kind!r}): comm entry references label {label!r} "
                f"absent from the signature (labels: {sorted(known)})")
        idx = entry.get("input")
        if in_labels and (not isinstance(idx, int)
                          or not (idx == -1 or 0 <= idx < len(in_labels))):
            raise OpDefError(
                f"defop({kind!r}): comm entry input index {idx!r} missing or "
                f"out of range for {len(in_labels)} inputs (-1 = the output)")
        rules.add(entry.get("rule") or ckind)
        out.append(entry)
    if len(rules) > 1:
        raise OpDefError(
            f"defop({kind!r}): comm entries resolve to conflicting shard "
            f"rules {sorted(rules)} — one rule lowers the whole node")
    if rules and shard_rule is not None and {shard_rule} != rules:
        raise OpDefError(
            f"defop({kind!r}): shard_rule={shard_rule!r} disagrees with the "
            f"rule the comm entries resolve to ({rules.pop()!r})")
    for name in rules | ({shard_rule} if shard_rule else set()):
        from repro_torch.core import opaque_rules

        if name not in opaque_rules.RULES:
            raise OpDefError(
                f"defop({kind!r}): comm declaration references shard rule "
                f"{name!r}, but only {sorted(opaque_rules.RULES)} are "
                "registered (core.opaque_rules.register_rule)")
    return tuple(out)


_CHECK_BOUND = 4  # per-label extent for the registration-time impl check


def check_impl(kind: str) -> None:
    """Run the signature-vs-impl output-shape check for one registered op
    (no-op without both a signature and a dense impl).

    ``defop`` runs this automatically; the built-in catalog registers with
    ``check_impl=False`` — the pure-planning path is a metadata-only
    registry consumer and runs no impl.
    """
    od = require(kind)
    if od.fn is not None and od.signature is not None:
        _check_impl_shape(od)


def _check_impl_shape(od: OpDef) -> None:
    """Invoke the dense impl on tiny signature-shaped inputs and verify the
    output shape matches the signature — the cross-validation that used to
    be impossible with impl and signature living in different registries."""
    bounds = {l: _CHECK_BOUND for l in od.labels}
    params = {pname: _CHECK_BOUND for pname in od.param_bounds.values()}
    args = []
    for i, ls in enumerate(od.in_labels):
        dt = od.in_dtypes[i] if i < len(od.in_dtypes) else None
        args.append(np.zeros(tuple(bounds[l] for l in ls),
                             np.dtype(dt) if dt is not None else np.float32))
    try:
        out = od.fn(*args, **params)
    except Exception as e:  # pragma: no cover - defensive
        raise OpDefError(
            f"defop({od.kind!r}): dense impl failed the registration "
            f"check on signature-shaped inputs "
            f"({' , '.join(str(a.shape) for a in args)}): {e!r}") from e
    want = tuple(bounds[l] for l in od.out_labels)
    got = tuple(np.shape(out))
    if got != want:
        raise OpDefError(
            f"defop({od.kind!r}): dense impl output shape {got} does not "
            f"match the signature {od.signature!r} (expected {want} for "
            f"bounds {bounds})")


def defop(kind: str, signature: str | None = None, *,
          fn: Callable | None = None, kernel: Callable | None = None,
          vjp=None, vjp_reason: str | None = None, grad: str | None = None,
          comm: Sequence[Mapping] = (), shard_rule: str | None = None,
          shardable=None, param_bounds: Mapping[str, str] | None = None,
          out_dtype=None, in_dtypes: Sequence = (),
          category: str = "opaque", check_impl: bool = True,
          overwrite: bool = False, implicit: bool = False) -> OpDef:
    """Register one op kind.  This is *the* extension point of the system:
    everything — shape inference, dense execution, kernel dispatch,
    autodiff, comm pricing, shard_map lowering — resolves through the
    record registered here.  See the module docstring for field roles;
    ``frontend`` re-exports this as ``ein.defop`` plus the ``@ein.op``
    decorator.

    Raises :class:`OpDefError` on duplicate kinds (unless ``overwrite``),
    malformed signatures/comm declarations, references to unregistered
    shard rules, and — when ``fn`` and a signature are given and
    ``check_impl`` holds — a dense-impl output shape that contradicts the
    signature.
    """
    _ensure_builtins()
    if category not in ("opaque", "map"):
        raise OpDefError(f"defop({kind!r}): unknown category {category!r}")
    if not overwrite and kind in _REGISTRY:
        raise OpDefError(
            f"defop({kind!r}): op kind already registered — pass "
            "overwrite=True to replace it, or pick another kind")
    if VJP_TAG in kind:
        raise OpDefError(
            f"defop({kind!r}): {VJP_TAG!r} is reserved for derived VJP ops")
    if grad is not None and category != "map":
        raise OpDefError(
            f"defop({kind!r}): grad= names a derivative *map*; opaque ops "
            "declare a vjp= rule instead")

    in_labels: tuple[tuple[str, ...], ...] = ()
    out_labels: tuple[str, ...] = ()
    if signature is not None:
        in_labels, out_labels = parse_einsum(signature)
        for ls in in_labels:
            if len(set(ls)) != len(ls):
                raise OpDefError(
                    f"defop({kind!r}): repeated label within one input: {ls}")
        bound_from_inputs = {l for ls in in_labels for l in ls}
        pb = dict(param_bounds or {})
        for l in out_labels:
            if l not in bound_from_inputs and l not in pb:
                raise OpDefError(
                    f"defop({kind!r}): output label {l!r} appears in no "
                    "input — bind it to a call param via "
                    "param_bounds={'%s': '<param>'}" % l)
        for l in pb:
            if l in bound_from_inputs:
                raise OpDefError(
                    f"defop({kind!r}): param_bounds label {l!r} is already "
                    "bound by an input")
    elif param_bounds:
        raise OpDefError(f"defop({kind!r}): param_bounds needs a signature")

    shardable_set = None
    if shardable is not None:
        shardable_set = frozenset(_as_labels(shardable))
        if signature is not None:
            universe = {l for ls in in_labels for l in ls} | set(out_labels) \
                | set(param_bounds or {})
            unknown = shardable_set - universe
            if unknown:
                raise OpDefError(
                    f"defop({kind!r}): shardable labels {sorted(unknown)} "
                    "absent from the signature")

    if grad is not None and grad != kind:
        target = _REGISTRY.get(grad)
        if target is None or target.category != "map":
            raise OpDefError(
                f"defop({kind!r}): grad names derivative map {grad!r}, "
                "which is not a registered map op — register it first "
                "(or use grad=<own kind> for self-derivative ops like exp)")

    comm_t = _validate_comm(kind, comm, in_labels, out_labels, shard_rule)

    od = OpDef(kind=kind, category=category, signature=signature,
               in_labels=in_labels, out_labels=out_labels, fn=fn,
               kernel=kernel, vjp=vjp, vjp_reason=vjp_reason, grad=grad,
               comm=comm_t,
               shard_rule=shard_rule, shardable=shardable_set,
               param_bounds=dict(param_bounds or {}), out_dtype=out_dtype,
               in_dtypes=tuple(in_dtypes), implicit=implicit)
    if fn is not None and signature is not None and check_impl:
        _check_impl_shape(od)
    _REGISTRY[kind] = od
    return od


def provide_impl(kind: str, fn: Callable, *, check: bool = True) -> OpDef:
    """Attach (or replace) the dense implementation of an already-declared
    op — the unified path for late-bound impls (``models/opaque_stubs``).
    With ``check``, the impl is validated against the declared signature.
    """
    od = require(kind)
    prev = od.fn
    od.fn = fn
    if check and od.signature is not None:
        try:
            _check_impl_shape(od)
        except OpDefError:
            od.fn = prev
            raise
    return od


# ---------------------------------------------------------------------------
# Call-site binding: signature + instance labels -> shapes / metadata
# ---------------------------------------------------------------------------


def instance_label_map(od: OpDef, in_labels: Sequence[Sequence[str]],
                       out_labels: Sequence[str] | None = None,
                       *, strict: bool = False) -> dict[str, str]:
    """{signature label -> instance label}, positional.

    Two signature labels may map to the *same* instance label (prefill
    attention renames the ring label ``l`` to the q-sequence ``s``); one
    signature label mapping to two different instance labels is ill-formed
    and raises when ``strict``.
    """
    ren: dict[str, str] = {}
    for sig_ls, inst_ls in zip(od.in_labels, in_labels):
        for s_l, i_l in zip(sig_ls, inst_ls):
            prev = ren.setdefault(s_l, i_l)
            if strict and prev != i_l:
                raise OpDefError(
                    f"{od.kind}: signature label {s_l!r} bound to both "
                    f"{prev!r} and {i_l!r} — instance labels must rename "
                    "each signature label consistently")
    if out_labels is not None:
        for s_l, i_l in zip(od.out_labels, out_labels):
            prev = ren.setdefault(s_l, i_l)
            if strict and prev != i_l:
                raise OpDefError(
                    f"{od.kind}: signature output label {s_l!r} bound to "
                    f"both {prev!r} and {i_l!r}")
    return ren


def bind_call(od: OpDef, arg_shapes: Sequence[Sequence[int]], *,
              in_labels: Sequence[Sequence[str]] = (),
              out_labels: Sequence[str] | None = None,
              params: Mapping[str, Any] | None = None) -> dict:
    """Infer one call's instance metadata from the signature.

    Returns ``{"in_labels", "out_labels", "out_shape", "shardable"}`` with
    every signature label renamed to the caller's instance labels
    (positionally) and every bound checked for consistency across the
    arguments — the plan-time label validation that makes caller-supplied
    ``out_shape`` unnecessary.
    """
    if od.signature is None:
        raise OpDefError(
            f"{od.kind}: op registered without a signature — pass "
            "out_labels and out_shape explicitly")
    if len(arg_shapes) != len(od.in_labels):
        raise OpDefError(
            f"{od.kind}: signature {od.signature!r} takes "
            f"{len(od.in_labels)} inputs, got {len(arg_shapes)}")
    inst_in = tuple(tuple(ls) for ls in in_labels) or od.in_labels
    if len(inst_in) != len(od.in_labels):
        raise OpDefError(
            f"{od.kind}: {len(inst_in)} in_labels for "
            f"{len(od.in_labels)} signature inputs")
    for i, (ls, shape) in enumerate(zip(inst_in, arg_shapes)):
        if len(ls) != len(od.in_labels[i]):
            raise OpDefError(
                f"{od.kind}: input {i} labels {ls} do not match the "
                f"signature arity {od.in_labels[i]}")
        if len(ls) != len(shape):
            raise OpDefError(
                f"{od.kind}: input {i} rank {len(shape)} vs labels {ls}")

    if out_labels is not None and len(tuple(out_labels)) != \
            len(od.out_labels):
        raise OpDefError(
            f"{od.kind}: {len(tuple(out_labels))} out_labels for the "
            f"{len(od.out_labels)} signature outputs {od.out_labels}")
    ren = instance_label_map(od, inst_in,
                             out_labels if out_labels is not None else None,
                             strict=True)
    # bounds per *instance* label (validates cross-argument consistency)
    bounds: dict[str, int] = {}
    for ls, shape in zip(inst_in, arg_shapes):
        for l, b in zip(ls, shape):
            if bounds.setdefault(l, int(b)) != int(b):
                raise OpDefError(
                    f"{od.kind}: label {l!r} bound mismatch "
                    f"{bounds[l]} vs {int(b)}")

    params = dict(params or {})
    inst_out: list[str] = []
    out_shape: list[int] = []
    for j, s_l in enumerate(od.out_labels):
        i_l = (tuple(out_labels)[j] if out_labels is not None
               else ren.get(s_l, s_l))
        inst_out.append(i_l)
        if i_l in bounds:
            out_shape.append(bounds[i_l])
        elif s_l in od.param_bounds:
            pname = od.param_bounds[s_l]
            if pname not in params:
                raise OpDefError(
                    f"{od.kind}: output label {s_l!r} is bound by call "
                    f"param {pname!r}, which was not passed")
            out_shape.append(int(params[pname]))
        else:
            raise OpDefError(
                f"{od.kind}: cannot infer the bound of output label "
                f"{i_l!r} from the inputs")
    shardable = None
    if od.shardable is not None:
        shardable = frozenset(ren.get(l, l) for l in od.shardable)
    return {"in_labels": inst_in, "out_labels": tuple(inst_out),
            "out_shape": tuple(out_shape), "shardable": shardable}


# ---------------------------------------------------------------------------
# Node-side resolution: comm declaration + shard rule for a graph node
# ---------------------------------------------------------------------------


def comm_for_node(node) -> list[dict]:
    """The comm declaration the DP prices for one opaque node.

    An explicit ``comm`` in the node's params wins (the historical per-call
    override, still honored); otherwise the registered OpDef's template is
    renamed into the node's instance labels via its ``in_labels`` /
    ``labels`` and returned.  Nodes of unregistered kinds declare nothing.
    """
    comm = node.params.get("comm")
    if comm is not None:
        return list(comm)
    cached = node.__dict__.get("_opdef_comm")
    if cached is not None:  # hot in the DP inner loop; nodes are immutable
        return list(cached)
    od = get(node.op)
    if od is None or not od.comm or od.signature is None:
        entries: list[dict] = []
    else:
        ren = instance_label_map(od, node.in_labels or (), node.labels)
        entries = [dict(e, label=ren.get(e["label"], e["label"]))
                   for e in od.comm]
    node.__dict__["_opdef_comm"] = tuple(entries)
    return entries


def shard_rule_for_node(node) -> str | None:
    """The OpDef-declared shard rule for a node whose comm entries name
    none (``opaque_rules.resolve_rule_name`` consults this)."""
    od = get(node.op)
    return od.shard_rule if od is not None else None


# ---------------------------------------------------------------------------
# Execution lookup (incl. derived @vjp kinds)
# ---------------------------------------------------------------------------


def executable_or_none(kind: str) -> Callable | None:
    _ensure_builtins()
    if VJP_TAG in kind:
        base_kind, _, idx = kind.rpartition(VJP_TAG)
        base = _REGISTRY.get(base_kind)
        if base is None or base.executable is None:
            return None
        return _vjp_impl(base_kind, int(idx))
    od = _REGISTRY.get(kind)
    return od.executable if od is not None else None


def executable(kind: str) -> Callable:
    fn = executable_or_none(kind)
    if fn is None:
        od = get(kind.rpartition(VJP_TAG)[0] if VJP_TAG in kind else kind)
        hint = ("its OpDef declares no implementation — attach one with "
                "opdef.provide_impl" if od is not None else
                "declare it with ein.defop(kind, signature, fn=...)")
        raise OpDefError(f"op kind {kind!r} has no implementation; {hint}")
    return fn


_VJP_IMPLS: dict[tuple[str, int], Callable] = {}


def _vjp_impl(base_kind: str, i: int) -> Callable:
    """Executable of the derived ``<kind>@vjp<i>`` op: pull the cotangent
    back through ``torch.func.vjp`` of the base op's **dense reference
    impl**, differentiating only the floating (float/complex) arguments.

    The reference is differentiated deliberately, as in the JAX package:
    the kernel dispatcher may route to a hand-written kernel, and the two
    compute the same function — an op whose kernel should own its backward
    declares a custom ``vjp=`` rule instead of ``"auto"``."""
    key = (base_kind, i)
    cached = _VJP_IMPLS.get(key)
    if cached is not None:
        return cached

    def impl(*args, **params):
        import torch
        import torch.func

        *prim, ct = args
        prim = [torch.as_tensor(a) for a in prim]
        diff = [j for j, a in enumerate(prim)
                if a.is_floating_point() or a.is_complex()]
        if i not in diff:
            raise OpDefError(
                f"{base_kind}{VJP_TAG}{i}: input {i} is not differentiable "
                f"(dtype {prim[i].dtype})")
        od = require(base_kind)
        base = od.fn if od.fn is not None else executable(base_kind)

        def f(*da):
            full = list(prim)
            for j, v in zip(diff, da):
                full[j] = v
            return base(*full, **params)

        y, pull = torch.func.vjp(f, *[prim[j] for j in diff])
        ct = torch.as_tensor(ct).to(device=y.device, dtype=y.dtype)
        return pull(ct)[diff.index(i)]

    _VJP_IMPLS[key] = impl
    return impl


# ---------------------------------------------------------------------------
# VJP graph construction (used by core/autodiff.grad_graph)
# ---------------------------------------------------------------------------


def _is_inexact(dtype) -> bool:
    try:
        return np.dtype(dtype).kind in "fc"
    except TypeError:
        return True


def build_vjp(gg, node, dz: int) -> list[int | None]:
    """Backward nodes for one opaque node: returns one adjoint node id per
    input (``None`` for non-differentiable inputs).

    Dispatches on the OpDef's ``vjp`` field: a callable builds custom
    backward structure (it receives ``(gg, node, dz)`` and returns the same
    shape of result); ``"auto"`` emits one derived ``<kind>@vjp<i>`` opaque
    node per inexact input, executed through ``torch.func.vjp`` of the
    forward impl.  An OpDef without a VJP — or an unregistered kind —
    raises the actionable error naming the op.
    """
    od = get(node.op)
    if od is None or od.vjp is None:
        have = f"OpDef for {node.op!r} declares no VJP" if od is not None \
            else f"op {node.op!r} has no OpDef"
        raise NotImplementedError(
            f"cannot differentiate through opaque op {node.op!r} "
            f"(node {node.name!r}): {have} — register one with "
            f"ein.defop({node.op!r}, ..., vjp='auto') or a custom "
            "vjp=callable")
    if callable(od.vjp):
        return list(od.vjp(gg, node, dz))
    if od.vjp != "auto":
        raise OpDefError(
            f"{node.op}: vjp must be None, 'auto', or callable, "
            f"got {od.vjp!r}")

    in_lab = node.in_labels or tuple((node.labels,) * len(node.inputs))
    outs: list[int | None] = []
    for i, (a, _ls) in enumerate(zip(node.inputs, in_lab)):
        an = gg.nodes[a]
        if not _is_inexact(an.dtype):
            outs.append(None)
            continue
        nid = gg.opaque(
            f"{node.op}{VJP_TAG}{i}", list(node.inputs) + [dz],
            an.labels, an.shape,
            in_labels=tuple(in_lab) + (tuple(node.labels),),
            shardable=node.shardable, dtype=an.dtype,
            name=f"{node.name or node.op}{VJP_TAG}{i}", **node.call_params)
        outs.append(nid)
    return outs


# ---------------------------------------------------------------------------
# Legacy views: MAP_FNS / OPAQUE_FNS / GRAD_MAPS over the one registry
# ---------------------------------------------------------------------------


class _ImplView(MutableMapping):
    """dict-compatible view of one category's executables.

    ``view[k] = fn`` installs a call-time override (creating a minimal
    implicit OpDef for unknown kinds — the legacy ``register_opaque``
    semantics, also what ``monkeypatch.setitem`` relies on); ``del
    view[k]`` removes the override, dropping implicit records entirely.
    """

    def __init__(self, category: str):
        self._category = category

    def _ods(self):
        _ensure_builtins()
        return {k: od for k, od in _REGISTRY.items()
                if od.category == self._category}

    def __getitem__(self, kind: str) -> Callable:
        fn = executable_or_none(kind)
        if fn is None:
            raise KeyError(kind)
        if VJP_TAG not in kind and require(kind).category != self._category:
            raise KeyError(kind)
        return fn

    def __setitem__(self, kind: str, fn: Callable) -> None:
        _ensure_builtins()
        od = _REGISTRY.get(kind)
        if od is None:
            od = defop(kind, None, category=self._category, implicit=True)
        elif od.category != self._category:
            # op kinds share one namespace now: writing an opaque impl over
            # a registered *map* op (or vice versa) would silently replace
            # its execution everywhere — the old split dicts kept such
            # writes inert, so reject instead of corrupting.
            raise OpDefError(
                f"op kind {kind!r} is registered as a {od.category} op — "
                f"cannot override it through the {self._category} view "
                "(pick another kind, or defop(..., overwrite=True))")
        od.impl_override = fn

    def __delitem__(self, kind: str) -> None:
        _ensure_builtins()
        od = _REGISTRY.get(kind)
        if od is None:
            raise KeyError(kind)
        od.impl_override = None
        if od.implicit and od.fn is None and od.kernel is None:
            del _REGISTRY[kind]

    def __iter__(self):
        return iter(sorted(k for k, od in self._ods().items()
                           if od.executable is not None))

    def __len__(self):
        return sum(1 for od in self._ods().values()
                   if od.executable is not None)

    def __repr__(self):
        return f"<{self._category} impl view over the OpDef registry: " \
               f"{sorted(self)}>"


class _GradMapView(MutableMapping):
    """dict-compatible view of the map-op derivative links (the historical
    ``autodiff.GRAD_MAPS``): ``{map kind: derivative map kind}``."""

    def _items(self):
        _ensure_builtins()
        return {k: od.grad for k, od in _REGISTRY.items()
                if od.category == "map" and od.grad is not None}

    def __getitem__(self, kind: str) -> str:
        grad = self._items().get(kind)
        if grad is None:
            raise KeyError(kind)
        return grad

    def __setitem__(self, kind: str, grad: str) -> None:
        _ensure_builtins()
        od = _REGISTRY.get(kind)
        if od is None:
            od = defop(kind, None, category="map", implicit=True)
        od.grad = grad

    def __delitem__(self, kind: str) -> None:
        od = _REGISTRY.get(kind)
        if od is None or od.grad is None:
            raise KeyError(kind)
        od.grad = None
        if od.implicit and od.executable is None:
            del _REGISTRY[kind]

    def __iter__(self):
        return iter(sorted(self._items()))

    def __len__(self):
        return len(self._items())


#: legacy registry surfaces — live views, re-exported by their historical
#: homes (engine.MAP_FNS / engine.OPAQUE_FNS / autodiff.GRAD_MAPS).
MAP_FNS = _ImplView("map")
OPAQUE_FNS = _ImplView("opaque")
GRAD_MAPS = _GradMapView()


def register_legacy(kind: str, fn: Callable, *, surface: str) -> None:
    """The body of the deprecated ``register_opaque`` entry points."""
    warnings.warn(
        f"{surface} is deprecated: register ops through the unified "
        f"OpDef API instead — ein.defop({kind!r}, '<signature>', fn=...) "
        "(one record: signature, impl, kernel, vjp, comm, shard rule)",
        DeprecationWarning, stacklevel=3)
    OPAQUE_FNS[kind] = fn
