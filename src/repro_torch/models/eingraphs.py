"""Declarative model builders for every architecture family + ``program_for``.

This is where the paper's technique becomes a first-class feature of the
framework: each model family's layer (plus embedding and LM head) is
declared with the symbolic frontend (``repro_torch.frontend``) as extended-einsum
expressions over canonical labels

    b batch  s sequence  t cache-time  a d_model  h q-heads  k kv-heads
    d head_dim  f ffn-hidden  g 2x-expansion  v vocab  e experts  c capacity

``program_for`` wraps one (arch x shape) cell as a ``Program`` with named
inputs and a named ``logits`` output; ``Program.compile`` runs EinDecomp
(through the plan cache) and ``CompiledProgram.policy()`` collapses the plan
to the ShardingPolicy the production model stack applies via GSPMD.  Fused
ops (flash attention, MoE dispatch, recurrent scans) are opaque
expressions whose whole declaration — label signature, shardable set, the
internal-communication (``comm``) template the DP prices as ring /
all-to-all traffic, the bound shard rule — lives on their registered
OpDef (core/opdefs_builtin.py); the builders below only pass arguments
and, where a signature label is renamed per instance, ``in_labels``
(DESIGN.md §2 adaptation 3, §4 arch-applicability).

``build_graph`` / ``plan_for`` remain as thin shims over the Program
surface for callers written against the original imperative API.
"""
from __future__ import annotations

import functools

from repro_torch import frontend as ein
from repro_torch.core.decomp import Plan
from repro_torch.core.einsum import EinGraph
from repro_torch.frontend import Program
from repro_torch.models.policy import ShardingPolicy, policy_from_plan


# ---------------------------------------------------------------------------
# Fragments (symbolic expressions; x is the running "b s a" activation)
# ---------------------------------------------------------------------------


def _attention_nodes(x: ein.Expr, cfg, B: int, S: int, *,
                     decode: bool = False, kv_len: int = 0,
                     kv_block: int = 0) -> ein.Expr:
    """q/k/v are declared in the kernel's (batch, heads, seq, head_dim)
    layout, so the opaque node's sequence label *is* the kernel's sequence
    axis — what the ring shard rule rotates K/V blocks over.  Everything
    else (output shape/labels, shardable set, the ring comm declaration the
    DP prices, the bound shard rule) comes from the ``flash_attention``
    OpDef; the per-call ``in_labels`` only rename its ring label ``l`` to
    this instance's label — ``s`` in prefill (shared with q), the
    kv-cache-time ``t`` in decode."""
    H, K, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    wq = ein.tensor("wq", "a h d", (D, H, hd))
    q = ein.einsum("b s a, a h d -> b h s d", x, wq, name="q_proj")
    if decode:
        if kv_block:
            # paged serving-tier decode: the cache arrives as a block pool
            # plus per-sequence block tables, and the time-ordered (b k t d)
            # view is a kv_block_gather node — an OpDef like any other, so
            # the DP prices the lookup and the shard_map executor lowers it
            # through the ``paged`` rule (zero-collective local gather).
            W = -(-kv_len // kv_block)
            t_len = W * kv_block
            kp = ein.tensor("kv_pool_k", "n p k d",
                            (B * W + 1, kv_block, K, hd))
            vp = ein.tensor("kv_pool_v", "n p k d",
                            (B * W + 1, kv_block, K, hd))
            tb = ein.tensor("block_tables", "b w", (B, W), dtype="int32")
            kc = ein.opaque("kv_block_gather", [kp, tb], name="kv_gather_k",
                            kv_len=t_len)
            vc = ein.opaque("kv_block_gather", [vp, tb], name="kv_gather_v",
                            kv_len=t_len)
        else:
            kc = ein.tensor("k_cache", "b k t d", (B, K, kv_len, hd))
            vc = ein.tensor("v_cache", "b k t d", (B, K, kv_len, hd))
        att = ein.opaque(
            "flash_attention", [q, kc, vc],
            in_labels=[("b", "h", "s", "d"), ("b", "k", "t", "d"),
                       ("b", "k", "t", "d")],
            name="attn")
    else:
        wk = ein.tensor("wk", "a k d", (D, K, hd))
        wv = ein.tensor("wv", "a k d", (D, K, hd))
        kk = ein.einsum("b s a, a k d -> b k s d", x, wk, name="k_proj")
        vv = ein.einsum("b s a, a k d -> b k s d", x, wv, name="v_proj")
        att = ein.opaque(
            "flash_attention", [q, kk, vv],
            in_labels=[("b", "h", "s", "d"), ("b", "k", "s", "d"),
                       ("b", "k", "s", "d")],
            name="attn")
    wo = ein.tensor("wo", "h d a", (H, hd, D))
    return ein.einsum("b h s d, h d a -> b s a", att, wo, name="o_proj")


def _ffn_nodes(x: ein.Expr, cfg, B: int, S: int,
               d_ff: int | None = None) -> ein.Expr:
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    w1 = ein.tensor("w1", "a f", (D, F))
    h = ein.einsum("b s a, a f -> b s f", x, w1, name="ffn_up")
    h = h.map(cfg.act if cfg.act in ("silu", "gelu", "relu2") else "silu")
    if cfg.gated_ffn:
        w3 = ein.tensor("w3", "a f", (D, F))
        hg = ein.einsum("b s a, a f -> b s f", x, w3, name="ffn_gate")
        h = ein.einsum("b s f, b s f -> b s f", h, hg, combine="mul", agg="",
                       name="ffn_mul")
    w2 = ein.tensor("w2", "f a", (F, D))
    return ein.einsum("b s f, f a -> b s a", h, w2, name="ffn_down")


def _moe_nodes(x: ein.Expr, cfg, B: int, S: int) -> ein.Expr:
    D, E, F = cfg.d_model, cfg.n_e, cfg.d_ff
    T = B * S
    C = max(128, -(-int(T * cfg.top_k / E * cfg.capacity_factor) // 128) * 128)
    wr = ein.tensor("router_w", "a e", (D, E))
    route = ein.einsum("b s a, a e -> b s e", x, wr, name="router")
    # the capacity param binds the output-only label c (OpDef param_bounds);
    # shardable set + a2a comm declaration + shard rule come from the OpDef
    disp = ein.opaque("moe_dispatch", [x, route], name="dispatch",
                      capacity=C)
    we1 = ein.tensor("we1", "e a f", (E, D, F))
    h = ein.einsum("e c a, e a f -> e c f", disp, we1, name="expert_up")
    h = h.map(cfg.act if cfg.act in ("silu", "gelu", "relu2") else "silu")
    if cfg.gated_ffn:
        we3 = ein.tensor("we3", "e a f", (E, D, F))
        hg = ein.einsum("e c a, e a f -> e c f", disp, we3, name="expert_gate")
        h = ein.einsum("e c f, e c f -> e c f", h, hg, combine="mul", agg="",
                       name="expert_mul")
    we2 = ein.tensor("we2", "e f a", (E, F, D))
    y = ein.einsum("e c f, e f a -> e c a", h, we2, name="expert_down")
    comb = ein.opaque("moe_combine", [y, route], name="combine")
    if cfg.shared_expert_ff:
        sh = _ffn_nodes(x, cfg, B, S, d_ff=cfg.shared_expert_ff)
        comb = ein.einsum("b s a, b s a -> b s a", comb, sh, combine="add",
                          agg="", name="moe_add_shared")
    return comb


def _recurrent_nodes(x: ein.Expr, cfg, B: int, S: int, kind: str) -> ein.Expr:
    """mLSTM / sLSTM / SSM path as proj -> opaque scan -> proj.

    The scan's sequence label is non-partitionable (the scan OpDefs'
    shardable sets exclude s) — the brief's arch-applicability caveat for
    recurrence.  mLSTM/SSM channel labels stay shardable (chunkwise forms
    are channel-local) and the OpDefs bind the ``local`` shard rule, so the
    shard_map executor runs a local scan per channel shard with zero
    collectives; sLSTM's dense recurrent matrix couples the whole width,
    so only b shards.
    """
    D = cfg.d_model
    F = 2 * D
    win = ein.tensor(f"{kind}_in", "a f", (D, F))
    h = ein.einsum("b s a, a f -> b s f", x, win, name=f"{kind}_up")
    scan = ein.opaque(f"{kind}_scan", [h], name=f"{kind}_scan")
    wdn = ein.tensor(f"{kind}_down", "f a", (F, D))
    return ein.einsum("b s f, f a -> b s a", scan, wdn, name=f"{kind}_down_proj")


# ---------------------------------------------------------------------------
# Whole-model declaration
# ---------------------------------------------------------------------------


def build_expr(cfg, shape, *, mode: str | None = None,
               kv_block: int = 0) -> ein.Expr:
    """Embedding -> one block period -> LM head, at the cell's (B, S),
    declared as one symbolic expression (the logits).

    One period is enough: scan reuses the same plan for every unit (the
    per-layer graphs are isomorphic), which is also why the DP stays fast.

    ``kv_block`` > 0 declares the decode KV cache as a *paged* block pool +
    block tables feeding ``kv_block_gather`` nodes (the serving tier's
    cache; block size ``kv_block``) instead of dense (b k t d) inputs.
    """
    mode = mode or ("decode" if shape.kind == "decode" else shape.kind)
    B = shape.batch
    S = 1 if mode == "decode" else shape.seq
    D, V = cfg.d_model, cfg.vocab_padded
    kv_len = 0
    if mode == "decode":
        # paged caches are time-ordered (window masking happens at the
        # attend), so their span is the full sequence, not the ring window
        kv_len = shape.seq if kv_block else cfg.kv_len(shape)

    ids = ein.tensor("ids", "b s", (B, S), dtype="int32")
    table = ein.tensor("embed", "v a", (V, D))
    x = ein.opaque("gather_rows", [table, ids], name="embed_lookup")

    for blk in cfg.block_pattern:
        if blk == "attn":
            a = _attention_nodes(x, cfg, B, S, decode=(mode == "decode"),
                                 kv_len=kv_len, kv_block=kv_block)
            x = ein.einsum("b s a, b s a -> b s a", x, a, combine="add",
                           agg="", name="resid_attn")
            m = (_moe_nodes(x, cfg, B, S) if cfg.moe
                 else _ffn_nodes(x, cfg, B, S))
            x = ein.einsum("b s a, b s a -> b s a", x, m, combine="add",
                           agg="", name="resid_ffn")
        elif blk == "hymba":
            a = _attention_nodes(x, cfg, B, S, decode=(mode == "decode"),
                                 kv_len=kv_len, kv_block=kv_block)
            sm = _recurrent_nodes(x, cfg, B, S, "ssm")
            mix = ein.einsum("b s a, b s a -> b s a", a, sm, combine="add",
                             agg="", name="hymba_mix")
            x = ein.einsum("b s a, b s a -> b s a", x, mix, combine="add",
                           agg="", name="resid_mix")
            f = _ffn_nodes(x, cfg, B, S)
            x = ein.einsum("b s a, b s a -> b s a", x, f, combine="add",
                           agg="", name="resid_ffn")
        elif blk in ("mlstm", "slstm"):
            r = _recurrent_nodes(x, cfg, B, S, blk)
            x = ein.einsum("b s a, b s a -> b s a", x, r, combine="add",
                           agg="", name=f"resid_{blk}")
        else:
            raise ValueError(blk)

    head = ein.tensor("head", "a v", (D, V))
    return ein.einsum("b s a, a v -> b s v", x, head, name="lm_head")


def _build_program(cfg, shape, *, mode: str | None = None,
                   kv_block: int = 0) -> Program:
    mode_str = mode or ("decode" if shape.kind == "decode" else shape.kind)
    logits = build_expr(cfg, shape, mode=mode, kv_block=kv_block)
    paged = f":paged{kv_block}" if kv_block else ""
    return Program({"logits": logits},
                   name=f"{cfg.name}:{shape.name}:{mode_str}{paged}")


@functools.lru_cache(maxsize=None)
def _program_cached(cfg, shape, kv_block: int = 0) -> Program:
    return _build_program(cfg, shape, kv_block=kv_block)


def program_for(cfg, shape, *, mode: str | None = None,
                kv_block: int = 0) -> Program:
    """The declarative surface for one (arch x shape) cell: a ``Program``
    with name-keyed inputs and a ``logits`` output.  Memoized per (cfg,
    shape, kv_block) for the default mode — programs (and their traced
    graphs) are immutable after construction.  ``kv_block`` > 0 declares
    the decode KV cache as a paged block pool (see ``build_expr``)."""
    if mode is None:
        return _program_cached(cfg, shape, kv_block)
    return _build_program(cfg, shape, mode=mode, kv_block=kv_block)


def fsdp_axes_for(mesh_axes: dict[str, int]) -> tuple[str, ...]:
    """The data-parallel mesh axes ZeRO-style parameter sharding lands on
    (train shapes; beyond-paper §Perf lever)."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes)


# ---------------------------------------------------------------------------
# Deprecation shims: the original imperative entry points
# ---------------------------------------------------------------------------


def build_graph(cfg, shape, *, mode: str | None = None) -> EinGraph:
    """Deprecated shim: the traced ``EinGraph`` of ``program_for(cfg,
    shape)`` — identical node-for-node to what the original imperative
    builder produced (tests/test_program_equivalence.py pins this)."""
    return program_for(cfg, shape, mode=mode).graph


@functools.lru_cache(maxsize=None)
def _plan_cached(cfg, shape, mesh_key: tuple, offpath_repart: bool):
    prog = _program_cached(cfg, shape)
    compiled = prog.compile(mesh_axes=dict(mesh_key),
                            offpath_repart=offpath_repart)
    return prog.graph, compiled.plan


def plan_for(cfg, shape, mesh_axes: dict[str, int], *,
             fsdp: bool = False, offpath_repart: bool = True,
             cache=None) -> tuple[EinGraph, Plan, ShardingPolicy]:
    """Deprecated shim over ``program_for(cfg, shape).compile(...)``: run
    EinDecomp for one (arch x shape x mesh) cell and derive the production
    ShardingPolicy.  ``fsdp`` additionally ZeRO-shards params over the data
    axes (train shapes; beyond-paper §Perf lever).

    ``cache`` is an optional ``core.plancache.PlanCache``; when given it
    replaces the process-local lru memo, which means plans survive process
    restarts (disk-backed caches) and transfer across isomorphic graphs —
    e.g. two archs whose block graphs coincide structurally plan once.
    New code should hold the ``CompiledProgram`` instead:

        compiled = program_for(cfg, shape).compile(mesh_axes=axes, cache=...)
        plan, policy = compiled.plan, compiled.policy(fsdp_axes=...)
    """
    if cache is not None:
        # program construction is memoized in-process; the canonical hash is
        # memoized on the graph object, so repeated replanning through the
        # persistent cache stays O(lookup) after the first call.
        prog = program_for(cfg, shape)
        compiled = prog.compile(mesh_axes=dict(mesh_axes),
                                offpath_repart=offpath_repart, cache=cache)
        g, plan = prog.graph, compiled.plan
    else:
        g, plan = _plan_cached(cfg, shape,
                               tuple(sorted(mesh_axes.items())), offpath_repart)
    policy = policy_from_plan(plan, g,
                              fsdp_axes=fsdp_axes_for(mesh_axes) if fsdp else ())
    return g, plan, policy
