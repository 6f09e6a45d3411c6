"""The model stack: embedding -> blocks -> norm -> LM head.

``cfg.block_pattern`` cycles the block kinds (attn | hymba | mlstm | slstm)
over layers; layers are grouped into *units* of one pattern period and
their parameters are stacked with a leading unit axis, as in the
reference.  A Python loop over units replaces the reference's
``lax.scan``.  ``attn`` blocks carry a dense FFN (the llama family) or a
MoE FFN (mixtral, qwen2-moe); ``hymba`` runs attention and a selective SSM
side by side (``models/ssm.py``); ``mlstm`` and ``slstm`` are the xLSTM
blocks (``models/xlstm.py``).  Prefix embeddings (paligemma's patch
embeddings, a stub of the vision tower) are prepended to the token
embeddings where ``forward`` is given them.

Decode caches are preallocated once (``init_caches``) and written in place
by each decode step; the serving tier's paged pools (``init_paged_caches``)
likewise, by ``decode_step_paged``.  A block's cache is the reference's
structure: ``KVCache`` for attn, ``(KVCache, SSMState)`` for hymba,
``MLSTMState`` or ``SLSTMState``, every leaf stacked over units.  Recurrent
states are per batch slot (paged or not); each decode step copies the new
state into them.  Training differentiates ``loss_fn`` with
``torch.autograd``, each unit rematerialized as the reference's
``jax.checkpoint`` does (``forward(remat=...)``).

Sharding: a ``ShardingPolicy`` (usually projected from an EinDecomp plan)
supplies the specs.  On a ``launch.mesh.Mesh`` of more than one rank the
parameters, caches and batch are DTensors (``param_shardings``,
``cache_shardings``, ``data.synthetic.place_batch``), the model code runs
on them under DTensor's sharding propagation, and the activations are
constrained where the reference constrains them (``_cst``: ``"b s a"``
after the embedding and each residual, ``"b s k d"`` on k/v, ``"b s v"``
on the logits, ``"b t k d"`` on the caches).  Every block runs under a
mesh: the MoE FFN routes each rank's own tokens, moves the kept rows to
their experts' ranks by all-to-all where the batch and the experts share
mesh axes, and runs its experts on each rank's expert block
(``models/moe.py``); the loss keeps the vocabulary split
(``common.softmax_xent``); the recurrent
blocks — hymba's SSM, the mLSTM and the sLSTM — run on each rank's batch
rows (``common.on_rows``), their states placed as ``cache_labels`` says;
hymba's attention runs as the attn block's does.  The serving tier's paged
decode (``decode_step_paged``) runs there too: its pools are placed by
``paged_cache_specs`` (the kv-head dim as the policy splits ``k``, the
block dims never), its states as ``cache_labels`` says.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import tree as tree_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (ParamFactory, dtype_of, embed,
                                       lm_logits, resolve_device, rmsnorm,
                                       softmax_xent)

BLOCKS = ("attn", "hymba", "mlstm", "slstm")


def _check_supported(cfg) -> None:
    for blk in cfg.block_pattern:
        if blk not in BLOCKS:
            raise ValueError(f"{cfg.name}: unknown block {blk!r}; expected "
                             f"one of {BLOCKS}")


def _placed(mesh) -> bool:
    return mesh is not None and mesh.world_size > 1


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(pf: ParamFactory, cfg, blk: str) -> dict:
    """One block's parameters, the reference's leaves."""
    p: dict[str, Any] = {"norm1": pf.ones(cfg.d_model)}
    if blk == "attn":
        p["attn"] = attn_mod.init_attention(pf, cfg)
        p["norm2"] = pf.ones(cfg.d_model)
        if cfg.moe:
            p["moe"] = moe_mod.init_moe(pf, cfg)
        else:
            p["ffn"] = ffn_mod.init_ffn(pf, cfg)
    elif blk == "hymba":
        p["attn"] = attn_mod.init_attention(pf, cfg)
        p["ssm"] = ssm_mod.init_ssm(pf, cfg)
        p["norm_a"] = pf.ones(cfg.d_model)
        p["norm_s"] = pf.ones(cfg.d_model)
        p["norm2"] = pf.ones(cfg.d_model)
        p["ffn"] = ffn_mod.init_ffn(pf, cfg)
    elif blk == "mlstm":
        p["mlstm"] = xlstm_mod.init_mlstm(pf, cfg)
    elif blk == "slstm":
        p["slstm"] = xlstm_mod.init_slstm(pf, cfg)
    else:
        raise ValueError(blk)
    return p


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Seeded random parameters on ``device`` (default: the card; a
    ``torch.Generator`` on that device, fan-in scaled as in the reference).
    The CPU and CUDA generators give different numbers for one seed; to run
    the same weights on both, make them on the CPU and move them.  On the
    ``"meta"`` device (no generator, no memory) it gives the parameters'
    shapes and dtypes only."""
    _check_supported(cfg)
    device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    dt = dtype_of(cfg)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    pattern = cfg.block_pattern
    units = cfg.n_layers // len(pattern)
    if units * len(pattern) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not divide "
                         f"into units of the pattern {pattern}")
    pf = ParamFactory(gen, dt, device)
    params = {
        # d**-0.5 keeps tied-head logits unit-variance (x RMS=1 post-norm)
        "embed": pf.dense(cfg.vocab_padded, cfg.d_model,
                          scale=cfg.d_model ** -0.5),
    }
    stacked = ParamFactory(gen, dt, device, stack=units)
    params["layers"] = [_init_block(stacked, cfg, blk) for blk in pattern]
    params["final_norm"] = pf.ones(cfg.d_model)
    if not cfg.tie_embeddings:
        params["head"] = pf.dense(cfg.d_model, cfg.vocab_padded)
    return params


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # numpy's bf16 extension type: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def from_reference_params(cfg, tree, device=None) -> dict:
    """The port's parameters from the JAX package's parameter tree, given
    as numpy arrays (``{"embed", "layers": [per pattern position: nested
    dict with a leading unit axis], "final_norm", "head"?}``).  The layouts
    agree leaf for leaf, so both packages compute the same function; a
    tree whose structure, leaf shapes or dtypes differ from the port's
    (``init_params`` on the meta device) raises.  ``device`` defaults to
    the card."""
    _check_supported(cfg)
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, device)

    params = conv(tree)
    want = init_params(cfg, device="meta")
    if _structure(params) != _structure(want):
        raise ValueError(f"from_reference_params: tree {_structure(params)}, "
                         f"expected {_structure(want)}")
    for got, ref in zip(tree_mod.leaves(params), tree_mod.leaves(want)):
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise ValueError(f"from_reference_params: a leaf of {tuple(got.shape)} "
                             f"{got.dtype} where the port has {tuple(ref.shape)} "
                             f"{ref.dtype}")
    return params


def _structure(tree):
    """``tree`` with every leaf replaced by None (dict keys, list lengths)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _unit(tree, u: int):
    """Unit ``u``'s parameters (or caches): views into the stacked tree,
    containers (dicts, tuples, NamedTuples) kept."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unit(v, u) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unit(v, u) for v in tree)
    return tree[u]


def _stack(trees: list):
    """Trees of one structure stacked leaf by leaf along a new leading
    (unit) axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(xs)) for xs in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(xs)) for xs in zip(*trees))
    return torch.stack(trees)


def _write_state(buf, new) -> None:
    """Copy a block's new recurrent state into its cache buffers in place;
    on a mesh each new leaf is redistributed to its buffer's placements
    first, and each rank copies its block."""
    from torch.distributed.tensor import DTensor

    for b, n in zip(tree_mod.leaves(buf), tree_mod.leaves(new)):
        if isinstance(b, DTensor):
            b.to_local().copy_(n.redistribute(b.device_mesh, b.placements).to_local())
        else:
            b.copy_(n)


def _n_units(cfg) -> int:
    return cfg.n_layers // len(cfg.block_pattern)


def _head(params) -> torch.Tensor:
    head = params.get("head")
    return params["embed"].T if head is None else head


# ---------------------------------------------------------------------------
# Labels and placements (mirroring init_params / init_caches)
# ---------------------------------------------------------------------------


def _block_labels(cfg, blk: str) -> dict:
    p: dict[str, Any] = {"norm1": "L a"}
    if blk in ("attn", "hymba"):
        at = {"wq": "L a h d", "wk": "L a k d", "wv": "L a k d", "wo": "L h d a"}
        if cfg.qkv_bias:
            at.update({"bq": "L h d", "bk": "L k d", "bv": "L k d"})
        p["attn"] = at
        p["norm2"] = "L a"
        ffl = {"w1": "L a f", "w2": "L f a"}
        if cfg.gated_ffn:
            ffl["w3"] = "L a f"
        if blk == "attn" and cfg.moe:
            ml = {"router": "L a e", "w1": "L e a f", "w2": "L e f a"}
            if cfg.gated_ffn:
                ml["w3"] = "L e a f"
            if cfg.shared_expert_ff:
                ml["shared"] = dict(ffl)
            p["moe"] = ml
        else:
            p["ffn"] = dict(ffl)
    if blk == "hymba":
        p["ssm"] = {"in_proj": "L a f", "conv_w": "L z a", "x_proj": "L a z",
                    "a_log": "L a n", "d_skip": "L a", "out_proj": "L f a"}
        p["norm_a"] = "L a"
        p["norm_s"] = "L a"
    if blk == "mlstm":
        p["mlstm"] = {"w_up": "L a f", "wq": "L a f", "wk": "L a f",
                      "wv": "L a f", "w_if": "L a z", "w_down": "L f a",
                      "norm": "L a"}
    if blk == "slstm":
        p["slstm"] = {"w_in": "L a f", "r": "L a f", "w_down": "L f a",
                      "norm": "L a"}
    return p


def param_labels(cfg) -> dict:
    """Label strings mirroring ``init_params``' structure."""
    labels = {
        "embed": "v a",
        "layers": [_block_labels(cfg, blk) for blk in cfg.block_pattern],
        "final_norm": "a",
    }
    if not cfg.tie_embeddings:
        labels["head"] = "a v"
    return labels


#: label strings of one unit's recurrent state, per block kind
_STATE_LABELS = {"hymba": ssm_mod.SSMState("b a n", "b z a"),
                 "mlstm": xlstm_mod.MLSTMState("b h d d", "b h d", "b h"),
                 "slstm": xlstm_mod.SLSTMState("b a", "b a", "b a", "b a")}


def cache_labels(cfg) -> list:
    """Label strings mirroring ``init_caches``' structure."""
    def one(blk):
        kv = attn_mod.KVCache("L b t k d", "L b t k d")
        if blk == "attn":
            return kv
        if blk not in _STATE_LABELS:
            raise ValueError(blk)
        st = type(_STATE_LABELS[blk])(*("L " + l for l in _STATE_LABELS[blk]))
        return (kv, st) if blk == "hymba" else st

    return [one(blk) for blk in cfg.block_pattern]


def _zip_map(fn, tree, labels):
    """``fn(leaf, label)`` over a tree of tensors and a tree of the same
    structure whose leaves may be tuples (labels, specs, placements)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], labels[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, t, l) for t, l in zip(tree, labels)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, t, l) for t, l in zip(tree, labels))
    return fn(tree, labels)


def param_specs(cfg, policy, mesh) -> dict:
    """Per-dim mesh axes of every parameter (``policy.param_spec`` made
    safe for its shape), mirroring ``init_params`` (walk it beside a
    parameter tree: its leaves are tuples)."""
    from repro_torch.models.policy import safe_spec

    return _zip_map(lambda t, lab: safe_spec(policy.param_spec(lab), t.shape,
                                             mesh),
                    init_params(cfg, device="meta"), param_labels(cfg))


def param_shardings(cfg, policy, mesh) -> dict:
    """DTensor placements of every parameter on ``mesh`` (a
    ``launch.mesh.Mesh`` or ``{axis: size}``), mirroring ``init_params``:
    the reference's NamedShardings (leaves are tuples of placements)."""
    return _zip_map(lambda t, lab: policy.sharding(mesh, lab, t.shape, param=True),
                    init_params(cfg, device="meta"), param_labels(cfg))


def cache_specs(cfg, batch: int, kv_len: int, policy, mesh) -> list:
    """Per-dim mesh axes of every decode-cache leaf, mirroring
    ``init_caches``."""
    from repro_torch.models.policy import safe_spec

    return _zip_map(lambda t, lab: safe_spec(policy.act_spec(lab), t.shape,
                                             mesh),
                    init_caches(cfg, batch, kv_len, device="meta"),
                    cache_labels(cfg))


def cache_shardings(cfg, batch: int, kv_len: int, policy, mesh) -> list:
    """DTensor placements of every decode-cache leaf, mirroring
    ``init_caches``."""
    return _zip_map(lambda t, lab: policy.sharding(mesh, lab, t.shape),
                    init_caches(cfg, batch, kv_len, device="meta"),
                    cache_labels(cfg))


def place_params(params, cfg, policy, mesh):
    """``params`` on ``mesh``: on more than one rank each leaf becomes a
    DTensor of its ``param_shardings`` placements, each rank keeping its
    blocks of the whole tree it holds (no collective; a leaf that is
    already a DTensor stays as it is); on one rank the tree as it is."""
    if not _placed(mesh):
        return params
    from torch.distributed.tensor import DTensor

    from repro_torch.core.gspmd import distribute

    return _zip_map(lambda t, spec: t if isinstance(t, DTensor)
                    else distribute(t, mesh, spec), params,
                    param_specs(cfg, policy, mesh))


def init_placed_params(cfg, policy, mesh, *, seed: int = 0) -> dict:
    """Seeded parameters on ``mesh`` (``mesh.device``): every rank makes the
    whole tree from the seed — the weights of ``init_params`` — and keeps
    its blocks.  Ranks that share a card take turns, a barrier apart, and
    each keeps its blocks on the host until every turn is done, so the card
    holds one whole tree at a time and no other rank's blocks beside it
    (qwen2-moe: a 30 GB tree whose making peaks near 47 GB, beside 4 x 10
    GB of blocks, would not fit)."""
    if not _placed(mesh):
        return init_params(cfg, seed=seed, device=mesh.device)
    import torch.distributed as dist

    from repro_torch.core.gspmd import nested, wrap_block

    dev = mesh.device
    if not (dev.type == "cuda" and torch.cuda.device_count() < mesh.world_size):
        return place_params(init_params(cfg, seed=seed, device=dev), cfg, policy, mesh)
    held = None
    for r in range(mesh.world_size):
        if r == mesh.rank:
            placed = place_params(init_params(cfg, seed=seed, device=dev), cfg, policy, mesh)
            held = tree_mod.map(lambda t: t.to_local().cpu(), placed)
            del placed
            torch.cuda.empty_cache()
        dist.barrier()
    return _zip_map(lambda t, spec: wrap_block(t.to(dev), mesh, nested(spec, mesh)),
                    held, param_specs(cfg, policy, mesh))


class InputSpec(NamedTuple):
    """A model input's shape, dtype and placements (None: unplaced) — the
    counterpart of the reference's ShapeDtypeStruct."""

    shape: tuple
    dtype: torch.dtype
    placements: tuple | None = None


def input_specs(cfg, shape, *, policy=None, mesh=None) -> dict:
    """``InputSpec`` stand-ins for every model input of a shape cell,
    placed by ``policy`` on ``mesh`` where both are given."""
    def spec(shp, dtype, labels):
        pl = (policy.sharding(mesh, labels, shp)
              if policy is not None and mesh is not None else None)
        return InputSpec(tuple(shp), dtype, pl)

    B, S = shape.batch, shape.seq
    if shape.kind in ("train", "prefill"):
        toks = S - (cfg.prefix_len or 0)
        out = {"tokens": spec((B, toks), torch.int32, "b s"),
               "labels": spec((B, toks), torch.int32, "b s")}
        if cfg.prefix_len:
            out["prefix_embeds"] = spec((B, cfg.prefix_len, cfg.d_model),
                                        dtype_of(cfg), "b s a")
        if shape.kind == "prefill":
            out.pop("labels")
        return out
    return {"tokens": spec((B, 1), torch.int32, "b s"),
            "pos": InputSpec((), torch.int32)}


def _cst(x, labels: str, policy, mesh):
    """The reference's sharding constraint: ``x`` redistributed to the
    policy's placements for ``labels`` on a mesh of more than one rank."""
    if policy is None or not _placed(mesh):
        return x
    from repro_torch.core.gspmd import constrain
    from repro_torch.models.policy import safe_spec

    return constrain(x, mesh, safe_spec(policy.act_spec(labels), x.shape,
                                        mesh))


def _lookup(table, ids, mesh):
    """Token embeddings.  Where the vocab is split across ranks, each rank
    looks its tokens up in its own vocab block (tokens outside it give
    zeros) and the blocks' lookups are summed over the vocab's mesh axes:
    a ``Partial`` sum that the ``"b s a"`` constraint resolves, so the
    table is never gathered.  DTensor's own masked lookup takes the vocab
    split on one mesh axis only."""
    from torch.distributed.tensor import DTensor

    if not isinstance(table, DTensor):
        return embed(table, ids)
    from repro_torch.core import gspmd

    spec = gspmd.spec_of_placements(table.placements, 2, mesh)
    vocab_axes = gspmd.entry_axes(spec[0])
    if not vocab_axes:
        return embed(table, ids)
    block = table.to_local()
    sizes = gspmd.mesh_sizes(mesh)
    j = 0  # this rank's vocab block: the axes split the vocab major to minor
    for a in vocab_axes:
        j = j * sizes[a] + mesh.coord[a]
    ids = gspmd.constrain(ids, mesh, (None,) * ids.ndim).to_local().long()
    rel = ids - j * block.shape[0]
    hit = (rel >= 0) & (rel < block.shape[0])
    out = embed(block, torch.where(hit, rel, 0)).masked_fill(~hit[..., None], 0)
    # one (1, *ids, a) block a rank of a grid split over the vocab's axes;
    # the sum over the grid is the lookup, and its gradient reaches every
    # rank's block with weight one
    grid = gspmd.wrap_block(out.unsqueeze(0), mesh,
                            (spec[0],) + (None,) * ids.ndim + (spec[1],))
    return torch.sum(grid, dim=0)


def _place_tokens(tokens, policy, mesh):
    """Token ids on the mesh (``"b s"``), where they are not yet."""
    from torch.distributed.tensor import DTensor

    if not _placed(mesh) or isinstance(tokens, DTensor):
        return tokens
    from repro_torch.core.gspmd import distribute
    from repro_torch.models.policy import safe_spec

    return distribute(tokens, mesh, safe_spec(policy.act_spec("b s"),
                                              tokens.shape, mesh))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _ffn_or_moe(p: dict, h, cfg, policy=None, mesh=None):
    """The block's FFN: (out, MoE aux loss or None)."""
    if cfg.moe:
        return moe_mod.moe_ffn(p["moe"], h, cfg, policy=policy, mesh=mesh)
    return ffn_mod.ffn(p["ffn"], h, cfg), None


def _placed_state(blk: str, st, policy, mesh):
    """A recurrent block's new state placed as its decode cache is
    (``cache_labels`` without the unit axis)."""
    return type(st)(*(_cst(t, lab, policy, mesh)
                      for t, lab in zip(st, _STATE_LABELS[blk])))


def _hymba_mix(p: dict, a_out, s_out, cfg):
    return 0.5 * (rmsnorm(a_out, p["norm_a"], cfg.norm_eps)
                  + rmsnorm(s_out, p["norm_s"], cfg.norm_eps))


def _block_forward(blk: str, p: dict, x, cfg, policy=None, mesh=None):
    """Full-sequence block.  Returns (x, cache, aux or None); the cache is
    the block's decode state (see the module docstring)."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    aux = None
    if blk == "attn":
        a_out, kv = attn_mod.attention_full(p["attn"], h, cfg, policy=policy,
                                            mesh=mesh)
        cache = (_cst(kv[0], "b s k d", policy, mesh),
                 _cst(kv[1], "b s k d", policy, mesh))
        x = x + _cst(a_out, "b s a", policy, mesh)
        m_out, aux = _ffn_or_moe(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg,
                                 policy, mesh)
        x = x + _cst(m_out, "b s a", policy, mesh)
    elif blk == "hymba":
        a_out, kv = attn_mod.attention_full(p["attn"], h, cfg, policy=policy,
                                            mesh=mesh)
        kv = (_cst(kv[0], "b s k d", policy, mesh),
              _cst(kv[1], "b s k d", policy, mesh))
        s_out, st = ssm_mod.ssm_forward(p["ssm"], h, cfg, policy=policy,
                                        mesh=mesh)
        a_out = _cst(a_out, "b s a", policy, mesh)
        s_out = _cst(s_out, "b s a", policy, mesh)
        x = x + _cst(_hymba_mix(p, a_out, s_out, cfg), "b s a", policy, mesh)
        f_out = ffn_mod.ffn(p["ffn"], rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
        x = x + _cst(f_out, "b s a", policy, mesh)
        cache = (kv, _placed_state(blk, st, policy, mesh))
    elif blk in ("mlstm", "slstm"):
        fwd = (xlstm_mod.mlstm_forward if blk == "mlstm"
               else xlstm_mod.slstm_forward)
        out, st = fwd(p[blk], h, cfg, policy=policy, mesh=mesh)
        x = x + _cst(out, "b s a", policy, mesh)
        cache = _placed_state(blk, st, policy, mesh)
    else:
        raise ValueError(blk)
    return x, cache, aux


#: what ``remat="dots"`` keeps: the outputs of matrix products (the
#: reference's ``jax.checkpoint_policies.dots_saveable``)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _rematerialized(unit, remat):
    """``unit`` under the remat policy: ``False`` runs it as it is; ``True``
    saves only its inputs and recomputes the rest in the backward
    (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``jax.checkpoint``); ``"dots"`` keeps the matrix products' outputs and
    recomputes everything else (selective checkpointing).  Outside grad
    mode there is no backward, and the unit runs as it is."""
    if not remat or not torch.is_grad_enabled():
        return unit
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    if remat == "dots":
        kw = {"context_fn": lambda: create_selective_checkpoint_contexts(_save_dots)}
    elif remat is True:
        kw = {}
    else:
        raise ValueError(f"remat must be True, False or 'dots', got {remat!r}")
    # no unit draws random numbers, so there is no RNG state to stash; and
    # reading the card's generator is illegal under a CUDA graph's capture
    return lambda x, u: checkpoint(unit, x, u, use_reentrant=False,
                                   preserve_rng_state=False, **kw)


def _embed_tokens(params, tokens, prefix_embeds, cfg, policy=None,
                  mesh=None):
    """Token embeddings in the model's dtype, the prefix embeddings (cast
    to it) before them where the config has a prefix and they are given."""
    x = _lookup(params["embed"], _place_tokens(tokens, policy, mesh),
                mesh).to(dtype_of(cfg))
    if cfg.prefix_len and prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(device=x.device, dtype=x.dtype), x], dim=1)
    return _cst(x, "b s a", policy, mesh)


def forward(params, tokens, cfg, *, prefix_embeds=None, policy=None,
            mesh=None, collect_cache: bool = False,
            last_logit_only: bool = False, logit_index=None, remat=False):
    """Full-sequence forward.  Returns (logits, caches, aux_loss), the
    aux loss summed over the MoE layers (0 without MoE).

    ``prefix_embeds`` (b, prefix_len, d_model), where the config has a
    prefix, go before the token embeddings; the logits then cover the
    prefix positions too.  ``caches`` (with ``collect_cache``) holds, per
    pattern position, the blocks' decode states with every leaf stacked
    over units: (k, v) of (units, b, s, kv_heads, hd) for attn, ((k, v),
    SSMState) for hymba, MLSTMState or SLSTMState.
    ``last_logit_only`` computes the LM head for the final position only
    (prefill serving never needs the (b, s, v) logits); ``logit_index``
    (an int, or a 0-d integer tensor on the device: the reference's traced
    scalar) generalizes it to any single position — the serving tier's
    bucketed prefill pads the prompt to the bucket length and takes the
    logit at the last real token, and a captured prefill reads it from a
    fixed buffer.  ``remat`` is the
    reference's: ``True`` recomputes each unit (one pattern period) in the
    backward from its input, ``"dots"`` keeps the unit's matrix products
    and recomputes the rest, ``False`` (the default, what serving runs)
    keeps every activation.

    ``policy`` and ``mesh`` (a ``launch.mesh.Mesh``): on a mesh of more
    than one rank the parameters are DTensors (``place_params``), the
    tokens are placed on ``"b s"`` where they are not yet, and the
    activations are constrained at the reference's points; the logits and
    caches come back as DTensors."""
    _check_supported(cfg)
    x = _embed_tokens(params, tokens, prefix_embeds, cfg, policy, mesh)
    pattern = cfg.block_pattern
    per_pos: list[list] = [[] for _ in pattern]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def unit(x, u):
        caches, auxs = [], []
        for ppos, blk in enumerate(pattern):
            x, cache, a = _block_forward(blk, _unit(params["layers"][ppos], u),
                                         x, cfg, policy, mesh)
            caches.append(cache)
            if a is not None:
                auxs.append(a)
        return x, caches, auxs

    body = _rematerialized(unit, remat)
    for u in range(_n_units(cfg)):
        x, caches, auxs = body(x, u)
        for a in auxs:
            aux = aux + a
        if collect_cache:
            for ppos, cache in enumerate(caches):
                per_pos[ppos].append(cache)
    caches = [_stack(cs) for cs in per_pos] if collect_cache else 0
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_logit_only:
        x = x[:, -1:]
    elif logit_index is not None:
        x = _at_position(x, logit_index)
    logits = _cst(lm_logits(x, _head(params)), "b s v", policy, mesh)
    return logits, caches, aux


def _at_position(x, index):
    """``x[:, index:index + 1]`` (the reference's ``dynamic_slice_in_dim``):
    a 0-d tensor ``index`` is read on the device (``index_select``, no
    host sync), an int by ``narrow``.  On DTensors the index is read on
    the host: a mesh runs eagerly."""
    from torch.distributed.tensor import DTensor

    if isinstance(index, torch.Tensor) and not isinstance(x, DTensor):
        return x.index_select(1, index.reshape(1).to(device=x.device, dtype=torch.long))
    return x.narrow(1, int(index), 1)


def loss_fn(params, batch, cfg, *, policy=None, mesh=None, remat=None):
    """Training loss: mean next-token cross-entropy plus 0.01 x the MoE aux
    loss, over the token positions only (the prefix positions of
    ``batch["prefix_embeds"]``, where the config has a prefix, predict
    nothing).  Returns ``(loss, {"ce", "aux"})``.  ``remat`` defaults as in
    the reference: the policy's, else True.  On a mesh of more than one
    rank the loss is a replicated DTensor."""
    from repro_torch.core.gspmd import replicate_like

    if remat is None:
        remat = policy.remat if policy is not None else True
    logits, _, aux = forward(params, batch["tokens"], cfg,
                             prefix_embeds=batch.get("prefix_embeds"),
                             policy=policy, mesh=mesh, remat=remat)
    if cfg.prefix_len:
        logits = logits[:, cfg.prefix_len:]
    labels = _place_tokens(batch["labels"], policy, mesh)
    ce = softmax_xent(logits[:, :-1], labels[:, 1:], cfg.vocab, mesh=mesh)
    aux = replicate_like(aux, ce)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _stacked_caches(cfg, one) -> list:
    """Per pattern position, ``one(blk)`` repeated over units: every leaf
    gets a leading unit axis, allocated once."""
    units = _n_units(cfg)

    def rep(t):
        return t.unsqueeze(0).expand(units, *t.shape).contiguous()

    return [tree_mod.map(rep, one(blk)) for blk in cfg.block_pattern]


def _recurrent_state(cfg, blk: str, batch: int, device):
    if blk == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, device=device)
    if blk == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device=device)
    raise ValueError(blk)


def init_caches(cfg, batch: int, kv_len: int, *, device=None):
    """Per-pattern-position stacked (units, ...) decode caches on
    ``device`` (default: the card), allocated once and written in place by
    ``decode_step``: (units, b, kv_len, kv_heads, hd) KV buffers, and the
    recurrent states of the hymba, mlstm and slstm blocks."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)

    def one(blk):
        if blk == "attn":
            return attn_mod.init_kv_cache(cfg, batch, kv_len, dt, device)
        if blk == "hymba":
            return (attn_mod.init_kv_cache(cfg, batch, kv_len, dt, device),
                    ssm_mod.init_ssm_state(cfg, batch, dt, device))
        return _recurrent_state(cfg, blk, batch, device)

    return _stacked_caches(cfg, one)


def _block_decode(blk: str, p: dict, x, cache, cfg, attend, policy=None,
                  mesh=None):
    """One decode step of one block.  ``attend(p_attn, h, kv)`` is the
    attention call (dense or paged), which writes its K/V in place; the
    recurrent state is copied into ``cache`` in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if blk == "attn":
        x = x + attend(p["attn"], h, cache)
        m_out, _ = _ffn_or_moe(p, rmsnorm(x, p["norm2"], cfg.norm_eps), cfg,
                               policy, mesh)
        return x + m_out
    if blk == "hymba":
        kv, st = cache
        a_out = attend(p["attn"], h, kv)
        s_out, st2 = ssm_mod.ssm_decode(p["ssm"], h, st, cfg, policy=policy,
                                        mesh=mesh)
        _write_state(st, st2)
        a_out = _cst(a_out, "b s a", policy, mesh)
        s_out = _cst(s_out, "b s a", policy, mesh)
        x = x + _hymba_mix(p, a_out, s_out, cfg)
        return x + ffn_mod.ffn(p["ffn"], rmsnorm(x, p["norm2"], cfg.norm_eps), cfg)
    if blk == "mlstm":
        out, st2 = xlstm_mod.mlstm_decode(p["mlstm"], h, cache, cfg,
                                          policy=policy, mesh=mesh)
    elif blk == "slstm":
        out, st2 = xlstm_mod.slstm_decode(p["slstm"], h, cache, cfg,
                                          policy=policy, mesh=mesh)
    else:
        raise ValueError(blk)
    _write_state(cache, st2)
    return x + out


def _decode_layers(params, tokens, caches, cfg, attend, policy=None,
                   mesh=None):
    x = _embed_tokens(params, tokens, None, cfg, policy, mesh)
    pattern = cfg.block_pattern
    for u in range(_n_units(cfg)):
        for ppos, blk in enumerate(pattern):
            x = _block_decode(blk, _unit(params["layers"][ppos], u), x,
                              _unit(caches[ppos], u), cfg, attend, policy,
                              mesh)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _cst(lm_logits(x, _head(params)), "b s v", policy, mesh)


def decode_step(params, tokens, caches, pos, cfg, *, policy=None,
                mesh=None):
    """One token for the whole batch.  tokens (b, 1); pos the absolute
    position, a 0-d integer tensor on the device (the reference's traced
    scalar) or an int.  Writes this step's K/V and recurrent states into
    ``caches`` in place and returns (logits (b, 1, v), caches).  No value
    of a tensor ``pos`` reaches the host on one rank, so the step can be
    captured once and replayed (``launch.steps.GraphedStep``).  On a mesh
    of more than one rank the parameters and caches are DTensors
    (``place_caches``), each rank writes its cache blocks, and the logits
    come back as a DTensor."""
    pos = attn_mod.as_position(pos, tokens.device)  # once a step, not once a layer

    def attend(p, h, kv):
        return attn_mod.attention_decode(p, h, kv, pos, cfg, mesh=mesh)[0]

    return _decode_layers(params, tokens, caches, cfg, attend, policy,
                          mesh), caches


def place_caches(caches, cfg, batch: int, kv_len: int, policy, mesh):
    """Decode caches (whole on every rank) on ``mesh``: each leaf becomes a
    DTensor of its ``cache_shardings`` placements; one rank: unchanged."""
    if not _placed(mesh):
        return caches
    from repro_torch.core.gspmd import distribute

    return _zip_map(lambda t, spec: distribute(t, mesh, spec), caches,
                    cache_specs(cfg, batch, kv_len, policy, mesh))


# ---------------------------------------------------------------------------
# Paged decode (the serving tier): block-pool KV caches + per-slot positions
# ---------------------------------------------------------------------------


def init_paged_caches(cfg, batch: int, n_blocks: int, block: int, *,
                      device=None):
    """Per-pattern-position stacked (units, ...) paged caches on ``device``
    (default: the card), written in place by ``decode_step_paged``:
    (units, n_blocks, block, kv_heads, hd) KV pools shared by all batch
    slots through block tables, and per-slot recurrent states (``batch``
    sizes only those)."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)

    def one(blk):
        if blk == "attn":
            return attn_mod.init_paged_kv_cache(cfg, n_blocks, block, dt, device)
        if blk == "hymba":
            return (attn_mod.init_paged_kv_cache(cfg, n_blocks, block, dt, device),
                    ssm_mod.init_ssm_state(cfg, batch, dt, device))
        return _recurrent_state(cfg, blk, batch, device)

    return _stacked_caches(cfg, one)


#: labels of a paged pool leaf (units, n_blocks, block, kv_heads, hd):
#: ``-`` is a label no policy assigns, so the block and row dims are never
#: split — any slot may own any block (``serving.BlockAllocator``)
PAGED_POOL_LABELS = "L - - k d"


def paged_cache_labels(cfg) -> list:
    """Label strings mirroring ``init_paged_caches``' structure: the pools
    ``PAGED_POOL_LABELS``, the per-slot recurrent states as
    ``cache_labels`` gives them."""
    pool = attn_mod.PagedKVCache(PAGED_POOL_LABELS, PAGED_POOL_LABELS)

    def one(blk, dense):
        if blk == "attn":
            return pool
        return (pool, dense[1]) if blk == "hymba" else dense

    return [one(blk, dense) for blk, dense in zip(cfg.block_pattern,
                                                  cache_labels(cfg))]


def paged_cache_specs(cfg, batch: int, n_blocks: int, block: int, policy,
                      mesh) -> list:
    """Per-dim mesh axes of every paged-cache leaf, mirroring
    ``init_paged_caches``: a pool's kv-head dim split as the policy splits
    ``k`` (its head dim as it splits ``d``), made safe for the shape as
    ``cache_specs`` does, its other dims whole; the states as
    ``cache_specs`` places them."""
    from repro_torch.models.policy import safe_spec

    return _zip_map(lambda t, lab: safe_spec(policy.act_spec(lab), t.shape,
                                             mesh),
                    init_paged_caches(cfg, batch, n_blocks, block,
                                      device="meta"),
                    paged_cache_labels(cfg))


def place_paged_caches(caches, cfg, batch: int, n_blocks: int, block: int,
                       policy, mesh):
    """Paged caches (whole on every rank) on ``mesh``: each leaf becomes a
    DTensor of its ``paged_cache_specs`` placements, each rank keeping its
    block; one rank: unchanged."""
    if not _placed(mesh):
        return caches
    from repro_torch.core.gspmd import distribute

    return _zip_map(lambda t, spec: distribute(t, mesh, spec), caches,
                    paged_cache_specs(cfg, batch, n_blocks, block, policy,
                                      mesh))


def decode_step_paged(params, tokens, caches, tables, pos, cfg, *,
                      policy=None, mesh=None):
    """One continuous-batching decode step.  tokens (b, 1); tables (b, W)
    int block tables; pos (b,) int per-slot positions.  Writes this step's
    K/V into the pools of ``caches`` and every slot's recurrent state in
    place, and returns (logits (b, 1, v), caches).  Idle slots point their
    table rows at the scratch block 0 with pos 0, so their writes land
    there; their recurrent rows run on and are overwritten at admission.

    On a mesh of more than one rank (``policy`` and ``mesh`` given) the
    parameters and caches are DTensors (``place_params``,
    ``place_paged_caches``), the tokens, tables and positions whole on
    every rank; the embeddings are constrained as ``"b s a"`` and the
    logits as ``"b s v"`` (a DTensor), as in the reference; attention runs
    on each rank's (batch block x kv-head block), every rank writing every
    slot's K/V row into its head block of the pool
    (``attention_decode_paged``); the MoE FFN and the recurrent blocks run
    as in ``decode_step``."""
    tables, pos = tables.long(), pos.long()  # once a step, not once a layer

    def attend(p, h, pool):
        return attn_mod.attention_decode_paged(p, h, pool, tables, pos, cfg,
                                               policy=policy, mesh=mesh)[0]

    return _decode_layers(params, tokens, caches, cfg, attend, policy,
                          mesh), caches
