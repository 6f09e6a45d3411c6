"""The serving engine's paged decode on a mesh of gloo CPU ranks, against
the one-rank port engine and the reference's engine.

Reduced llama-7b, qwen2-moe-a2.7b, hymba-1.5b and xlstm-125m in float32,
with the reference's seeded weights (``from_reference_params``), on
``{data: 2}``, ``{model: 2}``, ``{data: 2, model: 2}`` and ``(1, 4)`` —
one spawn per mesh (``launch.mesh.spawn``, ``file://`` rendezvous under a
pytest tmp path), every case on every rank, all spawns started at once.

* ``ServingEngine(mesh=)``: 3 requests through 2 slots (one queues and is
  admitted into the slot the first to finish leaves): the generations
  equal the one-rank port engine's and the reference engine's token for
  token (the reference's decode step wrapped in ``jax.block_until_ready``,
  as ``tests/test_torch_serving.py`` does); the first decode step's logits
  within 1e-5 x max|logit| of the one rank's (float32: the products of
  split blocks and the partial sums add in other orders); after the run,
  the pools' local blocks equal on every rank that holds the same head
  block; ``BucketRegistry.analyze()`` on the mesh equal to the reference's
  registry on those axes, bucket by bucket.
* Split coverage: the cells' own decode plans split ``k`` (every pool is
  split by head) and, for xlstm, ``b``; no attention cell's plan splits the
  batch apart from the kv heads, so ``decode_step_paged`` and admission
  also run under the manual policy ``{b: data, k: model}`` on (2, 2)
  (llama and hymba): two prompts admitted (slot 1 first, its rows of
  hymba's SSM state on the ranks of the second data block), then 3 decode
  steps — every step's logits within 1e-5 x max|logit| of one rank's, the
  pools equal across the two ranks of each head block and within 1e-5 of
  one rank's pools, every state leaf within 1e-5 of one rank's.
* The head dim split (``{d: model}`` on ``{model: 2}``): reduced llama's
  dense decode (prefill of two 9-token prompts, then 3 steps of
  ``decode_step`` fed fixed tokens) within 1e-5 x max|logit| of one
  rank's and of the reference's ``decode_step``, every step; the same
  with the cache time split too (``{d: model, t: data}`` on (2, 2));
  admission and 3 ``decode_step_paged`` steps (``paged_case``) within
  1e-5 of one rank's, each rank's ``d`` block of every pool within 1e-5
  of the same block of one rank's pools.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.serve import prepare_decode_caches as ref_prepare  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import BucketRegistry as RefBucketRegistry  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.gspmd import full  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCHS = ("llama-7b", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m")
ATTN = ARCHS[:3]
MESHES = {"data2": {"data": 2}, "model2": {"model": 2},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}}
LENS, NEW = (5, 9, 12), (4, 6, 3)
SLOTS, MAX_SEQ, BLOCK = 2, 24, 8
MANUAL = {"b": "data", "k": "model"}
TOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def _ref_cfg(arch):
    return dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype="float32")


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in LENS]


def _head_block(t, mesh) -> tuple:
    """This rank's block coordinates of DTensor ``t`` (its index along each
    split dim), or () for a plain tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import gspmd

    if not isinstance(t, DTensor):
        return ()
    spec = gspmd.spec_of_placements(t.placements, t.ndim, mesh)
    return tuple(mesh.linear_index(gspmd.entry_axes(e)) for e in spec)


def _pools(caches, mesh) -> list:
    """Every pool leaf of ``caches``: (its block coordinates, its local
    block as numpy)."""
    from repro_torch.models.attention import PagedKVCache

    out = []
    for c in caches:
        pool = c if isinstance(c, PagedKVCache) else (c[0] if isinstance(c, tuple)
                                                       and isinstance(c[0], PagedKVCache)
                                                       else None)
        if pool is None:
            continue
        for t in pool:
            local = t.to_local() if hasattr(t, "to_local") else t
            out.append((_head_block(t, mesh), local.detach().numpy().copy()))
    return out


def _splits(policy, label, sizes) -> bool:
    return any(sizes.get(a, 1) > 1 for a in policy.label_axes.get(label, ()))


# ---------------------------------------------------------------------------
# what every rank (and the one rank) computes
# ---------------------------------------------------------------------------


def engine_case(arch, params_np, mesh) -> dict:
    """The engine on ``mesh`` (None: one rank): generations, the first
    decode step's whole logits, the slots admitted into, the pools' blocks
    after the run, the decode policy and the registry's reports."""
    from repro_torch.serving import ServingEngine

    cfg = _cfg(arch)
    params = tf.from_reference_params(cfg, params_np, device="cpu")
    eng = ServingEngine(cfg, batch=SLOTS, max_seq=MAX_SEQ, block=BLOCK, params=params,
                        mesh=mesh, device="cpu")
    logits, slots = [], []
    decode, admit = tf.decode_step_paged, eng._admit

    def recorded(*a, **kw):  # the registry's decode step, read through
        out, caches = decode(*a, **kw)
        logits.append(full(out)[:, -1].detach().numpy().copy())
        return out, caches

    def admit_logged(caches, pre, blocks, slot, tok0, tokens):
        slots.append(int(slot))  # a 0-d tensor: the bucket step's fixed buffer
        return admit(caches, pre, blocks, slot, tok0, tokens)

    eng._admit = admit_logged
    tf.decode_step_paged = recorded
    try:
        for p, n in zip(_prompts(cfg), NEW):
            eng.submit(p, n)
        gen, metrics = eng.run()
    finally:
        tf.decode_step_paged = decode
    return {"gen": gen, "logits0": logits[0], "slots": slots, "pools": _pools(eng.caches, mesh),
            "policy": dict(eng.policy.label_axes), "steps": metrics.decode_steps,
            "analysis": {k: r.to_json() for k, r in eng.registry.analyze().items()}}


TABLES = np.array([[1, 2, 0], [3, 4, 0]], np.int32)   # slot 0: blocks 1, 2; slot 1: 3, 4
PAGED_LENS = (6, 11)


def paged_case(arch, params_np, policy, mesh) -> dict:
    """Admission and 3 ``decode_step_paged`` steps under ``policy`` on
    ``mesh`` (None: one rank, no policy): slot 1's prompt admitted first,
    then slot 0's, each prefilled under the same policy; every step's whole
    logits, the pools' blocks and every state leaf whole at the end."""
    from repro_torch.serving.paged_kv import make_admit_fn

    cfg = _cfg(arch)
    placed = mesh is not None
    params = tf.place_params(tf.from_reference_params(cfg, params_np, device="cpu"),
                             cfg, policy, mesh)
    n_blocks = 6
    caches = tf.init_paged_caches(cfg, SLOTS, n_blocks, BLOCK, device="cpu")
    rng = np.random.default_rng(5)
    for leaf in tree.leaves(caches):  # rows nobody wrote: seeded, equal everywhere
        leaf.copy_(torch.from_numpy(rng.normal(size=tuple(leaf.shape)).astype(np.float32)))
    caches = tf.place_paged_caches(caches, cfg, SLOTS, n_blocks, BLOCK, policy, mesh)
    admit = make_admit_fn(cfg)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.int32)
    pos = np.zeros((SLOTS,), np.int32)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, max(PAGED_LENS)))
    out = {"logits": []}
    with torch.no_grad():
        for slot in (1, 0):
            n = PAGED_LENS[slot]
            toks = torch.as_tensor(prompts[slot:slot + 1, :n].astype(np.int32))
            logits, pre, _ = tf.forward(params, toks, cfg, policy=policy, mesh=mesh,
                                        collect_cache=True, last_logit_only=True)
            tok0 = torch.argmax(full(logits)[:, -1], dim=-1).to(torch.int32)
            caches, tokens = admit(caches, pre, torch.from_numpy(TABLES[slot]), slot, tok0,
                                   tokens)
            pos[slot] = n
        for _ in range(3):
            logits, caches = tf.decode_step_paged(
                params, tokens, caches, torch.from_numpy(TABLES), torch.from_numpy(pos), cfg,
                policy=policy, mesh=mesh)
            whole = full(logits)[:, -1]
            out["logits"].append(whole.numpy().copy())
            tokens = torch.argmax(whole, dim=-1)[:, None].to(torch.int32)
            pos += 1
    out["pools"] = _pools(caches, mesh if placed else None)
    out["states"] = [full(t).numpy().copy() for t in tree.leaves(caches)
                     if t.shape[1] == SLOTS]
    return out


DENSE_LEN, DENSE_STEPS, DENSE_KV = 9, 3, 16
D_SPLIT = {"d": "model"}
DT_SPLIT = {"d": "model", "t": "data"}


def _dense_tokens(cfg):
    rng = np.random.default_rng(8)
    return (rng.integers(0, cfg.vocab, size=(2, DENSE_LEN)).astype(np.int32),
            rng.integers(0, cfg.vocab, size=(DENSE_STEPS, 2, 1)).astype(np.int32))


def dense_case(arch, params_np, policy, mesh) -> dict:
    """Prefill of two prompts and ``DENSE_STEPS`` dense decode steps
    (``decode_step``, fed fixed tokens) under ``policy`` on ``mesh`` (None:
    one rank): the prefill's and every step's whole logits, and the
    cache's spec."""
    from repro_torch.core import gspmd
    from repro_torch.launch import steps
    from repro_torch.launch.serve import prepare_decode_caches

    cfg = _cfg(arch)
    params = tf.place_params(tf.from_reference_params(cfg, params_np, device="cpu"),
                             cfg, policy, mesh)
    prompts, fed = _dense_tokens(cfg)
    with torch.no_grad():
        logits, caches = steps.make_prefill_step(cfg, policy=policy, mesh=mesh)(
            params, {"tokens": torch.as_tensor(prompts)})
        out = {"logits": [full(logits)[:, -1].numpy().copy()]}
        caches = prepare_decode_caches(cfg, caches, DENSE_LEN, DENSE_KV, policy=policy,
                                       mesh=mesh)
        k = caches[0].k
        out["cache_spec"] = (gspmd.spec_of_placements(k.placements, k.ndim, mesh)
                             if mesh is not None else None)
        for i in range(DENSE_STEPS):
            logits, caches = tf.decode_step(params, torch.as_tensor(fed[i]), caches,
                                            DENSE_LEN + i, cfg, policy=policy, mesh=mesh)
            out["logits"].append(full(logits)[:, -1].numpy().copy())
    return out


def rank_battery(rank, world, mesh_id, weights):
    from repro_torch.models.policy import manual_policy

    mesh = Mesh(MESHES[mesh_id], device="cpu")
    res = {"engine": {a: engine_case(a, weights[a], mesh) for a in ARCHS}}
    if mesh_id == "2x2":
        res["paged"] = {a: paged_case(a, weights[a], manual_policy(MANUAL), mesh)
                        for a in ("llama-7b", "hymba-1.5b")}
        res["dense_dt"] = dense_case("llama-7b", weights["llama-7b"],
                                     manual_policy(DT_SPLIT), mesh)
    if mesh_id == "model2":
        llama = weights["llama-7b"]
        res["dense_d"] = dense_case("llama-7b", llama, manual_policy(D_SPLIT), mesh)
        res["paged_d"] = paged_case("llama-7b", llama, manual_policy(D_SPLIT), mesh)
    return res


# ---------------------------------------------------------------------------
# fixtures: the reference, one rank, the meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    return {a: jax.tree.map(np.asarray, ref_tf.init_params(_ref_cfg(a), jax.random.PRNGKey(i)))
            for i, a in enumerate(ARCHS)}


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Every mesh's spawn, all started at once (threads waiting on their
    ranks) before the one-rank and reference cases run here."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(MESHES))
    runs = {m: pool.submit(spawn, math.prod(sizes.values()), rank_battery, m, weights,
                           timeout=600, tmpdir=tmp_path_factory.mktemp(f"engine{m}"))
            for m, sizes in MESHES.items()}
    yield lambda mesh_id: runs[mesh_id].result()
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_rank(weights, ranks):
    return {"engine": {a: engine_case(a, weights[a], None) for a in ARCHS},
            "paged": {a: paged_case(a, weights[a], None, None)
                      for a in ("llama-7b", "hymba-1.5b")},
            "dense": dense_case("llama-7b", weights["llama-7b"], None, None)}


@pytest.fixture(scope="module")
def reference_dense(weights):
    """``dense_case`` through the reference: its prefill step, decode
    caches and ``decode_step`` on the same weights and tokens."""
    cfg = _ref_cfg("llama-7b")
    params = jax.tree.map(jnp.asarray, weights["llama-7b"])
    prompts, fed = _dense_tokens(cfg)
    logits, caches = ref_steps.make_prefill_step(cfg)(params, {"tokens": jnp.asarray(prompts)})
    out = [np.asarray(logits)[:, -1]]
    caches = ref_prepare(cfg, caches, DENSE_LEN, DENSE_KV)
    for i in range(DENSE_STEPS):
        logits, caches = ref_tf.decode_step(params, jnp.asarray(fed[i]), caches,
                                            jnp.int32(DENSE_LEN + i), cfg)
        out.append(np.asarray(logits)[:, -1])
    return out


@pytest.fixture(scope="module")
def reference(weights, ranks):
    """The reference's engine on the same weights and requests."""
    out = {}
    for arch in ARCHS:
        eng = RefServingEngine(_ref_cfg(arch), batch=SLOTS, max_seq=MAX_SEQ, block=BLOCK,
                               params=jax.tree.map(jax.numpy.asarray, weights[arch]))
        decode = eng._decode
        eng._decode = lambda *a, decode=decode: jax.block_until_ready(decode(*a))
        for p, n in zip(_prompts(_cfg(arch)), NEW):
            eng.submit(p, n)
        out[arch] = eng.run()[0]
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_engine_equals_reference_engine(arch, one_rank, reference):
    got = one_rank["engine"][arch]["gen"]
    assert sorted(got) == sorted(reference[arch]) == [0, 1, 2]
    for rid, want in reference[arch].items():
        np.testing.assert_array_equal(got[rid], np.asarray(want), err_msg=f"{arch} rid {rid}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_mesh_engine_equals_one_rank_and_reference(mesh_id, arch, one_rank, reference, ranks):
    one = one_rank["engine"][arch]
    for rank, res in enumerate(ranks(mesh_id)):
        got, what = res["engine"][arch], f"{mesh_id} rank {rank} {arch}"
        assert sorted(got["gen"]) == [0, 1, 2], what
        for rid, want in reference[arch].items():
            np.testing.assert_array_equal(got["gen"][rid], one["gen"][rid], err_msg=what)
            np.testing.assert_array_equal(got["gen"][rid], np.asarray(want), err_msg=what)
        _close(got["logits0"], one["logits0"], what + " first decode step")
        # the same scheduler on every rank: the same slots, the same steps
        assert got["slots"] == one["slots"] == [0, 1, 0] and got["steps"] == one["steps"], what


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_pools_agree_on_every_rank_of_a_head_block(mesh_id, ranks):
    """After the run, the ranks that hold one head block of a pool hold it
    bit for bit alike (each wrote every slot's rows); the pools are split
    by head on every mesh of the attention cells."""
    res = ranks(mesh_id)
    for arch in ATTN:
        n_leaves = len(res[0]["engine"][arch]["pools"])
        assert n_leaves > 0
        for i in range(n_leaves):
            by_block: dict = {}
            for rank, r in enumerate(res):
                coord, block = r["engine"][arch]["pools"][i]
                by_block.setdefault(coord, []).append((rank, block))
            assert len(by_block) > 1, (mesh_id, arch, "the pool is not split")
            for coord, blocks in by_block.items():
                for rank, block in blocks[1:]:
                    np.testing.assert_array_equal(block, blocks[0][1],
                                                  err_msg=f"{mesh_id} {arch} {coord} {rank}")


def test_decode_plans_split_the_pools_by_head_and_the_states_by_batch(ranks):
    """Which of ``b`` and ``k`` each cell's decode plan splits: ``k`` in
    every attention cell (so every engine above ran the head-split pool),
    ``b`` for xlstm on the meshes with a data or model axis of two (its
    states' rows on the ranks that own them: admission into slot 1 wrote
    only on those).  No attention cell splits the batch apart from the kv
    heads, hence the manual-policy cases below."""
    for mesh_id, sizes in MESHES.items():
        for arch in ARCHS:
            pol = types.SimpleNamespace(label_axes=ranks(mesh_id)[0]["engine"][arch]["policy"])
            if arch in ATTN:
                assert _splits(pol, "k", sizes), (mesh_id, arch, pol.label_axes)
                heads = set(pol.label_axes.get("k", ()))
                assert not [a for a in pol.label_axes.get("b", ())
                            if sizes[a] > 1 and a not in heads], (mesh_id, arch)
            elif mesh_id != "1x4":
                assert _splits(pol, "b", sizes), (mesh_id, arch, pol.label_axes)


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_registry_analyze_on_the_mesh_equals_reference(mesh_id, ranks):
    """``BucketRegistry.analyze()`` of each engine's registry on the mesh:
    every bucket's report (findings, per-device peak) equals the
    reference's registry's on the same axes and buckets."""
    import json

    sizes = MESHES[mesh_id]
    ref_mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                     devices=np.empty(tuple(sizes.values())))
    for arch in ARCHS:
        ref_reg = RefBucketRegistry(_ref_cfg(arch), ref_mesh)
        for n in LENS:
            ref_reg.prefill(n)
        ref_reg.decode(MAX_SEQ, SLOTS, BLOCK)
        want = {k: r.to_json() for k, r in ref_reg.analyze().items()}
        got = ranks(mesh_id)[0]["engine"][arch]["analysis"]
        assert list(got) == list(want) and len(got) >= 2, (mesh_id, arch)
        for key, rep in got.items():
            text = json.dumps(rep, sort_keys=True).replace("src/repro_torch/", "src/repro/")
            assert json.loads(text) == want[key], (mesh_id, arch, key)
            assert rep["memory"]["peak_bytes"] > 0


@pytest.mark.parametrize("arch", ["llama-7b", "hymba-1.5b"])
def test_paged_decode_with_the_batch_split_equals_one_rank(arch, one_rank, ranks):
    one = one_rank["paged"][arch]
    res = ranks("2x2")
    for rank, r in enumerate(res):
        got, what = r["paged"][arch], f"rank {rank} {arch} {MANUAL}"
        for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
            _close(g, w, f"{what} step {i}")
        for i, (g, w) in enumerate(zip(got["states"], one["states"])):
            _close(g, w, f"{what} state leaf {i}")
        assert len(got["states"]) == (2 if arch == "hymba-1.5b" else 0)
        # each rank's head block of every pool, against the same block of one rank's
        for (coord, block), (_, whole) in zip(got["pools"], one["pools"]):
            assert len(coord) == 5 and coord[:3] == (0, 0, 0) and coord[4] == 0, coord
            kh = block.shape[3]                 # (units, blocks, rows, kv heads, hd)
            want = whole[:, :, :, coord[3] * kh:(coord[3] + 1) * kh]
            _close(block[:, 1:], want[:, 1:], f"{what} pool (scratch block 0 aside)")
    for i in range(len(res[0]["paged"][arch]["pools"])):
        coords = {}
        for r in res:
            coord, block = r["paged"][arch]["pools"][i]
            coords.setdefault(coord, []).append(block)
        assert len(coords) == 2 and all(len(b) == 2 for b in coords.values())
        for blocks in coords.values():  # the two data ranks of a head block
            np.testing.assert_array_equal(blocks[0], blocks[1])


@pytest.mark.parametrize("case", ["dense_d", "dense_dt"])
def test_decode_with_the_head_dim_split_equals_one_rank_and_reference(
        case, one_rank, reference_dense, ranks):
    """The dense decode with a cache split along its head dim (each rank's
    partial scores summed across ``d``'s axes), and with its time dim split
    too (the softmax partials combined across ``t``'s)."""
    one = one_rank["dense"]["logits"]
    for rank, r in enumerate(ranks("model2" if case == "dense_d" else "2x2")):
        got = r[case]
        b, t, k, d = got["cache_spec"][1:]  # (L, b, t, k, d)
        assert d == "model" and k is None and b is None, got["cache_spec"]
        assert t == ("data" if case == "dense_dt" else None), got["cache_spec"]
        assert len(got["logits"]) == DENSE_STEPS + 1
        for i, (g, w, ref) in enumerate(zip(got["logits"], one, reference_dense)):
            _close(g, w, f"{case} rank {rank} step {i} vs one rank")
            _close(g, ref, f"{case} rank {rank} step {i} vs the reference")


def test_paged_decode_with_the_head_dim_split_equals_one_rank(one_rank, ranks):
    one = one_rank["paged"]["llama-7b"]
    for rank, r in enumerate(ranks("model2")):
        got, what = r["paged_d"], f"rank {rank} {D_SPLIT}"
        assert len(got["logits"]) == 3
        for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
            _close(g, w, f"{what} step {i}")
        # each rank's head-dim block of every pool, against one rank's
        for (coord, block), (_, whole) in zip(got["pools"], one["pools"]):
            assert coord == (0, 0, 0, 0, rank), coord
            kd = block.shape[4]                 # (units, blocks, rows, kv heads, hd)
            want = whole[..., rank * kd:(rank + 1) * kd]
            _close(block[:, 1:], want[:, 1:], f"{what} pool (scratch block 0 aside)")
