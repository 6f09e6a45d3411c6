"""The gspmd executor on DTensor, and llama trained and served on a mesh,
on gloo CPU ranks.

One spawn per mesh (``launch.mesh.spawn``, ``file://`` rendezvous under a
pytest tmp path) runs every case on every rank and hands back what each
rank computed:

1. **The executor.**  ``Program.compile(mesh=<Mesh>, executor="gspmd")`` on
   meshes (2, 2) and (1, 4) of 4 ranks and (2, 4) of 8, for the FFNN of
   the paper's Experiment 2, reduced llama's prefill graph (flash node
   included) and a wider llama (d 128, f 688, v 1024) whose (2, 2) plan
   keeps llama-7b's: ``f`` and ``v`` on ("data", "model").  Every rank's
   outputs equal the port's dense run, the ``shard_map`` run on the same
   mesh and the reference's dense run to 1e-5 x max|reference| (float32;
   the sharded contractions sum in other orders).  The collectives DTensor
   issued are the same on every rank; with the all-gathers staged through
   the host (``launch.mesh.stage_all_gather``, what gloo ranks on a card
   use) the outputs are bit-identical.

2. **The train step.**  Reduced llama, float32, on 2 ranks with meshes
   ``{"data": 2}`` and ``{"model": 2}``, under reduced llama's own plan
   (the batch split: data parallel) and under the policy llama-7b's plan
   takes there (heads, d_model, ffn and vocab split, as on the card): the
   loss, every gradient (pinned
   to its parameter's placements) and the parameters after one AdamW step
   with the norm clip active equal the one-rank step.  Loss and grad norm
   to 1e-5 relative, each gradient to 1e-5 x its max|g| (sums over shards
   in other orders).  The parameters: Adam's first step moves a weight by
   lr·g/(|g| + 1e-8), and a gradient error dg moves that by lr·1e-8·dg/g²;
   so where |g| clears 30 x the gradients' tolerance every weight is held
   to 1e-4 x lr beyond one float32 ulp of itself, and below that, where the step's size and sign are
   rounding, to 2 x lr (one unit step either way).  On the (2, 2) mesh,
   under llama-7b's plan at b=4, s=512 (``f`` and ``v`` on ("data",
   "model"): the embedding table's vocab split on two axes), the same step
   is held to the same limits.  The one-rank step equals the reference's
   ``make_train_step`` on the same weights: the metrics to 1e-5 relative,
   the parameters by the same rule.

   On that mesh two placed ops are held on their own: ``gspmd.matmul`` in
   bfloat16, whose product runs in float32 only where the contraction is
   split (a column-parallel product stays bfloat16), each within one
   bfloat16 ulp (2^-7 x |y|) of the one-rank product; and the embedding
   lookup with the vocab on two axes, equal to ``F.embedding`` and its
   gradient exactly (each token has one nonzero term), with no collective
   but the tokens' all-gather moving the table.

3. **Serving.**  ``serve(mesh=)`` of reduced llama on 4 ranks ((1, 4) and
   (2, 2)) gives the one-rank port serve's generations and the
   reference's, token for token; a ``BucketRegistry`` on the mesh runs its
   bucket prefill step under the bucket's policy to the one-rank
   registry's logit (1e-5 x max|logit|, float32).

5. **What the executor once refused**, on a mesh of three axes, (pod,
   data, model) = (2, 2, 1), under hand-written plans: a ``prod``
   aggregation over a split label (a ``Partial("product")``), an opaque
   node of a rule registered here with no local lowering (run whole on
   every rank through the ``replicate`` rule), and plans with an entry
   out of mesh order, ``("data", "pod")``, on a kept and on a contracted
   label (placed nested in mesh order).  Every rank's outputs equal the
   reference's dense run to 1e-5 x max|reference|.

4. **The other blocks.**  MoE, hymba and xLSTM run under a mesh of two
   ranks, each under its plan's policy, and their logits equal one
   rank's to 1e-5 x max|logit| (tests/test_torch_blocks_mesh.py holds them
   in full: decode, train, serve, the executor's a2a rule).
"""
import dataclasses
import math
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.einsum import EinGraph as RefGraph  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.serve import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.eingraphs import program_for as ref_program_for  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.einsum import EinGraph  # noqa: E402
from repro_torch.core.gspmd import comm_summary, full  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, place_batch  # noqa: E402
from repro_torch.frontend import Program  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn, stage_all_gather  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.eingraphs import program_for  # noqa: E402
from repro_torch.serving import BucketRegistry  # noqa: E402

RUN_MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
              "2x4": {"data": 2, "model": 4}}
CASES = ("ffnn", "llama", "llama-wide")
TOL = 1e-5


# ---------------------------------------------------------------------------
# Cases, built the same way through either package
# ---------------------------------------------------------------------------


def _ffnn(G):
    """The FFNN of the paper's Experiment 2 (benchmarks/bench_ffnn.py):
    X@W1 -> relu -> @W2 -> - Y -> square -> sum, at a small size."""
    g = G("ffnn")
    X = g.input("X", "bf", (16, 32))
    W1 = g.input("W1", "fh", (32, 24))
    W2 = g.input("W2", "hc", (24, 8))
    Y = g.input("Y", "bc", (16, 8))
    out = g.einsum("bh,hc->bc", g.map("relu", g.einsum("bf,fh->bh", X, W1)), W2)
    diff = g.einsum("bc,bc->bc", out, Y, combine="sub", agg="")
    loss = g.einsum("bc->", g.map("square", diff), combine="id", agg="sum")
    return g, {"out": out, "loss": loss}


def _llama_cfgs(name):
    cfg, ref_cfg = reduced(get_config("llama-7b")), ref_reduced(ref_get_config("llama-7b"))
    if name == "llama-wide":  # wide enough that the (2, 2) plan is llama-7b's
        wide = dict(d_model=128, head_dim=32, d_ff=688, vocab=1024)
        cfg, ref_cfg = dataclasses.replace(cfg, **wide), dataclasses.replace(ref_cfg, **wide)
    return cfg, ref_cfg


def build(name, pkg):
    """(graph, {output name: node id})."""
    if name == "ffnn":
        return _ffnn(EinGraph if pkg == "port" else RefGraph)
    cfg, ref_cfg = _llama_cfgs(name)
    seq = 32 if name == "llama-wide" else 16
    prog = (program_for(cfg, ShapeConfig("eq", "prefill", seq, 4)) if pkg == "port"
            else ref_program_for(ref_cfg, RefShape("eq", "prefill", seq, 4)))
    return prog.graph, dict(prog._out)


def feeds_for(g, name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    out = {}
    for n in g.nodes:
        if n.kind != "input":
            continue
        if str(np.dtype(n.dtype)) == "int32":
            out[n.name] = rng.integers(0, 256, size=n.shape).astype(np.int32)
        else:
            out[n.name] = (rng.normal(size=n.shape) * 0.1).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# 1. the executor
# ---------------------------------------------------------------------------


def executor_battery(rank, world, sizes):
    """Every case on this rank: {name: {"gspmd", "shard_map", "dense":
    {output: array}, "comms": {kind: {count, bytes}}, "two_axis": [labels
    of the policy on two axes]}}; on (2, 2) also "staged", the gspmd run
    with host-staged all-gathers."""
    mesh = Mesh(sizes, device="cpu")
    res = {}
    for name in CASES:
        g, outs = build(name, "port")
        prog = Program.from_graph(g, outs)
        feeds = feeds_for(g, name)
        comp = prog.compile(mesh=mesh, executor="gspmd")
        comp._fn.log_comms = True
        r = {"gspmd": {k: v.numpy() for k, v in comp(feeds).items()},
             "shard_map": {k: v.numpy() for k, v in prog.compile(
                 mesh=mesh, executor="shard_map")(feeds).items()},
             "dense": {k: v.numpy() for k, v in prog.compile(
                 p=1, device="cpu")(feeds).items()},
             "comms": comm_summary(comp._fn.comms),
             "collectives": comp.collectives,
             "two_axis": sorted(l for l, ax in comp.policy().label_axes.items()
                                if len(ax) > 1)}
        res[name] = r
    if sizes == RUN_MESHES["2x2"]:
        stage_all_gather("CPU")
        g, outs = build("llama-wide", "port")
        comp = Program.from_graph(g, outs).compile(mesh=mesh, executor="gspmd")
        res["llama-wide"]["staged"] = {
            k: v.numpy() for k, v in comp(feeds_for(g, "llama-wide")).items()}
    return res


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    cache = {}

    def get(mesh_id):
        if mesh_id not in cache:
            sizes = RUN_MESHES[mesh_id]
            cache[mesh_id] = spawn(math.prod(sizes.values()), executor_battery, sizes,
                                   tmpdir=tmp_path_factory.mktemp(f"gspmd{mesh_id}"))
        return cache[mesh_id]

    return get


def _ref_dense(name):
    g, outs = build(name, "ref")
    vals = ref_engine.run(g, feeds_for(g, name))
    return {k: np.asarray(vals[o]) for k, o in outs.items()}


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh_id", list(RUN_MESHES))
def test_gspmd_equals_dense_shard_map_and_reference(mesh_id, name, gloo):
    ranks = gloo(mesh_id)
    ref = _ref_dense(name)
    for rank, res in enumerate(ranks):
        r = res[name]
        assert r["collectives"] is None  # as in the reference, under gspmd
        for k, want in ref.items():
            tol = TOL * max(float(np.abs(want).max()), 1e-30)
            for other in ("dense", "shard_map"):
                np.testing.assert_allclose(r["gspmd"][k], r[other][k], rtol=0, atol=tol,
                                           err_msg=f"rank {rank} {k} vs {other}")
            np.testing.assert_allclose(r["gspmd"][k], want, rtol=0, atol=tol,
                                       err_msg=f"rank {rank} {k} vs the reference")
        assert r["comms"] == ranks[0][name]["comms"]  # every rank issued the same


def test_gspmd_carries_llama_7b_plan_on_two_axes(gloo):
    """The wide case's (2, 2) plan puts f and v on ("data", "model"), as
    llama-7b's does — the [Shard(d), Shard(d)] layouts — and its outputs
    are bit-identical with the all-gathers staged through the host."""
    r = gloo("2x2")[0]["llama-wide"]
    assert r["two_axis"] == ["f", "v"]
    assert r["comms"]["all_gather"]["count"] > 0 and "all_reduce" in r["comms"]
    for k, v in r["gspmd"].items():
        np.testing.assert_array_equal(r["staged"][k], v)
    for mesh_id in ("1x4", "2x4"):
        assert gloo(mesh_id)[0]["llama-wide"]["two_axis"] == []


# ---------------------------------------------------------------------------
# 5. what the executor once refused
# ---------------------------------------------------------------------------

REPAIR_MESH = {"pod": 2, "data": 2, "model": 1}
REPAIRS = {"prod": {"i": ("data",), "j": ("pod",)},
           "custom": {"i": ("data",), "j": ("pod",)},
           "order": {"b": ("data", "pod")},
           "order-contracted": {"a": ("data", "pod")}}
CUSTOM_OP, CUSTOM_RULE = "gspmd_test_affine", "gspmd_test_nolocal"


class _NoLocalRule:
    """A shard rule with no lowering the DTensor executor may call."""

    name = CUSTOM_RULE

    def lower(self, g, node, ax_n, sizes):
        raise AssertionError("the gspmd executor lowers this rule's nodes as replicated")


def _register_custom(pkg):
    if pkg == "port":
        from repro_torch.core import opaque_rules, opdef

        opaque_rules.register_rule(_NoLocalRule())
        opdef.defop(CUSTOM_OP, "i j -> i j", fn=lambda x: torch.as_tensor(x) * 2 + 1,
                    shard_rule=CUSTOM_RULE, overwrite=True)
    else:
        from repro.core import opdef as ref_opdef

        ref_opdef.defop(CUSTOM_OP, "i j -> i j", fn=lambda x: x * 2 + 1, overwrite=True)


def build_repair(name, pkg):
    """(graph, {output name: node id}) of a repair case."""
    g = (EinGraph if pkg == "port" else RefGraph)(name)
    if name in ("prod", "custom"):
        x = g.input("x", "i j", (8, 8))
        if name == "custom":
            _register_custom(pkg)
            x = g.opaque(CUSTOM_OP, [x], "i j", (8, 8), in_labels=[("i", "j")])
        agg = "prod" if name == "prod" else "sum"
        return g, {"y": g.einsum("i j -> i", x, combine="id", agg=agg)}
    x = g.input("x", "b a", (8, 8))
    w = g.input("w", "a f", (8, 8))
    return g, {"y": g.einsum("b a, a f -> b f", x, w)}


def _repair_feeds(g):
    rng = np.random.default_rng(zlib.crc32(g.name.encode()))
    return {n.name: (1 + 0.1 * rng.normal(size=n.shape)).astype(np.float32)
            for n in g.nodes if n.kind == "input"}


def repair_rank(rank, world):
    """Every repair case through ``executor="gspmd"`` on this rank: its
    outputs and the opaque nodes' rules."""
    from repro_torch.core.decomp import Plan

    mesh = Mesh(REPAIR_MESH, device="cpu")
    res = {}
    for name, axes in REPAIRS.items():
        g, outs = build_repair(name, "port")
        plan = Plan(p=4, mode="mesh")
        plan.axes_by_node = {n.nid: dict(axes) for n in g.nodes}
        comp = Program.from_graph(g, outs).compile(mesh=mesh, executor="gspmd", plan=plan)
        res[name] = {"y": comp(_repair_feeds(g))["y"].numpy(),
                     "rules": [st.rule for st in comp._fn.program if st.rule],
                     "partial": [st.partial for st in comp._fn.program if st.partial]}
    return res


@pytest.fixture(scope="module")
def repairs(tmp_path_factory):
    return spawn(4, repair_rank, tmpdir=tmp_path_factory.mktemp("repairs"))


@pytest.mark.parametrize("name", list(REPAIRS))
def test_gspmd_runs_what_it_once_refused_equal_to_the_reference(name, repairs):
    g, outs = build_repair(name, "ref")
    want = np.asarray(ref_engine.run(g, _repair_feeds(g))[outs["y"]])
    tol = TOL * float(np.abs(want).max())
    for rank, r in enumerate(repairs):
        np.testing.assert_allclose(r[name]["y"], want, rtol=0, atol=tol,
                                   err_msg=f"{name} rank {rank}")
        if name == "custom":
            assert r[name]["rules"] == ["replicate"], r[name]
        if name == "prod":
            assert r[name]["partial"] == [(("pod", "product"),)], r[name]
        if name == "order-contracted":  # the partial sums nested in mesh order
            assert r[name]["partial"] == [(("pod", "sum"), ("data", "sum"))], r[name]


# ---------------------------------------------------------------------------
# 2-4. train, serve, blocks that raise
# ---------------------------------------------------------------------------

LR = 1e-3


def _train_setup():
    cfg = reduced(get_config("llama-7b"))
    shape = ShapeConfig("t", "train", 16, 4)
    batch = SyntheticLM(cfg.vocab, shape.seq, shape.batch, seed=0).global_batch_at(0)
    return cfg, shape, batch


def train_one(mesh, plan_of="reduced"):
    """Loss, gradients and one AdamW step of reduced llama on ``mesh``,
    everything gathered whole, under the policy of ``plan_of``'s plan:
    reduced llama's own (the batch on the mesh: data parallel, ``Partial``
    gradients reduce-scattered into the weights' shards), llama-7b's at
    chip_smoke's train cell (heads, d_model, ffn and vocab split, as on the
    card) or llama-7b's at b=4, s=512 (on (2, 2): ffn and vocab on both
    axes)."""
    from repro_torch.models.eingraphs import fsdp_axes_for

    cfg, shape, hb = _train_setup()
    axes = dict(mesh.sizes)
    planned = {"reduced": (cfg, shape),
               "llama-7b": (get_config("llama-7b"), ShapeConfig("t", "train", 128, 2)),
               "llama-7b-2x2": (get_config("llama-7b"), ShapeConfig("t", "train", 512, 4)),
               }[plan_of]
    policy = program_for(*planned).compile(mesh_axes=axes, device="cpu").policy(
        fsdp_axes=fsdp_axes_for(axes))
    params = tf.place_params(tf.init_params(cfg, seed=5, device="cpu"), cfg, policy, mesh)
    batch = place_batch(hb, policy, mesh)
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = tf.loss_fn(params, batch, cfg, policy=policy, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    grads = [full(g.redistribute(p.device_mesh, p.placements) if mesh.world_size > 1
                  else g).detach().numpy() for g, p in zip(grads, leaves)]
    for p in leaves:
        p.requires_grad_(False)
    step = steps.make_train_step(cfg, policy=policy, mesh=mesh, lr_fn=lambda s: LR)
    params, _, met = step(params, optim.adamw_init(params), batch)
    return {"loss": float(full(loss).detach()), "grads": grads,
            "metrics": {k: float(v) for k, v in met.items()},
            "params": [full(p).numpy() for p in tree.leaves(params)],
            "policy": dict(policy.label_axes)}


def serve_one(mesh, params_np):
    cfg = reduced(get_config("llama-7b"))
    params = tf.from_reference_params(cfg, params_np, device="cpu")
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, size=(4, 12)).astype(np.int32)
    gen, stats = serve(cfg, prompts, max_new=6, mesh=mesh, params=params, device="cpu")
    return gen, stats["param_bytes"], bucket_prefill(cfg, mesh, params)


def bucket_prefill(cfg, mesh, params):
    """The registry's bucket prefill step of one 13-token prompt (bucket
    16) under the bucket's policy on ``mesh``: its logit, whole."""
    reg = BucketRegistry(cfg, mesh, device="cpu")
    ent = reg.prefill(13)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = np.arange(13) * 7
    with torch.no_grad():
        logits, _ = ent.step(tf.place_params(params, cfg, ent.policy, mesh),
                             {"tokens": torch.as_tensor(toks)}, 12)
    return full(logits).numpy()


def placed_ops(mesh):
    """gspmd.matmul in bfloat16, column- and row-parallel, and the
    embedding lookup with the vocab on ("data", "model"), each against its
    one-rank value; ``mesh`` is (2, 2)."""
    import torch.nn.functional as F

    from repro_torch.core import gspmd

    rng = np.random.default_rng(23)
    x = torch.as_tensor(rng.normal(size=(8, 64)), dtype=torch.bfloat16)
    w = torch.as_tensor(rng.normal(size=(64, 32)), dtype=torch.bfloat16)
    out = {"y1": torch.matmul(x, w).float().numpy()}
    for name, xs, ws in (("column", ("data", None), (None, "model")),
                         ("row", (None, "model"), ("model", None))):
        xd, wd = gspmd.distribute(x, mesh, xs), gspmd.distribute(w, mesh, ws)
        y = gspmd.matmul(xd, wd)
        out[name] = {"split": gspmd.splits_contraction(xd, wd), "dtype": str(y.dtype),
                     "partial": any(p.is_partial() for p in y.placements),
                     "y": full(y).float().numpy()}
    table = torch.as_tensor(rng.normal(size=(512, 16)), dtype=torch.float32)
    ids = torch.as_tensor(rng.integers(0, 512, size=(4, 16)), dtype=torch.int32)
    td = gspmd.distribute(table, mesh, (("data", "model"), None)).requires_grad_(True)
    with gspmd.CommLog() as log:
        e = gspmd.constrain(tf._lookup(td, gspmd.distribute(ids, mesh, ("data", None)),
                                       mesh), mesh, ("data", None, None))
    torch.sum(e * gspmd.replicate_like(torch.arange(16.0), e)).backward()
    want_grad = torch.zeros_like(table).index_add_(
        0, ids.long().flatten(), torch.arange(16.0).expand(64, 16))
    out["lookup"] = {"equal": bool(torch.equal(full(e).detach(), F.embedding(ids.long(), table))),
                     "grad_equal": bool(torch.equal(full(td.grad), want_grad)),
                     "comms": comm_summary(log), "ids_block_bytes": ids.nbytes // 2}
    return out


def other_block(arch, mesh):
    """Reduced ``arch``'s forward on ``mesh`` under its plan's policy:
    (max|mesh - one rank| of the logits, max|logit| of one rank)."""
    cfg = reduced(get_config(arch))
    policy = program_for(cfg, ShapeConfig("t", "train", 16, 4)).compile(
        mesh_axes=dict(mesh.sizes), device="cpu").policy()
    params = tf.init_params(cfg, seed=2, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab, size=(4, 16)),
                           dtype=torch.int32)
    with torch.no_grad():
        want = tf.forward(params, toks, cfg)[0]
        got = full(tf.forward(tf.place_params(params, cfg, policy, mesh), toks, cfg,
                              policy=policy, mesh=mesh)[0])
    return float((got - want).abs().max()), float(want.abs().max())


def mesh_battery(rank, world, kind, sizes, params_np):
    mesh = Mesh(sizes, device="cpu")
    if kind == "train:llama-7b-2x2":
        return dict(train_one(mesh, "llama-7b-2x2"), ops=placed_ops(mesh))
    if kind.startswith("train"):
        out = train_one(mesh, kind.split(":")[1])
        out["blocks"] = {arch: other_block(arch, mesh)
                         for arch in ("mixtral-8x7b", "hymba-1.5b", "xlstm-125m")}
        return out
    return serve_one(mesh, params_np)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    cache = {}

    def get(kind, mesh_id, sizes, params_np=None):
        key = (kind, mesh_id)
        if key not in cache:
            cache[key] = spawn(math.prod(sizes.values()), mesh_battery, kind, sizes,
                               params_np, tmpdir=tmp_path_factory.mktemp(f"{kind}{mesh_id}"))
        return cache[key]

    return get


@pytest.fixture(scope="module")
def one_rank_step():
    return train_one(Mesh({"data": 1, "model": 1}, device="cpu"))


def _assert_adam_close(got, want, grads, what):
    """Parameters after one AdamW step at ``LR`` (see the module docstring:
    1e-4 x lr where |g| clears 30 x the gradients' tolerance, else 2 x lr)."""
    for i, (g, w, gr) in enumerate(zip(got, want, grads)):
        d = np.abs(g - w) - np.finfo(np.float32).eps * np.abs(w)  # beyond an ulp
        sure = np.abs(gr) >= 30 * TOL * np.abs(gr).max()
        assert d[sure].max(initial=0.0) <= 1e-4 * LR, (what, i, float(d[sure].max()))
        assert d.max() <= 2 * LR, (what, i, float(d.max()))


@pytest.mark.parametrize("plan_of", ["reduced", "llama-7b"])
@pytest.mark.parametrize("sizes", [{"data": 2}, {"model": 2}], ids=["data2", "model2"])
def test_train_step_on_two_ranks_equals_one_rank(sizes, plan_of, meshes, one_rank_step):
    want = one_rank_step
    assert want["metrics"]["grad_norm"] > 1.0  # the clip (max norm 1) is active
    (axis,) = sizes
    for rank, got in enumerate(meshes(f"train:{plan_of}", axis, sizes)):
        if plan_of == "reduced":  # data parallel: the batch on the axis
            assert got["policy"]["b"] == (axis,), got["policy"]
        else:
            assert set(got["policy"]) == {"v", "a", "f", "k"}, got["policy"]
        for k in ("loss", "grad_norm", "ce"):
            w = want["loss"] if k == "loss" else want["metrics"][k]
            g = got["loss"] if k == "loss" else got["metrics"][k]
            assert abs(g - w) <= 1e-5 * abs(w), (rank, k, g, w)
        assert got["metrics"]["loss"] == pytest.approx(got["loss"], rel=1e-6)
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL * float(np.abs(w).max()),
                                       err_msg=f"rank {rank} grad leaf {i}")
        _assert_adam_close(got["params"], want["params"], want["grads"], f"rank {rank}")


def test_train_step_with_the_vocab_on_two_axes_equals_one_rank(meshes, one_rank_step):
    want = one_rank_step
    for rank, got in enumerate(meshes("train:llama-7b-2x2", "2x2", {"data": 2, "model": 2})):
        assert got["policy"]["v"] == got["policy"]["f"] == ("data", "model"), got["policy"]
        assert got["policy"]["b"] == ("data",), got["policy"]
        for k in ("loss", "grad_norm", "ce"):
            w = want["loss"] if k == "loss" else want["metrics"][k]
            g = got["loss"] if k == "loss" else got["metrics"][k]
            assert abs(g - w) <= 1e-5 * abs(w), (rank, k, g, w)
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL * float(np.abs(w).max()),
                                       err_msg=f"rank {rank} grad leaf {i}")
        _assert_adam_close(got["params"], want["params"], want["grads"], f"rank {rank}")


def test_matmul_runs_float32_only_where_the_contraction_is_split(meshes):
    for got in meshes("train:llama-7b-2x2", "2x2", {"data": 2, "model": 2}):
        ops = got["ops"]
        assert not ops["column"]["split"] and ops["row"]["split"]
        y1 = ops["y1"]
        for name in ("column", "row"):
            r = ops[name]
            assert r["dtype"] == "torch.bfloat16" and not r["partial"], (name, r)
            assert (np.abs(r["y"] - y1) <= 2.0 ** -7 * np.abs(y1)).all(), name


def test_lookup_with_the_vocab_on_two_axes_moves_no_table(meshes):
    for got in meshes("train:llama-7b-2x2", "2x2", {"data": 2, "model": 2}):
        lk = got["ops"]["lookup"]
        assert lk["equal"] and lk["grad_equal"]
        # the tokens' block is all that is gathered; the rows' sum is a
        # reduce-scatter and an all-reduce of the (b, s, a) lookup
        assert lk["comms"]["all_gather"] == {"count": 1, "bytes": lk["ids_block_bytes"]}


def test_one_rank_step_equals_reference(one_rank_step):
    cfg, shape, hb = _train_setup()
    ref_cfg = ref_reduced(ref_get_config("llama-7b"))
    params = tf.init_params(cfg, seed=5, device="cpu")
    ref_params = jax.tree.unflatten(jax.tree.structure(ref_tf.init_params(
        ref_cfg, jax.random.PRNGKey(0))), [p.numpy() for p in tree.leaves(params)])
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, lr_fn=lambda s: LR))
    ref_params, _, met = ref_step(ref_params, ref_optim.adamw_init(ref_params), hb)
    for k in ("loss", "grad_norm", "ce"):
        assert one_rank_step["metrics"][k] == pytest.approx(float(met[k]), rel=1e-5), k
    _assert_adam_close(one_rank_step["params"],
                       [np.asarray(w) for w in jax.tree.leaves(ref_params)],
                       one_rank_step["grads"], "reference")


def test_blocks_without_a_mesh_path_raise(meshes):
    """The blocks that raised on a mesh before they had a path there (MoE,
    hymba, xLSTM) now run on it: each rank's logits equal one rank's."""
    for got in meshes("train:reduced", "data", {"data": 2}):
        assert set(got["blocks"]) == {"mixtral-8x7b", "hymba-1.5b", "xlstm-125m"}
        for arch, (err, scale) in got["blocks"].items():
            assert err <= TOL * scale, (arch, err, scale)


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 4}, {"data": 2, "model": 2}],
                         ids=["1x4", "2x2"])
def test_serve_on_four_ranks_equals_one_rank_and_reference(sizes, meshes):
    cfg, ref_cfg = reduced(get_config("llama-7b")), ref_reduced(ref_get_config("llama-7b"))
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(3))
    params_np = jax.tree.map(np.asarray, ref_params)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, size=(4, 12)).astype(np.int32)
    want, _ = ref_serve(ref_cfg, prompts, max_new=6, params=ref_params)
    one, stats = serve(cfg, prompts, max_new=6, device="cpu",
                       params=tf.from_reference_params(cfg, params_np, device="cpu"))
    np.testing.assert_array_equal(one, np.asarray(want))
    params = tf.from_reference_params(cfg, params_np, device="cpu")
    one_logit = bucket_prefill(cfg, Mesh({"data": 1, "model": 1}, device="cpu"), params)
    for gen, nbytes, logit in meshes("serve", "x".join(map(str, sizes.values())), sizes,
                                     params_np):
        np.testing.assert_array_equal(gen, one)
        assert nbytes < stats["param_bytes"]  # each rank holds a share
        np.testing.assert_allclose(logit, one_logit, rtol=0,
                                   atol=TOL * float(np.abs(one_logit).max()))
