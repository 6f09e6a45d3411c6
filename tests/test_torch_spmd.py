"""The port's explicit-collective executor against the reference.

1. **Static schedules.**  ``build_schedule`` is pure Python in both
   packages, so the port's programs, layouts, prefetches and collective
   trace equal the reference's exactly, on the reduced zoo's prefill graphs
   and on seeded random graphs, for every mesh, ``fuse`` and ``lookahead``.
   The four predicted/traced ratios pinned in ``BENCH_spmd.json`` come out
   of the port's traces.

2. **Execution on gloo ranks.**  All cases for one mesh run in one spawn of
   CPU ranks (``launch.mesh.spawn``, ``file://`` rendezvous under a tmp
   path).  On every rank the shard_map output equals the port's dense run
   and the reference's dense run; inside the port, fused vs unfused and
   lookahead 0/1/2 (and the ring's double buffer on/off) are bit-identical;
   the collectives each rank issued equal the static trace.  MoE graphs
   (mixtral's prefill, and a dispatch/combine pair with real capacity
   drops) run with each package's stubs (``models/opaque_stubs.py``); where
   the plan shards the expert label, dispatch and combine go through the
   ``a2a`` rule's all_to_all program.

Tolerances: float32 throughout.  shard_map vs a dense run sums the sharded
contractions in another order, so 1e-5 (rtol and atol) on the small graphs
and 1e-4 on the model graphs (deeper sums); everything inside the port that
runs the same collectives on the same values is compared bit for bit.
"""
import dataclasses
import itertools
import json
import math
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import spmd as ref_spmd  # noqa: E402
from repro.core.decomp import Plan as RefPlan  # noqa: E402
from repro.core.decomp import eindecomp as ref_eindecomp  # noqa: E402
from repro.core.einsum import EinGraph as RefGraph  # noqa: E402
from repro.models.eingraphs import program_for as ref_program_for  # noqa: E402
from repro.models.opaque_stubs import capacity_of as ref_capacity_of  # noqa: E402
from repro.models.opaque_stubs import make_stub_opaques as ref_stub_opaques  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import engine, spmd  # noqa: E402
from repro_torch.core.decomp import Plan, eindecomp, plan_cost  # noqa: E402
from repro_torch.core.einsum import EinGraph  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.models.eingraphs import program_for  # noqa: E402
from repro_torch.models.opaque_stubs import capacity_of, make_stub_opaques  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ZOO = ("llama-7b", "mixtral-8x7b", "xlstm-125m", "hymba-1.5b")
SCAN_OPS = ("ssm_scan", "mlstm_scan", "slstm_scan")


def _mesh_id(sizes):
    return "x".join(str(v) for v in sizes.values())


# ---------------------------------------------------------------------------
# Graphs, built the same way through either package
# ---------------------------------------------------------------------------


def _mlp(G):
    g = G("mlp")
    x = g.input("x", "b a", (8, 16))
    w1 = g.input("w1", "a f", (16, 32))
    w2 = g.input("w2", "f c", (32, 8))
    h = g.map("relu", g.einsum("b a, a f -> b f", x, w1))
    return g, [g.einsum("b f, f c -> b c", h, w2)], None


def _softmax(G):
    g = G("softmax")
    x = g.input("X", "i j", (8, 16))
    c = g.einsum("i j -> i", x, combine="id", agg="max")
    e = g.einsum("i j, i -> i j", x, c, combine="expsub", agg="")
    s = g.einsum("i j -> i", e, combine="id", agg="sum")
    return g, [g.einsum("i j, i -> i j", e, s, combine="div", agg="")], None


def _random(G, seed):
    """A random 3-6 node graph over four labels of extent 8 (the reference
    test's generator)."""
    rng = np.random.default_rng(seed)
    pool = ["i", "j", "k", "l"]
    g = G("prop")
    nodes = []
    for t in range(int(rng.integers(2, 4))):
        nl = int(rng.integers(1, 4))
        labels = list(rng.choice(pool, size=nl, replace=False))
        nodes.append(g.input(f"in{t}", labels, [8] * nl))
    for _ in range(int(rng.integers(1, 4))):
        a, b = int(rng.choice(nodes)), int(rng.choice(nodes))
        la, lb = g.nodes[a].labels, g.nodes[b].labels
        union = list(dict.fromkeys(la + lb))
        keep = [l for l in union if rng.random() < 0.6] or [union[0]]
        try:
            nodes.append(g.einsum(f"{' '.join(la)}, {' '.join(lb)} -> "
                                  f"{' '.join(keep)}", a, b))
        except ValueError:
            continue
        if rng.random() < 0.3:
            nodes.append(g.map("relu", nodes[-1]))
    return g, g.outputs(), None


def _hand_plan(P, g, p, axes_of):
    """A mesh-mode plan giving node ``nid`` the label->axes map
    ``axes_of(node)``."""
    plan = P(p=p, mode="mesh")
    for n in g.nodes:
        plan.d_by_node[n.nid] = {l: 1 for l in n.labels}
        plan.axes_by_node[n.nid] = axes_of(n)
    return plan


def _aggs(G):
    """max / min / prod over a sharded label: pmax, pmin and the gathered
    product."""
    g = G("aggs")
    x = g.input("x", "i j", (8, 16))
    outs = [g.einsum("i j -> i", x, combine="id", agg=a)
            for a in ("max", "min", "prod")]
    return g, outs, lambda P, p: _hand_plan(
        P, g, p, lambda n: {"j": ("model",)} if "j" in n.labels or n.kind
        == "einsum" else {})


def _swap(G):
    """data -> model on the same dim: a ppermute where the two axes have
    one size (gather + slice otherwise)."""
    g = G("swap")
    x = g.input("x", "b f", (8, 16))
    h = g.einsum("b f -> b f", x, combine="id", agg="")
    y = g.einsum("b f -> b f", h, combine="id", agg="")
    axes = {x: ("data",), h: ("data",), y: ("model",)}
    return g, [y], lambda P, p: _hand_plan(
        P, g, p, lambda n: {"b": axes[n.nid]})


B, H, K, S, D = 2, 4, 2, 32, 16


def _ring(G, window):
    g = G("ring")
    q = g.input("q", "b h s d", (B, H, S, D))
    k = g.input("k", "b k s d", (B, K, S, D))
    v = g.input("v", "b k s d", (B, K, S, D))
    o = g.opaque(
        "flash_attention", [q, k, v], "b h s d", (B, H, S, D),
        in_labels=[("b", "h", "s", "d"), ("b", "k", "s", "d"),
                   ("b", "k", "s", "d")],
        shardable={"b", "h", "k", "s"},
        comm=[{"kind": "ring", "label": "s", "input": 1, "rule": "ring"},
              {"kind": "ring", "label": "s", "input": 2, "rule": "ring"}],
        window=window)
    return g, [o], lambda P, p: _hand_plan(
        P, g, p, lambda n: {} if n.kind == "input"
        else {"s": ("model",), "b": ("data",)})


E_MOE, CAP = 8, 4  # 64 tokens for 32 expert slots: real capacity drops
# ("model", "data") orders the ranks along the a2a axes unlike the
# process groups do (by global rank): the stacked collectives permute
MOE_PLANS = {"moe_e-all": {"e": ("data", "model")}, "moe_e-model": {"e": ("model",)},
             "moe_e-model-data": {"e": ("model", "data")}}


def _moe(G, axes_cfg):
    """A dispatch/combine pair (the reference's ``_moe_graph``); every
    non-input node gets ``axes_cfg``, the inputs stay replicated."""
    g = G("moe")
    x = g.input("x", "b s a", (B, S, D))
    route = g.input("route", "b s e", (B, S, E_MOE))
    disp = g.opaque(
        "moe_dispatch", [x, route], "e c a", (E_MOE, CAP, D),
        in_labels=[("b", "s", "a"), ("b", "s", "e")],
        shardable={"e", "c", "b", "s"},
        comm=[{"kind": "a2a", "label": "e", "input": 0, "rule": "a2a"}])
    comb = g.opaque(
        "moe_combine", [disp, route], "b s a", (B, S, D),
        in_labels=[("e", "c", "a"), ("b", "s", "e")],
        shardable={"e", "c", "b", "s"},
        comm=[{"kind": "a2a", "label": "e", "input": -1, "rule": "a2a"}])
    return g, [comb], lambda P, p: _hand_plan(
        P, g, p, lambda n: {} if n.kind == "input" else dict(axes_cfg))


def _zoo(pkg, arch):
    if pkg == "port":
        cfg = reduced(get_config(arch))
        prog = program_for(cfg, ShapeConfig("eq", "prefill", 8, 2))
    else:
        cfg = ref_reduced(ref_get_config(arch))
        prog = ref_program_for(cfg, RefShape("eq", "prefill", 8, 2))
    return prog.graph, [prog._out[k] for k in prog._out], None


CASES = (["mlp", "softmax", "aggs", "swap", "ring_w0", "ring_w8"]
         + [f"rand{i}" for i in range(6)]
         + ["llama-7b", "mixtral-8x7b", "xlstm-125m", "hymba-1.5b"]
         + list(MOE_PLANS))


def build_case(name, pkg):
    """(graph, output ids, plan factory or None) for ``pkg`` "port" or
    "ref"; a None factory means the case is planned by eindecomp."""
    G = EinGraph if pkg == "port" else RefGraph
    if name in ZOO:
        return _zoo(pkg, name)
    if name.startswith("rand"):
        return _random(G, int(name[4:]))
    if name.startswith("ring_w"):
        return _ring(G, int(name[6:]))
    if name in MOE_PLANS:
        return _moe(G, MOE_PLANS[name])
    return {"mlp": _mlp, "softmax": _softmax, "aggs": _aggs,
            "swap": _swap}[name](G)


def case_feeds(g, name):
    """Seeded numpy feeds keyed by node id (products stay near 1)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    feeds = {}
    for n in g.nodes:
        if n.kind != "input":
            continue
        if str(np.dtype(n.dtype)) == "int32":
            feeds[n.nid] = rng.integers(0, 256, size=n.shape).astype(np.int32)
        elif name == "aggs":
            feeds[n.nid] = (1 + 0.1 * rng.normal(size=n.shape)).astype(np.float32)
        elif name in MOE_PLANS:  # the reference test's scales
            scale = 2.0 if n.name == "route" else 0.3
            feeds[n.nid] = (rng.normal(size=n.shape) * scale).astype(np.float32)
        else:
            feeds[n.nid] = (rng.normal(size=n.shape) * 0.1).astype(np.float32)
    return feeds


# ---------------------------------------------------------------------------
# 1. static schedules equal the reference's
# ---------------------------------------------------------------------------

SCHED_MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 2},
                {"data": 2, "model": 4}]


def _schedule_record(s) -> dict:
    """Everything a schedule decides, as plain data."""
    return {
        "programs": [(p.nid, p.layout, p.arg_steps, p.post_steps, p.rule,
                      p.prefetch, p.prefetch_src) for p in s.programs],
        "layouts": s.layouts,
        "events": [dataclasses.astuple(e) for e in s.trace.events],
        "rule_by_node": s.trace.rule_by_node,
        "prefetches": [dataclasses.astuple(pf) for pf in s.prefetches],
        "compute_elems": s.compute_elems,
        "sizes": s.sizes, "lookahead": s.lookahead,
    }


def _both_plans(name, sizes):
    p = math.prod(sizes.values())
    g, outs, hand = build_case(name, "port")
    rg, routs, rhand = build_case(name, "ref")
    if hand is None:
        plan = eindecomp(g, p, mesh_axes=sizes)
        rplan = ref_eindecomp(rg, p, mesh_axes=sizes)
    else:
        plan, rplan = hand(Plan, p), rhand(RefPlan, p)
    assert plan.to_json() == rplan.to_json()
    return g, outs, plan, rg, routs, rplan


@pytest.mark.parametrize("sizes", SCHED_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name", list(ZOO) + [f"rand{i}" for i in range(8)]
                         + ["mlp", "softmax", "ring_w8"])
def test_schedule_equals_reference(name, sizes):
    g, outs, plan, rg, routs, rplan = _both_plans(name, sizes)
    assert outs == routs
    for fuse, la in itertools.product((True, False), (0, 1, 2)):
        got = spmd.build_schedule(g, plan, sizes, outs, fuse=fuse, lookahead=la)
        want = ref_spmd.build_schedule(rg, rplan, sizes, routs, fuse=fuse,
                                       lookahead=la)
        assert _schedule_record(got) == _schedule_record(want), (fuse, la)
        assert got.exposed_wire_elems() == want.exposed_wire_elems()


def _pinned_ratios() -> dict[str, float]:
    rows = json.loads((ROOT / "BENCH_spmd.json").read_text())
    return {r["name"].split("/")[1]: r["value"] for r in rows
            if r["metric"] == "predicted_over_traced"}


@pytest.mark.parametrize("arch", ZOO)
def test_bench_spmd_ratio_from_port_trace(arch):
    """predicted (plan_cost) over traced wire elems, as the reference's
    trajectory computes it: reduced config, (4, 32) prefill, 2x4 mesh,
    fused schedule at lookahead 1."""
    sizes = {"data": 2, "model": 4}
    prog = program_for(reduced(get_config(arch)),
                       ShapeConfig("bench", "prefill", 32, 4))
    g = prog.graph
    plan = eindecomp(g, 8, mesh_axes=sizes, offpath_repart=True)
    sched = spmd.build_schedule(g, plan, sizes, [prog._out[k] for k in prog._out],
                                fuse=True, lookahead=1)
    ratio = round(plan_cost(g, plan) / max(sched.trace.total_elems, 1), 4)
    assert abs(ratio - _pinned_ratios()[arch]) <= 1e-3


# ---------------------------------------------------------------------------
# 2. execution on gloo ranks (one spawn per mesh)
# ---------------------------------------------------------------------------

RUN_MESHES = {"2x2": {"data": 2, "model": 2}, "2x4": {"data": 2, "model": 4}}
KNOBS = list(itertools.product((True, False), (0, 1, 2)))


def _events(trace):
    return sorted((e.nid, e.kind, e.axes, e.elems) for e in trace.events)


def rank_battery(rank, world, sizes):
    """Every case on this rank: {name: {"runs": {(fuse, lookahead): [out
    arrays]}, "dense": [...], "issued": {...}, "trace": {...},
    "kinds": [...], "rules": {nid: rule}, "bytes_by_rule": {...}}}; ring
    cases add "serial", the run without the double buffer."""
    from repro_torch.core.opaque_rules import RingAttentionRule

    mesh = Mesh(sizes, device="cpu")
    p = math.prod(sizes.values())
    results = {}
    for name in CASES:
        g, outs, hand = build_case(name, "port")
        make_stub_opaques(capacity_of(g))
        plan = eindecomp(g, p, mesh_axes=sizes) if hand is None else hand(Plan, p)
        feeds = case_feeds(g, name)
        args = [feeds[i] for i in g.input_ids()]
        dense = engine.run(g, feeds)
        res = {"dense": [dense[o].numpy() for o in outs], "runs": {},
               "issued": {}, "trace": {}, "kinds": set()}
        for fuse, la in KNOBS:
            run = spmd.make_spmd_runner(g, outs, plan=plan, mesh=mesh,
                                        fuse=fuse, lookahead=la)
            res["runs"][(fuse, la)] = [t.numpy() for t in run(*args)]
            res["issued"][(fuse, la)] = sorted(run.issued)
            res["trace"][(fuse, la)] = _events(run.schedule.trace)
            res["kinds"] |= {st[0] for prog in run.schedule.programs
                             for steps in prog.arg_steps + [prog.post_steps]
                             for st in steps}
            res["kinds"] |= {e.kind for e in run.schedule.trace.events}
        res["rules"] = dict(run.schedule.trace.rule_by_node)
        res["bytes_by_rule"] = {
            rule: {k: v["bytes"] for k, v in kinds.items()}
            for rule, kinds in run.schedule.trace.by_rule().items()}
        if name.startswith("ring"):
            RingAttentionRule.double_buffer = False
            try:
                run = spmd.make_spmd_runner(g, outs, plan=plan, mesh=mesh)
                res["serial"] = [t.numpy() for t in run(*args)]
            finally:
                RingAttentionRule.double_buffer = True
        results[name] = res
    return results


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """mesh id -> every rank's ``rank_battery`` results (spawned once)."""
    cache = {}

    def get(mesh_id):
        if mesh_id not in cache:
            sizes = RUN_MESHES[mesh_id]
            cache[mesh_id] = spawn(math.prod(sizes.values()), rank_battery,
                                   sizes, tmpdir=tmp_path_factory.mktemp(mesh_id))
        return cache[mesh_id]

    return get


def _ref_dense(name, monkeypatch):
    rg, routs, _ = build_case(name, "ref")
    for kind, fn in ref_stub_opaques(ref_capacity_of(rg), register=False).items():
        monkeypatch.setitem(ref_engine.OPAQUE_FNS, kind, fn)
    vals = ref_engine.run(rg, case_feeds(rg, name))
    return [np.asarray(vals[o]) for o in routs]


def _tol(name):
    return 1e-4 if name in ZOO else 1e-5


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh_id", list(RUN_MESHES))
def test_gloo_shard_map_equals_dense_runs(mesh_id, name, gloo, monkeypatch):
    ranks = gloo(mesh_id)
    res = ranks[0][name]
    base = res["runs"][(True, 1)]
    for r, other in enumerate(ranks):  # every rank assembled the same outputs
        for knob in KNOBS:  # fused/unfused, lookahead 0/1/2: bit-identical
            for got, want in zip(other[name]["runs"][knob], base):
                np.testing.assert_array_equal(got, want, err_msg=f"rank {r} {knob}")
    tol = _tol(name)
    for got, dense, want in zip(base, res["dense"], _ref_dense(name, monkeypatch)):
        np.testing.assert_allclose(got, dense, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh_id", list(RUN_MESHES))
def test_gloo_issued_collectives_equal_static_trace(mesh_id, name, gloo):
    for rank in gloo(mesh_id):
        for knob in KNOBS:
            assert rank[name]["issued"][knob] == rank[name]["trace"][knob], knob


@pytest.mark.parametrize("name", ["ring_w0", "ring_w8"])
@pytest.mark.parametrize("mesh_id", list(RUN_MESHES))
def test_gloo_ring_double_buffer_bit_identical(mesh_id, name, gloo):
    """The ring at r = 2 (2x2) and r = 4 (2x4): the hops really ran, and
    with and without the double buffer the outputs are bit-identical."""
    r = RUN_MESHES[mesh_id]["model"]
    for rank in gloo(mesh_id):
        res = rank[name]
        ppermutes = [e for e in res["issued"][(True, 1)] if e[1] == "ppermute"]
        assert len(ppermutes) == 2 * (r - 1)
        for got, want in zip(res["serial"], res["runs"][(True, 1)]):
            np.testing.assert_array_equal(got, want)


def test_gloo_battery_covers_every_step_kind(gloo):
    """Between them the cases run every collective the executor has."""
    kinds = set()
    for mesh_id in RUN_MESHES:
        for res in gloo(mesh_id)[0].values():
            kinds |= res["kinds"]
    assert {"all_gather", "all_to_all", "ppermute", "slice", "psum", "pmax",
            "pmin", "psum_scatter", "gather_reduce"} <= kinds, kinds


@pytest.mark.parametrize("name", list(MOE_PLANS))
@pytest.mark.parametrize("mesh_id", list(RUN_MESHES))
def test_gloo_a2a_moe_with_drops_matches_dense(mesh_id, name, gloo, monkeypatch):
    """Real capacity drops (64 tokens, 32 slots), the expert label on both
    axes (in either order) and on ``model`` alone: dispatch and combine run
    through the a2a
    rule and equal both packages' dense stubs at the reference's rtol 1e-5
    / atol 1e-6 (routing decisions identical); the payload all_to_all
    moves more bytes than the count all-gather."""
    ranks = gloo(mesh_id)
    want = _ref_dense(name, monkeypatch)
    for rank in ranks:
        res = rank[name]
        assert set(res["rules"].values()) == {"a2a"}
        for got, dense, ref in zip(res["runs"][(True, 1)], res["dense"], want):
            np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        issued = res["issued"][(True, 1)]
        assert issued == res["trace"][(True, 1)]
        assert [e[1] for e in issued].count("all_to_all") == 4  # 2 per node
        a2a = res["bytes_by_rule"]["a2a"]
        assert a2a["all_gather"] < a2a["all_to_all"]
