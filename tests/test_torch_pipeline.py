"""The port's pipeline tier against the reference and against itself.

1. **Pure equality with the reference.**  Partitioning, per-stage planning,
   stitching and the GPipe schedule are deterministic Python in both
   packages, so on the reference tests' graphs (the waist graph, the
   layered chain, the multi-hop relay, 6 random batched graphs) and on the
   reduced zoo (prefill and decode) every stage's node ids, ``recv``, key,
   plan and schedule, the boundaries and ``cut_tensors``, the stitched
   plan, the cells, the combined trace event for event, the bubbles,
   ``handoff_elems`` and every stage's priced and traced wire equal the
   reference's, for p in {1, 2, 4} and m in {1, 2, 4}.  A cell the
   reference refuses (too many stages, an indivisible batch, MoE rows
   coupled across the batch) raises the same message in the port.

2. **Execution on gloo CPU ranks.**  One spawn per mesh shape runs every
   case of that shape (``launch.mesh.spawn``, ``file://`` rendezvous under
   a tmp path); a module-scoped fixture shares the results and each case
   stays its own test.  On every rank the pipelined outputs equal, bit for
   bit, the unpipelined compile of the stitched plan on the same mesh, and
   the collectives the rank issued equal the static trace (handoffs over
   ``pp`` included), and every rank's outputs agree with the reference's
   dense run (``repro.core.engine.run``) of the reference's graph of the
   same case on the same feeds.

   Tolerance: ``CPU_ORDER_CASES`` names the zoo cases at m = 2 on the
   2x2x2 mesh.  Their microbatches sum some elements in another order than
   the unpipelined run does, outside anything the pipeline decides: a
   decode product whose microbatch block has one local row takes MKL's
   gemv path (``test_cpu_blas_one_row_product_changes_bits``), and gloo's
   all-reduce over the 4 ranks of (data, model) sums each element in an
   order set by the buffer's size, which a microbatch halves
   (``test_cpu_gloo_psum_order_depends_on_size``).  Those cases are held
   to 1e-6 (rtol and atol); the same graphs at m = 1, every other case,
   and every rank against rank 0 are bit-identical.  Outputs are held
   against the port's dense run to 1e-5 on the small graphs and 1e-4 on
   the model graphs (the sharded sums run in another order), and against
   the reference's to the same, times max|reference|.
"""
import dataclasses
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ShapeConfig as RefShape  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.einsum import EinGraph as RefGraph  # noqa: E402
from repro.core.plancache import PlanCache as RefPlanCache  # noqa: E402
from repro.models.eingraphs import program_for as ref_program_for  # noqa: E402
from repro.models.opaque_stubs import capacity_of as ref_capacity_of  # noqa: E402
from repro.models.opaque_stubs import make_stub_opaques as ref_stub_opaques  # noqa: E402
from repro.pipeline import PipelineSpec as RefSpec  # noqa: E402
from repro.pipeline import batch_splittable as ref_batch_splittable  # noqa: E402
from repro.pipeline import build_pipeline_schedule as ref_build  # noqa: E402
from repro.pipeline import cut_tensors as ref_cut_tensors  # noqa: E402
from repro.pipeline import scale_graph_batch as ref_scale  # noqa: E402

from repro_torch import frontend as ein  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import engine, spmd  # noqa: E402
from repro_torch.core.cost import bubble_fraction, bubble_fraction_weighted  # noqa: E402
from repro_torch.core.decomp import eindecomp  # noqa: E402
from repro_torch.core.einsum import EinGraph  # noqa: E402
from repro_torch.core.plancache import PlanCache  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.launch.trajectory import FAMILIES  # noqa: E402
from repro_torch.models.eingraphs import program_for  # noqa: E402
from repro_torch.models.opaque_stubs import capacity_of, make_stub_opaques  # noqa: E402
from repro_torch.pipeline import (PipelineSpec, batch_splittable,  # noqa: E402
                                  build_pipeline_schedule, cut_tensors,
                                  partition_stages, scale_graph_batch)


# ---------------------------------------------------------------------------
# Graphs, built the same way through either package (the reference tests')
# ---------------------------------------------------------------------------


def _waist_graph(G=EinGraph):
    """Four balanced einsum hops with a narrow waist after the second —
    the min-byte cut must land on the waist tensor."""
    g = G("waist")
    x = g.input("x", "b a", (8, 64))
    w1 = g.input("w1", "a c", (64, 64))
    w2 = g.input("w2", "c d", (64, 4))
    w3 = g.input("w3", "d e", (4, 64))
    w4 = g.input("w4", "e f", (64, 64))
    h1 = g.einsum("b a, a c -> b c", x, w1)
    h2 = g.einsum("b c, c d -> b d", h1, w2)   # the waist: (8, 4)
    h3 = g.einsum("b d, d e -> b e", h2, w3)
    h4 = g.einsum("b e, e f -> b f", h3, w4)
    return g, [h1, h2, h3, h4]


def _layered_graph(n_layers=4, G=EinGraph):
    """n structurally identical einsum layers — repeated-stage dedup."""
    g = G("layers")
    h = g.input("x", "b a", (8, 32))
    for i in range(n_layers):
        w = g.input(f"w{i}", "a c", (32, 32))
        h = g.einsum("b a, a c -> b a", h, w)
    return g


def _relay_graph(G=EinGraph):
    g = G("relay")
    x = g.input("x", "b a", (8, 8))
    a = g.map("relu", x, name="a")
    b = g.map("relu", a, name="b")
    c = g.einsum("b a, b a -> b a", a, b)  # consumes stage-0's a at stage 2
    return g, (a, b, c)


def _random_batched_graph(rng, G=EinGraph):
    """Random einsum chain where every node keeps the batch label ``b``."""
    pool = ["i", "j", "k"]
    g = G("rand")
    nl = int(rng.integers(1, 3))
    labels = ["b"] + list(rng.choice(pool, size=nl, replace=False))
    h = g.input("x", labels, [8] * len(labels))
    nodes = [h]
    for t in range(int(rng.integers(2, 5))):
        la = g.nodes[nodes[-1]].labels
        nl = int(rng.integers(1, 3))
        wl = list(rng.choice(pool, size=nl, replace=False))
        w = g.input(f"w{t}", wl, [8] * nl)
        union = list(dict.fromkeys(list(la) + wl))
        keep = ["b"] + [l for l in union
                        if l != "b" and rng.random() < 0.6]
        expr = f"{' '.join(la)}, {' '.join(wl)} -> {' '.join(keep)}"
        nodes.append(g.einsum(expr, nodes[-1], w))
        if rng.random() < 0.3:
            nodes.append(g.map("relu", nodes[-1]))
    return g


ZOO_CASES = [f"{a}/{ph}" for a in FAMILIES for ph in ("prefill", "decode")]
GRAPHS = ["waist", "layers", "relay"] + [f"rand{i}" for i in range(6)] + ZOO_CASES


def build_graph(name, pkg):
    """The named graph through ``pkg`` ("port" or "ref")."""
    G = EinGraph if pkg == "port" else RefGraph
    if name == "waist":
        return _waist_graph(G)[0]
    if name == "layers":
        return _layered_graph(4, G)
    if name == "relay":
        return _relay_graph(G)[0]
    if name.startswith("rand"):
        return _random_batched_graph(np.random.default_rng(int(name[4:])), G)
    arch, phase = name.split("/")
    if pkg == "port":
        return program_for(reduced(get_config(arch)),
                           ShapeConfig("eq", phase, 8, 4)).graph
    return ref_program_for(ref_reduced(ref_get_config(arch)),
                           RefShape("eq", phase, 8, 4)).graph


# ---------------------------------------------------------------------------
# 1. pure equality with the reference
# ---------------------------------------------------------------------------


def _sched_record(s) -> dict:
    return {
        "programs": [(p.nid, p.layout, p.arg_steps, p.post_steps, p.rule,
                      p.prefetch, p.prefetch_src) for p in s.programs],
        "layouts": s.layouts,
        "events": [dataclasses.astuple(e) for e in s.trace.events],
        "rule_by_node": s.trace.rule_by_node,
        "prefetches": [dataclasses.astuple(pf) for pf in s.prefetches],
        "sizes": s.sizes,
    }


def _psched_record(ps) -> dict:
    """Everything a PipelineSchedule decides, as plain data."""
    return {
        "stages": [{"index": st.index, "nids": st.nids, "recv": st.recv,
                    "key": st.key, "out_gids": st.out_gids,
                    "gid_of": sorted(st.gid_of.items()),
                    "n_nodes": len(st.graph.nodes),
                    "plan": st.plan.to_json(), "sched": _sched_record(st.sched)}
                   for st in ps.stages],
        "stitched": ps.stitched.to_json(), "stitched_cost": ps.stitched.cost,
        "cells": ps.cells, "boundaries": ps.boundaries,
        "events": [dataclasses.astuple(e) for e in ps.trace.events],
        "rule_by_node": ps.trace.rule_by_node,
        "sizes": ps.sizes, "out_ids": ps.out_ids, "cut_elems": ps.cut_elems,
        "stage_compute": ps.stage_compute, "bubble": ps.bubble,
        "bubble_weighted": ps.bubble_weighted,
        "handoff_elems": ps.handoff_elems,
        "stage_priced": [ps.stage_priced(s) for s in range(len(ps.stages))],
        "stage_trace_elems": [ps.stage_trace_elems(s)
                              for s in range(len(ps.stages))],
        "cache_stats": ps.cache_stats,
    }


def _either(fn):
    try:
        return fn()
    except ValueError as e:
        return f"ValueError: {e}"


EQ_MESH = {"data": 2, "model": 2}


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_pipeline_schedule_equals_reference(name, p, m):
    g, rg = build_graph(name, "port"), build_graph(name, "ref")
    sizes = {"pp": p, **EQ_MESH}
    got = _either(lambda: _psched_record(build_pipeline_schedule(
        g, PipelineSpec(stages=p, microbatches=m), sizes, cache=PlanCache())))
    want = _either(lambda: _psched_record(ref_build(
        rg, RefSpec(stages=p, microbatches=m), sizes, cache=RefPlanCache())))
    assert got == want
    if isinstance(got, dict):
        boundaries = [len(sum((st["nids"] for st in got["stages"][:k + 1]), []))
                      for k in range(p - 1)]
        assert cut_tensors(g, boundaries) == ref_cut_tensors(rg, boundaries)
        assert cut_tensors(g, boundaries) == got["boundaries"]


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_scale_and_splittable_equal_reference(name, m):
    g, rg = build_graph(name, "port"), build_graph(name, "ref")
    assert batch_splittable(g, "b") == ref_batch_splittable(rg, "b")
    got = _either(lambda: [(n.name, n.labels, n.shape)
                           for n in scale_graph_batch(g, m, "b").nodes])
    want = _either(lambda: [(n.name, n.labels, n.shape)
                            for n in ref_scale(rg, m, "b").nodes])
    assert got == want


# ---------------------------------------------------------------------------
# the reference tests' own checks, on the port
# ---------------------------------------------------------------------------


def test_partition_p1_identity():
    g, _ = _waist_graph()
    stages = partition_stages(g, PipelineSpec(stages=1, microbatches=1))
    assert len(stages) == 1 and stages[0].graph is g
    assert stages[0].recv == []


def test_partition_cuts_at_the_waist():
    g, (h1, h2, h3, h4) = _waist_graph()
    stages = partition_stages(g, PipelineSpec(stages=2))
    assert [st.nids for st in stages] == [[h1, h2], [h3, h4]]
    assert stages[1].recv == [h2]


def test_partition_stages_contiguous_and_closed():
    g, _ = _waist_graph()
    stages = partition_stages(g, PipelineSpec(stages=3))
    seq = [nid for nid in g.topo_order() if g.nodes[nid].kind != "input"]
    assert [nid for st in stages for nid in st.nids] == seq
    stage_of = {gn: st.index for st in stages for gn in st.nids}
    for st in stages:
        assert st.nids, "empty stage"
        for gn in st.recv:
            assert stage_of[gn] < st.index


def test_partition_too_many_stages_raises():
    g, _ = _waist_graph()
    with pytest.raises(ValueError, match="stages"):
        partition_stages(g, PipelineSpec(stages=5))


def test_multi_hop_tensor_lives_on_every_boundary():
    g, (a, b, c) = _relay_graph()
    psc = build_pipeline_schedule(g, PipelineSpec(stages=3), {"pp": 3})
    assert [st.nids for st in psc.stages] == [[a], [b], [c]]
    assert psc.boundaries == [[a], [a, b]]
    relayed = [e.nid for e in psc.trace.events if e.rule == "handoff"]
    assert relayed.count(a) == 2 and relayed.count(b) == 1


def test_scale_graph_batch():
    g, _ = _waist_graph()
    gm = scale_graph_batch(g, 4, "b")
    assert gm.nodes[0].shape == (2, 64)
    assert gm.nodes[1].shape == (64, 64)
    assert scale_graph_batch(g, 1, "b") is g
    with pytest.raises(ValueError, match="divisible"):
        scale_graph_batch(g, 3, "b")


def test_moe_batch_coupling_rejected():
    moe = program_for(reduced(get_config("mixtral-8x7b")),
                      ShapeConfig("eq", "prefill", 8, 2)).graph
    dense = program_for(reduced(get_config("llama-7b")),
                        ShapeConfig("eq", "prefill", 8, 2)).graph
    assert not batch_splittable(moe, "b")
    assert batch_splittable(dense, "b")
    with pytest.raises(ValueError, match="couples rows"):
        partition_stages(moe, PipelineSpec(stages=2, microbatches=2))


def test_repeated_stages_hash_equal_and_hit_warm():
    cache = PlanCache()
    psc = build_pipeline_schedule(_layered_graph(4), PipelineSpec(stages=2),
                                  {"pp": 2, "data": 2}, cache=cache)
    assert psc.stages[0].key == psc.stages[1].key
    assert psc.cache_stats["misses"] == 1
    assert psc.cache_stats["hits"] == 1


def test_p1_reproduces_serial_schedule_verbatim():
    g = _layered_graph(3)
    axes = {"data": 2, "model": 2}
    psc = build_pipeline_schedule(g, PipelineSpec(stages=1), {"pp": 1, **axes})
    direct = spmd.build_schedule(
        g, eindecomp(g, 4, mesh_axes=axes, offpath_repart=True), axes,
        g.outputs())
    st = psc.stages[0]
    assert st.graph is g
    assert st.sched.programs == direct.programs
    assert st.sched.layouts == direct.layouts
    assert st.sched.trace.events == direct.trace.events
    assert len(psc.trace.events) == len(direct.trace.events)
    assert all(e.stage == 0 and e.microbatch == 0 for e in psc.trace.events)


def test_gpipe_cell_order():
    psc = build_pipeline_schedule(_layered_graph(4),
                                  PipelineSpec(stages=2, microbatches=4),
                                  {"pp": 2})
    assert psc.cells == [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1),
                         (0, 3), (1, 2), (1, 3)]
    assert psc.bubble == bubble_fraction(2, 4) == pytest.approx(1 / 5)


def test_bubble_fraction_static_and_weighted():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 1) == pytest.approx(3 / 4)
    assert bubble_fraction(2, 7) == pytest.approx(1 / 8)
    for p, m in [(2, 4), (3, 5), (4, 1)]:
        assert bubble_fraction_weighted([100] * p, m) == \
            pytest.approx(bubble_fraction(p, m))
    assert bubble_fraction_weighted([100, 300], 4) > bubble_fraction(2, 4)
    assert bubble_fraction_weighted([0, 0], 4) == 0.0


def test_trace_attribution_and_handoff_tagging():
    psc = build_pipeline_schedule(_layered_graph(4),
                                  PipelineSpec(stages=2, microbatches=2),
                                  {"pp": 2, "data": 2})
    assert psc.trace.events
    for e in psc.trace.events:
        assert 0 <= e.stage < 2 and 0 <= e.microbatch < 2
    handoffs = [e for e in psc.trace.events if e.rule == "handoff"]
    assert len(handoffs) == 2
    for e in handoffs:
        assert e.kind == "ppermute" and e.axes == ("pp",)
        assert sorted(e.perm) == [(0, 1), (1, 0)]
    idx = {id(e): i for i, e in enumerate(psc.trace.events)}
    for h in handoffs:
        for e in psc.trace.events:
            if (e.stage, e.microbatch) == (h.stage, h.microbatch) \
                    and e.rule != "handoff":
                assert idx[id(e)] < idx[id(h)]


@pytest.mark.parametrize("m", [1, 4])
def test_zero_handoff_collectives_on_size1_pp_axis(m):
    psc = build_pipeline_schedule(
        _layered_graph(4), PipelineSpec(stages=1, microbatches=m),
        {"pp": 1, "data": 2})
    assert psc.handoff_elems == 0
    assert all(e.rule != "handoff" for e in psc.trace.events)
    assert all("pp" not in e.axes for e in psc.trace.events)
    assert psc.bubble == 0.0
    want = ref_build(_layered_graph(4, RefGraph), RefSpec(stages=1, microbatches=m),
                     {"pp": 1, "data": 2})
    assert _psched_record(psc) == _psched_record(want)


def test_mesh_axis_size_must_match_stages():
    with pytest.raises(ValueError, match="must agree"):
        build_pipeline_schedule(_layered_graph(4), PipelineSpec(stages=2),
                                {"pp": 1})


def test_stage_traced_within_priced():
    psc = build_pipeline_schedule(_layered_graph(4),
                                  PipelineSpec(stages=2, microbatches=2),
                                  {"pp": 2, "data": 2, "model": 2})
    for s in range(2):
        assert psc.stage_trace_elems(s) <= psc.stage_priced(s)


def test_compile_pipeline_api_guards():
    g = _layered_graph(2)
    prog = ein.Program.from_graph(g, {"y": g.outputs()[-1]})
    spec = PipelineSpec(stages=1)
    mesh = Mesh({"pp": 1}, device="cpu")
    with pytest.raises(ValueError, match="shard_map"):
        prog.compile(p=2, pipeline=spec)
    with pytest.raises(ValueError, match="donate"):
        prog.compile(mesh=mesh, executor="shard_map", pipeline=spec,
                     donate=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        prog.compile(mesh=mesh, executor="shard_map", pipeline=spec,
                     plan=object())
    with pytest.raises(ValueError):
        PipelineSpec(stages=0)
    with pytest.raises(ValueError):
        PipelineSpec(microbatches=0)


def test_cpu_blas_one_row_product_changes_bits():
    """One reason ``CPU_ORDER_CASES`` are held to a tolerance: the decode
    graphs' q projection (b s a, a h d) at the reduced width, on two rows
    and on the first of them alone, through the port's plain matmul on the
    CPU.  The one-row product sums in another order (BLAS's gemv path), so
    its bits differ from row 0 of the two-row product — outside any
    pipeline."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(2, 64)) * 0.05).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 64)) * 0.05).astype(np.float32))
    two, one = ops.matmul(x, w), ops.matmul(x[:1], w)
    np.testing.assert_allclose(one.numpy(), two[:1].numpy(), rtol=1e-6, atol=1e-7)
    assert not torch.equal(one, two[:1])


# ---------------------------------------------------------------------------
# 2. execution on gloo CPU ranks (one spawn per mesh shape)
# ---------------------------------------------------------------------------

# case name -> (mesh sizes, p, m); the chain grid, the random graphs (p = 2
# where there are two nodes to cut, m = 2 where the batch splits) and the
# zoo on the 2x2x2 mesh at m = 2 (mixtral at m = 1: capacity routing
# couples rows), and at m = 1 too
RUN_CASES: dict[str, tuple[dict, int, int]] = {}
for _p, _m in [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4)]:
    RUN_CASES[f"chain_p{_p}m{_m}"] = ({"pp": _p, "data": 2}, _p, _m)
for _i in range(6):
    _g = _random_batched_graph(np.random.default_rng(_i))
    _p = 2 if sum(1 for n in _g.nodes if n.kind != "input") >= 2 else 1
    _m = 2 if batch_splittable(_g, "b") else 1
    RUN_CASES[f"rand{_i}"] = ({"pp": _p, "data": 2}, _p, _m)
ZOO_MESH = {"pp": 2, "data": 2, "model": 2}
for _c in ZOO_CASES:
    RUN_CASES[_c] = (ZOO_MESH, 2, 1 if _c.startswith("mixtral") else 2)
    if not _c.startswith("mixtral"):
        RUN_CASES[f"{_c}/m1"] = (ZOO_MESH, 2, 1)

# the microbatched zoo cases: some elements summed in another order than the
# unpipelined run's, by MKL's one-row path and by gloo's size-dependent
# all-reduce order (see the module doc), held to 1e-6
CPU_ORDER_CASES = {c for c in ZOO_CASES if not c.startswith("mixtral")}


def _mesh_key(sizes: dict) -> str:
    return "x".join(f"{a}{s}" for a, s in sizes.items())


MESH_SHAPES = {_mesh_key(s): s for s, _, _ in RUN_CASES.values()}


def _run_graph(name, pkg="port"):
    """(graph, output ids, vocab or None) of a run case, through ``pkg``
    ("port" or "ref")."""
    G = EinGraph if pkg == "port" else RefGraph
    if name.startswith("chain"):
        g = _layered_graph(4, G)
        return g, [g.outputs()[-1]], None
    if name.startswith("rand"):
        g = _random_batched_graph(np.random.default_rng(int(name[4:])), G)
        return g, g.outputs(), None
    arch, phase = name.split("/")[:2]
    if pkg == "port":
        cfg = reduced(get_config(arch))
        prog = program_for(cfg, ShapeConfig("eq", phase, 8, 2))
    else:
        cfg = ref_reduced(ref_get_config(arch))
        prog = ref_program_for(cfg, RefShape("eq", phase, 8, 2))
    return prog.graph, [prog._out["logits"]], cfg.vocab


def _run_feeds(g, name, vocab):
    rng = np.random.default_rng(sorted(RUN_CASES).index(name))
    feeds = {}
    for n in g.nodes:
        if n.kind != "input":
            continue
        if str(np.dtype(n.dtype)) == "int32":
            feeds[n.name] = rng.integers(0, vocab or 4, size=n.shape).astype(np.int32)
        else:
            scale = 1.0 if vocab is None else 0.05
            feeds[n.name] = (rng.normal(size=n.shape) * scale).astype(np.float32)
    return feeds


def _events(trace):
    return sorted((e.nid, e.kind, e.axes, e.elems) for e in trace.events)


def pipeline_rank(rank, world, mesh_key):
    """Every run case of one mesh shape on this rank: {name: {"out",
    "base", "dense", "issued", "trace", "handoff_elems", "bubble",
    "surface"}}."""
    sizes = MESH_SHAPES[mesh_key]
    mesh = Mesh(sizes, device="cpu")
    results = {}
    for name, (case_sizes, p, m) in RUN_CASES.items():
        if case_sizes != sizes:
            continue
        g, outs, vocab = _run_graph(name)
        make_stub_opaques(capacity_of(g))
        prog = ein.Program.from_graph(g, {f"out{i}": o for i, o in enumerate(outs)})
        run = prog.compile(mesh=mesh, executor="shard_map",
                           pipeline=PipelineSpec(stages=p, microbatches=m))
        psc = run.pipeline_schedule
        base = prog.compile(mesh=mesh, executor="shard_map", plan=psc.stitched)
        feeds = _run_feeds(g, name, vocab)
        got = run(feeds)
        dense = engine.run(g, {g.nodes[i].name: feeds[g.nodes[i].name]
                               for i in g.input_ids()})
        results[name] = {
            "out": [got[k].numpy() for k in got],
            "base": [v.numpy() for v in base(feeds).values()],
            "dense": [dense[o].numpy() for o in outs],
            "issued": sorted(run._fn.issued), "trace": _events(run.collectives),
            "handoff_elems": psc.handoff_elems, "bubble": psc.bubble,
            "priced": [(psc.stage_trace_elems(s), psc.stage_priced(s))
                       for s in range(p)],
            "surface": (run.collectives is psc.trace, run.plan is psc.stitched,
                        run.plan.mode, run.plan.p, math.prod(psc.sizes.values()),
                        run.donate_argnums),
        }
    if sizes == ZOO_MESH:  # one psum over (data, model), at two sizes
        import torch.distributed as dist

        rng = np.random.default_rng(100 + rank)
        full = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
        half = full[:2048].clone()
        for buf in (full, half):
            dist.all_reduce(buf, group=mesh.group(("data", "model")))
        results["psum"] = (full[:2048].numpy(), half.numpy())
    return results


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """mesh key -> every rank's ``pipeline_rank`` results (spawned once)."""
    cache = {}

    def get(mesh_key):
        if mesh_key not in cache:
            sizes = MESH_SHAPES[mesh_key]
            cache[mesh_key] = spawn(math.prod(sizes.values()), pipeline_rank,
                                    mesh_key, tmpdir=tmp_path_factory.mktemp(
                                        re.sub(r"\W", "_", mesh_key)))
        return cache[mesh_key]

    return get


@pytest.mark.parametrize("name", list(RUN_CASES))
def test_gloo_pipelined_equals_stitched_compile(name, gloo):
    sizes, p, m = RUN_CASES[name]
    ranks = gloo(_mesh_key(sizes))
    r0 = ranks[0][name]
    for r, rank in enumerate(ranks):
        res = rank[name]
        for got, base, want0 in zip(res["out"], res["base"], r0["out"]):
            if name in CPU_ORDER_CASES:
                np.testing.assert_allclose(got, base, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, base, err_msg=f"rank {r}")
            np.testing.assert_array_equal(got, want0, err_msg=f"rank {r}")
        tol = 1e-4 if "/" in name else 1e-5
        for got, dense in zip(res["out"], res["dense"]):
            np.testing.assert_allclose(got, dense, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(RUN_CASES))
def test_gloo_pipelined_equals_reference(name, gloo, monkeypatch):
    """Every rank's pipelined outputs against the reference's dense run
    (``repro.core.engine.run``) of the reference's graph of the same case
    on the same feeds, with the reference's opaque stand-ins.  Tolerance
    ``tol`` x max|reference|, tol = 1e-5 on the small graphs and 1e-4 on
    the model graphs: the chain's outputs reach some hundreds, where XLA's
    and torch's float32 sums differ in their last bits, and the reduced
    models' logits stay below 0.1."""
    g, _, vocab = _run_graph(name)
    rg, routs, _ = _run_graph(name, "ref")
    feeds = _run_feeds(g, name, vocab)
    assert [rg.nodes[i].name for i in rg.input_ids()] == \
        [g.nodes[i].name for i in g.input_ids()]
    for kind, fn in ref_stub_opaques(ref_capacity_of(rg), register=False).items():
        monkeypatch.setitem(ref_engine.OPAQUE_FNS, kind, fn)
    vals = ref_engine.run(rg, feeds)
    want = [np.asarray(vals[o]) for o in routs]
    tol = 1e-4 if "/" in name else 1e-5
    sizes, _, _ = RUN_CASES[name]
    for r, rank in enumerate(gloo(_mesh_key(sizes))):
        got = rank[name]["out"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=tol,
                                       atol=tol * float(np.abs(b).max()),
                                       err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(RUN_CASES))
def test_gloo_issued_collectives_equal_static_trace(name, gloo):
    sizes, p, m = RUN_CASES[name]
    for rank in gloo(_mesh_key(sizes)):
        res = rank[name]
        assert res["issued"] == res["trace"]
        handoffs = [e for e in res["issued"] if "pp" in e[2]]
        assert all(e[1] == "ppermute" and e[2] == ("pp",) for e in handoffs)
        assert sum(e[3] for e in handoffs) == res["handoff_elems"]
        assert (res["handoff_elems"] > 0) == (p > 1)
        assert res["bubble"] == bubble_fraction(p, m)
        for traced, priced in res["priced"]:
            assert traced <= priced


def test_compiled_pipeline_surface(gloo):
    """.pipeline_schedule, .collectives (= the combined tagged trace) and
    .plan (= the stitched baseline plan) are all exposed."""
    sizes, _, _ = RUN_CASES["chain_p2m2"]
    for rank in gloo(_mesh_key(sizes)):
        assert rank["chain_p2m2"]["surface"] == (True, True, "mesh", 2, 4, ())


def test_cpu_gloo_psum_order_depends_on_size(gloo):
    """The other reason ``CPU_ORDER_CASES`` are held to a tolerance: one
    all-reduce over the 4 ranks of (data, model) on the zoo mesh, of a
    4096-element buffer and of its first 2048 elements alone.  gloo sums
    each element in an order set by the buffer's size, so the half's bits
    differ from the full buffer's first half — outside any pipeline."""
    for rank in gloo(_mesh_key(ZOO_MESH)):
        full, half = rank["psum"]
        np.testing.assert_allclose(half, full, rtol=1e-6, atol=1e-6)
        assert not np.array_equal(half, full)
