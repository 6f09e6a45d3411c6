"""The port's planner against the reference: equal keys, plans and costs.

The IR, the §8 DP, the canonical keys and the plan cache are pure Python
in both packages, so every comparison here is exact equality: the same
graph built through each package gives the same ``canon.graph_key``, the
same ``Plan.to_json()``, the same cost and the same policy, and a plan-cache
store written by one package loads as hits in the other.
"""
import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, SHAPES, get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core import canon as ref_canon  # noqa: E402
from repro.core import opdef as ref_opdef  # noqa: E402
from repro.core.decomp import eindecomp as ref_eindecomp  # noqa: E402
from repro.core.einsum import EinGraph as RefGraph  # noqa: E402
from repro.core.einsum import eval_graph_dense as ref_eval_dense  # noqa: E402
from repro.core.plancache import PlanCache as RefCache  # noqa: E402
from repro.models.eingraphs import program_for as ref_program_for  # noqa: E402
from repro.models.policy import policy_from_plan as ref_policy  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import canon, opaque_rules, opdef  # noqa: E402
from repro_torch.core.decomp import eindecomp  # noqa: E402
from repro_torch.core.einsum import EinGraph, eval_graph_dense  # noqa: E402
from repro_torch.core.plancache import PlanCache  # noqa: E402
from repro_torch.models.eingraphs import program_for  # noqa: E402
from repro_torch.models.policy import policy_from_plan  # noqa: E402

MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 4}]


def _mesh_id(m):
    return "x".join(str(v) for v in m.values())


# ---------------------------------------------------------------------------
# llama-7b prefill and decode at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("kind,seq", [("prefill", 512), ("decode", 528)])
def test_llama7b_plan_matches_reference(kind, seq, mesh):
    ref_prog = ref_program_for(ref_get_config("llama-7b"),
                               RefShape("serve", kind, seq, 4))
    prog = program_for(get_config("llama-7b"), ShapeConfig("serve", kind, seq, 4))
    assert canon.graph_key(prog.graph) == ref_canon.graph_key(ref_prog.graph)
    ref_c = ref_prog.compile(mesh_axes=dict(mesh))
    c = prog.compile(mesh_axes=dict(mesh))
    assert c.plan.to_json() == ref_c.plan.to_json()
    assert c.plan.cost == ref_c.plan.cost
    assert c.policy().label_axes == ref_c.policy().label_axes
    assert c.canonical_key == ref_c.canonical_key
    lowered, ref_lowered = c.lower(), ref_c.lower()
    assert lowered.outputs == ref_lowered.outputs
    assert lowered.shardings == {nid: tuple(spec) for nid, spec
                                 in ref_lowered.shardings.items()}


# ---------------------------------------------------------------------------
# The reference tests' graphs, built through either package's EinGraph
# ---------------------------------------------------------------------------


def _chain(G, n=3, size=64):
    """tests/test_decomp.py's chain of square matmuls."""
    g = G()
    prev = g.input("A0", "ij", (size, size))
    labels = "ijklmnop"
    for t in range(n):
        w = g.input(f"W{t}", labels[t + 1] + labels[t + 2], (size, size))
        prev = g.einsum(f"{labels[t]}{labels[t+1]},{labels[t+1]}{labels[t+2]}"
                        f"->{labels[t]}{labels[t+2]}", prev, w)
    return g


def _skewed_chain(G, swap=False):
    """tests/test_plancache.py's rectangular chain (operand order swapped
    on request: commutative, so the key must not change)."""
    g = G("chain")
    a = g.input("A", ("i", "j"), (64, 128))
    b = g.input("B", ("j", "k"), (128, 64))
    c = g.input("C", ("k", "l"), (64, 32))
    ab = g.einsum("jk,ij->ik", b, a) if swap else g.einsum("ij,jk->ik", a, b)
    g.einsum("ik,kl->il", ab, c)
    return g


def _random_graph(G, seed):
    """A random DAG of binary contractions, elementwise joins, maps and
    softmax-style reductions over power-of-two bounds, made from a seed."""
    rng = np.random.default_rng(seed)
    g = G(f"rand{seed}")
    bounds = {l: int(2 ** rng.integers(4, 9)) for l in "ijklmn"}
    nodes = []
    for t in range(int(rng.integers(2, 4))):
        ls = "".join(rng.choice(list(bounds), size=2, replace=False))
        nodes.append(g.input(f"X{t}", ls, tuple(bounds[c] for c in ls)))
    for t in range(int(rng.integers(3, 7))):
        a = nodes[int(rng.integers(len(nodes)))]
        la = "".join(g.nodes[a].labels)
        op = rng.integers(4)
        if op == 0:  # contraction with a fresh weight
            free = [c for c in bounds if c not in la]
            out = la[0] + str(rng.choice(free))
            w = g.input(f"W{t}", la[1] + out[1], (bounds[la[1]], bounds[out[1]]))
            nodes.append(g.einsum(f"{la},{la[1]}{out[1]}->{out}", a, w))
        elif op == 1:  # elementwise join of two same-label nodes
            b = g.input(f"Y{t}", la, tuple(bounds[c] for c in la))
            nodes.append(g.einsum(f"{la},{la}->{la}", a, b, combine="add",
                                  agg=""))
        elif op == 2:
            nodes.append(g.map(str(rng.choice(["relu", "exp", "silu"])), a))
        else:  # max-reduce then expsub against it (softmax's E node)
            m = g.einsum(f"{la}->{la[0]}", a, agg="max")
            nodes.append(g.einsum(f"{la},{la[0]}->{la}", a, m,
                                  combine="expsub", agg=""))
    return g


def _matrix_chain(G, s, skewed):
    """benchmarks/bench_matrix_chain.py's graph (the paper's Experiment 1)."""
    g = G("chain")
    t = max(int(0.1 * s), 2)
    u = 10 * s if skewed else s
    dims = ({"A": (s, t), "B": (t, s), "C": (s, t), "D": (t, u), "E": (u, s)}
            if skewed else dict.fromkeys("ABCDE", (s, s)))
    A, B, C, D, E = (g.input(n, ls, dims[n])
                     for n, ls in zip("ABCDE", ("ij", "jk", "il", "lm", "mk")))
    AB = g.einsum("ij,jk->ik", A, B, name="AB")
    DE = g.einsum("lm,mk->lk", D, E, name="DE")
    CDE = g.einsum("il,lk->ik", C, DE, name="CDE")
    g.einsum("ik,ik->ik", AB, CDE, combine="add", agg="", name="sum")
    return g


def _ffnn_forward(G, batch, feats=65_536, hidden=8_192, labels=14_588):
    """benchmarks/bench_ffnn.py's network and loss, before autodiff (the
    gradient graph needs core/autodiff.py, a later slice of the port)."""
    g = G("ffnn")
    X = g.input("X", "bf", (batch, feats))
    W1 = g.input("W1", "fh", (feats, hidden))
    W2 = g.input("W2", "hc", (hidden, labels))
    Y = g.input("Y", "bc", (batch, labels))
    a1 = g.map("relu", g.einsum("bf,fh->bh", X, W1))
    diff = g.einsum("bc,bc->bc", g.einsum("bh,hc->bc", a1, W2), Y,
                    combine="sub", agg="")
    g.einsum("bc->", g.map("square", diff), combine="id", agg="sum")
    return g


GRAPHS = ([("chain", n) for n in (2, 3, 4)]
          + [("skewed", s) for s in (False, True)]
          + [("random", s) for s in range(8)]
          + [("mchain", (s, k)) for s in (256, 4096) for k in (False, True)]
          + [("ffnn", b) for b in (128, 512)])


def _build(G, which, arg):
    if which == "chain":
        return _chain(G, n=arg)
    if which == "skewed":
        return _skewed_chain(G, swap=arg)
    if which == "mchain":
        return _matrix_chain(G, *arg)
    if which == "ffnn":
        return _ffnn_forward(G, arg)
    return _random_graph(G, arg)


@pytest.mark.parametrize("which,arg", GRAPHS)
@pytest.mark.parametrize("plan_kw", [{"p": 16}, {"p": 8, "mesh_axes": {"data": 2, "model": 4}}],
                         ids=["pow2", "mesh"])
def test_graph_plans_match_reference(which, arg, plan_kw):
    g, rg = _build(EinGraph, which, arg), _build(RefGraph, which, arg)
    assert canon.graph_key(g) == ref_canon.graph_key(rg)
    plan = eindecomp(g, **plan_kw)
    ref_plan = ref_eindecomp(rg, **plan_kw)
    assert plan.to_json() == ref_plan.to_json()
    assert plan.cost == ref_plan.cost
    if "mesh_axes" in plan_kw:
        assert (policy_from_plan(plan, g).label_axes
                == ref_policy(ref_plan, rg).label_axes)


ZOO = ["llama-7b"] + list(ARCH_IDS)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_keys_and_plans_match_reference(arch):
    """Every config's declared model graph (opaque ops included) keys and
    plans identically, which also exercises the copied config files."""
    shape = SHAPES["prefill_32k"]
    prog = program_for(get_config(arch), ShapeConfig(shape.name, shape.kind,
                                                     shape.seq, shape.batch))
    ref_prog = ref_program_for(ref_get_config(arch), shape)
    assert canon.graph_key(prog.graph) == ref_canon.graph_key(ref_prog.graph)
    mesh = {"data": 2, "model": 2}
    plan = prog.compile(mesh_axes=mesh).plan
    ref_plan = ref_prog.compile(mesh_axes=mesh).plan
    assert plan.to_json() == ref_plan.to_json()


# ---------------------------------------------------------------------------
# One plan-cache store, either package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plan_cache_store_crosses_packages(writer, tmp_path):
    path = str(tmp_path / "plans.json")
    cells = [("prefill", 512), ("decode", 528)]
    mesh = {"data": 2, "model": 4}
    W, R = (RefCache, PlanCache) if writer == "reference" else (PlanCache, RefCache)
    wprog, rprog = ((ref_program_for, program_for) if writer == "reference"
                    else (program_for, ref_program_for))
    wcfg, rcfg = ((ref_get_config, get_config) if writer == "reference"
                  else (get_config, ref_get_config))
    wshape, rshape = ((RefShape, ShapeConfig) if writer == "reference"
                      else (ShapeConfig, RefShape))

    wcache = W.open(path)
    written = [wprog(wcfg("llama-7b"), wshape("s", k, s, 4)).compile(
        mesh_axes=mesh, cache=wcache).plan for k, s in cells]
    assert wcache.stats["misses"] == 2 and wcache.stats["hits"] == 0
    assert len(json.load(open(path))["entries"]) == 2

    rcache = R.open(path)
    read = [rprog(rcfg("llama-7b"), rshape("s", k, s, 4)).compile(
        mesh_axes=mesh, cache=rcache).plan for k, s in cells]
    assert rcache.stats["hits"] == 2 and rcache.stats["misses"] == 0
    for a, b in zip(written, read):
        assert a.to_json() == b.to_json()


# ---------------------------------------------------------------------------
# The op registry: builtin map impls, shard-rule names, dense evaluation
# ---------------------------------------------------------------------------

MAP_KINDS = sorted(ref_opdef.list_ops("map"))


def test_builtin_catalog_matches_reference():
    assert opdef.list_ops() == ref_opdef.list_ops()
    assert len(MAP_KINDS) == 26
    for kind in opdef.list_ops():
        od, ref_od = opdef.get(kind), ref_opdef.get(kind)
        assert (od.signature, od.grad, od.comm, od.shard_rule, od.shardable,
                od.param_bounds, od.vjp) == (
            ref_od.signature, ref_od.grad, ref_od.comm, ref_od.shard_rule,
            ref_od.shardable, ref_od.param_bounds, ref_od.vjp), kind
    assert sorted(opaque_rules.RULES) == sorted(
        ["replicate", "local", "ring", "a2a", "paged"])


@pytest.mark.parametrize("kind", MAP_KINDS)
def test_builtin_map_impl_matches_reference(kind):
    x = np.random.default_rng(7).normal(size=(4, 6)).astype(np.float32)
    if kind in ("rsqrt_eps", "rsqrt_eps_grad"):
        x = np.abs(x) + 0.1
    got = opdef.executable(kind)(x)
    want = ref_opdef.executable(kind)(x)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)


def test_unported_lowering_and_vjp_raise():
    """What runs now (the ring and a2a rules lower; a program runs; the
    derived VJPs build and execute, since the autodiff slice; donate=
    compiles, since the engine-on-a-mesh slice, with the reference's
    ``donate_argnums``) and what still raises: pipeline= without its
    executor and mesh, and a donation of an unknown input."""
    g = program_for(get_config("llama-7b"), ShapeConfig("s", "prefill", 64, 1)).graph
    attn = next(n for n in g.nodes if n.op == "flash_attention")
    assert opaque_rules.resolve_rule_name(attn) == "ring"
    low = opaque_rules.get_rule("ring").lower(g, attn, {}, {})
    assert low.events == [] and low.out_layout == ((), (), (), ())
    q, k, v, ct = (torch.randn(1, 2, 8, 4, dtype=torch.float64) for _ in range(4))
    want = torch.func.vjp(lambda q: opdef.require("flash_attention").fn(q, k, v),
                          q)[1](ct)[0]
    torch.testing.assert_close(opdef.executable("flash_attention@vjp0")(q, k, v, ct),
                               want, rtol=1e-12, atol=1e-12)
    gg = copy.deepcopy(g)
    derived = opdef.build_vjp(gg, gg.nodes[attn.nid], attn.nid)
    assert [gg.nodes[d].op for d in derived] == [
        f"flash_attention@vjp{i}" for i in range(3)]
    mg = EinGraph("moe")
    x = mg.input("x", "b s a", (2, 8, 4))
    route = mg.input("route", "b s e", (2, 8, 4))
    disp = mg.opaque("moe_dispatch", [x, route], "e c a", (4, 4, 4),
                     in_labels=[("b", "s", "a"), ("b", "s", "e")],
                     shardable={"e", "c", "b", "s"},
                     comm=[{"kind": "a2a", "label": "e", "input": 0}])
    low = opaque_rules.get_rule("a2a").lower(mg, mg.nodes[disp],
                                            {"e": ("model",)}, {"model": 2})
    assert [ev[0] for ev in low.events] == ["all_gather", "all_to_all", "all_to_all"]
    assert low.arg_layouts == [((), ("model",), ()), ((), ("model",), ())]
    assert low.out_layout == (("model",), (), ()) and callable(low.run)
    prog = program_for(get_config("llama-7b"), ShapeConfig("s", "prefill", 64, 1))
    with pytest.raises(ValueError, match="missing feeds"):
        prog.compile(p=1)({})
    with pytest.raises(ValueError, match="needs a mesh"):
        prog.compile(p=1, executor="shard_map")
    with pytest.raises(ValueError, match="executor='shard_map' and a mesh"):
        prog.compile(p=1, pipeline=object())  # the reference's guard
    ref_prog = ref_program_for(ref_get_config("llama-7b"), RefShape("s", "prefill", 64, 1))
    names = sorted(n.name for n in g.nodes if n.kind == "input")
    for donate in (True, names[:2], [names[-1]], False):
        got = prog.compile(p=1, donate=donate).donate_argnums
        assert got == ref_prog.compile(p=1, donate=donate).donate_argnums, donate
        assert len(got) == (len(names) if donate is True else len(donate or ()))
    for compile_ in (prog.compile, ref_prog.compile):
        with pytest.raises(KeyError, match="unknown inputs"):
            compile_(p=1, donate=["tokens", "no_such_input"])


def test_eval_graph_dense_matches_reference():
    """The numpy oracle runs map nodes through each package's registry."""
    g, rg = _random_graph(EinGraph, 3), _random_graph(RefGraph, 3)
    rng = np.random.default_rng(0)
    feeds = {n.nid: rng.normal(size=n.shape).astype(np.float32) * 0.1
             for n in g.nodes if n.kind == "input"}
    got, want = eval_graph_dense(g, feeds), ref_eval_dense(rg, feeds)
    for nid in want:
        np.testing.assert_allclose(got[nid], want[nid], rtol=1e-5, atol=1e-6)
