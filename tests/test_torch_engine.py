"""The port's dense engine and its runners against the reference.

``engine.run`` evaluates an EinGraph node by node with torch; the reference
does the same with jnp.  The same seeded numpy feeds go to both and every
node's value is compared in float32 at rtol = atol = 1e-5 (the two sum in
different orders).  Opaque ops the port does not run yet (the recurrent
scans) get the reference test suite's stand-in on both sides.

Then the wiring: ``make_runner`` and ``Program.compile`` build the dense
runner and the shard_map runner on a one-rank CPU mesh, the gspmd
(DTensor) runner on a mesh of more than one rank, raise for what they
cannot run, and run on the card unless ``device="cpu"`` is asked for.
"""
import itertools
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core.einsum import EinGraph as RefGraph  # noqa: E402
from repro.models.opaque_stubs import capacity_of, make_stub_opaques  # noqa: E402

from repro_torch import frontend as ein  # noqa: E402
from repro_torch.core import engine, spmd  # noqa: E402
from repro_torch.core.decomp import eindecomp  # noqa: E402
from repro_torch.core.einsum import EinGraph  # noqa: E402
from repro_torch.core.plancache import PlanCache  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

from repro_torch.models.opaque_stubs import cumnorm  # noqa: E402

from test_torch_spmd import SCAN_OPS, build_case, case_feeds  # noqa: E402

TOL = 1e-5
CASES = (["mlp", "softmax", "aggs", "ring_w0", "ring_w8"]
         + [f"rand{i}" for i in range(8)]
         + ["llama-7b", "xlstm-125m", "hymba-1.5b"])


@pytest.fixture
def stub_scans(monkeypatch):
    """Both packages' scan stand-ins for the test's lifetime."""
    for op in SCAN_OPS:
        monkeypatch.setitem(engine.OPAQUE_FNS, op, cumnorm)

    def ref_side(rg):
        for kind, fn in make_stub_opaques(capacity_of(rg), register=False).items():
            monkeypatch.setitem(ref_engine.OPAQUE_FNS, kind, fn)

    return ref_side


@pytest.mark.parametrize("name", CASES)
def test_engine_run_matches_reference(name, stub_scans):
    g, outs, _ = build_case(name, "port")
    rg, routs, _ = build_case(name, "ref")
    stub_scans(rg)
    feeds = case_feeds(g, name)
    got = engine.run(g, feeds)
    want = ref_engine.run(rg, case_feeds(rg, name))
    assert set(got) == set(want) and outs == routs
    for nid in sorted(got):
        assert got[nid].shape == tuple(want[nid].shape), nid
        np.testing.assert_allclose(got[nid].numpy(), np.asarray(want[nid]),
                                   rtol=TOL, atol=TOL, err_msg=f"node {nid}")


COMBINE_AGG = ([(c, a) for c in engine._COMBINE2 for a in ("sum", "max")]
               + [(c, a) for c in engine._COMBINE1 for a in engine._AGG])


@pytest.mark.parametrize("combine,agg", COMBINE_AGG)
def test_lower_einsum_matches_reference(combine, agg):
    """Every (⊗, ⊕) pair of the lowering tables: broadcast + reduce."""
    rng = np.random.default_rng(7)
    x = (1 + 0.1 * rng.normal(size=(4, 6))).astype(np.float32)
    y = (1 + 0.1 * rng.normal(size=(6, 5))).astype(np.float32)
    if combine in engine._COMBINE2:
        ins, args = "i j, j k -> k i", (x, y)
    else:
        ins, args = "i j -> i", (x,)
    nodes = []
    for G in (EinGraph, RefGraph):
        g = G("one")
        ids = [g.input(f"a{t}", lab, a.shape)
               for t, (lab, a) in enumerate(zip(("i j", "j k"), args))]
        nodes.append(g.nodes[g.einsum(ins, *ids, combine=combine, agg=agg)].spec)
    got = engine.lower_einsum(nodes[0], *(torch.from_numpy(a) for a in args))
    want = ref_engine.lower_einsum(nodes[1], *(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_run_with_keep_drops_every_other_value():
    g, outs, _ = build_case("mlp", "port")
    feeds = case_feeds(g, "mlp")
    full = engine.run(g, feeds)
    kept = engine.run(g, feeds, keep=set(outs))
    assert set(kept) == set(outs)
    torch.testing.assert_close(kept[outs[0]], full[outs[0]], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# make_runner / Program.compile
# ---------------------------------------------------------------------------


def _hand_plan(g, axes):
    from repro_torch.core.decomp import Plan

    plan = Plan(p=4, mode="mesh")
    plan.axes_by_node = {n.nid: dict(axes) for n in g.nodes}
    return plan


def _mlp_program():
    x = ein.tensor("x", "b a", (8, 16))
    w = ein.tensor("w", "a f", (16, 32))
    return ein.Program({"y": ein.einsum("b a, a f -> b f", x, w).map("relu")})


def _mlp_feeds():
    rng = np.random.default_rng(3)
    return {"x": rng.normal(size=(8, 16)).astype(np.float32),
            "w": rng.normal(size=(16, 32)).astype(np.float32)}


def test_make_runner_dense_and_one_rank_shard_map_agree():
    g, outs, _ = build_case("mlp", "port")
    feeds = case_feeds(g, "mlp")
    args = [feeds[i] for i in g.input_ids()]
    dense = engine.make_runner(g, outs, device="cpu")(*args)
    mesh = Mesh({"data": 1, "model": 1}, device="cpu")
    tr = spmd.CollectiveTrace()
    f = engine.make_runner(g, outs, mesh=mesh, executor="shard_map",
                           collective_trace=tr)
    got = f(*args)
    assert len(tr) == 0 and f.runner.issued == []  # one rank: nothing moves
    torch.testing.assert_close(got, dense, rtol=TOL, atol=TOL)
    torch.testing.assert_close(dense, engine.run(g, feeds)[outs[0]], rtol=0, atol=0)


def test_make_runner_rejects_what_it_cannot_run():
    g, outs, _ = build_case("mlp", "port")
    with pytest.raises(ValueError, match="unknown executor"):
        engine.make_runner(g, outs, executor="mpi")
    with pytest.raises(ValueError, match="collective_trace"):
        engine.make_runner(g, outs, collective_trace=spmd.CollectiveTrace())
    with pytest.raises(ValueError, match="shard_map"):
        engine.make_runner(g, outs, executor="shard_map")
    mesh = Mesh({"data": 1, "model": 1}, device="cpu")
    with pytest.raises(ValueError, match="mesh-mode"):
        engine.make_runner(g, outs, plan=eindecomp(g, 4), mesh=mesh,
                           executor="shard_map")
    # gspmd on a mesh of more than one rank builds the DTensor runner (a
    # bare mesh self-plans); what it runs is tests/test_torch_gspmd.py's
    two_by_two = types.SimpleNamespace(sizes={"data": 2, "model": 2})
    f = engine.make_runner(g, outs, mesh=two_by_two)
    assert [st.nid for st in f.runner.program] == [n.nid for n in g.nodes]
    assert f.runner.plan.mode == "mesh"
    compiled = _mlp_program().compile(mesh=two_by_two)
    assert compiled.collectives is None and compiled.plan.mode == "mesh"
    assert type(compiled._fn).__name__ == "GspmdRunner"
    # ...and places what it once rejected: a prod aggregation over a mesh
    # axis is a DTensor Partial("product") there (tests/test_torch_gspmd.py
    # runs it against the reference)
    pg = EinGraph("prod")
    x = pg.input("x", "i j", (4, 4))
    pg.einsum("i j -> i", x, combine="id", agg="prod")
    f = engine.make_runner(pg, mesh=two_by_two, plan=_hand_plan(pg, {"j": ("model",)}))
    assert f.runner.program[1].partial == (("model", "product"),)


@pytest.mark.parametrize("executor", engine.EXECUTORS)
def test_compiled_program_runs_name_keyed(executor, tmp_path):
    prog = _mlp_program()
    feeds = _mlp_feeds()
    want = np.maximum(feeds["x"] @ feeds["w"], 0)
    mesh = Mesh({"data": 1, "model": 1}, device="cpu")
    cache = tmp_path / "plans.json"
    kw = dict(mesh=mesh) if executor == "shard_map" else dict(device="cpu")
    run = prog.compile(executor=executor, cache=str(cache),
                       mesh_axes=dict(mesh.sizes), **kw)
    assert cache.exists()
    hit = PlanCache.coerce(str(cache))
    again = prog.compile(executor=executor, cache=hit,
                         mesh_axes=dict(mesh.sizes), **kw)
    assert hit.hits == 1 and again.plan.to_json() == run.plan.to_json()
    out = run(feeds)
    assert set(out) == {"y"} and isinstance(out["y"], torch.Tensor)
    np.testing.assert_allclose(out["y"].numpy(), want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(run(**feeds)["y"], out["y"], rtol=0, atol=0)
    assert (run.collectives is None) == (executor == "gspmd")
    assert run.canonical_key.endswith(executor)
    with pytest.raises(KeyError, match="unknown inputs"):
        run({**feeds, "z": feeds["x"]})


def test_shard_map_collectives_by_rule_and_knobs():
    prog = _mlp_program()
    mesh = Mesh({"data": 1, "model": 1}, device="cpu")
    outs = {}
    for fuse, la in itertools.product((True, False), (0, 1, 2)):
        run = prog.compile(mesh=mesh, executor="shard_map", fuse=fuse,
                           lookahead=la)
        assert run.collectives_by_rule == {} and run.lookahead == la
        outs[(fuse, la)] = run(_mlp_feeds())["y"]
    for v in outs.values():
        torch.testing.assert_close(v, outs[(True, 1)], rtol=0, atol=0)
    assert math.isclose(float(outs[(True, 1)].sum()),
                        float(np.maximum(_mlp_feeds()["x"] @ _mlp_feeds()["w"], 0).sum()),
                        rel_tol=1e-5)
