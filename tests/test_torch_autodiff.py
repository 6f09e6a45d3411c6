"""The port's graph autodiff (``core/autodiff.py``, ``Program.grad``, the
derived ``<kind>@vjp<i>`` ops) against the reference.

1. **The gradient graph is pure Python over the EinGraph**, so the port's
   must *equal* the reference's: node for node, by ``canon.graph_key``, and
   by the §8 DP's ``Plan.to_json()`` and cost at p = 16 — on the paper's
   Experiment 2 graph (``benchmarks/bench_ffnn.py``'s FFNN training graph)
   over ``bench_ffnn.run``'s sweep, EinDecomp and forced data parallelism.
2. **Gradient values** from the same numpy inputs (a seeded generator) go
   through the port (dense, and ``executor="shard_map"`` on 4 gloo ranks)
   and through ``jax.grad``; float32 throughout, at the reference tests'
   own tolerance for these graphs (rtol 1e-4, atol 1e-5): both packages
   sum the contractions in their own order.
3. **Derived VJP ops** pull back through ``torch.func.vjp`` of the dense
   impl, never the kernel dispatcher, and integer inputs get no gradient.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import canon as ref_canon  # noqa: E402
from repro.core.autodiff import grad_graph as ref_grad_graph  # noqa: E402
from repro.core.decomp import eindecomp as ref_eindecomp  # noqa: E402
from repro.core.decomp import plan_data_parallel as ref_plan_dp  # noqa: E402
from repro.core.einsum import EinGraph as RefGraph  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch import frontend as ein  # noqa: E402
from repro_torch.core import canon, engine, opdef  # noqa: E402
from repro_torch.core.autodiff import grad_graph  # noqa: E402
from repro_torch.core.decomp import eindecomp, plan_data_parallel  # noqa: E402
from repro_torch.core.einsum import EinGraph  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
FEATS, HIDDEN, LABELS = 597_540, 8_192, 14_588  # AmazonCat-14K (bench_ffnn.py)


def _ffnn_train_graph(G, gg, batch, feats=FEATS, hidden=HIDDEN, labels=LABELS):
    """benchmarks/bench_ffnn.py::ffnn_train_graph, built through either
    package's EinGraph and grad_graph."""
    g = G("ffnn")
    X = g.input("X", "bf", (batch, feats))
    W1 = g.input("W1", "fh", (feats, hidden))
    W2 = g.input("W2", "hc", (hidden, labels))
    Y = g.input("Y", "bc", (batch, labels))
    h1 = g.einsum("bf,fh->bh", X, W1)
    a1 = g.map("relu", h1)
    p = g.einsum("bh,hc->bc", a1, W2)
    diff = g.einsum("bc,bc->bc", p, Y, combine="sub", agg="")
    sq = g.map("square", diff)
    loss = g.einsum("bc->", sq, combine="id", agg="sum")
    out, grads, seed = gg(g, loss, [W1, W2])
    return out, loss, grads, seed, (X, W1, W2, Y)


def _node_list(g):
    return [(n.nid, n.name, n.kind, tuple(n.labels), tuple(n.shape), str(n.dtype),
             tuple(n.inputs), n.op, repr(sorted(n.params.items())),
             None if n.shardable is None else sorted(n.shardable),
             tuple(map(tuple, n.in_labels)), None if n.spec is None else
             (n.spec.pretty(), n.spec.combine, n.spec.agg)) for n in g.nodes]


SWEEP = [(b, f) for b in (128, 512) for f in (8_192, 65_536, 262_144, FEATS)]


@pytest.mark.parametrize("batch,feats", SWEEP, ids=[f"b{b}f{f}" for b, f in SWEEP])
def test_ffnn_gradient_graph_and_plans_equal_the_reference(batch, feats):
    """The graph PR 11's planner tests left waiting for autodiff
    (tests/test_torch_planner.py's ``_ffnn_forward``), now with its
    backward: equal graph, key, plans and costs."""
    g, loss, grads, seed, _ = _ffnn_train_graph(EinGraph, grad_graph, batch, feats)
    rg, rloss, rgrads, rseed, _ = _ffnn_train_graph(RefGraph, ref_grad_graph, batch, feats)
    assert _node_list(g) == _node_list(rg)
    assert (grads, seed) == (rgrads, rseed)
    assert canon.graph_key(g) == ref_canon.graph_key(rg)
    ein_plan = eindecomp(g, 16, offpath_repart=True)
    ref_plan = ref_eindecomp(rg, 16, offpath_repart=True)
    assert ein_plan.to_json() == ref_plan.to_json()
    assert ein_plan.cost == ref_plan.cost
    dp, ref_dp = plan_data_parallel(g, 16, batch_label="b"), ref_plan_dp(rg, 16, batch_label="b")
    assert dp.to_json() == ref_dp.to_json() and dp.cost == ref_dp.cost
    # the paper's headline: data parallelism broadcasts the model and loses
    assert dp.cost > ein_plan.cost


def _small_ffnn_feeds(seed=0):
    rng = np.random.default_rng(seed)
    return {"X": rng.normal(size=(16, 32)).astype(np.float32),
            "W1": (rng.normal(size=(32, 64)) * 0.1).astype(np.float32),
            "W2": (rng.normal(size=(64, 8)) * 0.1).astype(np.float32),
            "Y": rng.normal(size=(16, 8)).astype(np.float32)}


def _jax_ffnn_grads(f):
    def loss(w1, w2):
        h = jnp.maximum(f["X"] @ w1, 0)
        return jnp.sum((h @ w2 - f["Y"]) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(f["W1"], f["W2"])]


def test_grad_graph_matches_jax_grad():
    """tests/test_engine.py's FFNN case: the gradient graph run densely
    with the seed fed as ones."""
    g, _, grads, seed, (X, W1, W2, Y) = _ffnn_train_graph(EinGraph, grad_graph, 16, 32, 64, 8)
    f = _small_ffnn_feeds()
    vals = engine.run(g, {X: f["X"], W1: f["W1"], W2: f["W2"], Y: f["Y"],
                          seed: np.ones((), np.float32)})
    want = _jax_ffnn_grads(f)
    for w, nid in zip(want, (grads[W1], grads[W2])):
        np.testing.assert_allclose(vals[nid].numpy(), w, rtol=RTOL, atol=ATOL)


def _ffnn_program():
    X = ein.tensor("X", "b f", (16, 32))
    W1 = ein.tensor("W1", "f h", (32, 64))
    W2 = ein.tensor("W2", "h c", (64, 8))
    Y = ein.tensor("Y", "b c", (16, 8))
    a1 = ein.einsum("b f, f h -> b h", X, W1).map("relu")
    diff = ein.einsum("b h, h c -> b c", a1, W2) - Y
    loss = ein.einsum("b c ->", diff.map("square"), combine="id", agg="sum")
    return ein.Program({"loss": loss})


def test_program_grad_dense_matches_jax_grad():
    prog = _ffnn_program().grad(["W1", "W2"])
    assert prog.output_names == ("loss", "grad_W1", "grad_W2")
    assert "dLoss_seed" in prog.input_names
    f = _small_ffnn_feeds()
    out = prog.compile(p=1, device="cpu")(f)  # dLoss_seed defaults to ones
    for name, w in zip(("grad_W1", "grad_W2"), _jax_ffnn_grads(f)):
        np.testing.assert_allclose(out[name].numpy(), w, rtol=RTOL, atol=ATOL)
    # an explicit seed scales the cotangent; CompiledProgram.grad is the same program
    out2 = prog.compile(device="cpu")({**f, "dLoss_seed": np.full((), 2.0, np.float32)})
    np.testing.assert_allclose(out2["grad_W2"].numpy(), 2 * out["grad_W2"].numpy(),
                               rtol=1e-6, atol=1e-7)
    again = _ffnn_program().compile(device="cpu").grad(["W1", "W2"])
    assert canon.graph_key(again.graph) == canon.graph_key(prog.graph)


def test_runner_skips_adjoints_no_output_reads():
    """The FFNN asks for W1's and W2's gradients; X's and Y's adjoints are
    built (as in the reference) but dead, and the runner does not run
    them — the reference's jit drops them the same way."""
    prog = _ffnn_program().grad(["W1", "W2"])
    g = prog.graph
    live = engine.live_nodes(g, [prog._out[k] for k in prog.output_names])
    dead = [n for n in g.nodes if n.nid not in live]
    assert dead and all(n.kind != "input" for n in dead)
    # the (b f) adjoint of X, a full contraction the run must not pay for
    assert any(tuple(n.labels) == ("b", "f") and n.kind == "einsum" for n in dead)
    seen = []
    real = engine.lower_einsum

    def spy(spec, *args):
        seen.append(spec.pretty())
        return real(spec, *args)

    try:
        engine.lower_einsum = spy
        prog.compile(device="cpu")(_small_ffnn_feeds())
    finally:
        engine.lower_einsum = real
    assert len(seen) == sum(1 for n in g.nodes if n.kind == "einsum" and n.nid in live)


def _mlp_grad_program():
    x = ein.tensor("x", "b a", (8, 16))
    w = ein.tensor("w", "a f", (16, 32))
    y = ein.einsum("b a, a f -> b f", x, w).map("relu")
    loss = ein.einsum("b f ->", y, combine="id", agg="sum")
    return ein.Program({"loss": loss}).grad("w")


def _mlp_feeds():
    rng = np.random.default_rng(1)
    return {"x": rng.normal(size=(8, 16)).astype(np.float32),
            "w": (rng.normal(size=(16, 32)) * 0.1).astype(np.float32)}


def gloo_grad_rank(rank, world, sizes):
    """On this rank: the FFNN and MLP gradient programs through the
    shard_map executor on ``sizes``, and the dense run of each."""
    mesh = Mesh(sizes, device="cpu")
    res = {}
    for name, prog, feeds in (("ffnn", _ffnn_program().grad(["W1", "W2"]),
                               _small_ffnn_feeds()),
                              ("mlp", _mlp_grad_program(), _mlp_feeds())):
        run = prog.compile(mesh=mesh, executor="shard_map")
        out = run(feeds)
        res[name] = {k: v.numpy() for k, v in out.items()}
        res[name + "_issued"] = sorted(run._fn.issued)
        res[name + "_trace"] = sorted((e.nid, e.kind, e.axes, e.elems)
                                      for e in run.collectives.events)
    return res


@pytest.fixture(scope="module")
def gloo_grads(tmp_path_factory):
    sizes = {"data": 2, "model": 2}
    return spawn(math.prod(sizes.values()), gloo_grad_rank, sizes,
                 tmpdir=tmp_path_factory.mktemp("grad2x2"))


def test_program_grad_shard_map_on_4_gloo_ranks_matches_jax_grad(gloo_grads):
    """tests/test_spmd.py's grad-program equivalence: the backward graph
    (broadcast_to opaques, accumulations) runs through the explicit-
    collective executor on a 2x2 mesh of gloo ranks."""
    f = _small_ffnn_feeds()
    want_ffnn = dict(zip(("grad_W1", "grad_W2"), _jax_ffnn_grads(f)))
    m = _mlp_feeds()
    want_mlp = np.asarray(jax.grad(lambda w: jnp.sum(jnp.maximum(m["x"] @ w, 0)))(m["w"]))
    for rank in gloo_grads:
        for name, w in want_ffnn.items():
            np.testing.assert_allclose(rank["ffnn"][name], w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rank["mlp"]["grad_w"], want_mlp, rtol=RTOL, atol=ATOL)
    # the plan moves data: the schedule is not empty on this mesh
    assert any(rank["ffnn_trace"] for rank in gloo_grads)


def test_shard_map_grad_issues_only_scheduled_collectives(gloo_grads):
    """Every collective a rank issued is in the static trace (dead adjoints
    skip theirs, on every rank alike)."""
    for rank in gloo_grads:
        for name in ("ffnn", "mlp"):
            issued = set(rank[name + "_issued"])
            assert issued <= set(rank[name + "_trace"]), name
    assert any(rank["ffnn_issued"] for rank in gloo_grads)


# ---------------------------------------------------------------------------
# derived <kind>@vjp<i> ops (tests/test_opdef.py's auto-VJP cases)
# ---------------------------------------------------------------------------


@pytest.fixture
def defop_tmp():
    created = []

    def reg(kind, *a, **kw):
        od = opdef.defop(kind, *a, **kw)
        created.append(kind)
        return od

    yield reg
    for kind in created:
        opdef.unregister(kind)


RNG = np.random.default_rng(0)


def test_grad_without_vjp_names_the_op(defop_tmp):
    defop_tmp("t_novjp", "b s -> b s", fn=lambda x: torch.as_tensor(x) * 2)
    x = ein.tensor("x", "b s", (2, 4))
    loss = ein.einsum("b s ->", ein.opaque("t_novjp", [x]), combine="id", agg="sum")
    with pytest.raises(NotImplementedError, match="t_novjp.*vjp"):
        ein.Program({"loss": loss}).grad("x")


def test_auto_vjp_matches_jax_grad(defop_tmp):
    defop_tmp("t_sq", "b s -> b s", vjp="auto",
              fn=lambda x: torch.square(torch.as_tensor(x)) * 0.5)
    x = ein.tensor("x", "b s", (3, 5))
    loss = ein.einsum("b s ->", ein.opaque("t_sq", [x]), combine="id", agg="sum")
    run = ein.Program({"loss": loss}).grad("x").compile(device="cpu")
    X = RNG.normal(size=(3, 5)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.square(v) * 0.5))(X))
    np.testing.assert_allclose(run({"x": X})["grad_x"].numpy(), want, rtol=1e-5, atol=1e-6)


def test_auto_vjp_differentiates_the_dense_reference(defop_tmp):
    """The derived op pulls back through the dense impl, not the kernel
    dispatcher (whose kernel may have no backward)."""
    defop_tmp("t_kerngrad", "b s -> b s", vjp="auto",
              fn=lambda x: torch.square(torch.as_tensor(x)),
              kernel=lambda x: torch.square(torch.as_tensor(x)).detach())
    x = ein.tensor("x", "b s", (2, 4))
    loss = ein.einsum("b s ->", ein.opaque("t_kerngrad", [x]), combine="id", agg="sum")
    run = ein.Program({"loss": loss}).grad("x").compile(device="cpu")
    X = RNG.normal(size=(2, 4)).astype(np.float32)
    np.testing.assert_allclose(run({"x": X})["grad_x"].numpy(), 2 * X, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_grad_through_flash_attention_matches_jax_grad(causal, window):
    """Program.grad through the builtin flash-attention opaque: one
    ``flash_attention@vjp<i>`` node per input, against jax.grad of the
    reference's dense attention, for q, k and v (GQA 2:1)."""
    b, h, kh, s, d = 2, 4, 2, 8, 4
    q = ein.tensor("q", "b h s d", (b, h, s, d))
    k = ein.tensor("k", "b k s d", (b, kh, s, d))
    v = ein.tensor("v", "b k s d", (b, kh, s, d))
    att = ein.opaque("flash_attention", [q, k, v], causal=causal, window=window,
                     in_labels=[("b", "h", "s", "d"), ("b", "k", "s", "d"),
                                ("b", "k", "s", "d")])
    loss = ein.einsum("b h s d ->", att, combine="id", agg="sum")
    prog = ein.Program({"loss": loss}).grad(["q", "k", "v"])
    assert sorted(n.op for n in prog.graph.nodes if "@vjp" in n.op) == [
        f"flash_attention@vjp{i}" for i in range(3)]
    rng = np.random.default_rng(2)
    feeds = {n: (rng.normal(size=sh) * 0.3).astype(np.float32)
             for n, sh in (("q", (b, h, s, d)), ("k", (b, kh, s, d)), ("v", (b, kh, s, d)))}
    got = prog.compile(device="cpu")(feeds)

    def dense(qq, kk, vv):
        return jnp.sum(jref.attention(qq, kk, vv, causal=causal, window=window))

    want = jax.grad(dense, argnums=(0, 1, 2))(feeds["q"], feeds["k"], feeds["v"])
    for name, w in zip("qkv", want):
        np.testing.assert_allclose(got[f"grad_{name}"].numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=f"grad_{name}")


def test_grad_skips_integer_inputs():
    """gather_rows: the table gets a scatter-add gradient, the int ids get
    none (asking for one is a clear error), and the derived op for the ids
    raises if executed."""
    table = ein.tensor("table", "v a", (8, 4))
    ids = ein.tensor("ids", "b s", (2, 3), dtype="int32")
    loss = ein.einsum("b s a ->", ein.opaque("gather_rows", [table, ids]),
                      combine="id", agg="sum")
    prog = ein.Program({"loss": loss})
    gprog = prog.grad("table")
    assert [n.op for n in gprog.graph.nodes if "@vjp" in n.op] == ["gather_rows@vjp0"]
    T = RNG.normal(size=(8, 4)).astype(np.float32)
    ids_v = np.array([[1, 2, 1], [0, 7, 1]], np.int32)
    got = gprog.compile(device="cpu")({"table": T, "ids": ids_v})["grad_table"].numpy()
    want = np.zeros_like(T)
    np.add.at(want, ids_v.reshape(-1), 1.0)
    np.testing.assert_allclose(got, want)
    with pytest.raises(ValueError, match="no gradient path"):
        prog.grad("ids")
    with pytest.raises(opdef.OpDefError, match="not differentiable"):
        opdef.executable("gather_rows@vjp1")(T, ids_v, np.ones((2, 3, 4), np.float32))
