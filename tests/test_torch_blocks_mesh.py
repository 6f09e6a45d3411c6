"""The MoE, hymba and xLSTM blocks on a mesh of gloo CPU ranks, against
the one-rank port and the reference.

Reduced mixtral-8x7b, qwen2-moe-a2.7b, hymba-1.5b and xlstm-125m in
float32, with the reference's seeded weights (``from_reference_params``),
on ``{data: 2}``, ``{model: 2}`` and ``{data: 2, model: 2}`` — one spawn
per mesh (``launch.mesh.spawn``, ``file://`` rendezvous under a pytest tmp
path), every case on every rank.  Each case runs under the policy the
cell's own plan projects on that mesh; the MoE configs also under the
experts on ``model`` (with the batch on ``data`` where the mesh has it).

* ``forward``: the logits within 1e-5 x max|logit| of the one-rank port
  (float32: the experts' partial sums and the products of split blocks add
  in other orders) and 1e-4 x max|logit| of the reference's ``forward``;
  the loss within 1e-5 relative of one rank's.
* 4 ``decode_step``s after the prefill (``prepare_decode_caches`` on the
  mesh), fed the same seeded tokens on the mesh and on one rank: each
  step's logits within 1e-5 x max|logit| of one rank's.
* The loss's gradients, each pinned to its parameter's placements, within
  1e-4 x max|g| of one rank's (the backward sums over shards in other
  orders); one ``make_train_step`` step's loss and grad norm within 1e-5
  relative.
* ``serve(mesh=)``: generations equal to the one-rank port's and the
  reference's ``serve``, token for token; on (2, 2) the bucket registry's
  prefill step (1e-5 x max|logit|) and ``train(mesh=)``'s loss (1e-5
  relative) against one rank.  hymba also runs with its sequence on
  ``model``, so its windowed (ring) decode cache is split along time.
* MoE capacity: a mixtral config at capacity factor 1 on 512 tokens, where
  full experts drop tokens: every rank ranks the same (token, expert)
  entries into the same capacity slots as one rank (so the same tokens
  drop), and the output and gradients equal one rank's; each rank's
  expert weights are its E/r block, and every ``ops.gmm`` it calls takes
  an (E/r, C, ·) block.  Group-local dispatch (``moe_groups=2``) on
  ``{data: 2}``: a group a rank, equal to one rank.
* The ``gspmd`` executor on the MoE prefill graph with ``a2a`` nodes (the
  experts on both axes, and on ``model``): every rank's logits equal the
  dense run and the ``shard_map`` run within 1e-5 x max|logit|, and the
  collectives the rule issued on each a2a node equal the ``shard_map``
  static trace's for it, in count and bytes.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch.serve import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.gspmd import full  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCHS = ("mixtral-8x7b", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m")
MOE = ARCHS[:2]
MESHES = {"data2": {"data": 2}, "model2": {"model": 2},
          "2x2": {"data": 2, "model": 2}}
B, S, NEW, STEPS = 4, 16, 6, 4
TOL, REF_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4


def _cfg(arch):
    return reduced(get_config(arch))


def _policies(arch, sizes) -> dict:
    """{name: manual assignments, or None for the cell's plan}: the MoE
    experts on ``model``; hymba's sequence on ``model`` (its windowed
    decode cache then split along time)."""
    out = {"plan": None}
    if arch in MOE and "model" in sizes:
        out["e"] = {"e": "model", "b": "data"} if "data" in sizes else {"e": "model"}
    if arch == "hymba-1.5b" and len(sizes) == 2:
        out["seq"] = {"b": "data", "s": "model"}
    return out


def _policy(cfg, sizes, manual):
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.policy import manual_policy

    if manual is not None:
        return manual_policy(manual)
    return program_for(cfg, ShapeConfig("t", "train", S, B)).compile(
        mesh_axes=dict(sizes), device="cpu").policy()


def _tokens(cfg, b=B, s=S, seed=11):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def _np(t):
    return full(t).detach().numpy()


# ---------------------------------------------------------------------------
# what every rank (and the one rank) computes
# ---------------------------------------------------------------------------


def model_case(cfg, params_np, policy, mesh) -> dict:
    """Forward logits and loss, the loss's gradients (in the parameters'
    placements), one train step's metrics, and STEPS decode steps after the
    prefill, fed seeded tokens."""
    from repro_torch.data.synthetic import place_batch
    from repro_torch.launch import steps
    from repro_torch.launch.serve import prepare_decode_caches
    from repro_torch.optim import adamw_init

    placed = mesh.world_size > 1
    mesh_arg = mesh if placed else None
    params = tf.place_params(tf.from_reference_params(cfg, params_np, device="cpu"),
                             cfg, policy, mesh_arg)
    toks = _tokens(cfg)
    batch = place_batch({"tokens": toks, "labels": toks}, policy, mesh_arg) if placed else {
        "tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    out = {}
    with torch.no_grad():
        logits, caches, _ = tf.forward(params, batch["tokens"], cfg, policy=policy,
                                       mesh=mesh_arg, collect_cache=True)
        out["logits"] = _np(logits)
        kv_len = cfg.kv_len(ShapeConfig("d", "decode", S + STEPS, B))
        caches = prepare_decode_caches(cfg, caches, S, kv_len, policy=policy, mesh=mesh_arg)
        fed = _tokens(cfg, B, STEPS, seed=13)
        out["decode"] = []
        for i in range(STEPS):
            t = torch.as_tensor(fed[:, i:i + 1])
            if placed:
                t = place_batch({"tokens": fed[:, i:i + 1]}, policy, mesh)["tokens"]
            step, caches = tf.decode_step(params, t, caches, S + i, cfg, policy=policy,
                                          mesh=mesh_arg)
            out["decode"].append(_np(step))
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = tf.loss_fn(params, batch, cfg, policy=policy, mesh=mesh_arg)
    grads = torch.autograd.grad(loss, leaves)
    if placed:
        grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
    out["grads"] = [_np(g) for g in grads]
    out["loss"] = float(_np(loss))
    for p in leaves:
        p.requires_grad_(False)
    step = steps.make_train_step(cfg, policy=policy, mesh=mesh_arg, lr_fn=lambda s: 1e-3)
    _, _, met = step(params, adamw_init(params), batch)
    out["metrics"] = {k: float(v) for k, v in met.items()}
    return out


class _Record:
    """Wraps ``moe._slot_ranks`` and ``ops.gmm`` in this process: the
    capacity ranks each dispatch computed and the shapes each gmm took."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import moe

        self.ranks, self.gmm = [], []
        self._saved = (moe._slot_ranks, ops.gmm)
        slot_ranks, gmm = self._saved

        def ranks(e_flat, E):
            r = slot_ranks(e_flat, E)
            self.ranks.append(r.detach().numpy().copy())
            return r

        def shapes(x, w, *a, **k):
            self.gmm.append((tuple(x.shape), tuple(w.shape)))
            return gmm(x, w, *a, **k)

        moe._slot_ranks, ops.gmm = ranks, shapes
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.models import moe

        moe._slot_ranks, ops.gmm = self._saved


def _drop_cfg():
    """Reduced mixtral whose full experts drop tokens: capacity factor 1
    on 512 tokens (8 experts, top 2: 128 slots an expert, as many as the
    entries an expert gets on average)."""
    return dataclasses.replace(_cfg("mixtral-8x7b"), capacity_factor=1.0)


def drop_case(params_np, policy, mesh) -> dict:
    """The drop config's forward on 4 x 128 tokens: logits, loss gradients,
    the capacity ranks, the gmm shapes and this rank's expert block."""
    cfg = _drop_cfg()
    placed = mesh.world_size > 1
    mesh_arg = mesh if placed else None
    params = tf.place_params(tf.from_reference_params(cfg, params_np, device="cpu"),
                             cfg, policy, mesh_arg)
    toks = torch.as_tensor(_tokens(cfg, 4, 128, seed=5))
    batch = {"tokens": toks, "labels": toks}
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    with _Record() as rec:
        logits, _, _ = tf.forward(params, toks, cfg, policy=policy, mesh=mesh_arg)
    loss, _ = tf.loss_fn(params, batch, cfg, policy=policy, mesh=mesh_arg)
    grads = torch.autograd.grad(loss, leaves)
    if placed:
        grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
    w1 = params["layers"][0]["moe"]["w1"]
    return {"logits": _np(logits), "grads": [_np(g) for g in grads],
            "ranks": rec.ranks, "gmm": rec.gmm,
            "w1_block": tuple((w1.to_local() if placed else w1).shape),
            "capacity": 128}


def group_case(params_np, mesh) -> dict:
    """mixtral with group-local dispatch (2 groups) under the batch on
    ``data``: logits and loss gradients."""
    from repro_torch.models.policy import manual_policy

    cfg = dataclasses.replace(_cfg("mixtral-8x7b"), moe_groups=2)
    policy = manual_policy({"b": "data"})
    placed = mesh.world_size > 1
    mesh_arg = mesh if placed else None
    params = tf.place_params(tf.from_reference_params(cfg, params_np, device="cpu"),
                             cfg, policy, mesh_arg)
    toks = torch.as_tensor(_tokens(cfg, 4, 32, seed=6))
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    logits, _, aux = tf.forward(params, toks, cfg, policy=policy, mesh=mesh_arg)
    loss, _ = tf.loss_fn(params, {"tokens": toks, "labels": toks}, cfg, policy=policy,
                         mesh=mesh_arg)
    grads = torch.autograd.grad(loss, leaves)
    if placed:
        grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
    return {"logits": _np(logits), "aux": float(aux.detach()), "loss": float(_np(loss)),
            "grads": [_np(g) for g in grads]}


def _prompts(cfg):
    return _tokens(cfg, B, 12, seed=7)


def bucket_case(cfg, params_np, mesh) -> np.ndarray:
    """The bucket registry's prefill step of one 13-token prompt (an exact
    bucket: none of these configs is pad-free) under the bucket's policy:
    its logit, whole."""
    from repro_torch.serving import BucketRegistry

    placed = mesh.world_size > 1
    reg = BucketRegistry(cfg, mesh if placed else None, device="cpu")
    ent = reg.prefill(13)
    params = tf.from_reference_params(cfg, params_np, device="cpu")
    if placed:
        params = tf.place_params(params, cfg, ent.policy, mesh)
    with torch.no_grad():
        logits, _ = ent.step(params, {"tokens": torch.as_tensor(_tokens(cfg, 1, 13, seed=8))},
                             12)
    return _np(logits)


def train_case(cfg, mesh) -> float:
    """``train(mesh=)``: one step of seeded weights and synthetic data, its
    loss."""
    from repro_torch.launch.train import train

    out = train(cfg, ShapeConfig("t", "train", S, B), steps_total=1, device="cpu",
                mesh=mesh if mesh.world_size > 1 else None)
    return out["steps"][0]["loss"]


def serve_case(cfg, params_np, mesh) -> np.ndarray:
    from repro_torch.launch.serve import serve

    params = tf.from_reference_params(cfg, params_np, device="cpu")
    gen, _ = serve(cfg, _prompts(cfg), max_new=NEW, params=params, device="cpu",
                   mesh=mesh if mesh.world_size > 1 else None)
    return gen


A2A_PLANS = {"e-both": ("data", "model"), "e-model": ("model",)}


def a2a_case(mesh, axes) -> dict:
    """The reduced qwen2-moe prefill graph (its dispatch and combine stubs
    through the ``a2a`` rule) under a plan that puts the experts on
    ``axes`` in the expert half of the layer: the gspmd, shard_map and
    dense logits, the rule's collectives on each a2a node and their static
    trace."""
    from repro_torch.core.decomp import Plan
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.opaque_stubs import capacity_of, make_stub_opaques

    cfg = _cfg("qwen2-moe-a2.7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 16, 4))
    g = prog.graph
    make_stub_opaques(capacity_of(g))
    plan = Plan(p=mesh.world_size, mode="mesh")
    for n in g.nodes:
        labels = n.spec.all_labels if n.kind == "einsum" else n.labels
        ep = n.kind != "input" and (n.op == "moe_combine" or ("e" in labels and "c" in labels))
        plan.d_by_node[n.nid] = {
            l: (math.prod(mesh.sizes[a] for a in axes) if ep and l == "e" else 1)
            for l in labels}
        plan.axes_by_node[n.nid] = {"e": tuple(axes)} if ep else {}
    rng = np.random.default_rng(3)
    feeds = {n.name: (rng.integers(0, cfg.vocab, size=n.shape).astype(np.int32)
                      if "int" in str(n.dtype)
                      else (rng.normal(size=n.shape) * 0.1).astype(np.float32))
             for n in g.nodes if n.kind == "input"}
    gs = prog.compile(mesh=mesh, executor="gspmd", plan=plan)
    out = {"gspmd": gs(feeds)["logits"].numpy()}
    sm = prog.compile(mesh=mesh, executor="shard_map", plan=plan)
    out["shard_map"] = sm(feeds)["logits"].numpy()
    out["dense"] = prog.compile(p=1, device="cpu")(feeds)["logits"].numpy()
    a2a = {n.nid for n in g.nodes if n.kind == "opaque"
           and n.op in ("moe_dispatch", "moe_combine")}
    out["a2a_nodes"] = sorted(a2a)
    out["issued"] = sorted((e[0], e[1], e[3]) for e in gs._fn.issued)
    out["static"] = sorted((e.nid, e.kind, e.elems) for e in sm._fn.schedule.trace.events
                           if e.nid in a2a and e.rule == "a2a")
    return out


def rank_battery(rank, world, mesh_id, weights):
    sizes = MESHES[mesh_id]
    mesh = Mesh(sizes, device="cpu")
    res = {"model": {}, "serve": {}}
    for arch in ARCHS:
        cfg = _cfg(arch)
        for name, manual in _policies(arch, sizes).items():
            policy = _policy(cfg, sizes, manual)
            res["model"][(arch, name)] = dict(
                model_case(cfg, weights[arch], policy, mesh),
                policy=dict(policy.label_axes))
        res["serve"][arch] = serve_case(cfg, weights[arch], mesh)
        if mesh_id == "2x2":
            res.setdefault("bucket", {})[arch] = bucket_case(cfg, weights[arch], mesh)
            res.setdefault("train", {})[arch] = train_case(cfg, mesh)
    if mesh_id == "2x2":
        from repro_torch.models.policy import manual_policy

        res["drop"] = {ax: drop_case(weights["drop"], manual_policy({"e": ax}), mesh)
                       for ax in (("data", "model"), "model")}
        res["a2a"] = {name: a2a_case(mesh, axes) for name, axes in A2A_PLANS.items()}
    if mesh_id == "data2":
        res["group"] = group_case(weights["mixtral-8x7b"], mesh)
    return res


# ---------------------------------------------------------------------------
# fixtures: the reference, one rank, the meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """Every case's weights, made by the reference from a seed, as numpy."""
    out = {}
    for i, arch in enumerate(ARCHS):
        ref_cfg = ref_reduced(ref_get_config(arch))
        out[arch] = jax.tree.map(np.asarray, ref_tf.init_params(ref_cfg, jax.random.PRNGKey(i)))
    ref_drop = dataclasses.replace(ref_reduced(ref_get_config("mixtral-8x7b")),
                                   capacity_factor=1.0)
    out["drop"] = jax.tree.map(np.asarray, ref_tf.init_params(ref_drop, jax.random.PRNGKey(9)))
    return out


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Every mesh's spawn, all started at once (threads waiting on their
    ranks) before the one-rank cases run here."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(MESHES))
    runs = {m: pool.submit(spawn, math.prod(sizes.values()), rank_battery, m, weights,
                           timeout=600, tmpdir=tmp_path_factory.mktemp(f"blocks{m}"))
            for m, sizes in MESHES.items()}
    yield lambda mesh_id: runs[mesh_id].result()
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_rank(weights, ranks):
    """The same cases on one rank (plain tensors), while the meshes run."""
    mesh = Mesh({"data": 1}, device="cpu")
    res = {"model": {}, "serve": {}, "bucket": {}, "train": {}}
    for arch in ARCHS:
        cfg = _cfg(arch)
        res["model"][arch] = model_case(cfg, weights[arch], None, mesh)
        res["serve"][arch] = serve_case(cfg, weights[arch], mesh)
        res["bucket"][arch] = bucket_case(cfg, weights[arch], mesh)
        res["train"][arch] = train_case(cfg, mesh)
    res["drop"] = drop_case(weights["drop"], None, mesh)
    res["group"] = group_case(weights["mixtral-8x7b"], mesh)
    return res


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _grads_close(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, GRAD_TOL, f"{what} grad leaf {i}")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_forward_equals_reference(arch, weights, one_rank):
    """The one-rank port's logits are the reference's ``forward`` on the
    same weights (1e-4 x max|logit|): the anchor every mesh is held to."""
    ref_cfg = ref_reduced(ref_get_config(arch))
    ref_params = jax.tree.map(jax.numpy.asarray, weights[arch])
    want, _, _ = ref_tf.forward(ref_params, _tokens(_cfg(arch)), ref_cfg)
    _close(one_rank["model"][arch]["logits"], np.asarray(want), REF_TOL, arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_forward_decode_and_train_on_a_mesh_equal_one_rank(mesh_id, arch, weights,
                                                           one_rank, ranks):
    want = one_rank["model"][arch]
    ref_cfg = ref_reduced(ref_get_config(arch))
    ref_logits = np.asarray(ref_tf.forward(jax.tree.map(jax.numpy.asarray, weights[arch]),
                                           _tokens(_cfg(arch)), ref_cfg)[0])
    cases = [k for k in ranks(mesh_id)[0]["model"] if k[0] == arch]
    assert len(cases) == len(_policies(arch, MESHES[mesh_id]))
    for rank, res in enumerate(ranks(mesh_id)):
        for key in cases:
            got = res["model"][key]
            what = f"rank {rank} {key} {got['policy']}"
            _close(got["logits"], want["logits"], TOL, what)
            _close(got["logits"], ref_logits, REF_TOL, what + " vs the reference")
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), what
            for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
                _close(g, w, TOL, f"{what} decode step {i}")
            _grads_close(got["grads"], want["grads"], what)
            for k in ("loss", "grad_norm", "ce"):
                assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-5), (what, k)


def test_meshes_split_what_the_blocks_need(ranks):
    """The cases exercise the placed paths: the batch split under the plans
    (the recurrent blocks run on local rows), the experts split on every
    MoE case of a mesh with a model axis."""
    for mesh_id in MESHES:
        for key, got in ranks(mesh_id)[0]["model"].items():
            pol = got["policy"]
            if key[1] == "e":
                assert pol["e"] == ("model",), (mesh_id, key, pol)
            if mesh_id == "data2":
                assert "data" in pol.get("b", ()), (mesh_id, key, pol)
            if key[1] == "seq":  # hymba's windowed cache split along time
                assert pol["s"] == ("model",), pol


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_a_mesh_equals_one_rank_and_reference(arch, weights, one_rank, ranks):
    ref_cfg = ref_reduced(ref_get_config(arch))
    ref_params = jax.tree.map(jax.numpy.asarray, weights[arch])
    want, _ = ref_serve(ref_cfg, _prompts(_cfg(arch)), max_new=NEW, params=ref_params)
    one = one_rank["serve"][arch]
    np.testing.assert_array_equal(one, np.asarray(want))
    for mesh_id in MESHES:
        for rank, res in enumerate(ranks(mesh_id)):
            np.testing.assert_array_equal(res["serve"][arch], one,
                                          err_msg=f"{mesh_id} rank {rank}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_prefill_and_train_on_four_ranks_equal_one_rank(arch, one_rank, ranks):
    """The bucket registry's prefill step on (2, 2) under its bucket's
    policy (1e-5 x max|logit|), and ``train(mesh=)``'s first loss (1e-5
    relative), against one rank."""
    for rank, res in enumerate(ranks("2x2")):
        _close(res["bucket"][arch], one_rank["bucket"][arch], TOL, f"rank {rank}")
        assert res["train"][arch] == pytest.approx(one_rank["train"][arch], rel=1e-5)


@pytest.mark.parametrize("axes", [("data", "model"), "model"], ids=["e-both", "e-model"])
def test_capacity_drops_the_same_tokens_as_one_rank(axes, one_rank, ranks):
    want = one_rank["drop"]
    C = want["capacity"]
    assert any((r >= C).any() for r in want["ranks"])  # full experts drop tokens
    r = 4 if axes == ("data", "model") else 2
    E = _drop_cfg().n_e
    for rank, res in enumerate(ranks("2x2")):
        got = res["drop"][axes]
        assert len(got["ranks"]) == len(want["ranks"])
        for g, w in zip(got["ranks"], want["ranks"]):
            np.testing.assert_array_equal(g, w)  # same slots: the same drops
        _close(got["logits"], want["logits"], TOL, f"rank {rank}")
        _grads_close(got["grads"], want["grads"], f"rank {rank}")
        assert got["w1_block"][1] == E // r  # (L, E/r, D, F)
        assert got["gmm"] and all(x[0] == E // r and x[1] == C and w[0] == E // r
                                  for x, w in got["gmm"]), got["gmm"]


def test_group_local_dispatch_on_two_ranks_equals_one_rank(one_rank, ranks):
    want = one_rank["group"]
    for rank, res in enumerate(ranks("data2")):
        got = res["group"]
        _close(got["logits"], want["logits"], TOL, f"rank {rank}")
        assert got["aux"] == pytest.approx(want["aux"], rel=1e-5)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        _grads_close(got["grads"], want["grads"], f"rank {rank}")


@pytest.mark.parametrize("name", list(A2A_PLANS))
def test_gspmd_a2a_equals_dense_shard_map_and_static_trace(name, ranks):
    """The gspmd executor lowers the a2a nodes through their rule on 4
    ranks: logits equal the dense and shard_map runs, and on each a2a node
    the rule issued an all-gather of the counts and two all-to-alls each
    way, equal to the shard_map static trace's in count and bytes."""
    for rank, res in enumerate(ranks("2x2")):
        got = res["a2a"][name]
        for other in ("dense", "shard_map"):
            _close(got["gspmd"], got[other], TOL, f"rank {rank} {name} vs {other}")
        assert got["issued"] == got["static"], (rank, name)
        for nid in got["a2a_nodes"]:
            kinds = [k for n, k, _ in got["issued"] if n == nid]
            assert kinds == ["all_gather", "all_to_all", "all_to_all"], kinds
