"""The port's placement layer against the reference, label by label.

Pure functions over plans, policies and shapes, compared exactly:

* ``engine.spec_for_node`` over every node of the zoo's prefill and train
  graphs, planned on four meshes (the production 16x16 among them), equals
  the reference's ``PartitionSpec`` entry for entry;
* ``policy.safe_spec`` over every parameter and decode-cache leaf of the
  zoo equals the reference's (given a stand-in mesh with the only two
  attributes it reads, ``axis_names`` and ``devices.shape``);
* ``param_labels``, ``cache_labels``, ``param_spec`` / ``act_spec`` after
  ``safe_spec``, ``input_specs`` (shapes and dtypes) and
  ``batch_shardings`` equal the reference's;
* DTensor placements of a spec: an entry on two axes in mesh order is
  ``[Shard(d), Shard(d)]``; an entry out of mesh order raises, naming it.

No tolerance: every comparison is equality.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.decomp import eindecomp as ref_eindecomp  # noqa: E402
from repro.models import policy as ref_policy  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.eingraphs import program_for as ref_program_for  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import engine, gspmd  # noqa: E402
from repro_torch.core.decomp import eindecomp  # noqa: E402
from repro_torch.data.synthetic import batch_shardings  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import policy as policy_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.eingraphs import program_for  # noqa: E402

ZOO = ("llama-7b", "mixtral-8x7b", "qwen2-moe-a2.7b", "hymba-1.5b",
       "xlstm-125m", "paligemma-3b")
MESHES = [{"data": 2, "model": 2}, {"data": 1, "model": 4},
          {"data": 2, "model": 4}, {"data": 16, "model": 16}]


def _mid(sizes):
    return "x".join(str(v) for v in sizes.values())


def _standin(sizes):
    """What the reference's ``safe_spec`` reads of a jax Mesh."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _tuple(spec):
    return tuple(spec)


def _walk(tree, other):
    """Pairs of leaves of two trees of one structure (NamedTuples and plain
    tuples alike)."""
    if isinstance(tree, dict):
        assert set(tree) == set(other)
        for k in sorted(tree):
            yield from _walk(tree[k], other[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, str):
        assert len(tree) == len(other)
        for a, b in zip(tree, other):
            yield from _walk(a, b)
    else:
        yield tree, other


def _plain(tree):
    """Nested dicts/lists of labels, NamedTuples as plain tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


# ---------------------------------------------------------------------------
# spec_for_node over the zoo's plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", MESHES, ids=_mid)
@pytest.mark.parametrize("arch", ZOO)
def test_spec_for_node_equals_reference(arch, sizes):
    p = int(np.prod(list(sizes.values())))
    for kind in ("prefill", "train"):
        prog = program_for(reduced(get_config(arch)), ShapeConfig("eq", kind, 16, 4))
        ref_prog = ref_program_for(ref_reduced(ref_get_config(arch)),
                                   RefShape("eq", kind, 16, 4))
        plan = eindecomp(prog.graph, p, mesh_axes=sizes)
        ref_plan = ref_eindecomp(ref_prog.graph, p, mesh_axes=sizes)
        assert plan.to_json() == ref_plan.to_json()
        for n, rn in zip(prog.graph.nodes, ref_prog.graph.nodes):
            got = engine.spec_for_node(n, plan.axes_by_node.get(n.nid, {}))
            want = ref_engine.spec_for_node(rn, ref_plan.axes_by_node.get(rn.nid, {}))
            assert got == _tuple(want), (arch, kind, n.name)
        # every node's spec is placeable: planned axes come in mesh order
        pl = engine.plan_shardings(prog.graph, plan, sizes)
        assert len(pl) == len(prog.graph.nodes)
        assert all(len(v) == len(sizes) for v in pl.values())


# ---------------------------------------------------------------------------
# labels, safe_spec, param / act specs, input specs, batch shardings
# ---------------------------------------------------------------------------


def _policies(arch, sizes):
    """(port, reference) policy pairs: the plan's projection with the data
    axis as fsdp axis, and the paper's megatron baseline."""
    cfg, ref_cfg = reduced(get_config(arch)), ref_reduced(ref_get_config(arch))
    p = int(np.prod(list(sizes.values())))
    prog = program_for(cfg, ShapeConfig("eq", "train", 16, 4))
    ref_prog = ref_program_for(ref_cfg, RefShape("eq", "train", 16, 4))
    plan = eindecomp(prog.graph, p, mesh_axes=sizes)
    ref_plan = ref_eindecomp(ref_prog.graph, p, mesh_axes=sizes)
    fsdp = ("data",)
    mega = {"h": "model", "k": "model", "f": "model", "v": "model", "b": "data"}
    return [(policy_mod.policy_from_plan(plan, prog.graph, fsdp_axes=fsdp),
             ref_policy.policy_from_plan(ref_plan, ref_prog.graph, fsdp_axes=fsdp)),
            (policy_mod.manual_policy(mega), ref_policy.manual_policy(mega))]


@pytest.mark.parametrize("sizes", MESHES[:3] + [{"data": 16, "model": 16}], ids=_mid)
@pytest.mark.parametrize("arch", ZOO)
def test_param_and_cache_specs_equal_reference(arch, sizes):
    for full in (False, True):
        cfg = get_config(arch) if full else reduced(get_config(arch))
        ref_cfg = ref_get_config(arch) if full else ref_reduced(ref_get_config(arch))
        assert _plain(tf.param_labels(cfg)) == _plain(ref_tf.param_labels(ref_cfg))
        assert _plain(tf.cache_labels(cfg)) == _plain(ref_tf.cache_labels(ref_cfg))
        meta = tf.init_params(cfg, device="meta")
        ref_abs = ref_tf.init_params(ref_cfg, abstract=True)
        cmeta = tf.init_caches(cfg, 2, 64, device="meta")
        ref_cabs = ref_tf.init_caches(ref_cfg, 2, 64, abstract=True)
        for pol, ref_pol in _policies(arch, sizes):
            pspec = tf.param_specs(cfg, pol, sizes)
            for (t, spec), (rs, lab) in zip(
                    _walk(meta, pspec), _walk(ref_abs, ref_tf.param_labels(ref_cfg))):
                assert tuple(t.shape) == tuple(rs.shape), lab
                want = ref_policy.safe_spec(ref_pol.param_spec(lab), rs.shape,
                                            _standin(sizes))
                assert spec == _tuple(want), (lab, spec, want)
                assert spec == policy_mod.safe_spec(pol.param_spec(lab), t.shape, sizes)
            cspec = tf.cache_specs(cfg, 2, 64, pol, sizes)
            for (t, spec), (rs, lab) in zip(
                    _walk(cmeta, cspec), _walk(ref_cabs, ref_tf.cache_labels(ref_cfg))):
                assert tuple(t.shape) == tuple(rs.shape), lab
                want = ref_policy.safe_spec(ref_pol.act_spec(lab), rs.shape,
                                            _standin(sizes))
                assert spec == _tuple(want), (lab, spec, want)
        # the placements DTensor gets are those of the specs
        shard = tf.param_shardings(cfg, pol, sizes)
        for (t, pl), (_, spec) in zip(_walk(meta, shard), _walk(meta, pspec)):
            assert pl == gspmd.placements(spec, sizes)


def test_safe_spec_drops_what_does_not_divide():
    """25 heads on a 16-way axis: the reference's example."""
    mesh = {"data": 16, "model": 16}
    for spec, shape in [(("model", None), (25, 8)), ((("data", "model"),), (48,)),
                        ((("data", "model"), "model"), (256, 32)),
                        ((None, "data"), (3, 32))]:
        got = policy_mod.safe_spec(spec, shape, mesh)
        want = ref_policy.safe_spec(ref_policy.P(*spec), shape, _standin(mesh))
        assert got == _tuple(want)
    assert policy_mod.safe_spec(("model", None), (25, 8), mesh) == (None, None)
    pol = policy_mod.manual_policy({"h": "model", "b": "data"})
    assert pol.sharding(mesh, "b h d", (32, 25, 64)) == (Shard(0), Replicate())
    assert pol.sharding(mesh, "b h d", (32, 32, 64)) == (Shard(0), Shard(1))
    assert pol.sharding(mesh, "b h d", (32, 25, 64), param=True) == (Shard(0), Replicate())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama-7b", "paligemma-3b"])
def test_input_specs_and_batch_shardings_equal_reference(arch, kind):
    cfg, ref_cfg = reduced(get_config(arch)), ref_reduced(ref_get_config(arch))
    sizes = {"data": 2, "model": 2}
    shape = ShapeConfig("eq", kind, 16, 4)
    pol, ref_pol = _policies(arch, sizes)[1]
    got = tf.input_specs(cfg, shape, policy=pol, mesh=sizes)
    want = ref_tf.input_specs(ref_cfg, RefShape("eq", kind, 16, 4))
    assert set(got) == set(want)
    for k, sds in want.items():
        assert got[k].shape == tuple(sds.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(np.dtype(sds.dtype)), k
        if k == "pos":
            assert got[k].placements is None
            continue
        labels = "b s a" if k == "prefix_embeds" else "b s"
        ref_spec = ref_policy.safe_spec(ref_pol.act_spec(labels), sds.shape,
                                        _standin(sizes))
        assert got[k].placements == gspmd.placements(_tuple(ref_spec), sizes), k
    bs = batch_shardings(pol, sizes, {k: v.shape for k, v in want.items()})
    for k, sds in want.items():
        if k == "pos":
            assert bs[k] is None
            continue
        labels = "b s a" if k == "prefix_embeds" else "b s"
        ref_spec = ref_policy.safe_spec(ref_pol.act_spec(labels), sds.shape,
                                        _standin(sizes))
        assert bs[k] == gspmd.placements(_tuple(ref_spec), sizes), k


# ---------------------------------------------------------------------------
# specs -> placements; the mesh constructors
# ---------------------------------------------------------------------------


def test_placements_nest_axes_in_mesh_order():
    sizes = {"pod": 2, "data": 2, "model": 2}
    assert gspmd.placements((("data", "model"), None), sizes) == (
        Replicate(), Shard(0), Shard(0))
    assert gspmd.placements((("pod", "model"), "data"), sizes) == (
        Shard(0), Shard(1), Shard(0))
    # size-1 axes shard nothing
    assert gspmd.placements((("data", "model"),), {"data": 1, "model": 4}) == (
        Replicate(), Shard(0))
    assert gspmd.placements(("model",), sizes, partial=[("data", "sum")]) == (
        Replicate(), gspmd.Partial("sum"), Shard(0))
    with pytest.raises(ValueError, match="not on the mesh"):
        gspmd.placements(("expert",), sizes)
    with pytest.raises(ValueError, match="splits dims"):
        gspmd.placements(("data", "data"), sizes)


def test_out_of_order_multi_axis_entry_raises_naming_it():
    """``policy_from_plan`` sorts a vote's axes: on ("pod", "data",
    "model") the entry ("data", "pod") is out of mesh order.  The port
    does not place it as given (no ``_StridedShard``): ``placements``
    raises, naming it.  Its callers nest the entry in mesh order first —
    the policy's ``sharding``, which places the model stack's tensors, and
    the gspmd executor's static program, which places such a plan as the
    plan in mesh order (tests/test_torch_gspmd.py runs it against the
    reference)."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    with pytest.raises(NotImplementedError, match=r"\('data', 'pod'\)"):
        gspmd.placements((("data", "pod"), None), sizes)
    pol = policy_mod.manual_policy({"b": ("data", "pod")})
    assert pol.sharding(sizes, "b s", (8, 4)) == gspmd.placements(
        (("pod", "data"), None), sizes) == (Shard(0), Shard(0), Replicate())
    from repro_torch.core.decomp import Plan
    from repro_torch.core.einsum import EinGraph

    g = EinGraph("order")
    x = g.input("x", "b a", (8, 4))
    w = g.input("w", "a f", (4, 8))
    g.einsum("b a, a f -> b f", x, w)
    plan = Plan(p=8, mode="mesh")
    for n in g.nodes:
        plan.axes_by_node[n.nid] = {"b": ("data", "pod")}
    nested = gspmd.build_program(g, plan, sizes)
    plan.axes_by_node = {n.nid: {"b": ("pod", "data")} for n in g.nodes}
    prog = gspmd.build_program(g, plan, sizes)  # mesh order: placed
    assert prog[2].local_spec == (("pod", "data"), None)
    assert [(st.arg_specs, st.local_spec, st.out_spec) for st in nested] == [
        (st.arg_specs, st.local_spec, st.out_spec) for st in prog]


def test_mesh_constructors_without_a_process_group():
    m = mesh_mod.make_host_mesh(device="cpu")
    assert m.sizes == {"data": 1, "model": 1} and m.dmesh is None
    m = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    assert m.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="differ"):
        mesh_mod.make_mesh((1, 1), ("data",), device="cpu")
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="256|512"):
            mesh_mod.make_production_mesh(multi_pod=multi, device="cpu")


def test_register_opaque_is_the_deprecated_shim():
    from repro_torch.core.opdef import OPAQUE_FNS

    fn = lambda x: x  # noqa: E731
    with pytest.warns(DeprecationWarning, match="register_opaque"):
        engine.register_opaque("_placement_test_op", fn)
    try:
        assert OPAQUE_FNS["_placement_test_op"] is fn
    finally:
        del OPAQUE_FNS["_placement_test_op"]
