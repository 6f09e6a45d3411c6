"""The port's MoE slice against the reference, on the CPU.

Seeded numpy inputs go through the JAX package and the port:

* the grouped-matmul wrapper (``ops.gmm``, the plain version for CPU
  tensors) against the Pallas kernel in interpret mode, at the reference
  kernel test's shapes and tolerances (float32 1e-4, bf16 3e-2, atol x8);
* ``moe_ffn`` in both dispatch modes, with pad experts, a shared expert
  and real capacity drops, float32 at rtol 1e-4 / atol 1e-5, aux loss
  included;
* reduced qwen2-moe and mixtral through ``from_reference_params``: prefill
  and decode logits (rtol 1e-4 / atol 1e-5, float32: the sums run in
  another order) and greedy generations token for token;
* the dense MoE stubs and the routing helper of the ``a2a`` rule, exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.opaque_rules import moe_route as ref_moe_route  # noqa: E402
from repro.kernels.moe_gmm import gmm as pallas_gmm  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import opaque_stubs as ref_stubs  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.opaque_rules import moe_route  # noqa: E402
from repro_torch.kernels import moe_gmm, ops  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import opaque_stubs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,c,k,n,dt", [  # tests/test_kernels.py
    (4, 128, 256, 128, "float32"),
    (8, 128, 128, 384, "float32"),
    (2, 256, 128, 128, "bfloat16"),
])
def test_gmm_auto_on_cpu_matches_pallas_kernel(e, c, k, n, dt):
    rng = np.random.default_rng(0)
    x, w = (rng.normal(size=s).astype(np.float32) for s in ((e, c, k), (e, k, n)))
    jx, jw = (jnp.asarray(a, getattr(jnp, dt)) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dt)) for a in (x, w))
    ops.reset_launch_counts()
    got = ops.gmm(tx, tw)
    assert got.dtype == tx.dtype and ops.launch_counts()["gmm"] == 0
    tol = 3e-2 if dt == "bfloat16" else 1e-4
    np.testing.assert_allclose(_f32(got), _f32(pallas_gmm(jx, jw, interpret=True)),
                               rtol=tol, atol=tol * 8)


def test_gmm_kernel_on_cpu_raises():
    x, w = torch.zeros(2, 8, 4), torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.gmm(x, w, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        moe_gmm.gmm(x, w)
    with pytest.raises(ValueError, match="impl must be"):
        ops.gmm(x, w, impl="pallas")
    assert ops.launch_counts()["gmm"] == 0


@pytest.mark.parametrize("shapes,dt,match", [
    (((8, 4), (4, 6)), torch.float32, "3-d"),
    (((2, 8, 4), (3, 4, 6)), torch.float32, "do not chain"),
    (((2, 8, 4), (2, 5, 6)), torch.float32, "do not chain"),
    (((2, 8, 4), (2, 4, 6)), torch.float16, "dtype"),
])
def test_gmm_wrapper_rejects_what_the_kernel_does_not_take(shapes, dt, match):
    """Checked before any build; meta tensors stand in for CUDA ones."""
    x, w = (torch.empty(s, dtype=dt, device="meta") for s in shapes)
    with pytest.raises(ValueError, match=match):
        moe_gmm.check_args(x, w)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

MOE_CASES = {
    "pad": dict(n_experts=6, n_experts_padded=8, shared_expert_ff=0),
    "shared": dict(n_experts=8, n_experts_padded=8, shared_expert_ff=64),
    "pad_shared_top3": dict(n_experts=6, n_experts_padded=8,
                            shared_expert_ff=48, top_k=3),
}


def _moe_params(cfg, seed=0):
    """Seeded numpy parameters in the reference's layout."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_e, cfg.d_ff

    def dense(*shape):
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(np.float32)

    p = {"router": dense(D, E), "w1": dense(E, D, F), "w2": dense(E, F, D),
         "w3": dense(E, D, F)}
    if cfg.shared_expert_ff:
        S = cfg.shared_expert_ff
        p["shared"] = {"w1": dense(D, S), "w2": dense(S, D), "w3": dense(D, S)}
    return p


def _both(p):
    return (jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p))


@pytest.mark.parametrize("groups", [0, 2], ids=["global", "group-local"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case, groups):
    ref_cfg, cfg = _cfgs("qwen2-moe-a2.7b", moe_groups=groups, **MOE_CASES[case])
    jp, tp = _both(_moe_params(cfg))
    x = np.random.default_rng(1).normal(size=(4, 6, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.moe_ffn(jp, jnp.asarray(x), ref_cfg)
    got, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4, atol=1e-5)


def test_pad_experts_never_win_routing():
    _, cfg = _cfgs("qwen2-moe-a2.7b", **MOE_CASES["pad"])
    _, tp = _both(_moe_params(cfg))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, cfg.d_model)).astype(np.float32))
    _, tope, _ = moe._route(tp, x, cfg)
    assert int(tope.max()) < cfg.n_experts


@pytest.mark.parametrize("C", [2, 4, 8])
def test_capacity_drops_match_reference(C):
    """32 tokens x top-3 over 6 real experts into C slots each: full
    experts drop tokens, and which ones depends on the stable sort's
    ranks."""
    ref_cfg, cfg = _cfgs("qwen2-moe-a2.7b", **MOE_CASES["pad_shared_top3"])
    jp, tp = _both(_moe_params(cfg, seed=3))
    xt = np.random.default_rng(4).normal(size=(32, cfg.d_model)).astype(np.float32)
    topw, tope, _ = ref_moe._route(jp, jnp.asarray(xt), ref_cfg)
    assert np.bincount(np.asarray(tope).ravel()).max() > C  # real drops
    want = ref_moe._dispatch_compute_combine(jp, jnp.asarray(xt), topw, tope, C,
                                             ref_cfg)
    got = moe._dispatch_compute_combine(
        tp, torch.from_numpy(xt), torch.from_numpy(np.array(topw)),
        torch.from_numpy(np.asarray(tope).astype(np.int64)), C, cfg)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_tokens", [4, 100, 2048, 10000])
def test_capacity_matches_reference(n_tokens):
    for arch in ARCHS:
        assert moe._capacity(n_tokens, get_config(arch)) == ref_moe._capacity(
            n_tokens, ref_get_config(arch))


# ---------------------------------------------------------------------------
# Reduced MoE models
# ---------------------------------------------------------------------------


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, tf.from_reference_params(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")


def _prompts(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_logits_match_reference(arch):
    """Prefill (aux loss included) and three teacher-forced decode steps,
    the reference's greedy tokens feeding both."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg)
    assert "moe" in params["layers"][0] and "ffn" not in params["layers"][0]
    prompts = _prompts(cfg)
    b, s = prompts.shape
    want, _, want_aux = ref_tf.forward(ref_params, jnp.asarray(prompts), ref_cfg)
    with torch.inference_mode():
        got, _, aux = tf.forward(params, torch.from_numpy(prompts), cfg)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4, atol=1e-5)
    assert float(aux) > 0

    kv_len = ref_cfg.kv_len(ref_serve.ShapeConfig("x", "decode", s + 4, b))
    ref_logits, ref_caches = jax.jit(ref_steps.make_prefill_step(ref_cfg))(
        ref_params, {"tokens": jnp.asarray(prompts)})
    ref_caches = ref_serve.prepare_decode_caches(ref_cfg, ref_caches, s, kv_len)
    with torch.inference_mode():
        logits, caches = steps.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(prompts)})
        caches = port_serve.prepare_decode_caches(cfg, caches, s, kv_len)
    np.testing.assert_allclose(_f32(logits), _f32(ref_logits), rtol=1e-4, atol=1e-5)
    ref_decode = jax.jit(ref_steps.make_serve_step(ref_cfg))
    decode = steps.make_serve_step(cfg)
    for i in range(3):
        tok = np.asarray(jnp.argmax(ref_logits[:, -1], axis=-1))[:, None].astype(np.int32)
        ref_logits, ref_caches = ref_decode(ref_params, jnp.asarray(tok), ref_caches,
                                            jnp.int32(s + i))
        with torch.inference_mode():
            logits, caches = decode(params, torch.from_numpy(tok), caches, s + i)
        np.testing.assert_allclose(_f32(logits), _f32(ref_logits), rtol=1e-4,
                                   atol=1e-5, err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_serve_generations_equal_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=1)
    prompts = _prompts(cfg, b=3, s=10, seed=2)
    want, _ = ref_serve.serve(ref_cfg, prompts, max_new=6, params=ref_params)
    got, stats = port_serve.serve(cfg, prompts, max_new=6, params=params,
                                  device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["decode_steps"] == 5


def test_mixtral_prefill_decode_self_consistency():
    """Teacher-forced decode reproduces the full forward's logits inside
    the port (the reference's own check, at its 2e-2)."""
    cfg = reduced(get_config("mixtral-8x7b"))
    params = tf.init_params(cfg, seed=1, device="cpu")
    B, T = 2, 8
    toks = torch.from_numpy(_prompts(cfg, b=B, s=T, seed=5))
    kv_len = cfg.window if cfg.window else T
    caches = tf.init_caches(cfg, B, kv_len, device="cpu")
    with torch.inference_mode():
        full, _, _ = tf.forward(params, toks, cfg)
        outs = []
        for t in range(T):
            lg, caches = tf.decode_step(params, toks[:, t:t + 1], caches, t, cfg)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(_f32(torch.stack(outs, dim=1)), _f32(full),
                               rtol=2e-2, atol=2e-2)


def test_serve_cli_runs_qwen2_moe_reduced_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2-moe-a2.7b",
                                     "--reduced", "--batch", "2", "--prompt-len",
                                     "8", "--max-new", "3", "--device", "cpu"])
    port_serve.main()
    out = capsys.readouterr().out
    assert "generations" in out and "'device': 'cpu'" in out


# ---------------------------------------------------------------------------
# The a2a rule's routing helper and the dense MoE stubs
# ---------------------------------------------------------------------------


def _route_input(seed=6, b=2, s=16, e=8):
    # a few exact ties, so argmax must take the first maximum as jax does
    r = np.random.default_rng(seed).normal(size=(b, s, e)).astype(np.float32)
    r[0, 3, 5] = r[0, 3].max()
    r[1, 7, :] = 0.0
    return r


def test_moe_route_matches_reference():
    r = _route_input()
    got = moe_route(torch.from_numpy(r))
    want = ref_moe_route(jnp.asarray(r))
    for name, a, b in zip(("expert", "pos", "gate", "cnt"), got, want):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-6, atol=0, err_msg=name)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.int32


@pytest.mark.parametrize("cap", [2, 4])
def test_moe_stubs_match_reference(cap):
    """Dispatch/combine with capacity drops, and the scans' running mean."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 5)).astype(np.float32)
    r = _route_input()
    fns = opaque_stubs.make_stub_opaques(cap, register=False)
    ref_fns = ref_stubs.make_stub_opaques(cap, register=False)
    disp = fns["moe_dispatch"](torch.from_numpy(x), torch.from_numpy(r))
    want = ref_fns["moe_dispatch"](jnp.asarray(x), jnp.asarray(r))
    np.testing.assert_allclose(_f32(disp), _f32(want), rtol=0, atol=0)
    y = rng.normal(size=tuple(disp.shape)).astype(np.float32)
    np.testing.assert_allclose(
        _f32(fns["moe_combine"](torch.from_numpy(y), torch.from_numpy(r))),
        _f32(ref_fns["moe_combine"](jnp.asarray(y), jnp.asarray(r))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_f32(fns["ssm_scan"](torch.from_numpy(x))),
                               _f32(ref_fns["ssm_scan"](jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_capacity_of_reads_the_dispatch_node():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.eingraphs import program_for

    cfg = reduced(get_config("mixtral-8x7b"))
    g = program_for(cfg, ShapeConfig("x", "prefill", 8, 2)).graph
    assert opaque_stubs.capacity_of(g) == moe._capacity(16, cfg) == 128
    llama = program_for(reduced(get_config("llama-7b")),
                        ShapeConfig("x", "prefill", 8, 2)).graph
    assert opaque_stubs.capacity_of(llama) == 0
