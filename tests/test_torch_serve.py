"""The port's serving slice against the reference, on reduced llama.

The JAX package's seeded parameters are carried over with
``from_reference_params``, so both packages compute the same function:
prefill logits and every decode step's logits agree at rtol 1e-4 / atol
1e-5 in float32 (the float32 sums run in another order), and greedy
generations agree token for token.  A bfloat16 variant compares logits at
2e-2, relative to each element and to the logits' scale.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

VARIANTS = {
    "mha": {},
    "gqa": {"n_kv_heads": 2},
    "window": {"window": 8},
}


def _cfgs(variant, dtype="float32"):
    kw = dict(VARIANTS[variant], dtype=dtype)
    return (dataclasses.replace(ref_reduced(ref_get_config("llama-7b")), **kw),
            dataclasses.replace(reduced(get_config("llama-7b")), **kw))


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, ref_params)
    return ref_params, tf.from_reference_params(cfg, tree, device="cpu")


def _prompts(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _step_logits(variant, dtype, n_decode=3):
    """Prefill + ``n_decode`` teacher-forced decode steps in both packages;
    the reference's greedy tokens feed both."""
    ref_cfg, cfg = _cfgs(variant, dtype)
    ref_params, params = _params(ref_cfg, cfg)
    prompts = _prompts(cfg)
    b, s = prompts.shape
    kv_len = ref_cfg.kv_len(ref_serve.ShapeConfig("x", "decode", s + n_decode + 1, b))

    ref_logits, ref_caches = jax.jit(ref_steps.make_prefill_step(ref_cfg))(
        ref_params, {"tokens": jnp.asarray(prompts)})
    ref_caches = ref_serve.prepare_decode_caches(ref_cfg, ref_caches, s, kv_len)
    with torch.inference_mode():
        logits, caches = steps.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(prompts)})
        caches = port_serve.prepare_decode_caches(cfg, caches, s, kv_len)
    pairs = [(logits, ref_logits)]

    ref_decode = jax.jit(ref_steps.make_serve_step(ref_cfg))
    decode = steps.make_serve_step(cfg)
    tok = np.asarray(jnp.argmax(ref_logits[:, -1], axis=-1))[:, None].astype(np.int32)
    for i in range(n_decode):
        ref_logits, ref_caches = ref_decode(ref_params, jnp.asarray(tok), ref_caches,
                                            jnp.int32(s + i))
        with torch.inference_mode():
            logits, caches = decode(params, torch.from_numpy(tok), caches, s + i)
        pairs.append((logits, ref_logits))
        tok = np.asarray(jnp.argmax(ref_logits[:, -1], axis=-1))[:, None].astype(np.int32)
    return pairs


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_logits_match_reference(variant):
    pairs = _step_logits(variant, "float32")
    for step, (got, want) in enumerate(pairs):
        assert got.shape == want.shape, step
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {step}")


def test_bf16_logits_match_reference():
    """2e-2, relative to each element and to the logits' scale: XLA fuses
    elementwise chains and rounds to bf16 once per fusion, torch rounds
    after every op, so a logit near zero can differ by a bf16 ulp of the
    scale of the values it was computed from."""
    for step, (got, want) in enumerate(_step_logits("gqa", "bfloat16", n_decode=2)):
        assert got.dtype == torch.bfloat16
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_serve_generations_equal_reference(variant, tmp_path):
    ref_cfg, cfg = _cfgs(variant)
    ref_params, params = _params(ref_cfg, cfg, seed=1)
    prompts = _prompts(cfg, b=3, s=10, seed=2)
    want, _ = ref_serve.serve(ref_cfg, prompts, max_new=6, params=ref_params)
    store = str(tmp_path / "plans.json")
    got, stats = port_serve.serve(cfg, prompts, max_new=6, params=params,
                                  plan_cache=store, device="cpu")
    assert got.shape == (3, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["device"] == "cpu" and stats["decode_steps"] == 5
    # the second call plans through the stored plan: same generations
    again, _ = port_serve.serve(cfg, prompts, max_new=6, params=params,
                                plan_cache=store, device="cpu")
    np.testing.assert_array_equal(again, got)


def test_decode_writes_the_preallocated_cache_in_place():
    _, cfg = _cfgs("gqa")
    params = tf.init_params(cfg, seed=0, device="cpu")
    caches = tf.init_caches(cfg, 2, 16, device="cpu")
    buf = caches[0].k.data_ptr()
    with torch.inference_mode():
        _, out = tf.decode_step(params, torch.zeros(2, 1, dtype=torch.int32),
                                caches, 5, cfg)
    assert out[0].k.data_ptr() == buf
    assert out[0].k[:, :, 5].abs().sum() > 0
    assert out[0].k[:, :, 6:].abs().sum() == 0


def test_unported_blocks_raise_naming_their_slice():
    """The hymba and xLSTM blocks, which raised until the recurrent slice
    ported them, now build the reference's parameter leaves: the same
    tree, and every leaf of the same shape and dtype.  Only a block kind
    the reference does not know raises, naming it."""
    for arch in ("hymba-1.5b", "xlstm-125m"):
        ref_cfg = ref_reduced(ref_get_config(arch))
        want = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
        got = tf.init_params(reduced(get_config(arch)), device="cpu")
        want_leaves, want_tree = jax.tree.flatten(want)
        assert len(tree.leaves(got)) == len(want_leaves), arch
        for g, w in zip(tree.leaves(got), want_leaves):
            assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}", arch
        assert jax.tree.structure(jax.tree.map(
            np.asarray, tree.map(lambda t: t.numpy(), got))) == want_tree, arch
    cfg = dataclasses.replace(reduced(get_config("llama-7b")), block_pattern=("rwkv",))
    with pytest.raises(ValueError, match="rwkv"):
        tf.init_params(cfg, device="cpu")


def test_serve_cli_runs_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "llama-7b", "--reduced",
                                     "--batch", "2", "--prompt-len", "8",
                                     "--max-new", "3", "--device", "cpu"])
    port_serve.main()
    out = capsys.readouterr().out
    assert "generations" in out and "'device': 'cpu'" in out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_common_components_match_reference(dtype):
    """rmsnorm (cast before the gain), RoPE in f32, the activations."""
    from repro.models import common as ref_common
    from repro_torch.models import common

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(7, 12)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tol = 1e-6 if dtype == "float32" else 2e-2
    pairs = [
        (common.rmsnorm(tx, torch.from_numpy(g).to(tx.dtype)),
         ref_common.rmsnorm(jx, jnp.asarray(g, jx.dtype))),
        (common.apply_rope(tx, torch.from_numpy(pos), 1e4),
         ref_common.apply_rope(jx, jnp.asarray(pos), 1e4)),
    ] + [(common.activation(a)(tx), ref_common.activation(a)(jx))
         for a in ("silu", "gelu", "relu2", "relu")]
    for got, want in pairs:
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
