"""The port's attention kernels: plain versions against the reference and
the dispatcher's routing (the CUDA kernel itself is held against its plain
version in tests/test_torch_kernels_gpu.py, on a card).

Inputs come from a seeded numpy generator and go to both packages.  The
tolerances are the reference kernel tests' own: 2e-5 in float32, 2e-2 in
bfloat16.  No case has a fully masked query row (for those the TPU
kernel's output depends on its tiling).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (b, hq, hkv, sq, sk, d, causal, window, dtype): tests/test_kernels.py's cases
ATT_CASES = [
    (1, 4, 2, 128, 128, 64, True, 0, "float32"),
    (2, 2, 1, 256, 256, 32, True, 64, "float32"),
    (1, 2, 2, 128, 256, 64, False, 0, "float32"),
    (1, 8, 1, 128, 128, 128, True, 0, "float32"),
    (1, 4, 4, 128, 128, 64, True, 0, "bfloat16"),
    (2, 4, 2, 64, 64, 16, True, 32, "float32"),
]
# lengths that divide no tile, GQA 4:1, a window, bf16
RAGGED_CASES = [
    (1, 2, 2, 200, 200, 64, True, 0, "float32"),
    (2, 8, 2, 77, 77, 32, True, 0, "float32"),
    (1, 4, 1, 50, 130, 64, True, 24, "float32"),
    (1, 2, 2, 33, 70, 16, False, 0, "float32"),
    (1, 4, 2, 100, 100, 128, True, 0, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, seed=0):
    b, hq, hkv, sq, sk, d, causal, win, dt = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    # causal with sq < sk: the queries are the last sq positions
    qoff = sk - sq if causal else 0
    return q, k, v, dict(causal=causal, window=win, q_offset=qoff)


def _torch(x, dt, device="cpu"):
    return torch.from_numpy(x).to(getattr(torch, dt)).to(device)


def _jax(x, dt):
    return jnp.asarray(x, getattr(jnp, dt))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _case_id(c):
    return "b{}h{}k{}q{}s{}d{}{}w{}{}".format(c[0], c[1], c[2], c[3], c[4], c[5],
                                              "c" if c[6] else "", c[7], c[8][:2])


@pytest.mark.parametrize("case", ATT_CASES + RAGGED_CASES, ids=_case_id)
def test_ref_attention_matches_reference(case):
    q, k, v, kw = _inputs(case)
    dt = case[-1]
    got = ref.attention(_torch(q, dt), _torch(k, dt), _torch(v, dt), **kw)
    want = jref.attention(_jax(q, dt), _jax(k, dt), _jax(v, dt), **kw)
    assert got.dtype == getattr(torch, dt)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("case", ATT_CASES, ids=_case_id)
def test_ref_attention_matches_pallas_interpret(case):
    q, k, v, kw = _inputs(case)
    dt = case[-1]
    got = ref.attention(_torch(q, dt), _torch(k, dt), _torch(v, dt), **kw)
    want = pallas_flash(_jax(q, dt), _jax(k, dt), _jax(v, dt), blk_q=64,
                        blk_k=64, interpret=True, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt], atol=TOL[dt])


def test_ref_attention_step_chain_matches_reference():
    """Blocks folded in reverse order, then finalized: equal to the
    reference's chain and to dense attention."""
    q, k, v, kw = _inputs((1, 4, 2, 64, 64, 32, True, 0, "float32"), seed=3)
    carry = ref_carry = None
    for j in (1, 0):
        blk = slice(32 * j, 32 * (j + 1))
        carry = ref.attention_step(torch.from_numpy(q), torch.from_numpy(k[:, :, blk]),
                                   torch.from_numpy(v[:, :, blk]), carry,
                                   kv_offset=32 * j)
        ref_carry = jref.attention_step(jnp.asarray(q), jnp.asarray(k[:, :, blk]),
                                        jnp.asarray(v[:, :, blk]), ref_carry,
                                        kv_offset=32 * j)
    for a, b in zip(carry, ref_carry):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=2e-5, atol=2e-5)
    out = ref.attention_finalize(carry)
    dense = ref.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(_f32(out), _f32(dense), rtol=2e-5, atol=2e-5)


def test_kv_block_gather_matches_reference():
    rng = np.random.default_rng(1)
    pool = rng.normal(size=(7, 4, 2, 8)).astype(np.float32)
    tables = np.array([[3, 1, 6], [2, 5, 4]], np.int32)
    got = ops.kv_block_gather(torch.from_numpy(pool), torch.from_numpy(tables), 10)
    want = ref_ops.kv_block_gather(jnp.asarray(pool), jnp.asarray(tables), 10)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    with pytest.raises(ValueError, match="exceeds"):
        ops.kv_block_gather(torch.from_numpy(pool), torch.from_numpy(tables), 13)


# ---------------------------------------------------------------------------
# Dispatch: plain version on the CPU, the kernel or an error elsewhere
# ---------------------------------------------------------------------------


def test_kernel_module_imports_without_building():
    """Importing the kernel modules built nothing: the library is built at
    the first launch, on the machine with the card."""
    assert "flash_attention" not in _build._LOADED
    assert fa.MAX_HEAD_DIM == 256
    assert (_build.CSRC / "flash_attention.cu").exists()


def test_auto_on_cpu_takes_plain_version_and_counts_no_launch():
    q, k, v, kw = _inputs(ATT_CASES[0])
    ops.reset_launch_counts()
    args = [torch.from_numpy(x) for x in (q, k, v)]
    got = ops.flash_attention(*args, **kw)
    assert ops.launch_counts() == {"flash_attention": 0}
    torch.testing.assert_close(got, ref.attention(*args, **kw), rtol=0, atol=0)


def test_kernel_impl_on_cpu_raises():
    args = [torch.zeros(1, 2, 8, 16) for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_attention(*args, impl="kernel")
    with pytest.raises(ValueError, match="impl must be"):
        ops.flash_attention(*args, impl="pallas")
    assert ops.launch_counts() == {"flash_attention": 0}


@pytest.mark.parametrize("bad,match", [
    ({"d": 320}, "head_dim"), ({"hkv": 3}, "GQA"),
    ({"dtype": torch.float16}, "dtype"), ({"sk": 0}, "no keys"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    """Checked before any build; meta tensors stand in for CUDA ones."""
    d, hkv, sk = bad.get("d", 64), bad.get("hkv", 2), bad.get("sk", 8)
    dt = bad.get("dtype", torch.float32)
    q = torch.empty(1, 4, 8, d, dtype=dt, device="meta")
    k = torch.empty(1, hkv, sk, d, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match=match):
        fa.check_args(q, k, k)


@pytest.mark.parametrize("dt,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_ref_matmul_gmm_rmsnorm_match_reference(dt, tol):
    """The other plain versions (their kernels come in later slices), at the
    reference matmul tests' tolerances."""
    rng = np.random.default_rng(5)
    x, w = rng.normal(size=(64, 96)), rng.normal(size=(96, 32))
    xe, we = rng.normal(size=(3, 16, 24)), rng.normal(size=(3, 24, 8))
    g = rng.normal(size=(96,))
    pairs = [
        (ref.matmul(_torch(x.astype(np.float32), dt), _torch(w.astype(np.float32), dt)),
         jref.matmul(_jax(x, dt), _jax(w, dt))),
        (ref.gmm(_torch(xe.astype(np.float32), dt), _torch(we.astype(np.float32), dt)),
         jref.gmm(_jax(xe, dt), _jax(we, dt))),
        (ref.rmsnorm(_torch(x.astype(np.float32), dt), _torch(g.astype(np.float32), dt)),
         jref.rmsnorm(_jax(x, dt), _jax(g, dt))),
    ]
    for got, want in pairs:
        assert got.dtype == getattr(torch, dt)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol * 8)
