"""The port's kernels (flash attention, the ring-attention step, matmul):
plain versions against the reference and the dispatcher's routing (the CUDA
kernels themselves are held against their plain versions in
tests/test_torch_kernels_gpu.py, on a card).

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
from repro.kernels.flash_attention import flash_attention_step as pallas_step  # noqa: E402
from repro.kernels.matmul import matmul as pallas_matmul  # noqa: E402

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

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
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_step": 0,
                                   "matmul": 0, "gmm": 0}
    torch.testing.assert_close(got, ref.attention(*args, **kw), rtol=0, atol=0)


def test_kernel_impl_on_cpu_raises():
    args = [torch.zeros(1, 2, 8, 16) for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_attention(*args, impl="kernel")
    with pytest.raises(ValueError, match="impl must be"):
        ops.flash_attention(*args, impl="pallas")
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_step": 0,
                                   "matmul": 0, "gmm": 0}


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


# ---------------------------------------------------------------------------
# matmul and the ring-attention step
# ---------------------------------------------------------------------------

# tests/test_kernels.py's matmul cases and tolerances (f32 1e-4, bf16 3e-2,
# atol x8)
MM_CASES = [(128, 128, 128, "float32"), (256, 384, 128, "float32"),
            (128, 256, 512, "bfloat16"), (64, 64, 64, "float32")]
MM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("m,k,n,dt", MM_CASES)
def test_matmul_on_cpu_matches_pallas_interpret(m, k, n, dt):
    rng = np.random.default_rng(11)
    x, w = (rng.normal(size=s).astype(np.float32) for s in ((m, k), (k, n)))
    got = ops.matmul(_torch(x, dt), _torch(w, dt))
    want = pallas_matmul(_jax(x, dt), _jax(w, dt), interpret=True)
    assert got.dtype == getattr(torch, dt) and got.shape == (m, n)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=MM_TOL[dt],
                               atol=MM_TOL[dt] * 8)


# (b, hq, hkv, s, d, causal, window): GQA, MQA, a window, no mask
STEP_CASES = [(1, 4, 2, 64, 16, True, 0), (2, 4, 1, 64, 32, True, 24),
              (1, 2, 2, 64, 16, False, 0)]


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "h{}k{}{}w{}".format(
    c[1], c[2], "c" if c[5] else "", c[6]))
def test_step_chain_matches_pallas_interpret_at_every_ring_offset(case, r):
    """The ring as rank i runs it, for every i: its q block at i*blk, the kv
    blocks arriving in ring order (i, i-1, ...).  Under the causal mask the
    later blocks are fully masked for the early ranks -- the finite -1e30
    semantics the carries must share.  Every carry equals the Pallas step
    kernel's; the finalized chain equals dense attention."""
    b, hq, hkv, s, d, causal, window = case
    rng = np.random.default_rng(13)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    blk = s // r
    kw = dict(causal=causal, window=window)
    for i in range(r):
        qi = q[:, :, i * blk:(i + 1) * blk]
        carry = want = None
        for t in range(r):
            j = (i - t) % r
            kj, vj = k[:, :, j * blk:(j + 1) * blk], v[:, :, j * blk:(j + 1) * blk]
            off = dict(q_offset=i * blk, kv_offset=j * blk, **kw)
            carry = ops.flash_attention_step(
                *(torch.from_numpy(a) for a in (qi, kj, vj)), carry, **off)
            want = pallas_step(*(jnp.asarray(a) for a in (qi, kj, vj)), want,
                               interpret=True, **off)
            for got_t, want_t in zip(carry, want):
                np.testing.assert_allclose(_f32(got_t), _f32(want_t),
                                           rtol=2e-5, atol=2e-5)
        out = ops.attention_finalize(carry, torch.float32)
        dense = ref.attention(*(torch.from_numpy(a) for a in (qi, k, v)),
                              q_offset=i * blk, **kw)
        np.testing.assert_allclose(_f32(out), _f32(dense), rtol=2e-5, atol=2e-5)


def test_matmul_and_step_auto_on_cpu_count_no_launch():
    rng = np.random.default_rng(2)
    x, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((8, 4), (4, 6)))
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 4)).astype(np.float32))
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.matmul(x, w), ref.matmul(x, w), rtol=0, atol=0)
    got = ops.flash_attention_step(q, q, q, kv_offset=0)
    for a, b in zip(got, ref.attention_step(q, q, q, kv_offset=0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_step": 0,
                                   "matmul": 0, "gmm": 0}


def test_matmul_and_step_kernel_impl_on_cpu_raises():
    x = torch.zeros(8, 8)
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.matmul(x, x, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_attention_step(q, q, q, impl="kernel")
    with pytest.raises(ValueError, match="impl must be"):
        ops.matmul(x, x, impl="pallas")
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_step": 0,
                                   "matmul": 0, "gmm": 0}
    assert "matmul" not in _build._LOADED
    assert (_build.CSRC / "matmul.cu").exists()


@pytest.mark.parametrize("shapes,dt,match", [
    (((2, 3, 4), (4, 5)), torch.float32, "2-d"),
    (((3, 4), (5, 6)), torch.float32, "do not chain"),
    (((3, 4), (4, 6)), torch.float16, "dtype"),
])
def test_matmul_wrapper_rejects_what_the_kernel_does_not_take(shapes, dt, match):
    """Checked before any build; meta tensors stand in for CUDA ones."""
    x, w = (torch.empty(s, dtype=dt, device="meta") for s in shapes)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mm.matmul(x, w)
    with pytest.raises(ValueError, match=match):
        mm.check_args(x, w)
