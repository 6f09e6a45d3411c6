"""The port's kernels (flash attention, the ring-attention step, matmul):
plain versions against the reference and the dispatcher's routing (the CUDA
kernels themselves are held against their plain versions in
tests/test_torch_kernels_gpu.py, on a card).

Inputs come from a seeded numpy generator and go to both packages.  The
tolerances are the reference kernel tests' own: 2e-5 in float32, 2e-2 in
bfloat16.  Rows that see no key are held against the Pallas kernel at its
own 128 x 128 blocks (``ref.attention_tiled``, the forward kernels'
convention); elsewhere no case has such a row.  The shape rule that picks
each kernel's design, and the build's source hash, are checked here too.
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
    # head dim 256 with MQA 8:1 (paligemma's attention), both types
    (1, 8, 1, 128, 128, 256, True, 0, "float32"),
    (1, 8, 1, 128, 192, 256, True, 64, "bfloat16"),
]
# lengths that divide no tile, GQA 4:1, a window, bf16
RAGGED_CASES = [
    (1, 2, 2, 200, 200, 64, True, 0, "float32"),
    (2, 8, 2, 77, 77, 32, True, 0, "float32"),
    (1, 4, 1, 50, 130, 64, True, 24, "float32"),
    (1, 2, 2, 33, 70, 16, False, 0, "float32"),
    (1, 4, 2, 100, 100, 128, True, 0, "bfloat16"),
    (1, 8, 1, 77, 333, 256, True, 0, "float32"),     # head dim 256, MQA 8:1
    (2, 8, 1, 260, 260, 256, True, 40, "bfloat16"),  # head dim 256, window
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


# paligemma-3b's float32 slice (256 prefix + 64 tokens, MQA 8:1, head dim
# 256): the ffma design's path shape
PALIGEMMA_F32_SLICE = (1, 8, 1, 320, 320, 256, True, 0, "float32")


@pytest.mark.parametrize("case", ATT_CASES + [PALIGEMMA_F32_SLICE], ids=_case_id)
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
    """Checked before any build; meta tensors stand in for CUDA ones (the
    wrapper takes them, as the dry run's abstract blocks, and refuses the
    shape), CPU tensors are refused as such."""
    d, hkv, sk = bad.get("d", 64), bad.get("hkv", 2), bad.get("sk", 8)
    dt = bad.get("dtype", torch.float32)
    q = torch.empty(1, 4, 8, d, dtype=dt, device="meta")
    k = torch.empty(1, hkv, sk, d, dtype=dt, device="meta")
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match=match):
        fa.check_args(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(*(torch.empty(t.shape, dtype=t.dtype) for t in (q, k, k)))


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
    """Checked before any build; meta tensors stand in for CUDA ones (the
    wrapper takes them and refuses the shape), CPU tensors are refused as
    such."""
    x, w = (torch.empty(s, dtype=dt, device="meta") for s in shapes)
    with pytest.raises(ValueError, match=match):
        mm.matmul(x, w)
    with pytest.raises(ValueError, match=match):
        mm.check_args(x, w)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mm.matmul(*(torch.empty(s, dtype=dt) for s in shapes))


# ---------------------------------------------------------------------------
# Fully masked query rows: the TPU kernel's 128 x 128 tile skipping
# ---------------------------------------------------------------------------

# (b, hq, hkv, sq, sk, d, causal, window, q_offset, kv_offset, dtype): every
# case has query rows that see no key; sq, sk in {128, 256}, the blocks the
# Pallas kernel takes by default (min(128, s))
MASKED_CASES = [
    (1, 4, 2, 128, 128, 32, True, 0, 0, 64, "float32"),     # q_offset < kv_offset
    (1, 4, 4, 256, 256, 32, True, 0, 0, 100, "float32"),    # one block pair skipped
    (2, 8, 2, 256, 256, 16, True, 8, 0, 120, "float32"),    # window, GQA 4:1
    (1, 4, 2, 128, 256, 32, False, 64, 250, 0, "float32"),  # window without causal
    (1, 2, 1, 128, 256, 32, True, 16, 300, 0, "float32"),   # every block skipped
    (1, 4, 1, 256, 128, 64, True, 0, 0, 130, "bfloat16"),   # GQA 4:1, bf16
    (1, 8, 1, 256, 256, 256, True, 0, 0, 100, "bfloat16"),  # head dim 256, MQA 8:1
    (1, 8, 1, 256, 128, 256, True, 8, 0, 120, "float32"),   # head dim 256, window
]


def _masked_id(c):
    return "h{}k{}q{}s{}{}w{}qo{}ko{}{}".format(c[1], c[2], c[3], c[4], "c" if c[6] else "",
                                               c[7], c[8], c[9], c[10][:2])


def _masked_inputs(case, seed=17):
    b, hq, hkv, sq, sk, d, causal, window, qo, ko, dt = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    return q, k, v, dict(causal=causal, window=window, q_offset=qo, kv_offset=ko)


@pytest.mark.parametrize("case", MASKED_CASES, ids=_masked_id)
def test_tiled_attention_matches_pallas_on_fully_masked_rows(case):
    """The port's convention for rows that see no key is the Pallas
    kernel's at its default 128 x 128 blocks: 0 where every block pair of
    the row is skipped, else the mean of v over the keys of the pairs that
    are not.  Rows that see a key equal plain attention."""
    q, k, v, kw = _masked_inputs(case)
    dt = case[-1]
    got = ref.attention_tiled(_torch(q, dt), _torch(k, dt), _torch(v, dt), **kw)
    want = pallas_flash(_jax(q, dt), _jax(k, dt), _jax(v, dt), interpret=True, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt], atol=TOL[dt])
    sq, sk = case[3], case[4]
    sees = ref._mask(sq, sk, kw["q_offset"], kw["kv_offset"], kw["causal"],
                     kw["window"]).any(dim=1).numpy()
    assert not sees.all(), "the case must hold fully masked rows"
    plain = ref.attention(_torch(q, dt), _torch(k, dt), _torch(v, dt), **kw)
    np.testing.assert_allclose(_f32(got)[:, :, sees], _f32(plain)[:, :, sees],
                               rtol=TOL[dt], atol=TOL[dt])


def test_tiled_attention_differs_from_plain_only_on_rows_that_see_no_key():
    """Where a fully masked row's block pair is visited, the tile
    convention (mean of v) and plain attention (the mean over every key,
    since all its scores are -1e30) part ways; elsewhere they agree."""
    q, k, v, kw = _masked_inputs(MASKED_CASES[1])
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tiled, plain = ref.attention_tiled(*args, **kw), ref.attention(*args, **kw)
    vis = ref._mask(256, 256, 0, 100, True, 0).any(dim=1)
    torch.testing.assert_close(tiled[:, :, vis], plain[:, :, vis], rtol=2e-5, atol=2e-5)
    # rows 0..99 see no key: their pair with key block 0 (keys 100..227) is
    # visited, the pair with block 1 (keys 228..355) skipped
    want = args[2][:, :, :128].mean(dim=2, keepdim=True)
    torch.testing.assert_close(tiled[:, :, :100], want.expand(-1, -1, 100, -1),
                               rtol=1e-5, atol=1e-5)
    assert not torch.allclose(tiled[:, :, :100], plain[:, :, :100], atol=1e-3)


@pytest.mark.parametrize("sq,sk,qo,ko", [(200, 333, 0, 150), (77, 300, 40, 0),
                                         (300, 90, 0, 60)])
def test_tiled_attention_ragged_blocks_follow_their_nominal_extent(sq, sk, qo, ko):
    """Lengths that divide no block (the port takes them; the Pallas kernel
    asserts they divide): the last block is partial and its nominal extent
    [start, start + block - 1] decides whether a pair is skipped.  Checked
    against a direct loop over block pairs with the online softmax."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 2, sq, 16), (1, 2, sk, 16), (1, 2, sk, 16)))
    kw = dict(causal=True, window=0, q_offset=qo, kv_offset=ko)
    got = ref.attention_tiled(q, k, v, **kw)
    bq, bk = min(128, sq), min(128, sk)
    want = torch.zeros_like(q)
    for q0 in range(0, sq, bq):
        qs = q[:, :, q0:q0 + bq] * 16 ** -0.5
        m = torch.full(qs.shape[:3], -torch.inf)
        l = torch.zeros(qs.shape[:3])
        acc = torch.zeros_like(qs)
        for k0 in range(0, sk, bk):
            if ko + k0 > qo + q0 + bq - 1:  # causal: the pair is skipped
                continue
            s = qs @ k[:, :, k0:k0 + bk].transpose(-1, -2)
            keep = ref._mask(qs.shape[2], s.shape[-1], qo + q0, ko + k0, True, 0)
            s = torch.where(keep, s, torch.full_like(s, ref.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha, p = torch.exp(m - m_new), torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ v[:, :, k0:k0 + bk]
            m = m_new
        l = torch.where(l == 0, torch.ones_like(l), l)
        want[:, :, q0:q0 + bq] = acc / l[..., None]
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The shape rule: which design serves a call (pure: reads dtypes, shapes,
# strides and base addresses; CPU tensors stand in for CUDA ones)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,strides,itemsize,ptr,inner,ok", [
    ((4, 32, 512, 128), (2097152, 65536, 128, 1), 2, 0, 3, True),
    ((4, 32, 512, 128), (2097152, 128, 4096, 1), 2, 0, 3, True),   # (b, s, h, d).T
    ((4, 32, 512, 128), (2097152, 65536, 128, 1), 2, 8, 3, False),  # base % 16
    ((3, 77, 130), (10010, 130, 1), 2, 0, 2, False),                # 260-byte rows
    ((3, 77, 136), (10472, 136, 1), 2, 0, 2, True),
    ((2, 64), (1, 2), 2, 0, 1, False),                              # inner not unit
    ((2, 64), (1, 2), 2, 0, 0, False),                              # 4-byte stride
    ((1, 64), (7, 1), 2, 0, 1, True),                               # size-1 dim
    ((4, 8, 16, 64), (0, 0, 64, 1), 2, 0, 3, False),                # expanded
    ((8, 64), (-64, 1), 2, 0, 1, False),                            # negative
])
def test_tma_addressable_rule(shape, strides, itemsize, ptr, inner, ok):
    from repro_torch.kernels import _tma
    assert _tma.addressable(shape, strides, itemsize, ptr, inner) is ok


def _misaligned(shape, dtype):
    """A contiguous tensor whose base is 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize("name,want", [
    ("bf16_d128", "wgmma"), ("bf16_d64", "wgmma"), ("bf16_bshd_views", "wgmma"),
    ("bf16_gqa", "wgmma"), ("bf16_ragged", "wgmma"),
    ("f32_d128", "ffma"), ("bf16_d256", "wgmma"), ("bf16_d256_bshd_views", "wgmma"),
    ("bf16_d256_mqa_ragged", "wgmma"), ("bf16_d256_misaligned_base", "template"),
    ("bf16_d192", "template"),
    ("bf16_d32", "template"), ("bf16_misaligned_base", "template"),
    ("bf16_rows_not_16_bytes", "template"), ("bf16_expanded_kv", "template"),
    ("f32_d64", "ffma"), ("f32_bshd_views", "ffma"), ("f32_gqa_ragged", "ffma"),
    ("f32_d32", "template"), ("f32_misaligned_base", "template"),
    ("f32_rows_not_16_bytes", "template"), ("f32_d256", "ffma"),
    ("f32_d256_bshd_views", "ffma"), ("f32_d256_misaligned_base", "template"),
    ("f32_d192", "template"),
    ("f32_base_16_bytes_in", "ffma"), ("f32_expanded_kv", "template"),
])
def test_flash_design_rule(name, want):
    bf, f32 = torch.bfloat16, torch.float32

    def t(shape, dt=bf):
        return torch.zeros(shape, dtype=dt)
    qkv = {
        "bf16_d128": [t((4, 32, 512, 128))] * 3,
        "bf16_d64": [t((1, 8, 256, 64))] * 3,
        "bf16_bshd_views": [t((4, 512, 32, 128)).transpose(1, 2)] * 3,
        "bf16_gqa": [t((2, 16, 300, 128)), t((2, 4, 300, 128)), t((2, 4, 300, 128))],
        "bf16_ragged": [t((1, 4, 77, 64)), t((1, 4, 333, 64)), t((1, 4, 333, 64))],
        "f32_d128": [t((4, 32, 512, 128), f32)] * 3,
        "bf16_d256": [t((1, 8, 77, 256))] * 3,
        "bf16_d256_bshd_views": [t((4, 512, 8, 256)).transpose(1, 2),
                                 t((4, 512, 1, 256)).transpose(1, 2),
                                 t((4, 512, 1, 256)).transpose(1, 2)],
        "bf16_d256_mqa_ragged": [t((2, 8, 77, 256)), t((2, 1, 333, 256)),
                                 t((2, 1, 333, 256))],
        "bf16_d256_misaligned_base": [_misaligned((1, 8, 77, 256), bf)] * 3,
        "bf16_d192": [t((1, 8, 77, 192))] * 3,
        "bf16_d32": [t((1, 8, 77, 32))] * 3,
        "bf16_misaligned_base": [_misaligned((1, 2, 128, 128), bf)] * 3,
        "bf16_rows_not_16_bytes": [t((1, 2, 128, 100))[..., :64]] * 3,
        "bf16_expanded_kv": [t((1, 8, 128, 64)), t((1, 1, 128, 64)).expand(1, 8, 128, 64),
                             t((1, 8, 128, 64))],
        "f32_d64": [t((1, 8, 256, 64), f32)] * 3,
        "f32_bshd_views": [t((4, 512, 32, 128), f32).transpose(1, 2)] * 3,
        "f32_gqa_ragged": [t((1, 16, 77, 128), f32), t((1, 4, 333, 128), f32),
                           t((1, 4, 333, 128), f32)],
        "f32_d32": [t((1, 8, 77, 32), f32)] * 3,
        "f32_misaligned_base": [_misaligned((1, 2, 128, 128), f32)] * 3,
        # rows of 66 floats (264 bytes): a stride no 16-byte copy can step
        "f32_rows_not_16_bytes": [t((1, 2, 128, 66), f32)[..., :64]] * 3,
        "f32_d256": [t((1, 8, 77, 256), f32)] * 3,
        "f32_d256_bshd_views": [t((4, 512, 8, 256), f32).transpose(1, 2),
                                t((4, 512, 1, 256), f32).transpose(1, 2),
                                t((4, 512, 1, 256), f32).transpose(1, 2)],
        "f32_d256_misaligned_base": [_misaligned((1, 8, 77, 256), f32)] * 3,
        "f32_d192": [t((1, 8, 77, 192), f32)] * 3,
        "f32_base_16_bytes_in": [torch.zeros(2 * 64 * 64 + 4)[4:].view(1, 2, 64, 64)] * 3,
        "f32_expanded_kv": [t((1, 8, 128, 64), f32),
                            t((1, 1, 128, 64), f32).expand(1, 8, 128, 64),
                            t((1, 8, 128, 64), f32)],
    }[name]
    assert fa.design(*qkv) == want


@pytest.mark.parametrize("name,want", [
    ("contiguous", (0, 1)), ("x_transposed", (1, 1)), ("w_transposed", (0, 0)),
    ("both_transposed", (1, 0)), ("ragged_k_in_aligned_rows", (0, 1)),
    ("f32", (0, 1)), ("misaligned_rows", None), ("misaligned_base", None),
    ("w_column_stride_2", None),
    ("f32_x_transposed", (1, 1)), ("f32_w_transposed", (0, 0)),
    ("f32_both_transposed", (1, 0)), ("f32_ragged_k_in_aligned_rows", (0, 1)),
    ("f32_ragged_m_n_k", (0, 1)), ("f32_base_16_bytes_in", (0, 1)),
    ("f32_rows_of_6_floats", None), ("f32_rows_of_130_floats", None),
    ("f32_misaligned_base", None), ("f32_w_column_stride_2", None),
    ("f32_x_transposed_rows_of_130", None), ("f32_with_bf16", None),
])
def test_matmul_layout_rule(name, want):
    """Operands with a contiguous inner dim (K-major or M-major x, N-major
    or K-major w) whose other strides and base are 16-byte multiples take
    the wgmma design in bf16 and the ffma design in float32 (4 floats to
    16 bytes); everything else the template.  Pure: reads dtypes, shapes,
    strides and base addresses."""
    bf, f32 = torch.bfloat16, torch.float32
    x, w = torch.zeros(256, 192, dtype=bf), torch.zeros(192, 384, dtype=bf)
    xf, wf = x.float(), w.float()
    xw = {
        "contiguous": (x, w),
        "x_transposed": (x.t().contiguous().t(), w),
        "w_transposed": (x, w.t().contiguous().t()),
        "both_transposed": (x.t().contiguous().t(), w.t().contiguous().t()),
        "ragged_k_in_aligned_rows": (x[:, :77], w[:77]),
        "f32": (xf, wf),
        "misaligned_rows": (torch.zeros(77, 130, dtype=bf), torch.zeros(130, 77, dtype=bf)),
        "misaligned_base": (_misaligned((256, 192), bf), w),
        "w_column_stride_2": (x, torch.zeros(192, 768, dtype=bf)[:, ::2]),
        "f32_x_transposed": (xf.t().contiguous().t(), wf),
        "f32_w_transposed": (xf, wf.t().contiguous().t()),
        "f32_both_transposed": (xf.t().contiguous().t(), wf.t().contiguous().t()),
        "f32_ragged_k_in_aligned_rows": (xf[:, :77], wf[:77]),
        "f32_ragged_m_n_k": (torch.zeros(200, 300), torch.zeros(300, 76)),
        "f32_base_16_bytes_in": (torch.zeros(256 * 192 + 4)[4:].view(256, 192), wf),
        "f32_rows_of_6_floats": (torch.zeros(10, 6), torch.zeros(6, 8)),
        "f32_rows_of_130_floats": (torch.zeros(77, 130), torch.zeros(130, 64)),
        "f32_misaligned_base": (_misaligned((256, 192), f32), wf),
        "f32_w_column_stride_2": (xf, torch.zeros(192, 768)[:, ::2]),
        "f32_x_transposed_rows_of_130": (torch.zeros(192, 130).t(), wf),
        "f32_with_bf16": (xf, w),
    }[name]
    assert mm.layouts(*xw) == want
    ruled = "ffma" if xw[0].dtype == f32 else "wgmma"
    assert mm.design(*xw) == ("template" if want is None else ruled)


@pytest.mark.parametrize("name,want", [
    ("contiguous", "wgmma"), ("stacked_unit_view", "wgmma"), ("x_transposed", "wgmma"),
    ("ragged_rank_local", "template"), ("f32", "ffma"),
    ("odd_expert_stride", "template"),
    ("f32_stacked_unit_view", "ffma"), ("f32_x_transposed", "ffma"),
    ("f32_ragged_rank_local", "template"), ("f32_odd_expert_stride", "template"),
    ("f32_expert_stride_2_floats", "template"), ("f32_one_expert_any_stride", "ffma"),
])
def test_gmm_design_rule(name, want):
    """gmm shares matmul's rule over the last two dims; the expert stride
    must be a 16-byte multiple too (any stride of a single expert)."""
    bf = torch.bfloat16
    x, w = torch.zeros(4, 128, 256, dtype=bf), torch.zeros(4, 256, 64, dtype=bf)
    xf, wf = x.float(), w.float()
    xw = {
        "contiguous": (x, w),
        "stacked_unit_view": (x, torch.zeros(4, 3, 256, 64, dtype=bf)[:, 1]),
        "x_transposed": (x.transpose(1, 2).contiguous().transpose(1, 2), w),
        "ragged_rank_local": (torch.zeros(3, 200, 77, dtype=bf),
                              torch.zeros(3, 77, 130, dtype=bf)),
        "f32": (xf, wf),
        "odd_expert_stride": (torch.zeros(4 * 128 * 256 + 4 * 8, dtype=bf).as_strided(
            (4, 128, 256), (128 * 256 + 4, 256, 1)), w),
        "f32_stacked_unit_view": (xf, torch.zeros(4, 3, 256, 64)[:, 1]),
        "f32_x_transposed": (xf.transpose(1, 2).contiguous().transpose(1, 2), wf),
        "f32_ragged_rank_local": (torch.zeros(3, 200, 77), torch.zeros(3, 77, 130)),
        "f32_odd_expert_stride": (torch.zeros(4 * 128 * 256 + 4 * 8).as_strided(
            (4, 128, 256), (128 * 256 + 1, 256, 1)), wf),
        "f32_expert_stride_2_floats": (xf, torch.zeros(4 * 256 * 64 + 8).as_strided(
            (4, 256, 64), (256 * 64 + 2, 64, 1))),
        "f32_one_expert_any_stride": (torch.zeros(1, 128, 256), torch.zeros(
            256 * 64 + 4).as_strided((1, 256, 64), (3, 64, 1))),
    }[name]
    assert mm.design(*xw) == want


@pytest.mark.parametrize("name,want", [
    ("bf16_d128_ring_blocks", "wgmma"), ("bf16_d64_ring_blocks", "wgmma"),
    ("bf16_bshd_views", "wgmma"), ("bf16_gqa_ragged_blocks", "wgmma"),
    ("f32_ring_blocks", "ffma"), ("bf16_d32", "template"),
    ("bf16_d256", "template"), ("bf16_d256_bshd_views", "template"),
    ("bf16_misaligned_base", "template"),
    ("f32_d64_ring_blocks", "ffma"), ("f32_bshd_views", "ffma"),
    ("f32_gqa_ragged_blocks", "ffma"), ("f32_d32", "template"),
    ("f32_misaligned_base", "template"), ("f32_d256", "template"),
])
def test_step_design_rule(name, want):
    """The ring step takes the forward's rule, read from q and the kv
    block, except that its wgmma and ffma designs stop at head dim 128 (at
    256 the step takes the template, though the forward takes wgmma or
    ffma): a block
    sliced out of the full kv along s keeps its strides and a 16-byte
    aligned base, so every ring position takes one design."""
    bf, f32 = torch.bfloat16, torch.float32

    def blocks(b, hq, hkv, s, d, r, dt=bf):
        q, kv = torch.zeros(b, hq, s // r, d, dtype=dt), torch.zeros(b, hkv, s, d, dtype=dt)
        blk = s // r
        return [(q, kv[:, :, j * blk:(j + 1) * blk], kv[:, :, j * blk:(j + 1) * blk])
                for j in range(r)]
    cases = {
        "bf16_d128_ring_blocks": blocks(4, 32, 32, 512, 128, 4),
        "bf16_d64_ring_blocks": blocks(2, 4, 2, 128, 64, 2),
        "bf16_bshd_views": [tuple(torch.zeros(2, 64, 4, 128, dtype=bf).transpose(1, 2)
                                  for _ in range(3))],
        "bf16_gqa_ragged_blocks": blocks(1, 8, 2, 200, 128, 2),
        "f32_ring_blocks": blocks(4, 32, 32, 512, 128, 4, f32),
        "bf16_d32": blocks(2, 4, 4, 64, 32, 2),
        "f32_d64_ring_blocks": blocks(2, 4, 2, 128, 64, 2, f32),
        "f32_bshd_views": [tuple(torch.zeros(2, 64, 4, 128).transpose(1, 2)
                                 for _ in range(3))],
        "f32_gqa_ragged_blocks": blocks(1, 8, 2, 200, 128, 2, f32),
        "f32_d32": blocks(2, 4, 4, 64, 32, 2, f32),
        "f32_misaligned_base": [(_misaligned((1, 2, 64, 128), f32),) * 3],
        "bf16_d256": blocks(1, 2, 2, 64, 256, 2),
        "f32_d256": blocks(1, 8, 1, 320, 256, 2, f32),
        "bf16_d256_bshd_views": [tuple(torch.zeros(2, 64, 4, 256, dtype=bf).transpose(1, 2)
                                       for _ in range(3))],
        "bf16_misaligned_base": [(_misaligned((1, 2, 64, 128), bf),) * 3],
    }[name]
    assert {fa.design(*qkv, step=True) for qkv in cases} == {want}
    if name.startswith("bf16_d256"):  # the forward's rule at the same operands
        assert {fa.design(*qkv) for qkv in cases} == {"wgmma"}


@pytest.mark.parametrize("shapes,dt,match", [
    (((2, 3), (3, 4)), torch.bfloat16, "3-d"),
    (((2, 3, 4), (3, 4, 5)), torch.bfloat16, "do not chain"),
    (((2, 3, 4), (2, 5, 6)), torch.bfloat16, "do not chain"),
    (((2, 3, 4), (2, 4, 5)), torch.float16, "dtype"),
    (((65536, 1, 4), (65536, 4, 1)), torch.bfloat16, "65535"),
])
def test_gmm_wrapper_rejects_what_the_kernel_does_not_take(shapes, dt, match):
    """Checked before any build or design choice; meta tensors stand in for
    CUDA ones (the wrapper takes them and refuses the shape), CPU tensors
    are refused as such."""
    from repro_torch.kernels import moe_gmm
    x, w = (torch.empty(s, dtype=dt, device="meta") for s in shapes)
    with pytest.raises(ValueError, match=match):
        moe_gmm.gmm(x, w)
    with pytest.raises(ValueError, match=match):
        moe_gmm.check_args(x, w)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        moe_gmm.gmm(*(torch.empty(s, dtype=dt) for s in shapes))


def test_design_counts_start_at_zero_and_reset():
    """Every kernel's launches split by design (the ring step's too); a CPU
    call launches nothing, and a reset clears the split with the counts."""
    ops.reset_launch_counts()
    att = mms = dict.fromkeys(("wgmma", "ffma", "template"), 0)
    assert ops.design_counts() == {"flash_attention": att, "flash_attention_step": att,
                                   "matmul": mms, "gmm": mms}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.zeros(4, 8, 8, dtype=dt)
        ops.gmm(x, x)
        ops.matmul(x[0], x[0])
        q = torch.zeros(1, 2, 8, 64, dtype=dt)
        ops.flash_attention_step(q, q, q)
    assert ops.design_counts()["gmm"] == mms and ops.design_counts()["matmul"] == mms
    assert ops.design_counts()["flash_attention_step"] == att
    fa.flash_attention.designs["wgmma"] = 3  # as a launch would
    fa.flash_attention.designs["ffma"] = 4
    fa.flash_attention_step.designs["ffma"] = 2
    mm.matmul.designs["ffma"] = 1
    ops.reset_launch_counts()
    assert ops.design_counts()["flash_attention"] == att
    assert ops.design_counts()["flash_attention_step"] == att
    assert ops.design_counts()["matmul"] == mms


# ---------------------------------------------------------------------------
# Build: the library's name hashes everything it is built from
# ---------------------------------------------------------------------------


def test_build_digest_covers_shared_headers_and_flags(tmp_path):
    """An edited shared header or other flags give another library name (a
    rebuild); a file that is neither does not."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "matmul.cu"
    base = _build.digest(src)
    assert base == _build.digest(src) and len(base) == 16
    assert base == _build.digest(_build.CSRC / "matmul.cu")
    (csrc / "notes.txt").write_text("not a source")
    assert _build.digest(src) == base
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.digest(src)
    assert edited != base
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.digest(src) not in (base, edited)
    assert _build.digest(src, flags=(*_build.NVCC_FLAGS, "-lcuda")) != _build.digest(src)
    assert _build.digest(csrc / "flash_attention.cu") != _build.digest(src)


# ---------------------------------------------------------------------------
# Gradients through the kernel wrappers' autograd Functions.  The kernel
# launch is monkeypatched to the plain version (and counted), so the
# Functions' plumbing runs here on the CPU; tests/test_torch_kernels_gpu.py
# holds the real kernels' gradients against the plain versions on a card.
# Plain version against plain version: the same arithmetic, so 1e-6.
# ---------------------------------------------------------------------------

GRAD_ATT_CASES = [  # (b, hq, hkv, sq, sk, d, causal, window)
    (1, 4, 2, 16, 16, 8, True, 0),    # GQA 2:1
    (2, 2, 2, 12, 12, 4, True, 5),    # window
    (1, 2, 1, 8, 20, 8, False, 0),    # cross, GQA
]


def _launch_as_plain(monkeypatch, module, name, plain):
    """Replace a kernel launch by its plain version; returns the list that
    records each "launch"."""
    calls = []

    def launch(*args, **kw):
        calls.append(name)
        return plain(*args, **kw)

    monkeypatch.setattr(module, name, launch)
    return calls


def _grads(fn, ins):
    out = fn(*ins)
    ct = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(out.shape)).astype(np.float32)).to(out.dtype)
    return out, torch.autograd.grad(out, [t for t in ins if t.requires_grad], ct)


def _leaf(shape, seed, grad=True):
    t = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return t.requires_grad_(grad)


@pytest.mark.parametrize("case", GRAD_ATT_CASES, ids=lambda c: "h{}k{}q{}s{}w{}".format(
    c[1], c[2], c[3], c[4], c[7]))
def test_flash_function_backpropagates_the_plain_versions_gradient(case, monkeypatch):
    b, hq, hkv, sq, sk, d, causal, window = case
    calls = _launch_as_plain(monkeypatch, fa, "flash_attention", ref.attention)
    # the projections reach attention as (b, s, h, d) views, transposed
    q, k, v = (_leaf(s, i).transpose(1, 2)
               for i, s in enumerate(((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))))
    kw = dict(causal=causal, window=window, q_offset=sk - sq if causal else 0)
    out = ops.flash_attention(q, k, v, impl="kernel", **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    # saved as passed: the transposed views, not contiguous copies
    assert [t.stride() for t in out.grad_fn.saved_tensors] == [t.stride() for t in (q, k, v)]
    _, got = _grads(lambda *a: out, (q, k, v))
    assert calls == ["flash_attention"]
    _, want = _grads(lambda q, k, v: ref.attention(q, k, v, **kw), (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_flash_function_gives_only_the_gradients_asked_for(monkeypatch):
    _launch_as_plain(monkeypatch, fa, "flash_attention", ref.attention)
    q, k = _leaf((1, 2, 8, 4), 0), _leaf((1, 2, 8, 4), 1)
    v = _leaf((1, 2, 8, 4), 2, grad=False)
    out, (gq, gk) = _grads(lambda q, k, v: ops.flash_attention(q, k, v, impl="kernel"),
                           (q, k, v))
    _, (wq, wk) = _grads(lambda q, k, v: ref.attention(q, k, v), (q, k, v))
    torch.testing.assert_close(gq, wq, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gk, wk, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel", ["flash_attention", "matmul", "gmm"])
def test_functions_save_nothing_without_grad(kernel, monkeypatch):
    """Under torch.no_grad(), or with no input that requires grad, the
    wrappers launch the kernel directly: no Function, no graph, nothing
    saved — serving is unchanged."""
    from repro_torch.kernels import moe_gmm

    module, plain, shapes, call = {
        "flash_attention": (fa, ref.attention, [(1, 2, 8, 4)] * 3, ops.flash_attention),
        "matmul": (mm, ref.matmul, [(6, 5), (5, 7)], ops.matmul),
        "gmm": (moe_gmm, ref.gmm, [(2, 6, 5), (2, 5, 7)], ops.gmm),
    }[kernel]
    calls = _launch_as_plain(monkeypatch, module, kernel, plain)
    fn = {"flash_attention": fa.FlashAttention, "matmul": mm.MatMul,
          "gmm": moe_gmm.GroupedMatMul}[kernel]
    monkeypatch.setattr(fn, "forward", staticmethod(lambda *a: pytest.fail("saved")))
    with torch.no_grad():
        out = call(*[_leaf(s, i) for i, s in enumerate(shapes)], impl="kernel")
    assert out.grad_fn is None and not out.requires_grad
    out = call(*[_leaf(s, i, grad=False) for i, s in enumerate(shapes)], impl="kernel")
    assert out.grad_fn is None
    assert calls == [kernel, kernel]


@pytest.mark.parametrize("layout", ["plain", "x_t", "w_t", "w_col_stride_2"])
def test_matmul_function_backpropagates_the_plain_versions_gradient(layout, monkeypatch):
    calls = _launch_as_plain(monkeypatch, mm, "matmul", ref.matmul)
    m, k, n = 9, 13, 6
    x = _leaf((k, m), 0).t() if layout == "x_t" else _leaf((m, k), 0)
    w = (_leaf((n, k), 1).t() if layout == "w_t" else
         _leaf((k, 2 * n), 1)[:, ::2] if layout == "w_col_stride_2" else _leaf((k, n), 1))
    out, got = _grads(lambda x, w: ops.matmul(x, w, impl="kernel"), (x, w))
    assert calls == ["matmul"] and type(out.grad_fn).__name__ == "MatMulBackward"
    _, want = _grads(ref.matmul, (x, w))
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=1e-6, atol=1e-6)


def test_gmm_function_backpropagates_the_plain_versions_gradient(monkeypatch):
    from repro_torch.kernels import moe_gmm

    calls = _launch_as_plain(monkeypatch, moe_gmm, "gmm", ref.gmm)
    x = _leaf((3, 7, 5), 0)
    w = _leaf((3, 2, 5, 4), 1)[:, 0]  # one unit of a stacked parameter
    out, got = _grads(lambda x, w: ops.gmm(x, w, impl="kernel"), (x, w))
    assert calls == ["gmm"] and type(out.grad_fn).__name__ == "GroupedMatMulBackward"
    _, want = _grads(ref.gmm, (x, w))
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=1e-6, atol=1e-6)


def test_step_kernel_raises_under_grad():
    """The step updates its carry in place and has no backward: under grad
    it raises, on any device, before it would launch."""
    q, k, v = (_leaf((1, 2, 8, 4), i) for i in range(3))
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.flash_attention_step(q, k, v, impl="kernel")
    carry = ref.attention_step(q.detach(), k.detach(), v.detach())
    m, l, acc = carry
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.flash_attention_step(q.detach(), k.detach(), v.detach(),
                                 (m, l, acc.requires_grad_()), impl="kernel")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_attention_step(q, k, v, impl="kernel")
