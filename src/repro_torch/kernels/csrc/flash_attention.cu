// Flash attention for Hopper (sm_90a), CUDA C++ with plain C entries: the
// forward kernel and the ring-attention step kernel, each in three designs.
//
// Forward.  Replaces: src/repro/kernels/flash_attention.py::flash_attention,
// the Pallas TPU kernel whose body is _flash_kernel.  Same function: scores,
// the running max m, the running sum l and the accumulator are f32; causal
// and sliding-window masks use the absolute positions q_offset + i and
// kv_offset + j; masked scores inside a tile that is not skipped are -1e30;
// the output is acc / (l == 0 ? 1 : l) in q's dtype; GQA maps query head h
// to KV head h / (hq / hkv).  Tiles are skipped on the TPU kernel's own
// grid (block_relevant below): q rows in blocks of min(128, sq), keys in
// blocks of min(128, sk), a pair of blocks skipped when every (q, k) pair in
// it is masked.  So a query row that sees no key gets what the TPU kernel
// gives it: 0 where all its blocks are skipped, else the mean of v over the
// keys of the blocks that are not (each masked score weighs exp(0) = 1 until
// a visible key wipes them).  Unlike the TPU kernel, sq and sk need not
// divide the blocks: keys past sk get weight exactly 0 and rows past sq are
// not written.
//
// Bound at the serving path's shape (b=4, h=32, s=512, d=128, bf16, causal):
// q, k, v and o are 16.8 MB each, 67.1 MB in all, about 20 us at 3.35 TB/s;
// the two products are 2 * 2 * b*h*s*s*d / 2 = 8.6 GFLOP, about 8.7 us at
// the 989 TFLOP/s bf16 tensor-core peak.  So the work is bounded by bytes,
// at about 20 us a launch (at s=2048 it would be bounded by operations).
//
// Design "wgmma" (flash_attention_wgmma_fwd: bf16, d in {64, 128, 256},
// operands that TMA can address).  One block of 384 threads per (128 q
// rows, head, batch): two consumer warpgroups each own a chunk of 64 q
// rows; a producer warpgroup hands its registers to them (setmaxnreg: 240
// a consumer thread, so the accumulators, scores and P fragments fit
// without spills) and one of its threads issues the TMA loads (4-d tensor
// maps over (d, s, h, b) with the tensors' own strides, so transposed (b,
// s, h, d) views load without a copy).
// The Q rows are loaded once; K and V tiles of 128 keys (64 at d = 256)
// sit in a 2-stage ring guarded by mbarriers (160 KB of shared memory at
// d = 128, 193 KB at d = 256).  S = Q K^T is wgmma m64n128k16 (m64n64k16 at
// d = 256) with both operands K-major in shared memory; the softmax runs
// on the accumulator registers in f32, in base 2 (exp2f of s * scale *
// log2 e: q is not pre-scaled in bf16), row maxima reduced over the 4
// lanes of a quad; P is rounded to bf16 in registers and is the register
// A operand of O += P V, with V an MN-major B (the transpose bit).  Only
// tiles on the diagonal, the window's edge or past sk are masked, and the
// key loop visits only tiles that are not skipped.  Each input byte is
// read once per q tile, the output written once, in bf16.  With
// SWIZZLE_128B a box row holds at most 128 bytes, so a head row is d / 64
// boxes and the descriptors step over them.
// At d = 64 and 128 a block's two chunks are one 128-row q tile, the
// heaviest tiles first.  At d = 256 (paligemma-3b's prefill, (4, 8, 512,
// 256), MQA 8:1) a ring of 128-key tiles would take 320 KB with Q, so K
// and V tiles hold 64 keys: S is 16 k-steps of m64n64k16 over 4 boxes, P V
// 4 key slices of m64n256k16 (a thread holds o[128], sc[32], pa[4][4]).  A
// 64-key tile is visited exactly when its enclosing 128-key block of the
// TPU grid is.  Its grid (128 blocks) is one wave, where the q-tile order
// balances nothing, so each block pairs chunk n_c - 1 - z with chunk z,
// heavy with light: the ring carries the tiles either chunk sees and each
// warpgroup computes its own.  Bound at that shape: 18.9 MB, 5.6 us at
// 3.35 TB/s, against 4.3 GFLOP, 4.4 us at the bf16 peak: bytes.  Measured
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke phase 23): 21.7 us of device
// time, against 656.7 us for the template and 17.6 us for SDPA (cuDNN's
// sm90 flash); 22.2 us unpaired.  What holds it back is the heavy chunk's
// warpgroup running S, the softmax and P V in series (the light one is done
// after 2 of its 8 tiles): without S it takes 18.2 us, without P V 19.3
// us, without the K/V reloads 20.5-21.0 us (tools/flash_wgmma_variants.py).
// Pairing at d = 64 and 128, whose grids take several waves, is slower.
//
// Design "ffma" (flash_attention_ffma_fwd: float32, d in {64, 128, 256},
// operands whose rows 16-byte copies address: the wgmma rule in 4-byte
// elements).
// True f32: both products are f32 FMAs on the CUDA cores, no TF32 (the
// reference holds float32 attention to 2e-5).  Bound, f32 causal: at one
// engine prefill (1, 32, 512, 128) 2.15 GFLOP over the unmasked pairs, 32.1
// us at the 67 TFLOP/s f32 peak, against 33.6 MB (10.0 us); at the
// executor's (4, 32, 512, 128) 8.6 GFLOP, 128.5 us, against 134 MB (40 us):
// bounded by operations.  The template (below) takes 7-9x that bound:
// every global load is a synchronous scalar load through registers,
// two __syncthreads a tile serialise copies and FMAs, and its products issue
// one scalar shared load per 1.3-4 FMAs, so shared-memory instruction issue
// bounds it.  This design: 64-row q tiles (at batch 1, 256 blocks for 132
// SMs; 128-row tiles would give 128 blocks, one wave set by the heaviest
// causal block), 64-key tiles, 128 threads each owning 8 x 4 of S and 8 x 8
// of the accumulator (8 x 4 at d = 64), read by float4 shared loads: per
// depth of S 3 loads for 32 FMAs, per key of P V 4 loads for 64 (256
// threads of 4 rows each run 9% slower).  Q is loaded once, pre-scaled in
// f32 and stored d-major; K is copied d-major through 4-byte cp.async
// copies that transpose on the way, V row-major through 16-byte ones.  K
// and V each have one buffer, refilled as soon as its product is done, so
// every copy runs under FMAs; at 112 KB of shared memory a block (d = 128)
// two blocks share an SM and each one's barriers run under the other's
// FMAs.  A
// two-stage ring of whole K and V tiles would take 176 KB: one block of
// these 4 warps an SM, with nothing to run during its barriers.  ptxas
// (CUDA 12.8): 191 registers at d = 128 (the step 181), 153 at d = 64 (the
// step 145), no spills; two blocks of 128 threads fit the SM's 65,536.  At
// (4, 32, 512, 128) the two products take about 194 of the kernel's 276 us
// of device time, each at about 74% of the f32 peak; the copies take about
// 7%, the softmax and the barriers the rest (NVIDIA H100 80GB HBM3, 700 W;
// tools/flash_ffma_variants.py times variants without each part, 256
// threads of 4 rows, and either q-tile order).  A tile is skipped
// where its enclosing block of the TPU grid is, and also where all its own
// pairs are masked while every row of its q tile sees a key (there it adds
// exactly nothing): causal (4, 32, 512, 128) visits 36 of 64 tiles a head
// instead of the grid's 40.  q tiles go heaviest first, or, where the whole
// grid is resident at once, paired heavy with light (see the kernel).  The
// step's design "ffma" (flash_attention_step_ffma) is this kernel's STEP
// instantiation, at d = 64 and 128 only.
// At d = 256 (float32 paligemma-3b: its slice (1, 8, 320, 256), MQA 8:1,
// is 421 MFLOP, 6.3 us at the f32 peak, against 5.9 MB, 1.8 us) 8 rows a
// thread would need 128 accumulators, so q tiles hold 32 rows of 4 (128
// threads, 64 accumulators, one block an SM).  The slice's 80 q tiles
// leave 52 of 132 SMs idle while the heaviest (5 visited 64-key tiles)
// sets the time, about 50 us.  So where a grid has fewer q tiles than SMs,
// each q tile takes a cluster of two blocks that visit its key tiles in
// turn; block 1 stores its (m, l, acc) into block 0's shared memory
// through distributed shared memory, and after one cluster barrier block 0
// folds it into its own in a fixed order: no atomics, the same bits every
// launch, the same tiles visited.  About 34 us: S runs at about 53% of the
// f32 peak (2 float4 shared loads for 16 FMAs), P V at about 69%; without
// either product and the refills it takes about 15 us (the first tile's
// copies about 4, Q's load about 3, the combine about 2: NVIDIA H100 80GB
// HBM3, 700 W; tools/flash_ffma_variants.py).  A grid of several waves
// does not split: at (4, 8, 512, 256), about 188 us, 64-row tiles of 256
// threads would take about 155.  ptxas: 165 registers, no spills.
//
// Design "template" (flash_attention_fwd: float32 outside the ffma rule,
// other head dims, bf16 operands TMA cannot address): one block of 256
// threads per (64-row q tile, head, batch), looping over 32-key tiles; Q, K
// and V are widened to f32 in shared memory and both products are f32 FMAs
// on the CUDA cores (the f32 path must be true f32, so no TF32).  A 64 x 32
// tile is skipped only when its enclosing block of the TPU grid is.
//
// Step (flash_attention_step).  Replaces:
// src/repro/kernels/flash_attention.py::flash_attention_step, the Pallas
// TPU kernel whose body is _flash_step_kernel.  Folds one KV block into a
// carried f32 state (m, l, acc) of shapes (b, hq, sq), (b, hq, sq) and
// (b, hq, sq, d), read at the start of a block's rows and written back at
// the end, in place (each row belongs to one block; the TPU kernel aliases
// the carry the same way).  With init set the state starts at
// (-1e30, 0, 0) without being read.  Unlike the forward kernel it skips no
// tile: every tile runs with masked scores at the finite -1e30, so the
// transition is kernels/ref.py attention_step's (up to the order of sums
// and the rounding of P, about 2^-16 in the wgmma design).  A row that is
// fully masked so far has m = -1e30, so its masked scores get weight
// exp(0) = 1 until a real key arrives, whose alpha = 0 wipes them; keys past
// sk (the ragged edge of a tile) still get weight exactly 0.  Offsets are
// plain ints at launch.  Bound at a ring step of the serving shape cut 4
// ways (q and k/v (4, 32, 128, 128) bf16, the f32 carry read and written):
// 4.2 MB each of q, k, v read, 8.4 MB of acc and 0.13 MB of (m, l) read and
// as much written, about 29.6 MB, about 8.8 us at 3.35 TB/s, against 1.07
// GFLOP (1.1 us at the bf16 peak), so bounded by bytes.
//
// The step's design "wgmma" (flash_attention_step_wgmma: the forward's rule,
// bf16, d in {64, 128}, q/k/v that TMA can address) is the wgmma forward
// kernel's STEP instantiation: the same producer warpgroup, TMA loads, wgmma
// products and bf16 P in registers, plus a second P V product with P's
// bf16 residual, because the carried acc is compared unnormalised (see the
// P V comment in the kernel).  At the ring shape each block sees one
// KV tile, so nothing overlaps inside a block and the bound is reached only
// with every load in flight at once: the consumers read their rows of the
// carry straight into the accumulator layout (8-byte loads, a quad covering
// 32 contiguous bytes of a row) before waiting for the TMA loads of Q, K
// and V, and write it back the same way.  Its softmax is in the natural
// units of ref.attention_step (m of s * scale; exp2f((x - m) * log2 e)), so
// the carry needs no conversion and a row fully masked so far weighs its
// -1e30 scores exp2f(0) = 1 exactly.  The step's design "ffma"
// (flash_attention_step_ffma: the ffma forward's rule, d = 64 and 128)
// reads its rows of the carry into its accumulators with float4 loads while
// the first K and V copies fly, and keeps the softmax in the carry's natural
// units the same way.  Bound at the f32 ring's step, (4, 32, 128, 128) float32: 1.07 GFLOP,
// 16.0 us at the f32 peak, against 42.2 MB (q, k, v read, the carry read
// and written), 12.6 us: bounded by operations.  The step's design
// "template" (flash_attention_step: float32 outside the ffma rule, other
// head dims, bf16 operands TMA cannot address) is the template forward
// kernel's STEP instantiation: the same 64 x 32 tiles and f32 FMAs on the
// CUDA cores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BLK_Q = 64;     // q rows per block
constexpr int BLK_K = 32;     // keys per KV tile
constexpr int THREADS = 256;  // 16 x 16: tx picks columns, ty picks rows
constexpr float NEG_INF = -1e30f;

// The TPU kernel's tile skipping: q rows in blocks of min(128, sq), keys in
// blocks of min(128, sk), block qb starting at q_offset + qb * that size (kb
// likewise at kv_offset); a pair of blocks is relevant unless every (q, k)
// pair in its nominal extent is masked.
__host__ __device__ __forceinline__ bool block_relevant(int qb, int kb, int sq, int sk,
                                                        int q_offset, int kv_offset,
                                                        int causal, int window) {
  const int bq = sq < 128 ? sq : 128;
  const int bk = sk < 128 ? sk : 128;
  const int q_lo = q_offset + qb * bq, q_hi = q_lo + bq - 1;
  const int k_lo = kv_offset + kb * bk, k_hi = k_lo + bk - 1;
  if (causal && k_lo > q_hi) return false;
  if (window && k_hi <= q_lo - window) return false;
  return true;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, hq, hkv, sq, sk, d;
  long long q_sb, q_sh, q_ss;  // element strides of batch, head, position
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal, window, q_offset, kv_offset;
  // step kernel only: the carried state, contiguous f32, updated in place
  float* m_io;
  float* l_io;
  float* acc_io;
  int init;  // 1: start from (-1e30, 0, 0) without reading the carry
};

__host__ __device__ constexpr size_t smem_floats(int d) {
  // Q tile and K tile with a padded row (d + 1) so that the 16 column
  // threads of a warp read 16 different banks; V tile; P tile (padded).
  return (size_t)BLK_Q * (d + 1) + (size_t)BLK_K * (d + 1) + (size_t)BLK_K * d +
         (size_t)BLK_Q * (BLK_K + 1);
}

// NCOL: output columns each thread owns (tx + 16 * c, c < NCOL), so d <= 16 * NCOL.
// STEP: the ring-attention step (carry in and out, no tile skipping).
template <typename T, int NCOL, bool STEP>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int ldq = d + 1;
  const int ldp = BLK_K + 1;
  float* Qs = smem;
  float* Ks = Qs + BLK_Q * ldq;
  float* Vs = Ks + BLK_K * ldq;
  float* Ps = Vs + BLK_K * d;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BLK_Q;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);

  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + bi * p.o_sb + h * p.o_sh;

  const int nq = min(BLK_Q, p.sq - q0);
  for (int idx = tid; idx < BLK_Q * d; idx += THREADS) {
    const int r = idx / d;
    const int c = idx - r * d;
    float x = 0.f;
    if (r < nq) x = to_f32(qg[(long long)(q0 + r) * p.q_ss + c]) * p.scale;
    Qs[r * ldq + c] = x;
  }

  // first element of this block's rows in the carried state
  const long long row0 = ((long long)bi * p.hq + h) * p.sq + q0;
  float m[4], l[4], acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = STEP ? NEG_INF : -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
    if constexpr (STEP) {
      const int r = ty + 16 * i;
      if (!p.init && r < nq) {
        m[i] = p.m_io[row0 + r];
        l[i] = p.l_io[row0 + r];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          const int col = tx + 16 * c;
          if (col < d) acc[i][c] = p.acc_io[(row0 + r) * d + col];
        }
      }
    }
  }

  const int q_first = p.q_offset + q0;
  const int n_kt = (p.sk + BLK_K - 1) / BLK_K;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLK_K;
    const int nk = min(BLK_K, p.sk - k0);
    const int k_first = p.kv_offset + k0;
    if constexpr (!STEP) {
      // skip the tile when its enclosing block of the TPU grid is skipped
      if (!block_relevant(q0 / min(128, p.sq), k0 / min(128, p.sk), p.sq, p.sk, p.q_offset,
                          p.kv_offset, p.causal, p.window))
        continue;
    }

    __syncthreads();  // Q is stored; the previous tile's readers are done
    for (int idx = tid; idx < BLK_K * d; idx += THREADS) {
      const int r = idx / d;
      const int c = idx - r * d;
      float kx = 0.f, vx = 0.f;
      if (r < nk) {
        kx = to_f32(kg[(long long)(k0 + r) * p.k_ss + c]);
        vx = to_f32(vg[(long long)(k0 + r) * p.v_ss + c]);
      }
      Ks[r * ldq + c] = kx;
      Vs[r * d + c] = vx;
    }
    __syncthreads();

    // S = (q * scale) K^T for rows ty + 16 i, keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + kk];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of (m, l, acc) per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_first + r;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k_first + c;
        bool keep = true;
        if (p.causal) keep = keep && kpos <= qpos;
        if (p.window) keep = keep && kpos > qpos - p.window;
        if (!keep) s[i][j] = NEG_INF;
        if (c < nk) mt = fmaxf(mt, s[i][j]);
      }
      // the 16 threads of one row are lanes 0-15 or 16-31 of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);  // finite: every tile holds a key
      // (in the step kernel m[i] = m_new = -1e30 for a row fully masked so
      // far: alpha = 1 and each masked score weighs exp(0) = 1, as in
      // ref.attention_step)
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const float pj = (c < nk) ? expf(s[i][j] - m_new) : 0.f;  // keys past sk: 0
        Ps[r * ldp + c] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
    for (int c = 0; c < nk; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int cc = 0; cc < NCOL; ++cc) {
        const int col = tx + 16 * cc;
        if (col < d) {
          const float vv = Vs[c * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
        }
      }
    }
  }

  if constexpr (STEP) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= nq) continue;
      if (tx == 0) {
        p.m_io[row0 + r] = m[i];
        p.l_io[row0 + r] = l[i];
      }
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = tx + 16 * c;
        if (col < d) p.acc_io[(row0 + r) * d + col] = acc[i][c];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= nq) continue;
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      T* orow = og + (long long)(q0 + r) * p.o_ss;
#pragma unroll
      for (int cc = 0; cc < NCOL; ++cc) {
        const int col = tx + 16 * cc;
        if (col < d) orow[col] = from_f32<T>(acc[i][cc] * inv);
      }
    }
  }
}

template <typename T, int NCOL, bool STEP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.d) * sizeof(float);
  // above 48 KB a block's dynamic shared memory needs this opt-in, or the
  // launch is refused (reported only by cudaGetLastError)
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NCOL, STEP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BLK_Q - 1) / BLK_Q, p.hq, p.b);
  flash_fwd_kernel<T, NCOL, STEP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool STEP>
cudaError_t dispatch_head_dim(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 2, STEP>(p, stream);
  if (p.d <= 64) return launch<T, 4, STEP>(p, stream);
  if (p.d <= 128) return launch<T, 8, STEP>(p, stream);
  return launch<T, 16, STEP>(p, stream);
}

template <bool STEP>
int dispatch_dtype(const Params& p, int dtype, cudaStream_t s) {
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_head_dim<float, STEP>(p, s);
  else if (dtype == 1)
    err = dispatch_head_dim<__nv_bfloat16, STEP>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

bool bad_shape(int b, int hq, int hkv, int sq, int sk, int d) {
  return d < 1 || d > 256 || b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 ||
         sk < 1;
}

// ---------------------------------------------------------------------------
// design "wgmma": bf16, d in {64, 128, 256}; wgmma, TMA and an mbarrier pipeline
// ---------------------------------------------------------------------------

constexpr int W_BLK = 128;      // q rows per block (and keys per KV tile at d <= 128)
constexpr int W_STAGES = 2;     // K/V ring
constexpr int W_THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int W_CONSUMER_WARPS = 8;

struct WParams {
  void* o;
  long long o_sb, o_sh, o_ss;
  int hq, hkv, sq, sk;
  float scale;  // forward: softmax scale * log2(e) (base 2); step: the scale itself
  int causal, window, q_offset, kv_offset;
  // step only: the carried state, contiguous f32, updated in place
  float* m_io;
  float* l_io;
  float* acc_io;
  int init;  // 1: start from (-1e30, 0, 0) without reading the carry
};

constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout (bytes from a 1024-byte aligned base): the two
// consumer warpgroups' Q rows, then W_STAGES K tiles, then W_STAGES V
// tiles, then the barriers.  A warpgroup's Q is D / 64 boxes of 64 rows x
// 128 bytes, a K or V tile D / 64 boxes of BK rows x 128 bytes: BK = 128
// keys at d = 64 and 128, 64 at d = 256, where a ring of 128-key tiles
// would take 320 KB with Q (192 KB with 64).
template <int D>
struct WLayout {
  static constexpr int BK = D == 256 ? 64 : W_BLK;  // keys per K/V tile
  static constexpr int QBOX = 64 * 128;
  static constexpr int KBOX = BK * 128;
  static constexpr int QWG = (D / 64) * QBOX;
  static constexpr int KTILE = (D / 64) * KBOX;
  static constexpr int Q = 0;
  static constexpr int K = 2 * QWG;
  static constexpr int V = K + W_STAGES * KTILE;
  static constexpr int BAR = V + W_STAGES * KTILE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * W_STAGES) + 1024;  // + alignment slack
};

// O += P V over one key slice of 16: P's bf16 A fragment, V an MN-major B
// of D columns (the transpose bit), in one wgmma.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t dv) {
  if constexpr (D == 256)
    hopper::wgmma_m64n256_rs<1>(o, a, dv, 1);
  else if constexpr (D == 128)
    hopper::wgmma_m64n128_rs<1>(o, a, dv, 1);
  else
    hopper::wgmma_m64n64_rs<1>(o, a, dv, 1);
}

// STEP: the ring-attention step (carry in and out, no tile skipping, the
// softmax in natural units as ref.attention_step: see the step's entry).
template <int D, bool STEP>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const WParams p) {
  using L = WLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + W_STAGES;

  // Each consumer warpgroup owns a chunk of 64 q rows.  Unpaired (d = 64
  // and 128, and the step): the two chunks of 128-row q tile n_qt - 1 - z,
  // the last q tiles, which see the most keys, first.  Paired (d = 256):
  // chunks n_c - 1 - z and z, heavy with light, so that under a causal mask
  // every block does about the same work (the grid is the same); where n_c
  // is odd the middle chunk's block runs it in both warpgroups and the
  // second stores nothing.  Rows past sq are computed and not stored.
  // Every warpgroup runs the same loop over the ring, so the ring's index
  // stays warp-uniform (the uniform datapath addresses the stages).
  constexpr bool PAIRED = !STEP && D == 256;
  const int n_qt = (p.sq + W_BLK - 1) / W_BLK;
  const int n_c = (p.sq + 63) / 64;
  const int z = blockIdx.z;
  const int chunk0 = PAIRED ? n_c - 1 - z : 2 * (n_qt - 1 - z);
  const int chunk1 = PAIRED ? min(z, chunk0) : chunk0 + 1;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int hk = h / (p.hq / p.hkv);
  constexpr int BK = L::BK;
  const int n_kt = (p.sk + BK - 1) / BK;
  // The forward's chunk sees a key tile where the pair of their enclosing
  // blocks of the TPU grid is relevant (at d = 256 both 64-key halves of a
  // 128-key block, or none); the step sees every tile.  The ring carries
  // the tiles that either chunk sees (unpaired, both chunks see the same).
  // qb: a chunk's q block on that grid; a key tile's key block is kt * BK /
  // 128 (0 where sk < 128: then kt < 2).
  const int qb0 = p.sq < 128 ? 0 : chunk0 / 2;
  const int qb1 = p.sq < 128 ? 0 : chunk1 / 2;
  auto sees = [&](int qb, int kt) {
    return STEP || block_relevant(qb, kt * BK / 128, p.sq, p.sk, p.q_offset, p.kv_offset,
                                  p.causal, p.window);
  };
  auto visited = [&](int kt) { return sees(qb0, kt) || (PAIRED && sees(qb1, kt)); };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W_CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Producer warpgroup: it hands its registers to the consumers (24 + 2 x
  // 240 = 504 a thread across the three warpgroups, of the 512 that the
  // SM's 65,536 allow), and one of its threads issues every load.  The two
  // roles never reconverge, which setmaxnreg requires.
  if (warp >= W_CONSUMER_WARPS) {
    hopper::setmaxnreg_dec<24>();
    if (warp == W_CONSUMER_WARPS && lane == 0) {
      hopper::mbar_expect_tx(q_full, 2 * L::QWG);
      for (int w = 0; w < 2; ++w)  // a chunk wholly past sq loads the last one's rows
        for (int j = 0; j < D / 64; ++j)
          hopper::tma_load_4d(smem + L::Q + w * L::QWG + j * L::QBOX, &tq, q_full, 64 * j,
                              64 * min(w == 0 ? chunk0 : chunk1, n_c - 1), h, bi);
      int t = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        if (!visited(kt)) continue;
        const int s = t % W_STAGES;
        if (t >= W_STAGES) hopper::mbar_wait(&empty[s], ((t / W_STAGES) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * L::KTILE);
        for (int j = 0; j < D / 64; ++j) {
          hopper::tma_load_4d(smem + L::K + s * L::KTILE + j * L::KBOX, &tk, &full[s], 64 * j,
                              kt * BK, hk, bi);
          hopper::tma_load_4d(smem + L::V + s * L::KTILE + j * L::KBOX, &tv, &full[s], 64 * j,
                              kt * BK, hk, bi);
        }
        ++t;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  // consumers: warpgroup wg owns q rows 64 my .. 64 my + 63; this thread
  // holds rows r and r + 8 (r below) and, in each 8-column chunk c of an
  // accumulator, columns 8 c + 2 (lane % 4) + {0, 1}
  const int wg = warp / 4;
  const int my = wg == 0 ? chunk0 : chunk1;
  const int my_qb = wg == 0 ? qb0 : qb1;
  const bool stores = !PAIRED || wg == 0 || chunk1 != chunk0;
  const int quad = lane % 4;
  const int row0 = 64 * my + (warp % 4) * 16 + lane / 4;
  const int qpos0 = p.q_offset + row0;
  const int q_lo = p.q_offset + 64 * my;
  const uint32_t q_base = hopper::smem_u32(smem + L::Q + wg * L::QWG);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  // step: this thread's part of the carry, read into the accumulator layout
  // before the first wait, so these loads are in flight with the TMA loads
  // of Q, K and V.  Each quad reads 32 contiguous bytes of a row a chunk.
  // The row sum l is carried whole by the quad's lane 0 (the others start
  // at 0 and the quad's partial sums are added at the end).
  const long long carry0 = ((long long)blockIdx.y * p.hq + h) * p.sq;
  if constexpr (STEP) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      m[i] = NEG_INF;
      if (p.init || row >= p.sq) continue;
      m[i] = p.m_io[carry0 + row];
      l[i] = quad == 0 ? p.l_io[carry0 + row] : 0.f;
      const float2* acc_row = reinterpret_cast<const float2*>(p.acc_io + (carry0 + row) * D);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float2 a = acc_row[4 * c + quad];
        o[4 * c + 2 * i] = a.x;
        o[4 * c + 2 * i + 1] = a.y;
      }
    }
  }
  // The forward runs the softmax in base 2 on s * scale * log2(e), so m is
  // in those units and exp2f(x - m) needs no multiply.  The step keeps m in
  // the natural units of s * scale, those of the carry and ref.attention_step,
  // and takes exp2f((x - m) * log2(e)): the difference comes first, so a
  // masked score equal to m = -1e30 gives exp2f(0) = 1 as expf(0) does.
  constexpr float unit = STEP ? LOG2E : 1.f;

  hopper::mbar_wait(q_full, 0);
  int t = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!visited(kt)) continue;
    const int s = t % W_STAGES;
    hopper::mbar_wait(&full[s], (t / W_STAGES) & 1);
    if (!PAIRED || sees(my_qb, kt)) {  // paired: a tile of the other chunk's only passes
      const uint32_t k_base = hopper::smem_u32(smem + L::K + s * L::KTILE);
      const uint32_t v_base = hopper::smem_u32(smem + L::V + s * L::KTILE);

      // S = Q K^T (m64 x nBK per warpgroup), both operands K-major
      float sc[BK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 columns of box kk / 4
        const uint64_t dq = hopper::make_desc(q_base + (kk / 4) * L::QBOX + col, 16, 1024);
        const uint64_t dk = hopper::make_desc(k_base + (kk / 4) * L::KBOX + col, 16, 1024);
        if constexpr (BK == 128)
          hopper::wgmma_m64n128_ss<0, 0>(sc, dq, dk, kk > 0);
        else
          hopper::wgmma_m64n64_ss<0, 0>(sc, dq, dk, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // scale (into base 2 in the forward); mask only tiles on the diagonal, the window's edge
      // or past sk (keys past sk weigh 0, masked keys -1e30 as in the TPU kernel)
      const int k0 = kt * BK;
      const int kpos0 = p.kv_offset + k0;
      const bool edge = k0 + BK > p.sk;
      const bool diag = p.causal && kpos0 + BK - 1 > q_lo;
      const bool wedge = p.window && kpos0 <= q_lo + 63 - p.window;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= p.scale;
      if (edge || diag || wedge) {
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int key = 8 * c + 2 * quad + j;
              const int kpos = kpos0 + key;
              const int qpos = qpos0 + 8 * i;
              float& x = sc[4 * c + 2 * i + j];
              if (k0 + key >= p.sk)
                x = -INFINITY;
              else if ((p.causal && kpos > qpos) || (p.window && kpos <= qpos - p.window))
                x = NEG_INF;
            }
      }

      // online softmax on the accumulator: row max over the quad, then
      // p = exp2(s - m); l keeps this thread's partial row sum
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
          mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * i], sc[4 * c + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // finite: every tile holds a key below sk, which scores at least -1e30
        alpha[i] = exp2f((m[i] - mx) * unit);
        m[i] = mx;
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = sc[4 * c + 2 * i + j];
            x = exp2f((x - mx) * unit);
            rs += x;
          }
        l[i] = l[i] * alpha[i] + rs;
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * c + 2 * i] *= alpha[i];
          o[4 * c + 2 * i + 1] *= alpha[i];
        }

      // O += P V: P in bf16 registers (the A fragment of key slice kk is
      // accumulator chunks 2 kk and 2 kk + 1), V an MN-major B.  The step
      // carries the unnormalised acc, whose error P's rounding to bf16 would
      // set (up to 2^-8 of each p, summed over the keys, with nothing to
      // divide it by): it adds P's bf16 residual (P - bf16(P), itself rounded
      // to bf16) as a second product, so each p enters P V to about 2^-16.
      uint32_t pa[BK / 16][4];
      uint32_t pr[STEP ? BK / 16 : 1][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
          pa[kk][r] = hopper::pack_bf16(x0, x1);
          if constexpr (STEP) {
            const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&pa[kk][r]);
            pr[kk][r] = hopper::pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
          }
        }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // keys 16 kk.. of the tile (16 rows of 128 bytes on); the next 64
        // head columns are the next box
        const uint64_t dv = hopper::make_desc(v_base + kk * 2048, L::KBOX, 1024);
        wgmma_pv<D>(o, pa[kk], dv);
        if constexpr (STEP) wgmma_pv<D>(o, pr[kk], dv);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          asm volatile("" : "+r"(pa[kk][r])::"memory");
          if constexpr (STEP) asm volatile("" : "+r"(pr[kk][r])::"memory");
        }
    }
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp is done with stage s
    ++t;
  }

  // step: (m, l, acc) back in place, unnormalised; forward: O / l (l == 0:
  // no tile visited, the row is 0), bf16; rows past sq dropped
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= p.sq || !stores) continue;
    if constexpr (STEP) {
      if (quad == 0) {
        p.m_io[carry0 + row] = m[i];
        p.l_io[carry0 + row] = l[i];
      }
      float2* acc_row = reinterpret_cast<float2*>(p.acc_io + (carry0 + row) * D);
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        acc_row[4 * c + quad] = make_float2(o[4 * c + 2 * i], o[4 * c + 2 * i + 1]);
      continue;
    }
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) + blockIdx.y * p.o_sb +
                          h * p.o_sh + row * p.o_ss;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * quad) =
          __floats2bfloat162_rn(o[4 * c + 2 * i] * inv, o[4 * c + 2 * i + 1] * inv);
  }
}

// Tensor map of q, k or v: dims (d, s, h, b) with the tensor's own element
// strides; boxes of 64 head columns x `rows` positions.
cudaError_t qkv_map(CUtensorMap* map, const void* base, int d, int s, int h, int b,
                    long long ss, long long sh, long long sb, int rows) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)s, (uint64_t)h, (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, (uint32_t)rows, 1, 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

template <int D, bool STEP>
cudaError_t launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         const WParams& p, int b, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D, STEP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WLayout<D>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.hq, b, (p.sq + W_BLK - 1) / W_BLK);
  flash_wgmma_kernel<D, STEP><<<grid, W_THREADS, WLayout<D>::BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// The wgmma design's rule on q, k, v (see flash_attention_wgmma_fwd; the
// step takes d = 64 and 128 only) and their tensor maps, K and V in boxes of
// the key tile; cudaErrorInvalidValue for what it does not take.
cudaError_t wgmma_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, const void* q,
                       const void* k, const void* v, int b, int hq, int hkv, int sq, int sk,
                       int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                       long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                       long long v_ss, bool step) {
  using hopper::tma_stride_ok;
  const bool aligned =
      tma_stride_ok(q_ss, sq) && tma_stride_ok(q_sh, hq) && tma_stride_ok(q_sb, b) &&
      tma_stride_ok(k_ss, sk) && tma_stride_ok(k_sh, hkv) && tma_stride_ok(k_sb, b) &&
      tma_stride_ok(v_ss, sk) && tma_stride_ok(v_sh, hkv) && tma_stride_ok(v_sb, b) &&
      reinterpret_cast<uintptr_t>(q) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (bad_shape(b, hq, hkv, sq, sk, d) || (d != 64 && d != 128 && (step || d != 256)) ||
      !aligned || b > 65535 || (sq + W_BLK - 1) / W_BLK > 65535)
    return cudaErrorInvalidValue;
  const int bk = d == 256 ? WLayout<256>::BK : W_BLK;
  cudaError_t err = qkv_map(tq, q, d, sq, hq, b, q_ss, q_sh, q_sb, 64);
  if (err == cudaSuccess) err = qkv_map(tk, k, d, sk, hkv, b, k_ss, k_sh, k_sb, bk);
  if (err == cudaSuccess) err = qkv_map(tv, v, d, sk, hkv, b, v_ss, v_sh, v_sb, bk);
  return err;
}

// ---------------------------------------------------------------------------
// design "ffma": float32, d in {64, 128, 256}; cp.async copies and f32 FMAs
// ---------------------------------------------------------------------------

constexpr int F_BK = 64;  // keys per KV tile

struct FParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int hq, hkv, sq, sk;
  long long q_sb, q_sh, q_ss;  // element strides of batch, head, position
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;  // forward: softmax scale * log2(e) (base 2); step: the scale itself
  int causal, window, q_offset, kv_offset;
  // step only: the carried state, contiguous f32, updated in place
  float* m_io;
  float* l_io;
  float* acc_io;
  int init;  // 1: start from (-1e30, 0, 0) without reading the carry
  int one_wave;  // every block of the grid is resident at once
  int split;     // d = 256: two blocks of a cluster share each q tile's key tiles
};

// The block's tile at head dim D: BQ q rows, RT of them a thread, 16
// threads (tx) a row group (ty), so BQ / RT row groups; each thread owns
// RT x 4 of S and RT x D / 16 of the accumulator.  At d = 64 and 128, 64
// rows of 8 (128 threads), two blocks an SM.  At d = 256, 32 rows of 4
// (128 threads, 64 accumulators a thread; 8 rows would need 128), one
// 200 KB block an SM; where the grid has fewer q tiles than the card has
// SMs, each q tile takes a cluster of two blocks that share its key tiles
// (SPLIT; paligemma's (1, 8, 320, 256) has 80 q tiles).
// Shared memory, in floats: Q [D][BQ] d-major; K [D][64] d-major; V [64][D]
// row-major; P [64 keys][BQ rows] key-major; at d = 256 R, where the
// cluster's second block leaves its partial state.  K and P swizzle their
// float4 slots (slot ^ (depth or key) % 8) instead of padding, so that both
// blocks' 112 KB fit an SM at d = 128 (P's swizzle needs BQ >= 32).
template <int D>
struct FLayout {
  static constexpr int BQ = D == 256 ? 32 : 64;  // q rows per block
  static constexpr int RT = D == 256 ? 4 : 8;    // q rows a thread owns
  static constexpr int NTY = BQ / RT;            // row groups (ty)
  static constexpr int THREADS = 16 * NTY;       // x 16 key / column groups (tx)
  static constexpr int WARPS = THREADS / 32;
  static constexpr int MIN_BLOCKS = D == 256 ? 1 : 2;  // blocks an SM (launch bounds)
  // a grid that would leave SMs idle splits each q tile's key tiles between
  // the two blocks of a cluster (see the kernel)
  static constexpr bool SPLIT = D == 256;
  // Q's float4 loads a thread has in flight: all of them at d = 256, where
  // nothing else runs on the SM while they land
  static constexpr int Q_UNROLL = D == 256 ? 16 : 4;
  static constexpr int Q = 0;
  static constexpr int K = Q + D * BQ;
  static constexpr int V = K + D * F_BK;
  static constexpr int P = V + F_BK * D;
  static constexpr int R = P + F_BK * BQ;  // split: block 1's acc [BQ][D], m [BQ], l [BQ]
  static constexpr int BYTES = (R + (SPLIT ? BQ * D + 2 * BQ : 0)) * 4;
  static_assert(BQ >= 32 && BQ % RT == 0 && RT % 4 == 0 && 128 % BQ == 0, "tile shape");
  static_assert(D % (8 * WARPS) == 0 && THREADS % (D / 4) == 0, "copy shape");
};

// One K tile into shared memory d-major, through 4-byte copies that
// transpose on the way.  Smem column c = 4 * (key % 16) + key / 16 holds key
// `key`, so thread tx's float4 at column 4 tx holds keys tx + 16 j.  A warp
// copies 8 depths (lane % 8) of 4 keys kb + 16 r (r = lane / 8): 32-byte
// pieces of 4 global rows, written to 32 distinct banks by the swizzle.
// Each thread walks its 4 rows' pointer down the key bases kb; its depths
// are 8 (WARPS c + warp) + lane % 8.  Keys past sk are zero-filled.
template <int D>
__device__ __forceinline__ void ffma_load_k(float* ks, const float* kg, long long k_ss, int k0,
                                            int sk) {
  constexpr int F_WARPS = FLayout<D>::WARPS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int dc = lane % 8, r = lane / 8;
  const int depth0 = 8 * warp + dc;
  const float* src = kg + (long long)(k0 + 16 * r) * k_ss + depth0;
  float* dst = ks + depth0 * F_BK + r;
#pragma unroll 4
  for (int kb = 0; kb < 16; ++kb, src += k_ss) {
    const bool valid = k0 + kb + 16 * r < sk;
    const int col = (kb ^ dc) << 2;
#pragma unroll
    for (int c = 0; c < D / (8 * F_WARPS); ++c)
      hopper::cp_async4(dst + 8 * F_WARPS * c * F_BK + col, valid ? src + 8 * F_WARPS * c : kg,
                        valid ? 4 : 0);
  }
}

// One V tile into shared memory row-major: 16-byte copies, a warp's 32
// consecutive float4s of a row at d = 128; keys past sk zero-filled.
template <int D>
__device__ __forceinline__ void ffma_load_v(float* vs, const float* vg, long long v_ss, int k0,
                                            int sk) {
  constexpr int C4 = D / 4, ROWS = FLayout<D>::THREADS / C4;  // rows a pass of the block copies
  const int row0 = threadIdx.x / C4, c4 = threadIdx.x % C4;
  const float* src = vg + (long long)(k0 + row0) * v_ss + 4 * c4;
  float* dst = vs + row0 * D + 4 * c4;
#pragma unroll 4
  for (int it = 0; it < F_BK / ROWS; ++it, src += ROWS * v_ss) {
    const bool valid = k0 + row0 + ROWS * it < sk;
    hopper::cp_async16(dst + ROWS * it * D, valid ? src : vg, valid ? 16 : 0);
  }
}

// One block of 128 threads per (BQ-row q tile, head, batch), or with
// p.split (d = 256) a cluster of two.  Thread (ty, tx) owns rows 4 ty + i
// and 32 + 4 ty + i (i < 4) of every tile (at d = 256 only the first
// four): of S the keys tx + 16 j (j < 4), of the accumulator the columns
// 64 c + 4 tx + e (e < 4, c < d / 64).  The 16 threads of a row group are
// one half-warp: row maxima reduce by shuffles each tile (the rows
// interleaved), row sums stay per thread and reduce once at the end.  Per
// tile: S = Q K^T (each depth: RT / 4 + 1 float4 shared loads for 4 RT
// FMAs, the next depth's fragments loaded during the current FMAs), the
// mask and online softmax in registers, P to shared memory key-major, then
// O += P V (each key: RT / 4 float4 loads of P and d / 64 of V for RT d /
// 16 FMAs).  K and V each have one buffer that refills once every warp is
// past its product, at the two barriers a tile has: the next tile's K
// copies run under this tile's P V, its V copies under the next S and
// softmax.  At d <= 128 the second block on the SM runs during the
// barriers; at d = 256 (one block an SM) nothing does.  Split, block
// `rank` of the cluster visits the q tile's key tiles of that parity (in
// the order of visits), and block 0 folds block 1's (m, l, acc) into its
// own at the end.
template <int D, bool STEP>
__global__ void __launch_bounds__(FLayout<D>::THREADS, FLayout<D>::MIN_BLOCKS)
    flash_ffma_kernel(const FParams p) {
  using L = FLayout<D>;
  constexpr int F_BQ = L::BQ, F_RT = L::RT, F_NTY = L::NTY, F_THREADS = L::THREADS;
  constexpr int NC = D / 16;  // accumulator columns a thread: 16, 8 or 4
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem + L::Q;
  float* Ks = fsmem + L::K;
  float* Vs = fsmem + L::V;
  float* Ps = fsmem + L::P;

  // The last q tiles see the most keys: they go first, so that the blocks
  // the hardware hands out as slots free end with the lightest.  Where the
  // whole grid is resident at once there is no such hand-out: the second
  // half of the q tiles then goes lightest first, and since an SM takes its
  // second block in the order it took its first, heavy tiles share SMs with
  // light ones (at (1, 32, 512, 128) causal, 81.7 us against 93.2
  // heaviest first; paired at (4, 32, 512, 128), which takes several waves,
  // 293.6 against 277.7: tools/flash_ffma_variants.py, on the H100).
  const int n_qt = (p.sq + F_BQ - 1) / F_BQ;
  // split: cluster z / 2 takes q tile z / 2's place below, its block `rank`
  // the visited key tiles of that parity
  int z = blockIdx.z, rank = 0;
  if constexpr (L::SPLIT) {
    if (p.split) {
      rank = z % 2, z /= 2;
      // with the wait before block 1's stores into block 0 (below): both
      // blocks have started
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    }
  }
  const int half = (n_qt + 1) / 2;
  const int q0 = (p.one_wave && z >= half ? z - half : n_qt - 1 - z) * F_BQ;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int hk = h / (p.hq / p.hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // row i of this thread's rows: float4 group i / 4 of row group ty
  auto frow = [&](int i) { return (i / 4) * 4 * F_NTY + 4 * ty + i % 4; };
  const float* qg = p.q + bi * p.q_sb + h * p.q_sh;
  const float* kg = p.k + bi * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + bi * p.v_sb + hk * p.v_sh;
  const int n_kt = (p.sk + F_BK - 1) / F_BK;
  // The forward visits a tile unless its enclosing block of the TPU grid is
  // skipped, or every pair of the tile itself is masked and every row of
  // the q tile sees some key: such a row gives a fully masked tile weight
  // exp2f(-1e30 - m) = 0 whatever the order, so skipping it changes no bit,
  // while a row that sees no key keeps the TPU grid's mean of v.
  const int q_lo = p.q_offset + q0, q_hi = p.q_offset + min(q0 + F_BQ, p.sq) - 1;
  const bool rows_see_keys = (!p.causal || p.kv_offset <= q_lo) &&
                             (!p.window || q_hi <= p.kv_offset + p.sk - 2 + p.window);
  auto next_tile = [&](int kt) -> int {
    if constexpr (!STEP) {
      for (; kt < n_kt; ++kt) {
        const int k_lo = p.kv_offset + kt * F_BK;
        if (block_relevant(q0 / min(128, p.sq), kt * F_BK / min(128, p.sk), p.sq, p.sk,
                           p.q_offset, p.kv_offset, p.causal, p.window) &&
            !(rows_see_keys && ((p.causal && k_lo > q_hi) ||
                                (p.window && k_lo + F_BK - 1 <= q_lo - p.window))))
          break;
      }
    }
    return kt;
  };

  int kt = next_tile(0);
  if constexpr (L::SPLIT)
    if (rank == 1 && kt < n_kt) kt = next_tile(kt + 1);
  if (kt < n_kt) ffma_load_k<D>(Ks, kg, p.k_ss, kt * F_BK, p.sk);
  hopper::cp_async_commit();
  if (kt < n_kt) ffma_load_v<D>(Vs, vg, p.v_ss, kt * F_BK, p.sk);
  hopper::cp_async_commit();

  // this thread's rows, its part of the carry (step) read while the copies fly
  float m[F_RT], l[F_RT], acc[F_RT][NC];
  const long long carry0 = ((long long)bi * p.hq + h) * p.sq;
#pragma unroll
  for (int i = 0; i < F_RT; ++i) {
    m[i] = STEP ? NEG_INF : -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    const int row = q0 + frow(i);
    if (STEP && !p.init && row < p.sq) {
      m[i] = p.m_io[carry0 + row];
      l[i] = tx == 0 ? p.l_io[carry0 + row] : 0.f;  // the row sum, carried whole by tx 0
      const float* arow = p.acc_io + (carry0 + row) * D;
#pragma unroll
      for (int c = 0; c < NC / 4; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(arow + 64 * c + 4 * tx);
        acc[i][4 * c] = a.x, acc[i][4 * c + 1] = a.y, acc[i][4 * c + 2] = a.z,
        acc[i][4 * c + 3] = a.w;
      }
    }
  }

  // Q once, pre-scaled in f32, stored d-major: a warp writes 32 consecutive
  // rows of one depth (distinct banks); rows past sq are zeros
#pragma unroll (L::Q_UNROLL)
  for (int it = 0; it < F_BQ * D / 4 / F_THREADS; ++it) {
    const int idx = threadIdx.x + it * F_THREADS;
    const int row = idx % F_BQ, c4 = idx / F_BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < p.sq)
      x = __ldg(reinterpret_cast<const float4*>(qg + (long long)(q0 + row) * p.q_ss + 4 * c4));
    float* dst = Qs + 4 * c4 * F_BQ + row;
    dst[0] = x.x * p.scale;
    dst[F_BQ] = x.y * p.scale;
    dst[2 * F_BQ] = x.z * p.scale;
    dst[3 * F_BQ] = x.w * p.scale;
  }

  // The forward runs the softmax in base 2 on q pre-scaled by scale *
  // log2(e); the step keeps m in the natural units of the carry and takes
  // exp2f((x - m) * log2(e)), as the wgmma design does.
  constexpr float unit = STEP ? LOG2E : 1.f;
  const int qpos0 = p.q_offset + q0;

  hopper::cp_async_wait<1>();  // this thread's copies of the first K tile landed
  __syncthreads();             // everyone's have; Q is stored
  while (kt < n_kt) {
    const int k0 = kt * F_BK;
    int next = next_tile(kt + 1);
    if constexpr (L::SPLIT)
      if (p.split && next < n_kt) next = next_tile(next + 1);

    // S = (q * scale) K^T: rows of this thread x keys tx + 16 j
    float s[F_RT][4];
#pragma unroll
    for (int i = 0; i < F_RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    float4 qf[2][F_RT / 4], kf[2];
    auto load_s = [&](int b, int d, int sw) {  // sw = d % 8, a constant
#pragma unroll
      for (int g = 0; g < F_RT / 4; ++g)
        qf[b][g] = *reinterpret_cast<const float4*>(Qs + d * F_BQ + 4 * (g * F_NTY + ty));
      kf[b] = *reinterpret_cast<const float4*>(Ks + d * F_BK + ((tx ^ sw) << 2));
    };
    load_s(0, 0, 0);
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += 8) {
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        if (dd < 7)
          load_s((dd + 1) % 2, d0 + dd + 1, dd + 1);
        else if (d0 + 8 < D)
          load_s(0, d0 + 8, 0);
        float qv[F_RT];
#pragma unroll
        for (int g = 0; g < F_RT / 4; ++g) {
          qv[4 * g] = qf[dd % 2][g].x, qv[4 * g + 1] = qf[dd % 2][g].y;
          qv[4 * g + 2] = qf[dd % 2][g].z, qv[4 * g + 3] = qf[dd % 2][g].w;
        }
        const float kv[4] = {kf[dd % 2].x, kf[dd % 2].y, kf[dd % 2].z, kf[dd % 2].w};
#pragma unroll
        for (int i = 0; i < F_RT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // mask only a tile on the diagonal, the window's edge or past sk (masked
    // keys -1e30 as in the TPU kernel, keys past sk weigh 0), then the
    // online-softmax update of (m, l, acc), the 8 rows' reductions interleaved
    const int kpos0 = p.kv_offset + k0;
    if (k0 + F_BK > p.sk || (p.causal && kpos0 + F_BK - 1 > qpos0) ||
        (p.window && kpos0 <= qpos0 + F_BQ - 1 - p.window)) {
      const int dq = qpos0 - kpos0;  // qpos - kpos = frow(i) + dq - key
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const bool past = k0 + key >= p.sk;
#pragma unroll
        for (int i = 0; i < F_RT; ++i) {
          const int rel = frow(i) + dq - key;
          if (past)
            s[i][j] = -INFINITY;
          else if ((p.causal && rel < 0) || (p.window && rel >= p.window))
            s[i][j] = NEG_INF;
        }
      }
    }
    float mx[F_RT];
#pragma unroll
    for (int i = 0; i < F_RT; ++i)
      mx[i] = fmaxf(fmaxf(m[i], fmaxf(s[i][0], s[i][1])), fmaxf(s[i][2], s[i][3]));
#pragma unroll
    for (int off = 8; off > 0; off /= 2)
#pragma unroll
      for (int i = 0; i < F_RT; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
    for (int i = 0; i < F_RT; ++i) {
      // finite: every visited tile holds a key below sk, which scores at
      // least -1e30 (a row fully masked so far has m = -1e30: alpha = 1 and
      // each masked score weighs exp2f(0) = 1 until a real key arrives, as
      // in ref); l keeps this thread's partial row sum
      const float alpha = exp2f((m[i] - mx[i]) * unit);
      m[i] = mx[i];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f((s[i][j] - mx[i]) * unit);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    // P key-major, float4 slot (row / 4) ^ (key % 8): the 8 lanes of a
    // quarter-warp (keys tx + 16 j, tx % 8 distinct) store to distinct banks
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tx + 16 * j;
      float* prow = Ps + key * F_BQ;
#pragma unroll
      for (int g = 0; g < F_RT / 4; ++g)
        *reinterpret_cast<float4*>(prow + (((g * F_NTY + ty) ^ (key % 8)) << 2)) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j], s[4 * g + 3][j]);
    }
    hopper::cp_async_wait<0>();  // this thread's V copies landed
    __syncthreads();  // everyone's have; P is stored; every warp is done with K: refill it
    if (next < n_kt) ffma_load_k<D>(Ks, kg, p.k_ss, next * F_BK, p.sk);
    hopper::cp_async_commit();

    // acc += P V over the tile's keys
    float4 pf[2][F_RT / 4], vf[2][NC / 4];
    auto load_pv = [&](int b, int j, int sw) {  // sw = j % 8, a constant
      const float* prow = Ps + j * F_BQ;
#pragma unroll
      for (int g = 0; g < F_RT / 4; ++g)
        pf[b][g] = *reinterpret_cast<const float4*>(prow + (((g * F_NTY + ty) ^ sw) << 2));
#pragma unroll
      for (int c = 0; c < NC / 4; ++c)
        vf[b][c] = *reinterpret_cast<const float4*>(Vs + j * D + 64 * c + 4 * tx);
    };
    load_pv(0, 0, 0);
#pragma unroll 1
    for (int j0 = 0; j0 < F_BK; j0 += 8) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj < 7)
          load_pv((jj + 1) % 2, j0 + jj + 1, jj + 1);
        else if (j0 + 8 < F_BK)
          load_pv(0, j0 + 8, 0);
        float pv[F_RT];
#pragma unroll
        for (int g = 0; g < F_RT / 4; ++g) {
          pv[4 * g] = pf[jj % 2][g].x, pv[4 * g + 1] = pf[jj % 2][g].y;
          pv[4 * g + 2] = pf[jj % 2][g].z, pv[4 * g + 3] = pf[jj % 2][g].w;
        }
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC / 4; ++c) {
          vv[4 * c] = vf[jj % 2][c].x, vv[4 * c + 1] = vf[jj % 2][c].y;
          vv[4 * c + 2] = vf[jj % 2][c].z, vv[4 * c + 3] = vf[jj % 2][c].w;
        }
#pragma unroll
        for (int i = 0; i < F_RT; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
    hopper::cp_async_wait<0>();  // this thread's copies of the next K tile landed
    __syncthreads();  // everyone's have; every warp is done with V and P: refill V
    if (next < n_kt) ffma_load_v<D>(Vs, vg, p.v_ss, next * F_BK, p.sk);
    hopper::cp_async_commit();
    kt = next;
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)

  // step: (m, l, acc) back in place, unnormalised; forward: acc / l (l == 0:
  // no tile visited, the row is 0); rows past sq dropped
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
#pragma unroll
    for (int i = 0; i < F_RT; ++i) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  if constexpr (L::SPLIT) {
    if (p.split) {
      // block 1 stores its partial (m, l, acc) into block 0's R through
      // distributed shared memory, and block 0 adds it to its own in a fixed
      // order: the same bits every launch.  A row one block saw no tile of
      // (m = -inf, l = 0) weighs 0 there; a row neither saw stays 0.
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      float* Rs = fsmem + L::R;
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      if (rank == 1) {
        float* racc = cluster.map_shared_rank(Rs, 0);
#pragma unroll
        for (int i = 0; i < F_RT; ++i) {
#pragma unroll
          for (int c = 0; c < NC / 4; ++c)
            *reinterpret_cast<float4*>(racc + frow(i) * D + 64 * c + 4 * tx) =
                make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
          if (tx == 0) racc[F_BQ * D + frow(i)] = m[i], racc[F_BQ * D + F_BQ + frow(i)] = l[i];
        }
      }
      cluster.sync();  // block 1's stores are visible to block 0
      if (rank == 1) return;
#pragma unroll
      for (int i = 0; i < F_RT; ++i) {
        const float m1 = Rs[F_BQ * D + frow(i)], l1 = Rs[F_BQ * D + F_BQ + frow(i)];
        const float mx = fmaxf(m[i], m1);
        const float a0 = m[i] == -INFINITY ? 0.f : exp2f(m[i] - mx);
        const float a1 = m1 == -INFINITY ? 0.f : exp2f(m1 - mx);
        l[i] = l[i] * a0 + l1 * a1;
        const float* arow = Rs + frow(i) * D;
#pragma unroll
        for (int c = 0; c < NC / 4; ++c) {
          const float4 r = *reinterpret_cast<const float4*>(arow + 64 * c + 4 * tx);
          acc[i][4 * c] = acc[i][4 * c] * a0 + r.x * a1;
          acc[i][4 * c + 1] = acc[i][4 * c + 1] * a0 + r.y * a1;
          acc[i][4 * c + 2] = acc[i][4 * c + 2] * a0 + r.z * a1;
          acc[i][4 * c + 3] = acc[i][4 * c + 3] * a0 + r.w * a1;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < F_RT; ++i) {
    const int row = q0 + frow(i);
    if (row >= p.sq) continue;
    float* out;
    float inv = 1.f;
    if constexpr (STEP) {
      if (tx == 0) {
        p.m_io[carry0 + row] = m[i];
        p.l_io[carry0 + row] = l[i];
      }
      out = p.acc_io + (carry0 + row) * D;
    } else {
      inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      out = p.o + bi * p.o_sb + h * p.o_sh + row * p.o_ss;
    }
#pragma unroll
    for (int c = 0; c < NC / 4; ++c)
      *reinterpret_cast<float4*>(out + 64 * c + 4 * tx) =
          make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv, acc[i][4 * c + 2] * inv,
                      acc[i][4 * c + 3] * inv);
  }
}

template <int D, bool STEP>
cudaError_t launch_ffma(FParams p, int b, cudaStream_t stream) {
  using L = FLayout<D>;
  auto kernel = flash_ffma_kernel<D, STEP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err == cudaSuccess)  // room for two blocks' shared memory on an SM (d <= 128)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L::THREADS, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.hq, b, (p.sq + L::BQ - 1) / L::BQ);
  p.one_wave = (long long)grid.x * grid.y * grid.z <= (long long)sms * per_sm;
  if constexpr (L::SPLIT) {
    // fewer q tiles than SMs: each gets a cluster of two blocks
    p.split = (long long)grid.x * grid.y * grid.z < sms;
    if (p.split) {
      p.one_wave = 0;  // clusters of two do not all fit at once: heaviest first
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = 1, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 2;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(grid.x, grid.y, 2 * grid.z);
      cfg.blockDim = dim3(L::THREADS);
      cfg.dynamicSmemBytes = L::BYTES;
      cfg.stream = stream;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, kernel, p);
      return err != cudaSuccess ? err : cudaGetLastError();
    }
  }
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// The ffma design's rule on q, k, v (see flash_attention_ffma_fwd): float32
// rows that 16-byte copies and float4 loads address; the step stops at d = 128.
bool ffma_takes(const void* q, const void* k, const void* v, int b, int hq, int hkv, int sq,
                int sk, int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                bool step) {
  auto ok = [](long long stride, int size) { return hopper::tma_stride_ok(stride, size, 4); };
  const int bq = d == 256 ? FLayout<256>::BQ : FLayout<128>::BQ;
  return !bad_shape(b, hq, hkv, sq, sk, d) && (d == 64 || d == 128 || (!step && d == 256)) &&
         ok(q_ss, sq) && ok(q_sh, hq) && ok(q_sb, b) && ok(k_ss, sk) && ok(k_sh, hkv) &&
         ok(k_sb, b) && ok(v_ss, sk) && ok(v_sh, hkv) && ok(v_sb, b) &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0 && b <= 65535 &&
         (sq + bq - 1) / bq <= 65535;
}

template <bool STEP>
int dispatch_ffma(const FParams& p, int b, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!STEP)
    if (d == 256) return static_cast<int>(launch_ffma<256, false>(p, b, s));
  return static_cast<int>(d == 128 ? launch_ffma<128, STEP>(p, b, s)
                                   : launch_ffma<64, STEP>(p, b, s));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of every tensor is contiguous.  Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int b, int hq, int hkv, int sq, int sk, int d, long long q_sb,
                        long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss, float scale,
                        int causal, int window, int q_offset, int kv_offset, void* stream) {
  if (bad_shape(b, hq, hkv, sq, sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    b,    hq,   hkv,   sq,     sk,     d,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,  v_sh,   v_ss,   o_sb,
                 o_sh, o_ss, scale, causal, window, q_offset, kv_offset,
                 nullptr, nullptr, nullptr, 0};
  return dispatch_dtype<false>(p, dtype, static_cast<cudaStream_t>(stream));
}

// Design "wgmma": bfloat16 only, d = 64, 128 or 256; every tensor 16-byte aligned
// with its last dim contiguous and every other stride (of a dim longer than
// 1) a positive multiple of 16 bytes, which is what TMA addresses.  Same
// arguments as flash_attention_fwd otherwise (no dtype); o is (b, hq, sq, d)
// with a contiguous last dim.  Returns cudaErrorInvalidValue for what it
// does not take, else cudaGetLastError() after the launch.
int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o, int b,
                              int hq, int hkv, int sq, int sk, int d, long long q_sb,
                              long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                              long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                              long long o_sb, long long o_sh, long long o_ss, float scale,
                              int causal, int window, int q_offset, int kv_offset,
                              void* stream) {
  CUtensorMap tq, tk, tv;
  const cudaError_t err = wgmma_maps(&tq, &tk, &tv, q, k, v, b, hq, hkv, sq, sk, d, q_sb,
                                     q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WParams p{o,        o_sb,   o_sh,     o_ss,      hq,      hkv,     sq, sk,
                  scale * LOG2E, causal, window, q_offset, kv_offset, nullptr, nullptr,
                  nullptr, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 256   ? launch_wgmma<256, false>(tq, tk, tv, p, b, s)
                          : d == 128 ? launch_wgmma<128, false>(tq, tk, tv, p, b, s)
                                     : launch_wgmma<64, false>(tq, tk, tv, p, b, s));
}

// One ring-attention step: fold k/v into the carry (m, l, acc), contiguous
// f32 of shapes (b, hq, sq), (b, hq, sq), (b, hq, sq, d), updated in place.
// Strides of q, k, v as for flash_attention_fwd.  Returns cudaGetLastError().
int flash_attention_step(const void* q, const void* k, const void* v, void* m_io,
                         void* l_io, void* acc_io, int init, int dtype, int b, int hq,
                         int hkv, int sq, int sk, int d, long long q_sb, long long q_sh,
                         long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss, float scale,
                         int causal, int window, int q_offset, int kv_offset, void* stream) {
  if (bad_shape(b, hq, hkv, sq, sk, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    nullptr, b,    hq,   hkv,   sq,    sk,     d,
                 q_sb, q_sh, q_ss, k_sb,    k_sh, k_ss, v_sb,  v_sh,  v_ss,   0,
                 0,    0,    scale, causal, window, q_offset, kv_offset,
                 static_cast<float*>(m_io), static_cast<float*>(l_io),
                 static_cast<float*>(acc_io), init};
  return dispatch_dtype<true>(p, dtype, static_cast<cudaStream_t>(stream));
}

// Design "wgmma" of flash_attention_step: the forward wgmma kernel's STEP
// instantiation, with the same rule on q, k, v (bf16, d = 64 or 128, what
// TMA addresses); m_io, l_io, acc_io as for flash_attention_step, acc_io
// 16-byte aligned.  Returns cudaErrorInvalidValue for what it does not
// take, else cudaGetLastError() after the launch.
int flash_attention_step_wgmma(const void* q, const void* k, const void* v, void* m_io,
                               void* l_io, void* acc_io, int init, int b, int hq, int hkv,
                               int sq, int sk, int d, long long q_sb, long long q_sh,
                               long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss, float scale,
                               int causal, int window, int q_offset, int kv_offset,
                               void* stream) {
  if (reinterpret_cast<uintptr_t>(acc_io) % 16 != 0 || m_io == nullptr || l_io == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  const cudaError_t err = wgmma_maps(&tq, &tk, &tv, q, k, v, b, hq, hkv, sq, sk, d, q_sb,
                                     q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WParams p{nullptr, 0,      0,        0,         hq,
                  hkv,     sq,     sk,       scale,     causal,
                  window,  q_offset, kv_offset, static_cast<float*>(m_io),
                  static_cast<float*>(l_io), static_cast<float*>(acc_io), init};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 128 ? launch_wgmma<128, true>(tq, tk, tv, p, b, s)
                                   : launch_wgmma<64, true>(tq, tk, tv, p, b, s));
}

// Design "ffma": float32 only, d = 64, 128 or 256; every tensor 16-byte aligned
// with its last dim contiguous and every other stride (of a dim longer than
// 1) a positive multiple of 16 bytes, the rule of the wgmma design in 4-byte
// elements.  Same arguments as flash_attention_wgmma_fwd; o is float32 (b,
// hq, sq, d), 16-byte aligned, its strides multiples of 4.  Returns
// cudaErrorInvalidValue for what it does not take, else cudaGetLastError()
// after the launch.
int flash_attention_ffma_fwd(const void* q, const void* k, const void* v, void* o, int b,
                             int hq, int hkv, int sq, int sk, int d, long long q_sb,
                             long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                             long long o_sb, long long o_sh, long long o_ss, float scale,
                             int causal, int window, int q_offset, int kv_offset, void* stream) {
  auto ok = [](long long stride, int size) { return hopper::tma_stride_ok(stride, size, 4); };
  if (!ffma_takes(q, k, v, b, hq, hkv, sq, sk, d, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                  v_ss, false) ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0 || !ok(o_ss, sq) || !ok(o_sh, hq) || !ok(o_sb, b))
    return static_cast<int>(cudaErrorInvalidValue);
  const FParams p{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, sk,
                  q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                  scale * LOG2E, causal, window, q_offset, kv_offset, nullptr, nullptr, nullptr,
                  0, 0, 0};
  return dispatch_ffma<false>(p, b, d, stream);
}

// Design "ffma" of flash_attention_step: the ffma forward kernel's STEP
// instantiation, with the same rule on q, k, v except that d is 64 or 128
// only (float32); m_io, l_io, acc_io as for flash_attention_step, acc_io
// 16-byte aligned.
// Returns cudaErrorInvalidValue for what it does not take, else
// cudaGetLastError() after the launch.
int flash_attention_step_ffma(const void* q, const void* k, const void* v, void* m_io,
                              void* l_io, void* acc_io, int init, int b, int hq, int hkv, int sq,
                              int sk, int d, long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                              long long v_sh, long long v_ss, float scale, int causal,
                              int window, int q_offset, int kv_offset, void* stream) {
  if (!ffma_takes(q, k, v, b, hq, hkv, sq, sk, d, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                  v_ss, true) ||
      reinterpret_cast<uintptr_t>(acc_io) % 16 != 0 || m_io == nullptr || l_io == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const FParams p{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), nullptr, hq, hkv, sq, sk,
                  q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, 0, 0, 0,
                  scale, causal, window, q_offset, kv_offset, static_cast<float*>(m_io),
                  static_cast<float*>(l_io), static_cast<float*>(acc_io), init, 0, 0};
  return dispatch_ffma<true>(p, b, d, stream);
}

// Dynamic shared memory of one block of the wgmma design at head dim d.
int flash_attention_wgmma_smem_bytes(int d) {
  return d == 256   ? WLayout<256>::BYTES
         : d == 128 ? WLayout<128>::BYTES
         : d == 64  ? WLayout<64>::BYTES
                    : 0;
}

// Dynamic shared memory of one block of the ffma design at head dim d.
int flash_attention_ffma_smem_bytes(int d) {
  return d == 256   ? FLayout<256>::BYTES
         : d == 128 ? FLayout<128>::BYTES
         : d == 64  ? FLayout<64>::BYTES
                    : 0;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
