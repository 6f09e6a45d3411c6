// Tiled matrix product for Hopper (sm_90a), CUDA C++ with plain C entries:
// matmul_fwd and gmm_fwd, the grouped (expert) product, their bf16 wgmma
// designs matmul_wgmma_fwd and gmm_wgmma_fwd, and their float32 ffma
// designs matmul_ffma_fwd and gmm_ffma_fwd.
//
// Replaces: src/repro/kernels/matmul.py::matmul, the Pallas TPU kernel whose
// body is _mm_kernel: (m, k) @ (k, n), every tile widened to f32, the sum
// accumulated in f32, the result cast to x's dtype.  It is the TRA kernel
// function of every clean contraction the explicit-collective executor
// runs (core/spmd.py local_einsum), one call per rank and node.
//
// Also replaces: src/repro/kernels/moe_gmm.py::gmm (_gmm_kernel), the same
// product per expert on capacity-padded MoE buffers, (e, c, k) @ (e, k, n)
// -> (e, c, n): three calls per MoE FFN (models/moe.py).  At qwen2-moe's
// prefill (b=4, s=512: e=64, c=256, k/n = 2048/1408) a call does 94.5 GFLOP
// on 482 MB in bf16: bounded by bytes, 144 us at 3.35 TB/s (the expert
// weights dominate); mixtral's (8, 640, 4096) @ (8, 4096, 14336) is bounded
// by operations, 608 us at 989 TFLOP/s.  Each design is the matmul's with
// one more grid axis: blockIdx.z selects the expert and the operands'
// expert strides offset the three operands, so each block still owns one
// output tile of one expert.  Capacity rows past an expert's count hold
// zeros and are computed anyway, as on the TPU.
//
// What bounds it on this card.  At the shapes of llama-7b's prefill graph
// on one card (m = b*s = 2048; k, n = 4096 / 11008 / 32000) a product does
// 2*m*k*n operations on m*k + k*n + m*n elements: 68.7 GFLOP against
// 134 MB in float32 for q_proj (2048 x 4096 x 4096), so it is bounded by
// operations — 1.03 ms at the 67 TFLOP/s of f32 FMA outside the tensor
// cores, 69 us at the 989 TFLOP/s of bf16 tensor cores.
//
// Design.  The TPU kernel's grid carries the f32 accumulator in VMEM across
// a sequential k axis; here one block owns one output tile and walks k
// itself, keeping the accumulator in registers, so nothing but the output
// is written.  There are four kernels, picked before launch by the
// wrapper's shape rule (kernels/matmul.py design):
//
// "wgmma" (matmul_wgmma_fwd / gmm_wgmma_fwd: bf16 operands that TMA can
// address).  One block per 128 x 256 output tile, 288 threads: one producer
// warp keeps a 4-stage ring of 128 x 64 A and 64 x 256 B tiles (48 KB a
// stage, 192 KB in all) filled by TMA, each stage guarded by a full and an
// empty mbarrier; two consumer warpgroups each run wgmma m64n256k16 with
// f32 accumulators in registers (128 a thread) over their 64 rows, keeping
// one k-tile of wgmmas in flight while the next stage's wait resolves.
// Blocks take the output tiles in groups of 16 row tiles, row tile fastest,
// so the blocks in flight share their B panels and an A of 2048 rows stays
// in L2: with the column tile fastest, each 128-row block re-read B from
// device memory (16 times over at m = 2048).  A may be K-major or M-major
// and B N-major or K-major: the tensor map's innermost dim is the
// contiguous one and wgmma's transpose bits read the tile either way, so
// transposed views load without a copy.
// The grouped product uses 3-d tensor maps whose outer dim is the expert
// (blockIdx.z).  The epilogue rounds each f32 sum to bf16 once and stores it
// from the registers, masked at the ragged edge (TMA fills loads past the
// edge with zeros).  No split-K and no atomics: a launch gives the same bits
// every time.
//
// "ffma" (matmul_ffma_fwd / gmm_ffma_fwd: float32 operands whose inner dim
// is contiguous and whose other strides and base are 16-byte multiples, in
// either major).  It must be true f32: the reference's 1e-4 tolerance and
// its f32 semantics rule out TF32 and 3xTF32, so it is bounded by the 67
// TFLOP/s of the CUDA cores' FMAs.  One block per 128 x 128 output tile,
// 256 threads each owning an 8 x 8 sub-tile in registers; a 3-stage ring
// of 16-deep k-tiles in shared memory filled by cp.async (16-byte copies of
// an MN-major operand, 4-byte copies that transpose a K-major one), so the
// copies of the next two k-tiles run under the current one's FMAs; the
// next k-slice's fragments load during the current slice's FMAs (4 float4
// shared loads per 64 FMAs); at most 128 registers, so two blocks share an
// SM; output tiles in groups of 16 row tiles, row tile fastest, as the
// wgmma design.  No split-K and no atomics.
//
// "template", float32 (matmul_fwd / gmm_fwd with dtype 0: the f32 operands
// the ffma rule refuses, such as rows that are not 16-byte multiples): 256
// threads each own an 8 x 8 sub-tile and do f32 FMAs on the CUDA cores from
// 8-deep k tiles staged in shared memory by plain loads, one stage, read
// back as float4 (4 shared loads per 64 FMAs).
//
// "template", bf16 (dtype 1: the operands TMA cannot address, such as a
// rank-local (77, 130) block whose rows are not 16-byte multiples): tensor
// cores through nvcuda::wmma (16 x 16 x 16 bf16 fragments, f32
// accumulators), 8 warps each owning a 64 x 32 sub-tile over 32-deep k
// tiles; the f32 tile is staged through shared memory and rounded to bf16
// once.  Both template kernels read their operands element by element
// through their strides and mask every load and store, so any shape and
// any strides are taken as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

namespace {

struct Params {
  const void* a;  // (e, m, k)
  const void* b;  // (e, k, n)
  void* c;        // (e, m, n)
  int m, n, k;
  long long a_sm, a_sk;  // element strides
  long long b_sk, b_sn;
  long long c_sm, c_sn;
  long long a_se, b_se, c_se;  // expert strides (blockIdx.z); 0 for matmul
};

// ---------------------------------------------------------------------------
// float32: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_THREADS = 256;
constexpr int F_LDA = F_BM + 4;  // padded: the transposed A stores hit 32 banks

// GROUPED: blockIdx.z selects the expert (gmm_fwd); the flag only names the
// instantiation apart from the plain product's in a profile.
template <bool GROUPED>
__global__ void __launch_bounds__(F_THREADS) mm_f32_kernel(const Params p) {
  __shared__ __align__(16) float As[F_BK][F_LDA];  // A tile, k-major
  __shared__ __align__(16) float Bs[F_BK][F_BN];
  const long long e = GROUPED ? blockIdx.z : 0;
  const float* A = static_cast<const float*>(p.a) + e * p.a_se;
  const float* B = static_cast<const float*>(p.b) + e * p.b_se;
  float* C = static_cast<float*>(p.c) + e * p.c_se;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4 + j and 64 + tx*4 + j
  const int ty = tid >> 4;  // rows    ty*4 + i and 64 + ty*4 + i
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.k; k0 += F_BK) {
#pragma unroll
    for (int t = 0; t < F_BM * F_BK / F_THREADS; ++t) {
      const int idx = tid + t * F_THREADS;
      const int r = idx / F_BK, c = idx % F_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < p.m && gk < p.k) ? A[gm * p.a_sm + gk * p.a_sk] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < F_BK * F_BN / F_THREADS; ++t) {
      const int idx = tid + t * F_THREADS;
      const int r = idx / F_BN, c = idx % F_BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < p.k && gn < p.n) ? B[gk * p.b_sk + gn * p.b_sn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < p.n) C[gm * p.c_sm + gn * p.c_sn] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through wmma, f32 accumulators
// ---------------------------------------------------------------------------

constexpr int H_BM = 128, H_BN = 128, H_BK = 32, H_THREADS = 256;
constexpr int H_LDA = H_BK + 8;  // bf16 elements; multiples of 8 for wmma
constexpr int H_LDB = H_BN + 8;
constexpr int H_LDC = H_BN + 4;  // f32 staging of the output tile
constexpr size_t H_SMEM_AB = (size_t)(H_BM * H_LDA + H_BK * H_LDB) * sizeof(__nv_bfloat16);
constexpr size_t H_SMEM_C = (size_t)H_BM * H_LDC * sizeof(float);
constexpr size_t H_SMEM = H_SMEM_AB > H_SMEM_C ? H_SMEM_AB : H_SMEM_C;

template <bool GROUPED>
__global__ void __launch_bounds__(H_THREADS) mm_bf16_kernel(const Params p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + H_BM * H_LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the k loop

  const long long e = GROUPED ? blockIdx.z : 0;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a) + e * p.a_se;
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b) + e * p.b_se;
  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(p.c) + e * p.c_se;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // warp rows    wm*64 .. +64
  const int wn = warp & 3;   // warp columns wn*32 .. +32
  const int m0 = blockIdx.y * H_BM;
  const int n0 = blockIdx.x * H_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < p.k; k0 += H_BK) {
#pragma unroll 4
    for (int t = 0; t < H_BM * H_BK / H_THREADS; ++t) {
      const int idx = tid + t * H_THREADS;
      const int r = idx / H_BK, c = idx % H_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * H_LDA + c] = (gm < p.m && gk < p.k) ? A[gm * p.a_sm + gk * p.a_sk] : zero;
    }
#pragma unroll 4
    for (int t = 0; t < H_BK * H_BN / H_THREADS; ++t) {
      const int idx = tid + t * H_THREADS;
      const int r = idx / H_BN, c = idx % H_BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * H_LDB + c] = (gk < p.k && gn < p.n) ? B[gk * p.b_sk + gn * p.b_sn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * H_LDA + kk, H_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * H_LDB + wn * 32 + j * 16, H_LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * H_LDC + wn * 32 + j * 16, acc[i][j],
                              H_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < H_BM * H_BN; idx += H_THREADS) {
    const int r = idx / H_BN, c = idx % H_BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < p.m && gn < p.n) C[gm * p.c_sm + gn * p.c_sn] = __float2bfloat16(Cs[r * H_LDC + c]);
  }
}

template <bool GROUPED>
cudaError_t launch_f32(const Params& p, int e, cudaStream_t stream) {
  const dim3 grid((p.n + F_BN - 1) / F_BN, (p.m + F_BM - 1) / F_BM, e);
  mm_f32_kernel<GROUPED><<<grid, F_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool GROUPED>
cudaError_t launch_bf16(const Params& p, int e, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory needs this opt-in, or the
  // launch is refused (reported only by cudaGetLastError)
  cudaError_t err = cudaFuncSetAttribute(mm_bf16_kernel<GROUPED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(H_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + H_BN - 1) / H_BN, (p.m + H_BM - 1) / H_BM, e);
  mm_bf16_kernel<GROUPED><<<grid, H_THREADS, H_SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <bool GROUPED>
cudaError_t launch(const Params& p, int dtype, int e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32<GROUPED>(p, e, s);
  if (dtype == 1) return launch_bf16<GROUPED>(p, e, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// design "wgmma": bf16 through TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int G_BM = 128, G_BN = 256, G_BK = 64, G_STAGES = 4;
constexpr int G_GROUP_M = 16;   // row tiles per raster group
constexpr int G_THREADS = 288;  // consumer warpgroups 0 and 1, producer warp 8
constexpr int G_CONSUMER_WARPS = 8;
constexpr int G_TILE_A = G_BM * G_BK * 2;  // 16 KB

constexpr int G_TILE_B = G_BK * G_BN * 2;  // 32 KB
constexpr int G_STAGE = G_TILE_A + G_TILE_B;
constexpr int G_SMEM = G_STAGES * G_STAGE + 16 * G_STAGES + 1024;  // + barriers, alignment

struct GParams {
  void* c;
  int m, n, k;
  long long c_se, c_sm, c_sn;
};

// A_MN: A is M-major (its m stride is 1), else K-major; B_MN: B is N-major
// (row-major weights), else K-major.  Shared tiles per stage: A as one
// 128-row box of 64 k (K-major) or two 64-column boxes of m (M-major); B as
// four 64-column boxes of n (N-major) or one 256-row box of 64 k
// (K-major).  Blocks walk the output tiles in groups of G_GROUP_M row tiles,
// the row tile fastest: the blocks in flight share their B panels, and a
// 2048-row A stays in L2, so each operand is read from device memory about
// once.
template <bool GROUPED, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(G_THREADS, 1)
    mm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb, const GParams p) {
  extern __shared__ uint8_t g_smem_raw[];
  uint8_t* smem = g_smem_raw + ((1024 - (hopper::smem_u32(g_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G_STAGES * G_STAGE);
  uint64_t* empty = full + G_STAGES;

  const int e = GROUPED ? blockIdx.z : 0;
  const int n_mt = (p.m + G_BM - 1) / G_BM;
  const int n_nt = (p.n + G_BN - 1) / G_BN;
  const int group = blockIdx.x / (G_GROUP_M * n_nt);
  const int first_mt = group * G_GROUP_M;
  const int group_mt = min(n_mt - first_mt, G_GROUP_M);
  const int in_group = blockIdx.x % (G_GROUP_M * n_nt);
  const int m0 = (first_mt + in_group % group_mt) * G_BM;
  const int n0 = (in_group / group_mt) * G_BN;
  const int n_kt = (p.k + G_BK - 1) / G_BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], G_CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == G_CONSUMER_WARPS) {  // producer: one thread issues every load
    if (lane == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % G_STAGES;
        if (kt >= G_STAGES) hopper::mbar_wait(&empty[s], ((kt / G_STAGES) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], G_STAGE);
        uint8_t* a = smem + s * G_STAGE;
        uint8_t* b = a + G_TILE_A;
        const int k0 = kt * G_BK;
        if (A_MN) {
          hopper::tma_load_3d(a, &ta, &full[s], m0, k0, e);
          hopper::tma_load_3d(a + G_TILE_A / 2, &ta, &full[s], m0 + 64, k0, e);
        } else {
          hopper::tma_load_3d(a, &ta, &full[s], k0, m0, e);
        }
        if (B_MN) {
          for (int j = 0; j < G_BN / 64; ++j)
            hopper::tma_load_3d(b + j * (G_BK * 128), &tb, &full[s], n0 + 64 * j, k0, e);
        } else {
          hopper::tma_load_3d(b, &tb, &full[s], k0, n0, e);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile (in
  // either A layout they start 8 KB into the stage's A tile)
  const int wg = warp / 4;
  float acc[G_BN / 2];
#pragma unroll
  for (int i = 0; i < G_BN / 2; ++i) acc[i] = 0.f;
  hopper::fence_regs(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % G_STAGES;
    hopper::mbar_wait(&full[s], (kt / G_STAGES) & 1);
    const uint32_t a = hopper::smem_u32(smem + s * G_STAGE) + wg * (G_TILE_A / 2);
    const uint32_t b = hopper::smem_u32(smem + s * G_STAGE + G_TILE_A);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk) {
      // K-major: 16 k are 32 bytes along a 128-byte row; MN-major: 16 rows
      const uint64_t da = A_MN ? hopper::make_desc(a + kk * 2048, G_TILE_A / 2, 1024)
                               : hopper::make_desc(a + kk * 32, 16, 1024);
      const uint64_t db = B_MN ? hopper::make_desc(b + kk * 2048, G_BK * 128, 1024)
                               : hopper::make_desc(b + kk * 32, 16, 1024);
      hopper::wgmma_m64n256_ss<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous k-tile's products are done
    hopper::fence_regs(acc);
    if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % G_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // epilogue: thread holds rows r, r + 8 and columns 8 c + 2 (lane % 4) + {0, 1}
  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(p.c) + e * p.c_se;
  const bool pairs = p.c_sn == 1 && p.c_sm % 2 == 0 && p.c_se % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(p.c) % 4 == 0;
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.m) continue;
    __nv_bfloat16* crow = C + row * p.c_sm;
#pragma unroll
    for (int c = 0; c < G_BN / 8; ++c) {
      const int col = n0 + 8 * c + 2 * (lane % 4);
      const float v0 = acc[4 * c + 2 * i], v1 = acc[4 * c + 2 * i + 1];
      if (pairs && col + 1 < p.n) {
        *reinterpret_cast<__nv_bfloat162*>(crow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < p.n) crow[col * p.c_sn] = __float2bfloat16(v0);
        if (col + 1 < p.n) crow[(col + 1) * p.c_sn] = __float2bfloat16(v1);
      }
    }
  }
}

// Tensor map of one operand: dims (inner, outer, expert) in elements, the
// inner dim contiguous, boxes of (64, box_outer, 1).
cudaError_t operand_map(CUtensorMap* map, const void* base, int inner, int outer, int e,
                        long long s_outer, long long s_e, uint32_t box_outer) {
  const uint64_t dims[3] = {(uint64_t)inner, (uint64_t)outer, (uint64_t)e};
  const uint64_t strides[2] = {(uint64_t)s_outer * 2, (uint64_t)s_e * 2};
  const uint32_t box[3] = {64, box_outer, 1};
  return hopper::make_map(map, base, 3, dims, strides, box);
}

template <bool GROUPED, bool A_MN, bool B_MN>
cudaError_t launch_wgmma_layout(const CUtensorMap& ta, const CUtensorMap& tb, const GParams& p,
                                int e, cudaStream_t stream) {
  auto kernel = mm_wgmma_kernel<GROUPED, A_MN, B_MN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((p.m + G_BM - 1) / G_BM) * ((p.n + G_BN - 1) / G_BN);
  const dim3 grid(static_cast<unsigned>(tiles), 1, e);
  kernel<<<grid, G_THREADS, G_SMEM, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

// a (e, m, k), b (e, k, n), c (e, m, n) bf16 with element strides; a_mn /
// b_mn pick the layouts (see mm_wgmma_kernel).
template <bool GROUPED>
int launch_wgmma(const void* a, const void* b, void* c, int e, int m, int n, int k,
                 long long a_se, long long a_sm, long long a_sk, long long b_se,
                 long long b_sk, long long b_sn, long long c_se, long long c_sm,
                 long long c_sn, int a_mn, int b_mn, void* stream) {
  using hopper::tma_stride_ok;
  const bool a_ok = a_mn ? (m == 1 || a_sm == 1) && tma_stride_ok(a_sk, k)
                         : (k == 1 || a_sk == 1) && tma_stride_ok(a_sm, m);
  const bool b_ok = b_mn ? (n == 1 || b_sn == 1) && tma_stride_ok(b_sk, k)
                         : (k == 1 || b_sk == 1) && tma_stride_ok(b_sn, n);
  const long long tiles = (long long)((m + G_BM - 1) / G_BM) * ((n + G_BN - 1) / G_BN);
  if (e < 1 || e > 65535 || m < 1 || n < 1 || k < 1 || tiles >= (1ll << 31) || !a_ok ||
      !b_ok || !tma_stride_ok(a_se, e) || !tma_stride_ok(b_se, e) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  cudaError_t err = a_mn ? operand_map(&ta, a, m, k, e, a_sk, a_se, G_BK)
                         : operand_map(&ta, a, k, m, e, a_sm, a_se, G_BM);
  if (err == cudaSuccess)
    err = b_mn ? operand_map(&tb, b, n, k, e, b_sk, b_se, G_BK)
               : operand_map(&tb, b, k, n, e, b_sn, b_se, G_BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GParams p{c, m, n, k, c_se, c_sm, c_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_mn)
    err = b_mn ? launch_wgmma_layout<GROUPED, true, true>(ta, tb, p, e, s)
               : launch_wgmma_layout<GROUPED, true, false>(ta, tb, p, e, s);
  else
    err = b_mn ? launch_wgmma_layout<GROUPED, false, true>(ta, tb, p, e, s)
               : launch_wgmma_layout<GROUPED, false, false>(ta, tb, p, e, s);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// design "ffma": float32 through a cp.async ring and f32 FMAs
// ---------------------------------------------------------------------------

constexpr int S_BM = 128, S_BN = 128, S_BK = 16, S_STAGES = 3, S_THREADS = 256;
constexpr int S_GROUP_M = 16;                // row tiles per raster group
constexpr int S_LD = S_BM + 4;               // floats per shared row of a tile
constexpr int S_TILE = S_BK * S_LD;          // floats per operand tile
constexpr int S_SMEM = S_STAGES * 2 * S_TILE * 4;  // 50,688 bytes: two blocks an SM

// One operand's k-tile into shared memory as [S_BK][S_LD], the M (or N)
// dim contiguous, whatever its layout in device memory: `mn` is the M/N
// index, `s_mn` / `s_k` the element strides.  MN_MAJOR (s_mn == 1): 16-byte
// copies of 4 consecutive M/N elements, 2 a thread.  K-major (s_k == 1):
// 4-byte copies that transpose on the way, 8 a thread; a warp takes 8 k of
// 4 rows (32-byte pieces of global rows) and writes them to 32 distinct
// banks.  Elements past the edges are zero-filled.
template <bool MN_MAJOR>
__device__ __forceinline__ void ffma_load_tile(float* dst, const float* src, int mn0, int k0,
                                               int mn_ext, int k_ext, long long s_mn,
                                               long long s_k) {
  const int tid = threadIdx.x;
  if constexpr (MN_MAJOR) {
    // copy i: k row tid / 32 + 8 i, columns 4 (tid % 32) .. 4 (tid % 32) + 3
    const int kr = tid / (S_BM / 4), col = (tid % (S_BM / 4)) * 4;
    const int cols = max(0, min(4, mn_ext - mn0 - col));  // in range at this column
    const float* from = src + (long long)(k0 + kr) * s_k + mn0 + col;
    float* to = dst + kr * S_LD + col;
#pragma unroll
    for (int i = 0; i < S_BK * S_BM / 4 / S_THREADS; ++i) {
      const int valid = k0 + kr + 8 * i < k_ext ? cols : 0;
      hopper::cp_async16(to + 8 * i * S_LD, valid ? from + 8 * i * s_k : src, 4 * valid);
    }
  } else {
    // copy i: k column lane % 8 + 8 (i % KG) of row lane / 8 + 4 warp + 32 (i / KG)
    constexpr int KG = S_BK / 8;
    const int lane = tid % 32, warp = tid / 32;
    const int kc = lane % 8, row = lane / 8 + 4 * warp;
    const int rows = mn_ext - mn0 - row;  // rows in range from this one on
    const float* from = src + (long long)(mn0 + row) * s_mn + k0 + kc;
    float* to = dst + kc * S_LD + row;
#pragma unroll
    for (int i = 0; i < S_BK * S_BM / S_THREADS; ++i) {
      const int dr = 32 * (i / KG), dk = 8 * (i % KG);
      const bool valid = dr < rows && k0 + kc + dk < k_ext;
      hopper::cp_async4(to + dk * S_LD + dr, valid ? from + dr * s_mn + dk : src,
                        valid ? 4 : 0);
    }
  }
}

// A thread's 8 values of one shared row: t*4 .. t*4+3 and 64+t*4 .. 64+t*4+3.
__device__ __forceinline__ void ffma_frag(float (&f)[8], const float* row, int t) {
  *reinterpret_cast<float4*>(f) = *reinterpret_cast<const float4*>(row + t * 4);
  *reinterpret_cast<float4*>(f + 4) = *reinterpret_cast<const float4*>(row + 64 + t * 4);
}

// One block per 128 x 128 output tile, 256 threads, each owning an 8 x 8
// sub-tile (rows ty*4 + i and 64 + ty*4 + i, columns likewise from tx) in
// registers.  A 3-stage ring of 16-deep k-tiles in shared memory is kept
// filled by cp.async: while the FMAs of k-tile kt run, the copies of
// kt + 1 and kt + 2 are in flight, and one __syncthreads a k-tile both
// publishes the arrived tile and frees the slot the next copies overwrite.
// Inside a k-tile the next k-slice's fragments (2 + 2 float4 shared loads)
// load while the current slice's 64 FMAs run.  Capped at 128 registers so
// two blocks (16 warps) share an SM.  Output tiles in groups of S_GROUP_M
// row tiles, the row tile fastest, as the wgmma design.
template <bool GROUPED, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(S_THREADS, 2) mm_ffma_kernel(const Params p) {
  extern __shared__ __align__(16) float s_smem[];
  const long long e = GROUPED ? blockIdx.z : 0;
  const float* A = static_cast<const float*>(p.a) + e * p.a_se;
  const float* B = static_cast<const float*>(p.b) + e * p.b_se;

  const int n_mt = (p.m + S_BM - 1) / S_BM;
  const int n_nt = (p.n + S_BN - 1) / S_BN;
  const int group = blockIdx.x / (S_GROUP_M * n_nt);
  const int first_mt = group * S_GROUP_M;
  const int group_mt = min(n_mt - first_mt, S_GROUP_M);
  const int in_group = blockIdx.x % (S_GROUP_M * n_nt);
  const int m0 = (first_mt + in_group % group_mt) * S_BM;
  const int n0 = (in_group / group_mt) * S_BN;
  const int n_kt = (p.k + S_BK - 1) / S_BK;

  auto load_stage = [&](int slot, int kt) {
    float* as = s_smem + slot * 2 * S_TILE;
    ffma_load_tile<A_MN>(as, A, m0, kt * S_BK, p.m, p.k, p.a_sm, p.a_sk);
    ffma_load_tile<B_MN>(as + S_TILE, B, n0, kt * S_BK, p.n, p.k, p.b_sn, p.b_sk);
  };
#pragma unroll
  for (int s = 0; s < S_STAGES - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    hopper::cp_async_commit();
  }

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    hopper::cp_async_wait<S_STAGES - 2>();  // this thread's copies of k-tile kt landed
    __syncthreads();  // everyone's have; everyone is done with k-tile kt - 1's slot
    const int next = kt + S_STAGES - 1;
    if (next < n_kt) load_stage(next % S_STAGES, next);
    hopper::cp_async_commit();

    const float* as = s_smem + (kt % S_STAGES) * 2 * S_TILE;
    const float* bs = as + S_TILE;
    float a[2][8], b[2][8];
    ffma_frag(a[0], as, ty);
    ffma_frag(b[0], bs, tx);
#pragma unroll
    for (int kk = 0; kk < S_BK; ++kk) {
      if (kk + 1 < S_BK) {
        ffma_frag(a[(kk + 1) % 2], as + (kk + 1) * S_LD, ty);
        ffma_frag(b[(kk + 1) % 2], bs + (kk + 1) * S_LD, tx);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[kk % 2][i], b[kk % 2][j], acc[i][j]);
    }
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)

  float* C = static_cast<float*>(p.c) + e * p.c_se;
  const bool vec = p.c_sn == 1 && p.c_sm % 4 == 0 && p.c_se % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.c) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= p.m) continue;
    float* crow = C + row * p.c_sm;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + tx * 4;
      if (vec && col + 3 < p.n) {
        *reinterpret_cast<float4*>(crow + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < p.n) crow[(col + j) * p.c_sn] = acc[i][4 * h + j];
      }
    }
  }
}

template <bool GROUPED, bool A_MN, bool B_MN>
cudaError_t launch_ffma_layout(const Params& p, int e, cudaStream_t stream) {
  auto kernel = mm_ffma_kernel<GROUPED, A_MN, B_MN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
  if (err == cudaSuccess)  // room for two blocks' shared memory on an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((p.m + S_BM - 1) / S_BM) * ((p.n + S_BN - 1) / S_BN);
  kernel<<<dim3(static_cast<unsigned>(tiles), 1, e), S_THREADS, S_SMEM, stream>>>(p);
  return cudaGetLastError();
}

// a (e, m, k), b (e, k, n), c (e, m, n) float32 with element strides; a_mn /
// b_mn pick the layouts as for the wgmma design, and the rule is the same:
// the operand's inner dim contiguous, its other strides and its base
// 16-byte multiples (what a 16-byte cp.async addresses).
template <bool GROUPED>
int launch_ffma(const void* a, const void* b, void* c, int e, int m, int n, int k,
                long long a_se, long long a_sm, long long a_sk, long long b_se, long long b_sk,
                long long b_sn, long long c_se, long long c_sm, long long c_sn, int a_mn,
                int b_mn, void* stream) {
  auto ok = [](long long stride, int size) { return hopper::tma_stride_ok(stride, size, 4); };
  const bool a_ok = a_mn ? (m == 1 || a_sm == 1) && ok(a_sk, k)
                         : (k == 1 || a_sk == 1) && ok(a_sm, m);
  const bool b_ok = b_mn ? (n == 1 || b_sn == 1) && ok(b_sk, k)
                         : (k == 1 || b_sk == 1) && ok(b_sn, n);
  const long long tiles = (long long)((m + S_BM - 1) / S_BM) * ((n + S_BN - 1) / S_BN);
  if (e < 1 || e > 65535 || m < 1 || n < 1 || k < 1 || tiles >= (1ll << 31) || !a_ok ||
      !b_ok || !ok(a_se, e) || !ok(b_se, e) || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a unit stride of a dim of size 1 is whatever the caller passed: the
  // kernel only ever steps the contiguous dim by 1
  const Params p{a, b, c, m, n, k, a_mn ? 1 : a_sm, a_mn ? a_sk : 1, b_mn ? b_sk : 1,
                 b_mn ? 1 : b_sn, c_sm, c_sn, a_se, b_se, c_se};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_mn)
    err = b_mn ? launch_ffma_layout<GROUPED, true, true>(p, e, s)
               : launch_ffma_layout<GROUPED, true, false>(p, e, s);
  else
    err = b_mn ? launch_ffma_layout<GROUPED, false, true>(p, e, s)
               : launch_ffma_layout<GROUPED, false, false>(p, e, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// c (m, n) = a (m, k) @ b (k, n) with f32 accumulation; dtype 0 = float32,
// 1 = bfloat16 (all three tensors).  Strides in elements, any sign-free
// values.  Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int matmul_fwd(const void* a, const void* b, void* c, int dtype, int m, int n, int k,
               long long a_sm, long long a_sk, long long b_sk, long long b_sn,
               long long c_sm, long long c_sn, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{a, b, c, m, n, k, a_sm, a_sk, b_sk, b_sn, c_sm, c_sn, 0, 0, 0};
  return static_cast<int>(launch<false>(p, dtype, 1, stream));
}

// Grouped (expert) product: c[i] (m, n) = a[i] (m, k) @ b[i] (k, n) for
// i < e, one grid slice per expert; strides in elements, the expert
// strides first.  Same dtypes and return value as matmul_fwd.
int gmm_fwd(const void* a, const void* b, void* c, int dtype, int e, int m, int n, int k,
            long long a_se, long long a_sm, long long a_sk, long long b_se, long long b_sk,
            long long b_sn, long long c_se, long long c_sm, long long c_sn, void* stream) {
  if (e < 1 || e > 65535 || m < 1 || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{a, b, c, m, n, k, a_sm, a_sk, b_sk, b_sn, c_sm, c_sn, a_se, b_se, c_se};
  return static_cast<int>(launch<true>(p, dtype, e, stream));
}

// Design "wgmma" of matmul_fwd: bfloat16 only.  a_mn = 1 when a's m stride
// is 1 (else its k stride must be), b_mn = 1 when b's n stride is 1 (else
// its k stride must be); the other stride of each, in bytes, a positive
// multiple of 16, and both bases 16-byte aligned.  Returns
// cudaErrorInvalidValue for what it does not take, else cudaGetLastError()
// after the launch.
int matmul_wgmma_fwd(const void* a, const void* b, void* c, int m, int n, int k,
                     long long a_sm, long long a_sk, long long b_sk, long long b_sn,
                     long long c_sm, long long c_sn, int a_mn, int b_mn, void* stream) {
  return launch_wgmma<false>(a, b, c, 1, m, n, k, 0, a_sm, a_sk, 0, b_sk, b_sn, 0, c_sm, c_sn,
                             a_mn, b_mn, stream);
}

// Design "wgmma" of gmm_fwd: as matmul_wgmma_fwd per expert; the expert
// strides too must be positive multiples of 16 bytes (where e > 1).
int gmm_wgmma_fwd(const void* a, const void* b, void* c, int e, int m, int n, int k,
                  long long a_se, long long a_sm, long long a_sk, long long b_se,
                  long long b_sk, long long b_sn, long long c_se, long long c_sm,
                  long long c_sn, int a_mn, int b_mn, void* stream) {
  return launch_wgmma<true>(a, b, c, e, m, n, k, a_se, a_sm, a_sk, b_se, b_sk, b_sn, c_se,
                            c_sm, c_sn, a_mn, b_mn, stream);
}

// Design "ffma" of matmul_fwd: float32 only, the same layout flags and
// operand rule as matmul_wgmma_fwd (strides in 4-byte elements).  Returns
// cudaErrorInvalidValue for what it does not take, else cudaGetLastError()
// after the launch.
int matmul_ffma_fwd(const void* a, const void* b, void* c, int m, int n, int k,
                    long long a_sm, long long a_sk, long long b_sk, long long b_sn,
                    long long c_sm, long long c_sn, int a_mn, int b_mn, void* stream) {
  return launch_ffma<false>(a, b, c, 1, m, n, k, 0, a_sm, a_sk, 0, b_sk, b_sn, 0, c_sm, c_sn,
                            a_mn, b_mn, stream);
}

// Design "ffma" of gmm_fwd: as matmul_ffma_fwd per expert; the expert
// strides too must be positive multiples of 16 bytes (where e > 1).
int gmm_ffma_fwd(const void* a, const void* b, void* c, int e, int m, int n, int k,
                 long long a_se, long long a_sm, long long a_sk, long long b_se, long long b_sk,
                 long long b_sn, long long c_se, long long c_sm, long long c_sn, int a_mn,
                 int b_mn, void* stream) {
  return launch_ffma<true>(a, b, c, e, m, n, k, a_se, a_sm, a_sk, b_se, b_sk, b_sn, c_se,
                           c_sm, c_sn, a_mn, b_mn, stream);
}

// Dynamic shared memory of one block of the wgmma design.
int matmul_wgmma_smem_bytes() { return G_SMEM; }

// Dynamic shared memory of one block of the ffma design.
int matmul_ffma_smem_bytes() { return S_SMEM; }

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
