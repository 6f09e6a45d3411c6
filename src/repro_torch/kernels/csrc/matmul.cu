// Tiled matrix product for Hopper (sm_90a), CUDA C++ with two plain C
// entries: matmul_fwd and gmm_fwd, the grouped (expert) product.
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
// by operations, 608 us at 989 TFLOP/s.  The design is the matmul's with
// one more grid axis: blockIdx.z selects the expert and the operands'
// expert strides offset the three pointers, so each block still owns one
// 128 x 128 output tile of one expert.  Capacity rows past an expert's
// count hold zeros and are computed anyway, as on the TPU.
//
// What bounds it on this card.  At the shapes of llama-7b's prefill graph
// on one card (m = b*s = 2048; k, n = 4096 / 11008 / 32000) a product does
// 2*m*k*n operations on m*k + k*n + m*n elements: 68.7 GFLOP against
// 134 MB in float32 for q_proj (2048 x 4096 x 4096), so it is bounded by
// operations — 1.03 ms at the 67 TFLOP/s of f32 FMA outside the tensor
// cores, 69 us at the 989 TFLOP/s of bf16 tensor cores.
//
// Design.  The TPU kernel's grid carries the f32 accumulator in VMEM across
// a sequential k axis; here one block owns one 128 x 128 output tile and
// walks k itself, keeping the accumulator in registers, so nothing but the
// output is written.  The f32 path must be true f32 (the reference's 1e-4
// tolerance rules out TF32): 256 threads each own an 8 x 8 sub-tile and do
// f32 FMAs on the CUDA cores from 8-deep k tiles staged in shared memory,
// read back as float4 (4 shared loads per 64 FMAs).  The bf16 path uses the
// tensor cores through nvcuda::wmma (16 x 16 x 16 bf16 fragments, f32
// accumulators): 8 warps each own a 64 x 32 sub-tile over 32-deep k tiles;
// the f32 tile is staged through shared memory and rounded to bf16 once.
// The reference asserts that the tiles divide the shape; a rank's local
// block need not, so every load and store is masked (zeros past the edge).
// Operands are read through their element strides, so transposed or
// sliced 2-d views are taken as they are, without a copy.  Neither path
// pipelines its loads (no cp.async / TMA double buffering) and the bf16
// path does not use wgmma: both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
