// Forward flash attention for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas TPU kernel whose body is _flash_kernel.  Same function: q is upcast
// to f32 and scaled; scores, the running max m, the running sum l and the
// accumulator are f32; causal and sliding-window masks use the absolute
// positions q_offset + i and kv_offset + j; masked scores inside a relevant
// tile are -1e30; KV tiles that are fully masked are skipped; the output is
// acc / (l == 0 ? 1 : l) in q's dtype; GQA maps query head h to KV head
// h / (hq / hkv).  Unlike the TPU kernel, sq and sk need not divide the
// tiles: keys past sk get weight exactly 0 and rows past sq are not written.
//
// Bound at the serving path's shape (b=4, h=32, s=512, d=128, bf16, causal):
// q, k, v and o are 16.8 MB each, 67.1 MB in all, about 20 us at 3.35 TB/s;
// the two products are 2 * 2 * b*h*s*s*d / 2 = 8.6 GFLOP, about 8.7 us at
// the 989 TFLOP/s bf16 tensor-core peak.  So the work is bounded by bytes,
// at about 20 us a launch (at s=2048 it would be bounded by operations).
//
// Design: one block of 256 threads per (64-row q tile, head, batch); the
// loop over 32-key KV tiles inside the block replaces the TPU's sequential
// grid axis and carries (m, l, acc) in registers.  Each input byte is read
// from device memory once per q tile (K/V once per q tile and query head),
// and nothing but the output is written, which is what the byte bound asks
// for.  The Q tile and the current K/V tile sit in shared memory in f32
// (the f32 path must be true f32, so no TF32), and both products run as
// f32 FMAs on the CUDA cores; at this shape that makes the kernel bounded
// by f32 FMA issue and shared-memory reads, well above the byte bound
// (chip_smoke.py measured 0.83 ms a launch, 41x the bound, on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit).  Tensor cores (wgmma), TMA loads and
// warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLK_Q = 64;     // q rows per block
constexpr int BLK_K = 32;     // keys per KV tile
constexpr int THREADS = 256;  // 16 x 16: tx picks columns, ty picks rows
constexpr float NEG_INF = -1e30f;

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
};

__host__ __device__ constexpr size_t smem_floats(int d) {
  // Q tile and K tile with a padded row (d + 1) so that the 16 column
  // threads of a warp read 16 different banks; V tile; P tile (padded).
  return (size_t)BLK_Q * (d + 1) + (size_t)BLK_K * (d + 1) + (size_t)BLK_K * d +
         (size_t)BLK_Q * (BLK_K + 1);
}

// NCOL: output columns each thread owns (tx + 16 * c, c < NCOL), so d <= 16 * NCOL.
template <typename T, int NCOL>
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

  float m[4], l[4], acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }

  const int q_first = p.q_offset + q0;
  const int q_last = q_first + nq - 1;
  const int n_kt = (p.sk + BLK_K - 1) / BLK_K;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLK_K;
    const int nk = min(BLK_K, p.sk - k0);
    const int k_first = p.kv_offset + k0;
    const int k_last = k_first + nk - 1;
    // tile relevance, uniform over the block: skip fully masked tiles
    if (p.causal && k_first > q_last) continue;
    if (p.window && k_last <= q_first - p.window) continue;

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

template <typename T, int NCOL>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.d) * sizeof(float);
  // above 48 KB a block's dynamic shared memory needs this opt-in, or the
  // launch is refused (reported only by cudaGetLastError)
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NCOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BLK_Q - 1) / BLK_Q, p.hq, p.b);
  flash_fwd_kernel<T, NCOL><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 2>(p, stream);
  if (p.d <= 64) return launch<T, 4>(p, stream);
  if (p.d <= 128) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
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
  if (d < 1 || d > 256 || b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    b,    hq,   hkv,   sq,     sk,     d,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,  v_sh,   v_ss,   o_sb,
                 o_sh, o_ss, scale, causal, window, q_offset, kv_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_head_dim<float>(p, s);
  else if (dtype == 1)
    err = dispatch_head_dim<__nv_bfloat16>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
