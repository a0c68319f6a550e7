// Forward flash attention with GQA, causal and sliding-window masks.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel). q is (B, H, Sq, D) and k, v are (B, HK, Skv, D), each
// given by its b, h and s strides with d contiguous, so the model's
// (B, S, H, D) projections are read and written in place. Query head h
// reads kv head h % HK, as the TPU kernel's index map does. Query row i sits
// at position i and key j at position j; a key is visible when j < Skv,
// j <= i (causal) and i - j < window. Masked scores are the finite -1e30 of
// the TPU kernel, and the denominator is clamped at 1e-30. m, l and the
// output accumulator stay in f32 registers; the output has q's type.
//
// What bounds it on the H100: on the main path (f32, B=8, H=14, HK=2,
// S=512, D=64, causal) the work is ~3.8 GFLOP of f32 arithmetic against
// 67 TFLOP/s of f32 CUDA cores, ~56 us, while q, k, v and o are ~34 MB,
// ~10 us at 3.35 TB/s: the kernel is bound by operations. Exact f32 input
// keeps it off the tensor cores (TF32 would break the 2e-5 agreement with
// the plain version). The design: one block of 256 threads per
// (64-query tile, head, batch row); the query tile and each 64-key tile of
// K and V are converted to f32 in shared memory; each thread owns a 4x4
// block of scores and a 4 x D/16 block of the output, with the row max and
// row sum reduced over the 16 threads that share a row by warp shuffles.
// Key tiles that lie wholly above the diagonal (causal) or wholly outside
// the window are skipped. Skipping is exact: every query row sees its own
// key, so a row's first visible tile flushes what masked tiles added.
// Head dims 64, 128 and 256. At D = 256 (recurrentgemma-2b: H=10, HK=1,
// a local window of 2048) the tiles take 4 * (64*257 + 64*257 + 64*256 +
// 64*65) = 213,760 bytes of shared memory, under the 232,448 a block may opt
// into, so one block runs per SM, and each thread holds 4 x 16 output
// accumulators in registers.
// Later work: bf16/fp16 through the tensor cores (mma/wgmma), a deeper
// pipeline with cp.async or TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so,
          int HK, int Sq, int Skv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;      // padded Q/K rows: conflict-free column reads
  constexpr int LDP = BKV + 1;
  constexpr int R = BQ / 16;     // query rows per thread
  constexpr int CS = BKV / 16;   // score columns per thread
  constexpr int CO = D / 16;     // output columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* Ps = Vs + BKV * D;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h % HK;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * LD + c] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * sq.s + c]) : 0.f;
  }

  float m[R], l[R], acc[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  // key range that some row of this tile can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (kv_end + BKV - 1) / BKV;

  for (int t = kv_begin / BKV; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Skv;
      Ks[r * LD + c] = ok ? to_f(kb[(k0 + r) * sk.s + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f(vb[(k0 + r) * sv.s + c]) : 0.f;
    }
    __syncthreads();

    float s[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[CS];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(ty * R + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CS; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < Skv && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * R + i) * LDP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      float pv[R], vv[CO];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(ty * R + i) * LDP + c];
#pragma unroll
      for (int jd = 0; jd < CO; ++jd) vv[jd] = Vs[c * D + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jd = 0; jd < CO; ++jd) acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < CO; ++jd) from_f(acc[i][jd] / den, ob + qp * so.s + tx + 16 * jd);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st,
           int B, int H, int HK, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, so, HK, Sq, Skv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: (b, h, s) element strides of
// q, k, v and o, in that order. window <= 0 means no window. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int B, int H, int HK, int Sq,
                                   int Skv, int D, int dtype, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, strides, B, H, HK, Sq, Skv, causal, window, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, strides, B, H, HK, Sq, Skv, causal, window, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, strides, B, H, HK, Sq, Skv, causal, window,
                                     scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, strides, B, H, HK, Sq, Skv, causal, window,
                                      scale, s);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, o, strides, B, H, HK, Sq, Skv, causal, window, scale, s);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, o, strides, B, H, HK, Sq, Skv, causal, window,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
