// Flash decode: one query token per (batch row, head) over a ring KV cache.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode
// (_decode_kernel). q is (B, H, D) and k, v are (B, HK, C, D) ring caches,
// each given by its strides with d contiguous, so the model's (B, C, HK, D)
// cache layers are read in place. Query head h reads kv head h % HK, as the
// TPU kernel's index map does. Slot s holds position pos - ((pos - s) mod C);
// it is visible when that position is >= 0 and, with a window, when
// pos - position < window. The kernel only walks slots s < C, so a cache
// length that is no multiple of any tile needs no padding. m, l and the
// output accumulator are f32; the denominator is clamped at 1e-30; the output
// has q's type.
//
// Masked slots are never read: their score is the finite -1e30 of the TPU
// kernel, whose weight exp(-1e30 - m) is 0 as soon as a visible slot has
// been seen (the slot pos % C always is), so leaving them out of l and acc
// gives what the TPU kernel gives, and no wholly masked stretch turns into
// NaN (m starts at the finite -1e30, so alpha = exp(m_prev - m_new) is 0
// or 1, never inf - inf).
//
// What bounds it on the H100: decode reads the whole cache for one query.
// On the main path (f32, B=8, H=14, HK=2, C=576, D=64) k and v are 4.7 MB
// and q and o 57 KB, ~1.4 us at 3.35 TB/s, against 16.5 MFLOP, ~0.25 us at
// 67 TFLOP/s of f32: the kernel is bound by bytes (and at this size by its
// launch). The design: one block of 8 warps per (head, batch row), 112
// blocks on the path for 132 SMs. Each warp walks its own groups of 4
// slots; lane i holds elements i, i + 32, ... of q, k, v and o, so every
// load of a warp is one contiguous run of a cache row. The 4 slots' dot
// products are reduced by interleaved warp shuffles, and each warp keeps its
// own (m, l, acc); one pass through shared memory merges the 8 warps. The
// G = H / HK query heads of one kv head re-read the same cache rows, which
// stay in the 50 MB L2. Head dims 32, 64, 128 and 256 (VEC = D / 32
// elements of a row per lane). On recurrentgemma-2b's decode path (B=2,
// H=10, HK=1, a full ring of C=2048, D=256) k and v are 8.4 MB, ~2.5 us at
// 3.35 TB/s, and the grid has only 20 blocks: the 10 query heads of a row
// all read kv head 0. Later work: one block per kv head with the G query
// heads in registers, split-K over the cache for small B * H, cp.async/TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, U = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides sq, Strides sk, Strides sv, int HK, int C, int pos,
             int window, float scale) {
  constexpr int VEC = D / 32;  // elements of a row per lane
  __shared__ float s_m[WARPS], s_l[WARPS], s_acc[WARPS][D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const T* kb = k + b * sk.b + (h % HK) * sk.h;
  const T* vb = v + b * sv.b + (h % HK) * sv.h;

  float qv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) qv[j] = to_f(q[b * sq.b + h * sq.h + lane + 32 * j]);

  float m = NEG_INF, l = 0.f, acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int s0 = warp * U; s0 < C; s0 += WARPS * U) {
    float sc[U];
    bool ok[U];  // the same in every lane of the warp: no divergence
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      int dist = 0;  // pos - (position held by slot s)
      if (s < C) {
        dist = (pos - s) % C;
        if (dist < 0) dist += C;
      }
      ok[u] = s < C && pos - dist >= 0 && (window <= 0 || dist < window);
      sc[u] = 0.f;
      if (ok[u]) {
        const T* kr = kb + s * sk.s;
#pragma unroll
        for (int j = 0; j < VEC; ++j) sc[u] = fmaf(qv[j], to_f(kr[lane + 32 * j]), sc[u]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);

    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sc[u] = ok[u] ? sc[u] * scale : NEG_INF;
      m_new = fmaxf(m_new, sc[u]);
    }
    const float alpha = expf(m - m_new);
    float p[U], psum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[u] = ok[u] ? expf(sc[u] - m_new) : 0.f;
      psum += p[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const T* vr = vb + (s0 + u) * sv.s;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(p[u], to_f(vr[lane + 32 * j]), acc[j]);
    }
    m = m_new;
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) s_acc[warp][lane + 32 * j] = acc[j];
  __syncthreads();

  float m_all = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m_all = fmaxf(m_all, s_m[w]);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(s_m[w] - m_all);
      num = fmaf(a, s_acc[w][d], num);
      den = fmaf(a, s_l[w], den);
    }
    from_f(num / fmaxf(den, 1e-30f), o + ((long long)b * H + h) * D + d);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
           int H, int HK, int C, int pos, int window, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], 0}, sk{st[2], st[3], st[4]}, sv{st[5], st[6], st[7]};
  const dim3 grid(H, B);
  flash_decode<T, D><<<grid, THREADS, 0, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                                   sq, sk, sv, HK, C, pos, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
             int H, int HK, int C, int D, int pos, int window, float scale, cudaStream_t s) {
  if (D == 32) return launch<T, 32>(q, k, v, o, st, B, H, HK, C, pos, window, scale, s);
  if (D == 64) return launch<T, 64>(q, k, v, o, st, B, H, HK, C, pos, window, scale, s);
  if (D == 128) return launch<T, 128>(q, k, v, o, st, B, H, HK, C, pos, window, scale, s);
  if (D == 256) return launch<T, 256>(q, k, v, o, st, B, H, HK, C, pos, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: (b, h) element strides of q,
// then (b, h, s) of k and of v. o is a contiguous (B, H, D) buffer. window
// <= 0 means no window. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                                const long long* strides, int B, int H, int HK, int C, int D,
                                int dtype, int pos, int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK != 0 || C <= 0 || pos < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(q, k, v, o, strides, B, H, HK, C, D, pos, window, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, strides, B, H, HK, C, D, pos, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
