// Mamba-1 selective scan: h <- exp(dt * A) * h + (dt * u) (x) B, y_t = h . C_t.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::mamba_scan
// (_mamba_kernel). u and dt are (B, S, DI), Bm and Cm (B, S, N), A (DI, N).
// The state h (DI, N) per batch row starts at zero and stays in f32; y has
// u's type (f32 or bf16) and h_final is the state after the last step. No
// D-skip: the caller adds u * D. u, dt and A are contiguous; Bm and Cm are
// given by their (b, s) strides with n contiguous, so the slices of the
// model's x_proj output (B, S, r + 2N) are read in place. Any S >= 1 and any
// DI: the kernel masks the ragged chunk and channel tile itself, where the
// TPU kernel asserts S % bc == 0 and DI % bd == 0.
//
// What bounds it on the H100: the scan is sequential in S, parallel in
// (b, d, n). On the main path (B=2, S=512, DI=8192, N=16) it reads u and dt
// and writes y, 101 MB, ~0.030 ms at 3.35 TB/s, and takes 134 M exp, ~0.032
// ms at the SFU's rate: bytes and exps weigh about the same, and a simple
// design is bound by the latency of each step's chain instead. The design
// spreads the N states of a channel over P >= N lanes of a warp (P = 16 on
// the path), so a block of 512 threads holds 512 / P channels and the path
// launches 2 * 8192 * 16 = 262,144 threads (512 blocks for 132 SMs) rather
// than the 16,384 of one thread per channel. Per chunk of steps the block
// stages its channels' u and dt (coalesced along DI) and the chunk's B and
// C rows in shared memory once, runs the steps from there (y_t summed over
// the P lanes by xor shuffles), and writes the chunk's y coalesced from
// shared memory. exp is the accurate expf, not __expf: the fast intrinsic's
// error compounds over hundreds of steps. Later work: a chunked parallel
// scan over S (the state carried between chunks in a second pass), TMA
// loads of the next chunk behind the current one, fewer shuffles per step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int TILE = 1024;  // elements of one staged (steps x channels) tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

struct RowStrides {
  long long b, s;
};

// P lanes per channel (a power of two >= N), CH = THREADS / P channels per
// block, STEPS = TILE / CH steps staged per chunk.
template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
mamba_scan(const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ a, T* __restrict__ y,
           float* __restrict__ h_out, RowStrides sb, RowStrides sc, int S, int DI, int N) {
  constexpr int CH = THREADS / P, STEPS = TILE / CH;
  __shared__ float s_u[STEPS][CH], s_dt[STEPS][CH], s_y[STEPS][CH];
  __shared__ float s_b[STEPS][P], s_c[STEPS][P];

  const int n = threadIdx.x % P, c = threadIdx.x / P;
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + c;
  const bool live = d < DI && n < N;
  // lanes n >= N and channels d >= DI see A = B = u = dt = 0: h stays 0
  const float an = live ? a[(long long)d * N + n] : 0.f;
  const long long row0 = (long long)b * S;  // (b, 0) row of u, dt and y
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += STEPS) {
    const int steps = min(STEPS, S - t0);
    for (int i = threadIdx.x; i < STEPS * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      float uv = 0.f, dv = 0.f;
      if (tt < steps && d0 + cc < DI) {
        const long long off = (row0 + t0 + tt) * DI + d0 + cc;
        uv = to_f(u[off]);
        dv = dt[off];
      }
      s_u[tt][cc] = uv;
      s_dt[tt][cc] = dv;
    }
    for (int i = threadIdx.x; i < STEPS * P; i += THREADS) {
      const int tt = i / P, nn = i % P;
      float bv = 0.f, cv = 0.f;
      if (tt < steps && nn < N) {
        bv = bm[b * sb.b + (long long)(t0 + tt) * sb.s + nn];
        cv = cm[b * sc.b + (long long)(t0 + tt) * sc.s + nn];
      }
      s_b[tt][nn] = bv;
      s_c[tt][nn] = cv;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float dtv = s_dt[tt][c];
      h = expf(dtv * an) * h + (dtv * s_u[tt][c]) * s_b[tt][n];
      float p = h * s_c[tt][n];
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o, P);
      if (n == 0) s_y[tt][c] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      if (d0 + cc < DI) from_f(s_y[tt][cc], y + (row0 + t0 + tt) * DI + d0 + cc);
    }
  }
  if (live) h_out[((long long)b * DI + d) * N + n] = h;
}

template <typename T, int P>
int launch(const void* u, const void* dt, const void* bm, const void* cm, const void* a, void* y,
           void* h, const long long* st, int B, int S, int DI, int N, cudaStream_t stream) {
  constexpr int CH = THREADS / P;
  const RowStrides sb{st[0], st[1]}, sc{st[2], st[3]};
  const dim3 grid((DI + CH - 1) / CH, B);
  mamba_scan<T, P><<<grid, THREADS, 0, stream>>>((const T*)u, (const float*)dt, (const float*)bm,
                                                 (const float*)cm, (const float*)a, (T*)y,
                                                 (float*)h, sb, sc, S, DI, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* u, const void* dt, const void* bm, const void* cm, const void* a,
             void* y, void* h, const long long* st, int B, int S, int DI, int N,
             cudaStream_t s) {
  if (N <= 4) return launch<T, 4>(u, dt, bm, cm, a, y, h, st, B, S, DI, N, s);
  if (N <= 8) return launch<T, 8>(u, dt, bm, cm, a, y, h, st, B, S, DI, N, s);
  if (N <= 16) return launch<T, 16>(u, dt, bm, cm, a, y, h, st, B, S, DI, N, s);
  return launch<T, 32>(u, dt, bm, cm, a, y, h, st, B, S, DI, N, s);
}

}  // namespace

// dtype (of u and y): 0 = float32, 1 = bfloat16; dt, Bm, Cm, A and h are
// float32. strides: (b, s) element strides of Bm, then of Cm. y is a
// contiguous (B, S, DI) buffer, h a contiguous (B, DI, N) one. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int mamba_scan_fwd(const void* u, const void* dt, const void* bm, const void* cm,
                              const void* a, void* y, void* h, const long long* strides, int B,
                              int S, int DI, int N, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DI <= 0 || N <= 0 || N > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_n<float>(u, dt, bm, cm, a, y, h, strides, B, S, DI, N, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(u, dt, bm, cm, a, y, h, strides, B, S, DI, N, s);
  return (int)cudaErrorInvalidValue;
}
