// Mamba-1 selective scan: h <- exp(dt * A) * h + (dt * u) (x) B, y_t = h . C_t.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::mamba_scan
// (_mamba_kernel). u and dt are (B, S, DI), Bm and Cm (B, S, N), A (DI, N).
// The state h (DI, N) per batch row starts at zero and stays in f32; y has
// u's type (f32 or bf16) and h_final is the state after the last step. No
// D-skip: the caller adds u * D. u, dt and A are contiguous; Bm and Cm are
// given by their (b, s) strides with n contiguous, so the slices of the
// model's x_proj output (B, S, r + 2N) are read in place. Any S >= 1, any
// DI and N <= 32: the kernel masks the ragged chunk and channel tile itself,
// where the TPU kernel asserts S % bc == 0 and DI % bd == 0.
//
// What bounds it on the H100: the scan is sequential in S, parallel in
// (b, d, n). On the main path (B=2, S=512, DI=8192, N=16) it reads u and dt
// and writes y, 101 MB, ~0.030 ms at 3.35 TB/s, and takes 134 M exps, ~0.032
// ms at the SFU's 16 a clock an SM. With 262,144 independent (b, d, n)
// chains it is not short of parallelism: what bounds a simple design is
// the instructions issued per state element. So the design spends as few
// as it can on each:
// - four states a thread (float4 of B_t and C_t), P = ceil(N / 4) lanes a
//   channel (a power of two, 4 on the path): dt, u and dt * u are read and
//   formed once a thread-step for four states;
// - the sum of y_t over a channel's lanes deferred: each lane leaves its
//   partial in shared memory (eight lanes first meet in pairs by one
//   shuffle), and the chunk's write-out adds a channel's partials with one
//   16-byte load, so no step waits on a shuffle chain;
// - exp(dt * A) as ex2.approx of dt * (A log2 e), A log2 e formed once a
//   (d, n) when the block starts: one multiply and one MUFU an element.
//   The recurrence contracts on the path (|dt A| <= 1.6, exp < 1), so the
//   approximation's error (~2 ulp) does not grow with S; chip_smoke.py
//   holds it to 1e-4 against the plain version and decode against forward
//   through 64 layers to 1e-3;
// - a compile-time chunk of 32 steps (16 at N > 16), unrolled when full in
//   groups of four steps whose exps, recurrences and y partials are issued
//   side by side, the ragged last chunk looped step by step;
// - the next chunk's u, dt, B and C go by cp.async into a second buffer
//   while the current chunk runs, so neither __syncthreads of a chunk
//   waits on device memory; y leaves coalesced.
// A block holds 32 channels (P * 32 threads: 128 on the path, 512 blocks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int CH = 32;     // channels a block
constexpr float LOG2E = 1.4426950408889634f;

struct RowStrides {
  long long b, s;
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// P lanes a channel, four states a lane. VEC: every staged row is whole
// 16-byte pieces at 16-byte aligned addresses, so it goes by cp.async;
// otherwise by plain loads.
// (16 / P blocks an SM: 512 threads, at most 128 registers each, so the
// path's 512 blocks run in one wave on 132 SMs)
template <typename T, int P, bool VEC>
__global__ void __launch_bounds__(P * CH, 16 / P)
mamba_scan(const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ a, T* __restrict__ y,
           float* __restrict__ h_out, RowStrides sb, RowStrides sc, int S, int DI, int N) {
  constexpr int STEPS = P == 8 ? 16 : 32;  // steps a chunk (fewer at N > 16: 48 KB)
  constexpr int THREADS = P * CH, NP = 4 * P;
  constexpr int PP = P < 4 ? P : 4;              // partial sums of y_t a channel
  constexpr int UPR = CH * (int)sizeof(T) / 16;  // 16-byte pieces a row of u
  __shared__ __align__(16) T s_u[2][STEPS][CH];
  __shared__ __align__(16) float s_dt[2][STEPS][CH];
  __shared__ __align__(16) float s_b[2][STEPS][NP];
  __shared__ __align__(16) float s_c[2][STEPS][NP];
  __shared__ __align__(16) float s_p[STEPS][CH][PP];

  const int tid = threadIdx.x;
  const int q = tid % P, c = tid / P;
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + c;
  const long long row0 = (long long)b * S;  // (b, 0) row of u, dt and y
  // states n >= N and channels d >= DI see A = B = 0: h stays 0
  float a2[4], h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = 4 * q + i;
    a2[i] = (d < DI && n < N) ? a[(long long)d * N + n] * LOG2E : 0.f;
    h[i] = 0.f;
  }

  // stage chunk `ch` (steps ch * STEPS ..) into buffer ch & 1; rows past S,
  // channels past DI and states past N are zero
  auto stage = [&](int ch) {
    const int buf = ch & 1, t0 = ch * STEPS;
    if constexpr (VEC) {
      for (int i = tid; i < STEPS * UPR; i += THREADS) {
        const int tt = i / UPR, e = (i % UPR) * (16 / (int)sizeof(T));
        const bool ok = t0 + tt < S && d0 + e < DI;
        const long long off = (row0 + t0 + tt) * DI + d0 + e;
        repro::cp_async16(&s_u[buf][tt][e], ok ? u + off : u, ok ? 16 : 0);
      }
      for (int i = tid; i < STEPS * (CH / 4); i += THREADS) {
        const int tt = i / (CH / 4), e = (i % (CH / 4)) * 4;
        const bool ok = t0 + tt < S && d0 + e < DI;
        const long long off = (row0 + t0 + tt) * DI + d0 + e;
        repro::cp_async16(&s_dt[buf][tt][e], ok ? dt + off : dt, ok ? 16 : 0);
      }
      for (int i = tid; i < 2 * STEPS * P; i += THREADS) {
        const bool is_c = i >= STEPS * P;
        const int j = is_c ? i - STEPS * P : i;
        const int tt = j / P, n = (j % P) * 4;
        const bool ok = t0 + tt < S && n < N;
        const float* src = is_c ? cm + b * sc.b + (long long)(t0 + tt) * sc.s + n
                                : bm + b * sb.b + (long long)(t0 + tt) * sb.s + n;
        repro::cp_async16(is_c ? &s_c[buf][tt][n] : &s_b[buf][tt][n], ok ? src : cm, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < STEPS * CH; i += THREADS) {
        const int tt = i / CH, e = i % CH;
        const bool ok = t0 + tt < S && d0 + e < DI;
        const long long off = (row0 + t0 + tt) * DI + d0 + e;
        s_u[buf][tt][e] = ok ? u[off] : T(0.f);
        s_dt[buf][tt][e] = ok ? dt[off] : 0.f;
      }
      for (int i = tid; i < STEPS * NP; i += THREADS) {
        const int tt = i / NP, n = i % NP;
        const bool ok = t0 + tt < S && n < N;
        s_b[buf][tt][n] = ok ? bm[b * sb.b + (long long)(t0 + tt) * sb.s + n] : 0.f;
        s_c[buf][tt][n] = ok ? cm[b * sc.b + (long long)(t0 + tt) * sc.s + n] : 0.f;
      }
    }
  };

  // one step; the lane's partial of y_t goes to shared memory, where the
  // chunk's write-out sums a channel's PP partials (eight lanes first meet
  // in pairs by one shuffle)
  auto step = [&](int buf, int tt) {
    const float dtv = s_dt[buf][tt][c];
    const float dtu = dtv * to_f(s_u[buf][tt][c]);
    const float4 bv = *reinterpret_cast<const float4*>(&s_b[buf][tt][4 * q]);
    const float4 cv = *reinterpret_cast<const float4*>(&s_c[buf][tt][4 * q]);
    h[0] = fmaf(ex2(dtv * a2[0]), h[0], dtu * bv.x);
    h[1] = fmaf(ex2(dtv * a2[1]), h[1], dtu * bv.y);
    h[2] = fmaf(ex2(dtv * a2[2]), h[2], dtu * bv.z);
    h[3] = fmaf(ex2(dtv * a2[3]), h[3], dtu * bv.w);
    float p = fmaf(h[3], cv.w, fmaf(h[2], cv.z, fmaf(h[1], cv.y, h[0] * cv.x)));
#pragma unroll
    for (int o = P / 2; o >= PP; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o, P);
    if (q < PP) s_p[tt][c][q] = p;
  };

  // four steps at once, each phase over the four before the next (the
  // exps, the recurrences, the partial y sums), so their latencies overlap
  // rather than queue behind one another
  auto step4 = [&](int buf, int t4) {
    float dA[4][4], dBu[4][4], p[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float dtv = s_dt[buf][t4 + s][c];
      const float dtu = dtv * to_f(s_u[buf][t4 + s][c]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_b[buf][t4 + s][4 * q]);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dA[s][i] = ex2(dtv * a2[i]);
        dBu[s][i] = dtu * bb[i];
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 cv = *reinterpret_cast<const float4*>(&s_c[buf][t4 + s][4 * q]);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = fmaf(dA[s][i], h[i], dBu[s][i]);
      p[s] = fmaf(h[3], cv.w, fmaf(h[2], cv.z, fmaf(h[1], cv.y, h[0] * cv.x)));
    }
#pragma unroll
    for (int o = P / 2; o >= PP; o >>= 1)
#pragma unroll
      for (int s = 0; s < 4; ++s) p[s] += __shfl_xor_sync(0xffffffffu, p[s], o, P);
    if (q < PP) {
#pragma unroll
      for (int s = 0; s < 4; ++s) s_p[t4 + s][c][q] = p[s];
    }
  };

  auto write_y = [&](int ch) {
    const int t0 = ch * STEPS, steps = min(STEPS, S - t0);
    for (int i = tid; i < steps * CH; i += THREADS) {
      const int tt = i / CH, e = i % CH;
      if (d0 + e >= DI) continue;
      float v;
      if constexpr (PP == 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&s_p[tt][e][0]);
        v = (p4.x + p4.y) + (p4.z + p4.w);
      } else if constexpr (PP == 2) {
        const float2 p2 = *reinterpret_cast<const float2*>(&s_p[tt][e][0]);
        v = p2.x + p2.y;
      } else {
        v = s_p[tt][e][0];
      }
      from_f(v, y + (row0 + t0 + tt) * DI + d0 + e);
    }
  };

  const int nchunks = (S + STEPS - 1) / STEPS;
  stage(0);
  repro::cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    repro::cp_async_wait<0>();
    // chunk ch is in buffer ch & 1 for every thread; chunk ch - 1's
    // buffer and partials are free
    __syncthreads();
    if (ch + 1 < nchunks) stage(ch + 1);
    repro::cp_async_commit();
    const int buf = ch & 1, steps = min(STEPS, S - ch * STEPS);
    if (steps == STEPS) {
#pragma unroll
      for (int t4 = 0; t4 < STEPS; t4 += 4) step4(buf, t4);
    } else {
      for (int tt = 0; tt < steps; ++tt) step(buf, tt);
    }
    __syncthreads();  // the chunk's partials are complete
    write_y(ch);
  }
  if (d < DI) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < N) h_out[((long long)b * DI + d) * N + 4 * q + i] = h[i];
  }
}

template <typename T, int P>
int launch(const void* u, const void* dt, const void* bm, const void* cm, const void* a, void* y,
           void* h, const long long* st, int B, int S, int DI, int N, cudaStream_t stream) {
  const RowStrides sb{st[0], st[1]}, sc{st[2], st[3]};
  const bool vec = DI % (16 / (int)sizeof(T)) == 0 && DI % 4 == 0 && N % 4 == 0 &&
                   (st[0] | st[1] | st[2] | st[3]) % 4 == 0 &&
                   (((uintptr_t)u | (uintptr_t)dt | (uintptr_t)bm | (uintptr_t)cm) % 16) == 0;
  const dim3 grid((DI + CH - 1) / CH, B);
  if (vec)
    mamba_scan<T, P, true><<<grid, P * CH, 0, stream>>>(
        (const T*)u, (const float*)dt, (const float*)bm, (const float*)cm, (const float*)a,
        (T*)y, (float*)h, sb, sc, S, DI, N);
  else
    mamba_scan<T, P, false><<<grid, P * CH, 0, stream>>>(
        (const T*)u, (const float*)dt, (const float*)bm, (const float*)cm, (const float*)a,
        (T*)y, (float*)h, sb, sc, S, DI, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* u, const void* dt, const void* bm, const void* cm, const void* a,
             void* y, void* h, const long long* st, int B, int S, int DI, int N,
             cudaStream_t s) {
  if (N <= 4) return launch<T, 1>(u, dt, bm, cm, a, y, h, st, B, S, DI, N, s);
  if (N <= 8) return launch<T, 2>(u, dt, bm, cm, a, y, h, st, B, S, DI, N, s);
  if (N <= 16) return launch<T, 4>(u, dt, bm, cm, a, y, h, st, B, S, DI, N, s);
  return launch<T, 8>(u, dt, bm, cm, a, y, h, st, B, S, DI, N, s);
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
