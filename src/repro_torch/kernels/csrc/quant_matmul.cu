// int8 x int8 -> int32 matrix product with an f32 row x column rescale.
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (_qmm_kernel): out[m, n] = float(sum_k x_q[m, k] * w_q[k, n]) * xs[m] * ws[n],
// the sum exact in int32. x_q is (M, K) and w_q is (K, N), both row major,
// as the JAX package lays them out.
//
// What bounds it on the H100: at the main path's shapes (M = B*S = 4096,
// K in {896, 4864}) the products are 14-122 GOP against 1979 TOP/s of int8
// tensor cores, and the f32 output (M*N*4 bytes) is the largest stream
// against 3.35 TB/s; the two bounds are of the same order. The design uses
// the int8 tensor cores through mma.sync m16n8k32 (s8.s8.s32), with one
// 128x128 output tile per block of 8 warps, each warp 32x64. K advances in
// steps of 32 through two shared-memory buffers: the next step's tiles are
// read from device memory into registers while the tensor cores work on the
// current one. mma.sync wants B with k contiguous, and w_q has n
// contiguous, so each thread reads a 4(k) x 4(n) byte block and transposes
// it with byte permutes before it stores it. Ragged M, N and K edges are
// masked inside the kernel (zero codes add nothing), so nothing is padded.
// The epilogue multiplies (float)acc * xs[m] * ws[n] in that order, as the
// plain version does, so the result matches it bit for bit.
// Later work: wgmma with TMA-fed shared-memory rings, a persistent grid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int LDA = BK + 16;  // bytes per A row in shared memory (16B aligned, no bank conflicts on fragment loads)
constexpr int LDB = BK + 8;   // bytes per B column: conflict-free transposed stores

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A: thread t holds 16 bytes of row t/2, k offset (t%2)*16.
__device__ __forceinline__ uint4 load_a(const int8_t* __restrict__ x, int M,
                                        int K, int m0, int k0, bool vec) {
  const int row = m0 + (threadIdx.x >> 1);
  const int kk = k0 + (threadIdx.x & 1) * 16;
  if (vec && row < M && kk + 16 <= K)
    return *reinterpret_cast<const uint4*>(x + (size_t)row * K + kk);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row < M) {
    for (int i = 0; i < 16; ++i) {
      if (kk + i < K)
        w[i >> 2] |= (uint32_t)(uint8_t)x[(size_t)row * K + kk + i] << (8 * (i & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// B: thread t holds the 4x4 block k = 4*(t%8) .. +3, n = 4*(t/8) .. +3;
// r[i] packs row k+i's four n values.
__device__ __forceinline__ void load_b(const int8_t* __restrict__ w, int N,
                                       int K, int n0, int k0, bool vec,
                                       uint32_t (&r)[4]) {
  const int n = n0 + 4 * (threadIdx.x >> 3);
  const int kb = k0 + 4 * (threadIdx.x & 7);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = kb + i;
    if (vec && kr < K && n + 4 <= N) {
      r[i] = *reinterpret_cast<const uint32_t*>(w + (size_t)kr * N + n);
    } else {
      uint32_t v = 0u;
      if (kr < K) {
        for (int j = 0; j < 4; ++j)
          if (n + j < N) v |= (uint32_t)(uint8_t)w[(size_t)kr * N + n + j] << (8 * j);
      }
      r[i] = v;
    }
  }
}

__device__ __forceinline__ void store_a(int8_t* As, const uint4& r) {
  *reinterpret_cast<uint4*>(As + (threadIdx.x >> 1) * LDA + (threadIdx.x & 1) * 16) = r;
}

// Transpose the 4x4 byte block so that word j holds column n+j's four k values.
__device__ __forceinline__ void store_b(int8_t* Bs, const uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  const uint32_t c[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                         __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
  const int n = 4 * (threadIdx.x >> 3);
  const int k = 4 * (threadIdx.x & 7);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint32_t*>(Bs + (n + j) * LDB + k) = c[j];
}

__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
           const float* __restrict__ xs, const float* __restrict__ ws,
           float* __restrict__ out, int M, int N, int K, bool vec_a, bool vec_b) {
  __shared__ __align__(16) int8_t As[2][BM * LDA];
  __shared__ __align__(16) int8_t Bs[2][BN * LDB];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int g = lane >> 2, t = lane & 3;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + BK - 1) / BK;
  uint4 ra = load_a(xq, M, K, m0, 0, vec_a);
  uint32_t rb[4];
  load_b(wq, N, K, n0, 0, vec_b, rb);
  store_a(As[0], ra);
  store_b(Bs[0], rb);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      ra = load_a(xq, M, K, m0, (kt + 1) * BK, vec_a);
      load_b(wq, N, K, n0, (kt + 1) * BK, vec_b, rb);
    }
    const int8_t* A = As[cur];
    const int8_t* B = Bs[cur];
    uint32_t af[2][4], bf[8][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(A + r * LDA + 4 * t);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(A + (r + 8) * LDA + 4 * t);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(A + r * LDA + 16 + 4 * t);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(A + (r + 8) * LDA + 16 + 4 * t);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int c = wn + ni * 8 + g;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(B + c * LDB + 4 * t);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(B + c * LDB + 16 + 4 * t);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    if (kt + 1 < nk) {
      store_a(As[cur ^ 1], ra);
      store_b(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float sx = xs[row];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + 2 * t + e;
          if (col < N)
            out[(size_t)row * N + col] =
                __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]), sx), ws[col]);
        }
      }
    }
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 = launched).
extern "C" int quant_matmul_s8(const void* xq, const void* wq, const void* xs,
                               const void* ws, void* out, int M, int N, int K,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const bool vec_a = (K % 16 == 0) && ((uintptr_t)xq % 16 == 0);
  const bool vec_b = (N % 4 == 0) && ((uintptr_t)wq % 4 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const int8_t*)wq, (const float*)xs, (const float*)ws,
      (float*)out, M, N, K, vec_a, vec_b);
  return (int)cudaGetLastError();
}
