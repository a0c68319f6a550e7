// int8 x int8 -> int32 matrix product with an f32 row x column rescale.
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (_qmm_kernel): out[m, n] = float(sum_k x_q[m, k] * w_q[k, n]) * xs[m] * ws[n],
// the sum exact in int32 and rescaled once, when complete, as
// __fmul_rn(__fmul_rn((float)acc, xs[m]), ws[n]): the plain version's order,
// so the result matches it bit for bit. x_q is (M, K) row major; both
// kernels read the weight K-major, as (N, K) row major: the transpose of
// w_q (K, N), the JAX package's layout, which a w8a8 leaf holds in that
// order on the card (models/layers.py::Dense), so no call transposes it.
// One entry point, one launch a call; the wrapper's plan
// (kernels/quant_matmul.py::plan) picks one of two kernels.
//
// Small M over deep K (decode: qwen2-0.5b's w8 step has M = 8): the call
// is a stream of K * N weight bytes, 0.1-4.4 MB at qwen2's shapes, whose
// byte bound is 0.04-1.3 us, so what bounds it is latency: how many SMs the
// stream reaches, how many bytes each keeps in flight, and the round trips
// that follow. qmm_split cuts N into tiles of BN = 32-128 columns and K
// into slices of whole 16-row units (split-K), so that even N = 128, K =
// 896 launches more blocks than the card has SMs. A block of BN threads
// streams its slice through a 4-stage cp.async ring of 64 rows of k (three
// stages, 4 x 16 bytes a thread, in flight) beside the matching 64-column
// slice of x_q. Each column's 64 bytes of a stage are four 16-byte units;
// a thread takes one unit of each of 4 columns and multiplies it with
// __dp4a against the same unit of up to MT = 16 rows of x, one 16-byte
// load each. The four threads of a column group meet by two shuffles. Split
// blocks add their partial into a workspace with atomics, and the last
// block of each tile (found by a counter) rescales the complete sum, writes
// the tile and leaves the workspace and counter at zero. Integer addition
// is associative, so the order of the atomics changes nothing. The merge
// costs three round trips to the L2 (the atomics, the counter, the
// read-back), so at small M over shallow K the plan takes qmm_wgmma, whose
// one launch a tile is then the faster (WG_WALK_MAX in the plan).
//
// Large M (split serving and prefill: M = 1024-4096): the products are
// 14-545 GOP against 1979 TOP/s of int8 tensor cores and the f32 output
// (4 * M * N bytes) is the largest stream against 3.35 TB/s. qmm_wgmma runs
// wgmma.mma_async m64nBNk32 s32.s8.s8, which takes both operands K-major
// from shared memory, as x_q and the weight are. One block an SM walks 128
// x BN output tiles (BN = 128, or 64 where 128 would leave SMs idle), m
// fastest, so the blocks in flight share a few column slices of the weight
// and each weight byte leaves device memory about once. One producer warp
// keeps a ring of 128 (m) x 128 (k) and BN x 128 tiles filled by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the edges of K,
// M and N) with full/empty mbarriers, as deep as shared memory allows (5
// stages at BN = 128); two consumer warpgroups each run 64 rows of the
// tile, one k step of products kept in flight. The f32 tile leaves as
// 128-byte panels staged in shared memory and written by TMA stores, which
// skip rows and columns past the edge, and which run on under the next
// tile's products. The loads ask the L2 to keep the operands (evict_last)
// and the stores to let the output go first (evict_first): at qwen2's gate
// and up the 80 MB output otherwise pushes the operands out of the 50 MB
// L2 (the call takes ~12 % longer). The three TMA maps are encoded on the
// host at every call.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- small M

constexpr int UNIT = 16;   // rows of K: the grain of a split's slice
constexpr int SROWS = 64;  // rows of K a stage
constexpr int STAGES = 4;  // cp.async ring depth: three stages in flight

template <int BN, int MT, bool VEC>
__global__ void __launch_bounds__(BN)
qmm_split(const int8_t* __restrict__ xq, const int8_t* __restrict__ wt,
          const float* __restrict__ xs, const float* __restrict__ ws, float* __restrict__ out,
          int* __restrict__ part, int* __restrict__ count, int M, int N, int K, int per_rows,
          int splits) {
  constexpr int COLS = BN / 4;  // threads along n, 4 columns each, COLS apart; 4 along k
  constexpr int UNITS = SROWS / 16;  // 16-byte units of k a column a stage
  // column n's SROWS bytes of k at n * SROWS: the four threads of a column
  // group read one 64-byte row, so 8 threads read 128 bytes, no conflict
  __shared__ __align__(16) int8_t s_w[STAGES][BN * SROWS];
  __shared__ __align__(16) int8_t s_x[STAGES][MT * SROWS];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * MT;
  const int kb = blockIdx.y * per_rows, ke = min(K, kb + per_rows);
  const int nsteps = (ke - kb + SROWS - 1) / SROWS;

  // stage `step` of the slice into ring slot step % STAGES; rows past the
  // slice, columns past N and rows past M are zero
  auto stage = [&](int step) {
    const int buf = step % STAGES, k = kb + step * SROWS;
#pragma unroll
    for (int l = 0; l < UNITS; ++l) {
      const int chunk = tid + l * BN;
      const int r = chunk / UNITS, c = (chunk % UNITS) * 16;
      const int n = n0 + r, kk = k + c;
      int8_t* dw = s_w[buf] + r * SROWS + c;
      if constexpr (VEC) {
        const bool ok = n < N && kk < ke;
        repro::cp_async16(dw, ok ? wt + (size_t)n * K + kk : wt, ok ? 16 : 0);
      } else {
        for (int j = 0; j < 16; ++j)
          dw[j] = (n < N && kk + j < ke) ? wt[(size_t)n * K + kk + j] : (int8_t)0;
      }
    }
    for (int i = tid; i < MT * (SROWS / 16); i += BN) {
      const int mm = i / (SROWS / 16), c = (i % (SROWS / 16)) * 16;
      const int m = m0 + mm, kk = k + c;
      int8_t* dx = s_x[buf] + mm * SROWS + c;
      if constexpr (VEC) {
        const bool ok = m < M && kk < ke;
        repro::cp_async16(dx, ok ? xq + (size_t)m * K + kk : xq, ok ? 16 : 0);
      } else {
        for (int j = 0; j < 16; ++j)
          dx[j] = (m < M && kk + j < ke) ? xq[(size_t)m * K + kk + j] : (int8_t)0;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) stage(s);
    repro::cp_async_commit();
  }
  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;
  // the thread's 16 rows of each stage, 16 u .. 16 u + 15, and its four
  // columns col + j COLS: each column's 16 bytes of k are one load
  const int u = tid % 4, col = tid / 4;

  for (int step = 0; step < nsteps; ++step) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot refilled now was read in the previous step, by every thread
    // before the barrier above
    if (step + STAGES - 1 < nsteps) stage(step + STAGES - 1);
    repro::cp_async_commit();
    const int8_t* W = s_w[step % STAGES] + col * SROWS + 16 * u;
    int4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const int4*>(W + j * COLS * SROWS);
    const int8_t* X = s_x[step % STAGES] + 16 * u;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int4 x = *reinterpret_cast<const int4*>(X + m * SROWS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[m][j] = __dp4a(x.w, w[j].w, __dp4a(x.z, w[j].z,
                    __dp4a(x.y, w[j].y, __dp4a(x.x, w[j].x, acc[m][j]))));
    }
  }
  repro::cp_async_wait<0>();
  // the four threads of a column group meet by shuffles; thread u keeps
  // column col + u COLS
  int sum[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 1);
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 2);
    }
    sum[m] = u == 0 ? acc[m][0] : u == 1 ? acc[m][1] : u == 2 ? acc[m][2] : acc[m][3];
  }
  const int c = col + u * COLS, n = n0 + c;

  if (splits == 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m0 + m < M && n < N)
        out[(size_t)(m0 + m) * N + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(sum[m]), xs[m0 + m]), ws[n]);
    return;
  }
  // split-K: add the partial into the tile's workspace; the last block of
  // the tile rescales the complete sum and zeroes the workspace and counter
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  int* P = part + (size_t)tile * (MT * BN);
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (m0 + m < M && n < N) atomicAdd(P + m * BN + c, sum[m]);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(count + tile, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < MT * BN; i += BN) {
    const int m = m0 + i / BN, nn = n0 + i % BN;
    if (m < M && nn < N) {
      const int total = __ldcg(P + i);
      P[i] = 0;
      out[(size_t)m * N + nn] = __fmul_rn(__fmul_rn(__int2float_rn(total), xs[m]), ws[nn]);
    }
  }
  if (tid == 0) count[tile] = 0;
}

template <int BN, int MT>
int launch_split(const int8_t* xq, const int8_t* wt, const float* xs, const float* ws,
                 float* out, int* part, int* count, int M, int N, int K, int per_rows,
                 int splits, cudaStream_t stream) {
  const bool vec = K % 16 == 0 && (uintptr_t)xq % 16 == 0 && (uintptr_t)wt % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, splits, (M + MT - 1) / MT);
  if (vec)
    qmm_split<BN, MT, true><<<grid, BN, 0, stream>>>(xq, wt, xs, ws, out, part, count, M, N, K,
                                                      per_rows, splits);
  else
    qmm_split<BN, MT, false><<<grid, BN, 0, stream>>>(xq, wt, xs, ws, out, part, count, M, N, K,
                                                       per_rows, splits);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_split_mt(int mt, const int8_t* xq, const int8_t* wt, const float* xs,
                    const float* ws, float* out, int* part, int* count, int M, int N, int K,
                    int per_rows, int splits, cudaStream_t s) {
  if (mt == 4) return launch_split<BN, 4>(xq, wt, xs, ws, out, part, count, M, N, K, per_rows, splits, s);
  if (mt == 8) return launch_split<BN, 8>(xq, wt, xs, ws, out, part, count, M, N, K, per_rows, splits, s);
  if (mt == 16) return launch_split<BN, 16>(xq, wt, xs, ws, out, part, count, M, N, K, per_rows, splits, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- large M

constexpr int WG_BM = 128, WG_BK = 128;
constexpr int WG_THREADS = 288;  // two consumer warpgroups, then one producer warp

// One block an SM, persistent: a ring of tiles and, apart from it, the
// staging of the f32 rows, so the producer fills the ring for the next tile
// while the consumers stage this one, and its TMA stores run on under the
// next tile's products. The ring takes what shared memory the staging
// leaves: the more stages, the longer a refill may take before the tensor
// cores wait on it.
template <int BN>
struct Wg {
  static constexpr int A_BYTES = WG_BM * WG_BK, B_BYTES = BN * WG_BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int PANELS = BN / 32;      // 32-column (128-byte) panels a row
  static constexpr int PANEL = 64 * 128;      // one panel of a warpgroup's 64 rows
  static constexpr int STAGING = WG_BM * BN * 4;
  static constexpr int STAGES = (227 * 1024 - 1024 - STAGING - 128) / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + STAGING + 2 * STAGES * 8;
  static_assert(STAGES >= 3 && SMEM <= 227 * 1024, "a ring of at least three stages");
};

using repro::desc_k;
using repro::fence_async_shared;
using repro::smem_u32;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_wait;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed. A
// phase that never completes (a copy that never lands) traps after ~2^26
// polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// L2 policies: the operands, read again by other tiles, are kept before
// the f32 output, which streams through the L2 once
__device__ __forceinline__ uint64_t l2_policy_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_policy_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// TMA: the (c0 = k, c1 = row) box of `map` into shared memory, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}
// TMA: shared memory to the (c0 = column, c1 = row) box of `map`; rows and
// columns past the tensor's edge are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%1, %2}], "
      "[%3], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x N int32, the m64nNk32 fragment) += A (64 x 32) * B (32 x N), both
// K-major in shared memory
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n64(d, da, db);
}

// Tile t of the (m_tiles x n_tiles) grid, m fastest: the blocks in flight
// share a few column slices of the weight, so each weight byte leaves
// device memory about once and x stays in the L2.
template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
          const __grid_constant__ CUtensorMap to, const float* __restrict__ xs,
          const float* __restrict__ ws, int M, int N, int K) {
  using C = Wg<BN>;
  extern __shared__ uint8_t dyn[];
  // the 128-byte swizzle wants 1024-byte aligned tiles
  uint8_t* ring = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
  uint8_t* staging = ring + C::STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + C::STAGING);
  uint64_t* empty = full + C::STAGES;
  const int warp = threadIdx.x / 32;
  const int m_tiles = (M + WG_BM - 1) / WG_BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int nk = (K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: one thread walks every k step of every tile
    if (threadIdx.x == 256) {
      const uint64_t keep = l2_policy_last();
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * WG_BM, n0 = (t / m_tiles) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % C::STAGES;
          if (it >= C::STAGES) mbar_wait(empty + s, ((it / C::STAGES) - 1) & 1);
          uint8_t* a = ring + s * C::STAGE;
          mbar_expect_tx(full + s, C::STAGE);
          tma_load(a, &tx, kt * WG_BK, m0, full + s, keep);
          tma_load(a + C::A_BYTES, &tw, kt * WG_BK, n0, full + s, keep);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;  // consumer warpgroup: rows 64 wg .. 64 wg + 63 of a tile
  const int t128 = threadIdx.x % 128, lane = t128 % 32;
  const int rl = 16 * (t128 / 32) + lane / 4;  // the thread's first row of the 64
  uint8_t* stage_c = staging + wg * C::PANELS * C::PANEL;
  const uint64_t stream_out = l2_policy_first();
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * WG_BM, n0 = (t / m_tiles) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(full + s, (it / C::STAGES) & 1);
      const uint8_t* a = ring + s * C::STAGE;
      const uint64_t da = desc_k<1>(a + wg * 64 * WG_BK), db = desc_k<1>(a + C::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 32; ++kk)  // 32 bytes of k = 2 units of 16 bytes
        wgmma<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      // keep this step's products in flight; the previous step's are done,
      // so its slot goes back to the producer
      wgmma_wait<1>();
      if (kt > 0 && t128 == 0) mbar_arrive(empty + (it - 1) % C::STAGES);
    }
    wgmma_wait<0>();
    if (t128 == 0) mbar_arrive(empty + (it - 1) % C::STAGES);

    // stage the rescaled rows as 128-byte panels in the TMA's 128-byte
    // swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), once this
    // warpgroup's previous store has read them, then store them by TMA
    if (t128 == 0) bulk_wait_read();
    bar_sync(2 + wg, 128);
    const int m = m0 + wg * 64 + rl;
    const float x0 = m < M ? xs[m] : 0.f, x1 = m + 8 < M ? xs[m + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      const float w0 = col < N ? ws[col] : 0.f, w1 = col + 1 < N ? ws[col + 1] : 0.f;
      uint8_t* panel = stage_c + (j / 4) * C::PANEL;
      const int chunk = 2 * (j % 4) + (lane % 4) / 2, off = 8 * (lane % 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rl + 8 * half;
        const float xr = half ? x1 : x0;
        const float2 v = make_float2(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half]), xr), w0),
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), xr), w1));
        *reinterpret_cast<float2*>(panel + r * 128 + ((chunk ^ (r & 7)) * 16) + off) = v;
      }
    }
    fence_async_shared();
    bar_sync(2 + wg, 128);
    if (t128 == 0) {
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p)
        tma_store(&to, stage_c + p * C::PANEL, n0 + 32 * p, m0 + wg * 64, stream_out);
      bulk_commit();
    }
  }
  if (t128 == 0) bulk_wait();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once in the loaded libcuda (so the
// library links against nothing beyond the CUDA runtime).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) matrix of `elem`-byte values as boxes of
// box_rows x box_cols values (box_cols * elem = 128 bytes) in the 128-byte
// swizzle; loads fill past its edges with zeros, stores skip them.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int elem,
                int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return enc(map, elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t smem_allowed[2][repro::MAX_DEVICES];  // by BN / 128

template <int BN>
int launch_wgmma(const int8_t* xq, const int8_t* wt, const float* xs, const float* ws,
                 float* out, int M, int N, int K, cudaStream_t stream) {
  using C = Wg<BN>;
  if (K % 16 != 0 || N % 4 != 0 || ((uintptr_t)xq | (uintptr_t)wt | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, to;
  if (!tensor_map(&tx, xq, M, K, 1, WG_BM) || !tensor_map(&tw, wt, N, K, 1, BN) ||
      !tensor_map(&to, out, M, N, 4, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = repro::allow_smem((const void*)qmm_wgmma<BN>, C::SMEM,
                                      smem_allowed[BN / 128]);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  static int sms_of[repro::MAX_DEVICES];  // 0 until read
  int sms = dev < repro::MAX_DEVICES ? sms_of[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < repro::MAX_DEVICES) sms_of[dev] = sms;
  }
  const long long tiles = (long long)((M + WG_BM - 1) / WG_BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  qmm_wgmma<BN><<<grid, WG_THREADS, C::SMEM, stream>>>(tx, tw, to, xs, ws, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// plan: {M, N, K, regime, bn, mt, per_rows, splits}, the wrapper's plan;
// w is the weight K-major, (N, K) row major, in both regimes. regime 0
// (split): tiles of mt (4, 8, 16) rows x bn (32, 64, 128) columns; part and
// count are the workspace of int32 partials and tile counters (zero between
// calls), used when splits > 1. regime 1 (wgmma): tiles of mt x bn = 128 x
// 64 or 128 x 128; K % 16 == 0, N % 4 == 0 and x_q, w and out 16-byte
// aligned (TMA). Returns the CUDA error code of the launch (0 = launched).
extern "C" int quant_matmul_s8(const void* xq, const void* w, const void* xs, const void* ws,
                               void* out, const long long* plan, void* part, void* count,
                               void* stream) {
  const int M = (int)plan[0], N = (int)plan[1], K = (int)plan[2];
  const int regime = (int)plan[3], bn = (int)plan[4], mt = (int)plan[5];
  const int per_rows = (int)plan[6], splits = (int)plan[7];
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* x = (const int8_t*)xq;
  const int8_t* wb = (const int8_t*)w;
  const float *sx = (const float*)xs, *sw = (const float*)ws;
  float* o = (float*)out;
  if (regime == 1) {
    if (mt != WG_BM) return (int)cudaErrorInvalidValue;
    if (bn == 128) return launch_wgmma<128>(x, wb, sx, sw, o, M, N, K, s);
    if (bn == 64) return launch_wgmma<64>(x, wb, sx, sw, o, M, N, K, s);
    return (int)cudaErrorInvalidValue;
  }
  if (regime != 0 || per_rows <= 0 || per_rows % UNIT != 0 || splits <= 0 ||
      (long long)per_rows * (splits - 1) >= K || (splits > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  int *p = (int*)part, *c = (int*)count;
  if (bn == 128) return launch_split_mt<128>(mt, x, wb, sx, sw, o, p, c, M, N, K, per_rows, splits, s);
  if (bn == 64) return launch_split_mt<64>(mt, x, wb, sx, sw, o, p, c, M, N, K, per_rows, splits, s);
  if (bn == 32) return launch_split_mt<32>(mt, x, wb, sx, sw, o, p, c, M, N, K, per_rows, splits, s);
  return (int)cudaErrorInvalidValue;
}
