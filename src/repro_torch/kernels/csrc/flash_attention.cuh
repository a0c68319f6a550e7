// Warp-level pieces shared by the flash attention kernels, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): padded shared
// memory rows filled by cp.async, the score product Q . K^T of 16 rows
// against groups of 8 keys on the tensor cores (3xTF32 for f32, bf16 with f32
// accumulators), and the product P . V with P taken from the score
// registers (or a shared tile) in the permuted k order that the C fragment
// of m16n8k8 gives. Each product reads row-major tiles whose reduced
// dimension is contiguous, so the backward runs its five products through
// the same two functions with the operands' roles exchanged.
#pragma once
#include "common.cuh"

namespace repro {
namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;
};

// A row of W elements in shared memory, padded by 16 bytes.
template <typename T, int W>
struct Row {
  static constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte copy
  static constexpr int LD = W + VEC;               // padded row, in elements
  static constexpr int CPR = W / VEC;              // 16-byte pieces per row
};

// ROWS rows starting at row0 of a (rows, W) matrix with row stride `stride`
// into shared memory (padded rows); rows at or past `limit` are zero-filled,
// not read.
template <typename T, int W, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride, int row0,
                                          int limit) {
  using R = Row<T, W>;
  for (int i = threadIdx.x; i < ROWS * R::CPR; i += THREADS) {
    const int r = i / R::CPR, c = i % R::CPR;
    const bool ok = row0 + r < limit;
    const T* g = src + (ok ? (long long)(row0 + r) * stride : 0) + c * R::VEC;
    cp_async16(dst + r * R::LD + c * R::VEC, g, ok ? 16 : 0);
  }
}

// s[n] += Q (this warp's 16 rows) . K^T for NT groups of 8 keys, over D
// columns of rows LD elements apart (by default a tile of D columns).
template <int D, int NT, int LD = Row<float, D>::LD>
__device__ __forceinline__ void qk(float (*s)[4], const float* Qw, const float* Ks, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ab[4], as[4];
    const float* qa = Qw + g * LD + kk * 8 + t;
    split_tf32(qa[0], ab[0], as[0]);
    split_tf32(qa[8 * LD], ab[1], as[1]);
    split_tf32(qa[4], ab[2], as[2]);
    split_tf32(qa[8 * LD + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];
      const float* kb = Ks + (n * 8 + g) * LD + kk * 8 + t;
      split_tf32(kb[0], bb[0], bs[0]);
      split_tf32(kb[4], bb[1], bs[1]);
      mma_3xtf32(s[n], ab, as, bb, bs);
    }
  }
}

template <int D, int NT>
__device__ __forceinline__ void qk(float (*s)[4], const __nv_bfloat16* Qw,
                                   const __nv_bfloat16* Ks, int g, int t) {
  constexpr int LD = Row<__nv_bfloat16, D>::LD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    const __nv_bfloat16* qa = Qw + g * LD + kk * 16 + 2 * t;
    a[0] = *reinterpret_cast<const uint32_t*>(qa);
    a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
    a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b[2];
      const __nv_bfloat16* kb = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
      b[0] = *reinterpret_cast<const uint32_t*>(kb);
      b[1] = *reinterpret_cast<const uint32_t*>(kb + 8);
      mma_bf16(s[n], a, b);
    }
  }
}

// The P fragment of one k step, f32: k slot t <-> key 2t, slot t + 4 <->
// key 2t + 1, in P and in V alike (the C fragment holds columns 2t, 2t + 1).
// From registers (p: the score fragment of these 8 keys) or from the shared
// P tile (row stride LDP).
__device__ __forceinline__ void p_frag(const float* p, uint32_t* ab, uint32_t* as) {
  split_tf32(p[0], ab[0], as[0]);
  split_tf32(p[2], ab[1], as[1]);
  split_tf32(p[1], ab[2], as[2]);
  split_tf32(p[3], ab[3], as[3]);
}
template <int LDP>
__device__ __forceinline__ void p_frag(const float* Pw, int kk, int g, int t, uint32_t* ab,
                                       uint32_t* as) {
  const float2 r0 = *reinterpret_cast<const float2*>(Pw + g * LDP + kk * 8 + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(Pw + (g + 8) * LDP + kk * 8 + 2 * t);
  const float p[4] = {r0.x, r0.y, r1.x, r1.y};
  p_frag(p, ab, as);
}

// o[n] += P (8 keys) . V for the NO 8-column groups of V at Vs (rows of DV,
// or LD elements apart).
template <int DV, int NO, int LD = Row<float, DV>::LD>
__device__ __forceinline__ void pv_step(float (*o)[4], const uint32_t* ab, const uint32_t* as,
                                        const float* Vs, int kk, int g, int t) {
  const float* vr = Vs + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    uint32_t bb[2], bs[2];
    split_tf32(vr[n * 8], bb[0], bs[0]);
    split_tf32(vr[LD + n * 8], bb[1], bs[1]);
    mma_3xtf32(o[n], ab, as, bb, bs);
  }
}

// bf16: P (16 keys) as the A fragment, from four score values per 8 keys
__device__ __forceinline__ void p_frag16(const float* lo, const float* hi, uint32_t* a) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}
template <int LDP>
__device__ __forceinline__ void p_frag16(const float* Pw, int kk, int g, int t, uint32_t* a) {
  const float* r = Pw + g * LDP + kk * 16 + 2 * t;
  const float lo[4] = {r[0], r[1], r[8 * LDP], r[8 * LDP + 1]};
  const float hi[4] = {r[8], r[9], r[8 * LDP + 8], r[8 * LDP + 9]};
  p_frag16(lo, hi, a);
}

template <int DV, int NO>
__device__ __forceinline__ void pv_step16(float (*o)[4], const uint32_t* a,
                                          const __nv_bfloat16* Vs, int kk, int g, int t) {
  constexpr int LD = Row<__nv_bfloat16, DV>::LD;
  const unsigned short* vr = reinterpret_cast<const unsigned short*>(Vs) + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    uint32_t b[2];
    b[0] = (uint32_t)vr[n * 8] | ((uint32_t)vr[LD + n * 8] << 16);
    b[1] = (uint32_t)vr[8 * LD + n * 8] | ((uint32_t)vr[9 * LD + n * 8] << 16);
    mma_bf16(o[n], a, b);
  }
}

// o += P . V over the tile's BKV keys (V rows of DV, or LD elements
// apart): P from the score registers s (the warp scored every key, WN = 1)
// or, SHARED, from the shared tile Pw.
template <int DV, int BKV, int NO, bool SHARED, int LD = Row<float, DV>::LD>
__device__ __forceinline__ void pv(float (*o)[4], float (*s)[4], const float* Pw, const float* Vs,
                                   int g, int t) {
  constexpr int LDP = BKV + 4;
#pragma unroll
  for (int kk = 0; kk < BKV / 8; ++kk) {
    uint32_t ab[4], as[4];
    if constexpr (SHARED) p_frag<LDP>(Pw, kk, g, t, ab, as);
    else p_frag(s[kk], ab, as);
    pv_step<DV, NO, LD>(o, ab, as, Vs, kk, g, t);
  }
}

template <int DV, int BKV, int NO, bool SHARED>
__device__ __forceinline__ void pv(float (*o)[4], float (*s)[4], const float* Pw,
                                   const __nv_bfloat16* Vs, int g, int t) {
  constexpr int LDP = BKV + 4;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    uint32_t a[4];
    if constexpr (SHARED) p_frag16<LDP>(Pw, kk, g, t, a);
    else p_frag16(s[2 * kk], s[2 * kk + 1], a);
    pv_step16<DV, NO>(o, a, Vs, kk, g, t);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace flash
}  // namespace repro
