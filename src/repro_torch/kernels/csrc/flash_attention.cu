// Forward flash attention with GQA, causal and sliding-window masks, on the
// tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel). q is (B, H, Sq, D), k (B, HK, Skv, D) and v (B, HK, Skv,
// Dv), each given by its b, h and s strides with d contiguous, so the model's
// (B, S, H, D) projections are read and written in place; the output is
// (B, H, Sq, Dv), as the TPU kernel reads Dv from v's shape. Query head h
// reads kv head h % HK, as the TPU kernel's index map does. Query row i sits
// at position i and key j at position j; a key is visible when j < Skv,
// j <= i (causal) and i - j < window. Masked scores are the finite -1e30 of
// the TPU kernel, and the denominator is clamped at 1e-30. m, l and the
// output accumulator stay in f32 registers; the output has q's type.
//
// What bounds it on the H100: QK^T and PV over the visible pairs. On the
// main path (f32, B=8, H=14, HK=2, S=512, D=64, causal) that is 3.77 GFLOP;
// q, k, v and o are 33.5 MB, 10 us at 3.35 TB/s. On f32 CUDA cores (67
// TFLOP/s) the operations take 56 us; on the tensor cores in 3xTF32 (three
// TF32 products per f32 product, 495 / 3 = 165 TFLOP/s of f32 work) 23 us.
// At head_dim 256 (recurrentgemma-2b's split path: B=4, H=10, HK=1, S=512)
// 5.38 GFLOP: 80 us on CUDA cores, 33 us in 3xTF32; its prefill (B=2,
// S=2304 under the 2048 window) 53.7 GFLOP: 0.80 ms and 0.33 ms. With
// D != Dv the products are 2 (D + Dv) FLOP a visible pair: at
// deepseek-v2-lite-16b's MLA split path (B=4, H=HK=16, S=512, D=192 of q/k,
// Dv=128 of v, causal) 5.38 GFLOP, 33 us in 3xTF32 and 80 us on CUDA cores;
// q, k, v and o are 21 MB, 6.3 us. The kernel is bound by operations.
//
// The design (FlashAttention-2's split of work): one block per (64-query
// tile, head, batch row); each 16 query rows belong to one warp (two at
// D = 256), and their scores and output accumulator stay in mma.sync
// fragments in registers.
//  - f32 inputs run mma.sync m16n8k8 in TF32 with the 3xTF32 split: each
//    operand x = big + small, both TF32, and a*b ~ a_small*b_big +
//    a_big*b_small + a_big*b_big in f32 accumulators. A single TF32 product
//    keeps ~3 digits and would miss the 2e-5 agreement with the plain
//    version; the split keeps f32 accuracy at three times the tensor-core
//    work. bf16 inputs run mma.sync m16n8k16 bf16 with f32 accumulators,
//    P rounded to bf16 for the PV product.
//  - P feeds the PV product from registers. The C fragment of m16n8k8 (a
//    thread holds columns 2t, 2t+1) is not its A fragment (columns t, t+4),
//    so the k index of each 8-key step is permuted alike in P and V: k slot
//    t is key 2t, slot t + 4 key 2t + 1, and V's B fragment loads rows 2t
//    and 2t + 1.
//  - D = 256: a 16 x 256 output accumulator is 128 registers a thread, and
//    one warp per SM sub-partition cannot hide the mma latency. So two warps
//    share 16 rows: each scores half of the tile's keys, they exchange the
//    row max and P through shared memory (a named barrier per pair), and
//    each multiplies all keys into its half of the 256 output columns.
//    8 warps a block, no spill.
//  - K and V tiles (64 keys at D = 64, 32 at D = 128 and 256) come by
//    16-byte cp.async into a ring of two stages, so the next tile lands
//    while the current one is multiplied; rows are padded by 16 bytes so
//    every fragment read from shared memory is free of bank conflicts. Q
//    stays in shared memory and is split per fragment.
//  - Causal q-tiles are launched heaviest first (the last tile of a
//    sequence sees the most keys). Key tiles wholly above the diagonal or
//    outside the window are skipped per block and per warp; skipping is
//    exact, since every query row sees its own key, so a row's first
//    visible tile flushes what masked tiles added. The mask is applied only
//    on tiles that cross a boundary; padded rows of a ragged tile are zero.
//  - Q and K rows are D wide, V rows and the output accumulator Dv wide:
//    the QK^T k-steps and the Q and K tiles follow D, the PV product's
//    output column groups, the V tiles and the store follow Dv.
//  - Shared memory, f32: 64 x (D + 4) x 4 for Q plus two stages of BKV x
//    (D + 4) (K) and BKV x (Dv + 4) (V) = 87,040 bytes at (D, Dv) = (64, 64)
//    (two blocks an SM), 101,376 at (128, 128) (two), 199,680 plus 9,728 of
//    P exchange at (256, 256) (one block of 8 warps an SM), 134,144 at
//    (192, 128) (BKV 32, one warp a 16 rows; one block of 4 warps an SM) and
//    58,368 at (48, 32) (BKV 64). Above 48 KB it needs the opt-in limit
//    (227 KB on the H100), which the launch sets and checks.
// Instances (D, Dv), each in f32 and bf16: (64, 64), (128, 128), (256, 256),
// and deepseek-v2-lite-16b's MLA widths (192, 128) and, reduced, (48, 32).
#include "flash_attention.cuh"

namespace {

using namespace repro;
using namespace repro::flash;

constexpr int BQ = 64, ROW_GROUPS = BQ / 16;

// D: the head dim of q and k; DV: that of v and o.
template <typename T, int D, int DV>
struct Tile {
  static constexpr int BKV = D >= 128 ? 32 : 64;   // keys per tile
  static constexpr int WN = DV >= 256 ? 2 : 1;     // warps that share 16 query rows
  static constexpr int THREADS = 32 * ROW_GROUPS * WN;
  static constexpr int LD = Row<T, D>::LD;         // padded Q and K row
  static constexpr int LDV = Row<T, DV>::LD;       // padded V row
  static constexpr int STAGE = BKV * (LD + LDV);   // one stage of the ring: K, then V
  static constexpr int LDP = BKV + 4;              // row of the shared P tile (WN > 1)
  // Q, two stages of K and V; with WN > 1 also P and the row exchange
  static constexpr size_t SMEM =
      sizeof(T) * ((size_t)LD * BQ + 2 * (size_t)STAGE) +
      (WN > 1 ? sizeof(float) * (size_t)ROW_GROUPS * 16 * (LDP + WN) : 0);
};

// the two warps of row group rg meet (named barrier 1 + rg, 64 threads)
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(Tile<T, D, DV>::THREADS, Tile<T, D, DV>::WN > 1 ? 1 : 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
          Strides so, int BH, int H, int HK, int Sq, int Skv, int causal, int window,
          float scale_log2, int n_qtiles) {
  using C = Tile<T, D, DV>;
  constexpr int BKV = C::BKV, LD = C::LD, WN = C::WN, LDP = C::LDP, STAGE = C::STAGE;
  constexpr int THREADS = C::THREADS;
  constexpr int KW = BKV / WN, NT = KW / 8;     // keys this warp scores, in 8s
  constexpr int NO = DV / 8 / WN;                // output 8-column groups of this warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + BQ * LD;  // stage s: K (rows of LD) at ring + s STAGE, V (rows of LDV) after it
  // WN > 1: the P tile of each row group, then each warp's 16 row values
  float* Ps = reinterpret_cast<float*>(ring + 2 * STAGE);
  float* xch = Ps + ROW_GROUPS * 16 * LDP;

  // heaviest causal q-tiles first: the tile index is the slowest grid index
  const int bh = blockIdx.x % BH, tq = blockIdx.x / BH;
  const int qt = causal ? n_qtiles - 1 - tq : tq;
  const int b = bh / H, h = bh % H, hk = h % HK;
  const int q0 = qt * BQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % ROW_GROUPS, wh = warp / ROW_GROUPS;   // row group, its half
  const int g = lane >> 2, t = lane & 3;
  const int w_first = q0 + rg * 16, w_last = min(w_first + 15, Sq - 1);
  const int r0 = w_first + g, r1 = r0 + 8;
  const int kw0 = wh * KW, dw0 = wh * (DV / WN);  // this warp's keys and output columns
  float* Pw = Ps + rg * 16 * LDP;
  float* xw = xch + (rg * WN + wh) * 16;         // this warp's row values
  const float* xp = xch + (rg * WN + (wh ^ 1)) * 16;  // its partner's

  // key range that some row of this tile can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / BKV, t_end = (kv_end + BKV - 1) / BKV;

  load_rows<T, D, BQ, THREADS>(Qs, qb, sq.s, q0, Sq);
  load_rows<T, D, BKV, THREADS>(ring, kb, sk.s, t_begin * BKV, Skv);
  load_rows<T, DV, BKV, THREADS>(ring + BKV * LD, vb, sv.s, t_begin * BKV, Skv);
  cp_async_commit();

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int st = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      T* nxt = ring + (st ^ 1) * STAGE;
      load_rows<T, D, BKV, THREADS>(nxt, kb, sk.s, (tile + 1) * BKV, Skv);
      load_rows<T, DV, BKV, THREADS>(nxt + BKV * LD, vb, sv.s, (tile + 1) * BKV, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int k0 = tile * BKV;
    // this warp's rows see none of the tile's keys: skipping it is exact
    // (the same for both warps of a row group)
    const bool skip = w_first >= Sq || (causal && k0 > w_last) ||
                      (window > 0 && w_first - (k0 + BKV - 1) >= window);
    if (!skip) {
      const T* Ks = ring + st * STAGE;
      const T* Vs = Ks + BKV * LD;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      qk<D, NT>(s, Qs + rg * 16 * LD, Ks + kw0 * LD, g, t);

      const bool masked = k0 + BKV > Skv || (causal && k0 + BKV - 1 > w_first) ||
                          (window > 0 && w_last - k0 >= window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (masked) {
            const int kp = k0 + kw0 + n * 8 + 2 * t + (e & 1), qp = e < 2 ? r0 : r1;
            const bool ok = kp < Skv && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
            x = ok ? x : NEG_INF;
          }
          s[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      if constexpr (WN > 1) {  // the row max over both halves of the tile
        if (t == 0) {
          xw[g] = mx0;
          xw[g + 8] = mx1;
        }
        pair_sync(rg);
        mx0 = fmaxf(mx0, xp[g]);
        mx1 = fmaxf(mx1, xp[g + 8]);
      }
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = exp2f(s[n][0] - mx0);
        s[n][1] = exp2f(s[n][1] - mx0);
        s[n][2] = exp2f(s[n][2] - mx1);
        s[n][3] = exp2f(s[n][3] - mx1);
        rs0 += s[n][0] + s[n][1];
        rs1 += s[n][2] + s[n][3];
      }
      // l stays a per-thread partial sum over this warp's keys: alpha is the
      // same in every thread of a row, so the row's sum is taken at the end
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
      if constexpr (WN > 1) {  // share P: each warp multiplies all keys into its columns
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = kw0 + n * 8 + 2 * t;
          *reinterpret_cast<float2*>(Pw + g * LDP + col) = make_float2(s[n][0], s[n][1]);
          *reinterpret_cast<float2*>(Pw + (g + 8) * LDP + col) = make_float2(s[n][2], s[n][3]);
        }
        pair_sync(rg);
        pv<DV, BKV, NO, true>(acc, s, Pw, Vs + dw0, g, t);
      } else {
        pv<DV, BKV, NO, false>(acc, s, Pw, Vs, g, t);
      }
    }
    __syncthreads();  // the stage (and P) is free for the load after next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (WN > 1) {  // each warp summed its own keys
    if (t == 0) {
      xw[g] = l0;
      xw[g + 8] = l1;
    }
    __syncthreads();
    l0 += xp[g];
    l1 += xp[g + 8];
  }
  // max(l, 1e-30) that keeps a NaN a NaN, as jnp.maximum does (fmaxf
  // would drop it): a NaN score gives a NaN row and a NaN log-sum-exp
  l0 = l0 < 1e-30f ? 1e-30f : l0;
  l1 = l1 < 1e-30f ? 1e-30f : l1;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  // the row's natural log-sum-exp for the backward: m is in log2 units
  if (lse != nullptr && wh == 0 && t == 0) {
    float* lb = lse + (long long)bh * Sq;
    if (r0 < Sq) lb[r0] = m0 * LN2 + logf(l0);
    if (r1 < Sq) lb[r1] = m1 * LN2 + logf(l1);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = dw0 + n * 8 + 2 * t;
    if (r0 < Sq) store2(ob + r0 * so.s + col, acc[n][0] * i0, acc[n][1] * i0);
    if (r1 < Sq) store2(ob + r1 * so.s + col, acc[n][2] * i1, acc[n][3] * i1);
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int H, int HK, int Sq, int Skv, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = Tile<T, D, DV>::SMEM;
  static size_t allowed[MAX_DEVICES] = {};  // one record per instantiation
  // above the device's opt-in limit the attribute is refused: the launch never runs
  cudaError_t err = allow_smem((const void*)flash_fwd<T, D, DV>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  const long long blocks = (long long)B * H * n_qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd<T, D, DV><<<(unsigned)blocks, Tile<T, D, DV>::THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, sk, sv, so, B * H, H, HK, Sq, Skv,
      causal, window, scale * LOG2E, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: the head dim of q and k, Dv: that of
// v and o; (D, Dv) one of the instances' pairs. strides: (b, h, s) element
// strides of q, k, v and o, in that order; every pointer and s stride must be
// 16-byte aligned (the wrapper sees to it). window <= 0 means no window.
// lse: null, or a contiguous (B, H, Sq) f32 buffer that takes each query
// row's log-sum-exp of its scaled scores, m + log(max(l, 1e-30)) (the
// backward's input). Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, const long long* strides, int B, int H, int HK,
                                   int Sq, int Skv, int D, int Dv, int dtype, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_INSTANCE(DT, T, DQK, DVO)                                                        \
  if (dtype == DT && D == DQK && Dv == DVO)                                                 \
    return launch<T, DQK, DVO>(q, k, v, o, lse, strides, B, H, HK, Sq, Skv, causal, window,  \
                               scale, s);
  FA_INSTANCE(0, float, 64, 64)
  FA_INSTANCE(0, float, 128, 128)
  FA_INSTANCE(0, float, 256, 256)
  FA_INSTANCE(0, float, 192, 128)
  FA_INSTANCE(0, float, 48, 32)
  FA_INSTANCE(1, __nv_bfloat16, 64, 64)
  FA_INSTANCE(1, __nv_bfloat16, 128, 128)
  FA_INSTANCE(1, __nv_bfloat16, 256, 256)
  FA_INSTANCE(1, __nv_bfloat16, 192, 128)
  FA_INSTANCE(1, __nv_bfloat16, 48, 32)
#undef FA_INSTANCE
  return (int)cudaErrorInvalidValue;
}
