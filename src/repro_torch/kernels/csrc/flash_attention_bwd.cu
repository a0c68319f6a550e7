// Backward flash attention with GQA, causal and sliding-window masks, on the
// tensor cores: FlashAttention-2's split of the gradient into a dK/dV pass
// over key tiles and a dQ pass over query tiles.
//
// It replaces no TPU kernel: the JAX package trains through its jnp
// attention (jax.grad of the plain softmax), and its Pallas kernel
// (repro/kernels/flash_attention.py::flash_attention) has no backward. The
// port's train step runs every self-attention through the CUDA forward
// (flash_attention.cu, which writes each query row's log-sum-exp on request),
// so its gradient on the card comes from this kernel, bound to autograd by
// kernels/flash_attention.py::FlashAttentionFn.
//
// The contract is the forward's: q (B, H, Sq, D), k (B, HK, Skv, D), v (B,
// HK, Skv, Dv), o and dO (B, H, Sq, Dv), each given by its b, h and s strides
// with d contiguous; query head h reads kv head h % HK; query i sits at
// position i, key j at j, and a key is visible when j < Skv, j <= i (causal)
// and i - j < window. With lse the forward's f32 (B, H, Sq) log-sum-exp of
// the scaled scores:
//   P = exp(scale q.k - lse) on visible pairs, 0 elsewhere;
//   delta_i = sum_d dO_id O_id;  dS = P (dO.v - delta);
//   dQ = scale dS.K;  dK = scale dS^T.Q;  dV = P^T.dO,
// dK and dV summed over the G = H / HK query heads h = hk, hk + HK, ... that
// read kv head hk. Three kernels on one stream: the delta pre-pass (one warp
// a query row), the dK/dV kernel (one block a (key tile of 64, kv head,
// batch row), walking the query tiles of each of its G heads, dK and dV in
// registers for a tile and summed in shared memory across tiles) and the
// dQ kernel (one block a (query tile of 64, head, batch row), walking its
// key tiles, dQ likewise). Every gradient element is
// written by exactly one block and summed in one fixed order: no atomics, so
// the result is the same from run to run.
//
// What bounds it on the H100: five products over the visible pairs (Q.K^T
// and dO.V^T recomputed in both passes, then dS.K, dS^T.Q and P^T.dO), 2 D
// FLOP each a pair at D = Dv. At qwen2-0.5b's training shape (f32, B = 8, H =
// 14, HK = 2, S = 512, D = 64, causal) that is 9.41 GFLOP over 14.7 M visible
// pairs, 0.057 ms at the 3xTF32 rate (165 TFLOP/s of f32 work); q, k, v, o,
// dO, lse and the three gradients are ~65 MB, 0.019 ms at 3.35 TB/s. So it is
// bound by operations.
//
// The design: each warp owns 16 rows of its block's tile (keys in the dK/dV
// kernel, queries in the dQ kernel) and runs the forward's two warp products
// (flash_attention.cuh) with the operands' roles exchanged. In the dK/dV
// kernel the scores come out transposed, S^T = K.Q^T (16 keys x BN queries),
// and so does dP^T = V.dO^T; P^T and dS^T then sit in the C fragments of the
// key rows, which is the A operand that the forward's P.V product takes from
// registers, so dV += P^T.dO and dK += dS^T.Q read dO and Q as the forward
// reads V. In the dQ kernel S = Q.K^T and dP = dO.V^T are the forward's
// products and dQ += dS.K reads K as the forward reads V. P and dS never
// leave registers. f32 runs mma.sync m16n8k8 in
// 3xTF32 (f32 accuracy); bf16 runs m16n8k16 with f32 accumulators, P and dS
// rounded to bf16 for their products, as the forward rounds P.
//  - Tiles: a block owns 64 rows (4 warps of 16); the walked tiles are BN =
//    64 rows at D = 64 and 32 at D = 128 (each warp holds 16 x D of dK and
//    of dV, or of dQ, in registers, plus two 16 x BN score fragments). One
//    stage: the walked tile is loaded by 16-byte cp.async after a barrier,
//    waited for, and multiplied. Shared memory, f32: 64 x (D + 4) and 64 x
//    (Dv + 4) for the own tiles, BN x the same for the walked ones, and the
//    walked or own rows' lse and delta, and the f32 sums of the own rows
//    (64 x (D + 8) and 64 x (Dv + 8)): 107,008 bytes at (64, 64), 171,520
//    at (128, 128); above 48 KB it needs the opt-in limit, which the launch
//    sets and checks.
//  - The sums: mma.sync's f32 accumulation does not round each addition to
//    nearest as an f32 add does, and at qwen2's shape a key's dK and dV sum G x Sq = 3,584
//    products (against a forward row's 512): summed in registers alone
//    they drifted ~35x further from an f64 reference than the plain f32
//    version did. So the register sums cover one walked tile (BN rows)
//    and are then added, by ordinary rounded f32 adds, into the block's
//    sums in shared memory, which the epilogue scales and stores. Each
//    element has one owner thread and a fixed order of adds: still
//    deterministic.
//  - Masks: the walk covers only tiles that hold a visible pair (causal:
//    queries from the key tile's first key on, keys up to the query tile's
//    last query; window: the band), and every element is masked by position
//    (padded rows of ragged tiles are zero and masked out).
//  - The causal dK/dV blocks of the first key tiles see the most queries and
//    are launched first; the dQ blocks of the last query tiles likewise.
// Instances (D, Dv) = (64, 64) and (128, 128), each in f32 and bf16; any
// other pair is refused (the wrapper raises before it calls).
#include "flash_attention.cuh"

namespace {

using namespace repro;
using namespace repro::flash;

constexpr int BM = 64;                       // rows a block owns, 16 a warp
constexpr int WARPS = BM / 16, THREADS = 32 * WARPS;
constexpr int DELTA_THREADS = 256;

template <typename T, int D, int DV>
struct BwdTile {
  static constexpr int BN = D >= 128 ? 32 : 64;    // rows of each walked tile
  static constexpr int NT = BN / 8;                // 8-column groups of a score fragment
  static constexpr int LD = Row<T, D>::LD;         // padded row of a D-wide tile
  static constexpr int LDV = Row<T, DV>::LD;       // padded row of a Dv-wide tile
  // the own tiles (D- and Dv-wide, BM rows), the walked ones (BN rows), lse
  // (log2 units) and delta of the query rows in view, then the f32 sums of
  // the gradient rows the block owns (dK and dV, or dQ and unused room)
  static constexpr size_t SMEM = sizeof(T) * (size_t)(BM + BN) * (LD + LDV) +
                                 sizeof(float) * 2 * (size_t)(BM > BN ? BM : BN) +
                                 sizeof(float) * (size_t)BM * (D + 8 + DV + 8);
};

// Add this thread's fragment of W columns (rows rl and rl + 8 of the block's
// tile, columns n * 8 + 2t, + 1) into the f32 sums at acc (row stride W +
// 8, which keeps a half-warp's 8-byte accesses on distinct banks), and zero
// it. Each element has one owner thread, so no barrier is needed.
template <int W>
__device__ __forceinline__ void flush(float* acc, float (*frag)[4], int rl, int t) {
  constexpr int LDA = W + 8;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    float2* p0 = reinterpret_cast<float2*>(acc + rl * LDA + n * 8 + 2 * t);
    float2* p1 = reinterpret_cast<float2*>(acc + (rl + 8) * LDA + n * 8 + 2 * t);
    float2 a = *p0, c = *p1;
    a.x += frag[n][0];
    a.y += frag[n][1];
    c.x += frag[n][2];
    c.y += frag[n][3];
    *p0 = a;
    *p1 = c;
    frag[n][0] = frag[n][1] = frag[n][2] = frag[n][3] = 0.f;
  }
}

template <int W>
__device__ __forceinline__ void zero_sums(float* acc, int rl, int t) {
  constexpr int LDA = W + 8;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    *reinterpret_cast<float2*>(acc + rl * LDA + n * 8 + 2 * t) = make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(acc + (rl + 8) * LDA + n * 8 + 2 * t) = make_float2(0.f, 0.f);
  }
}

// the block's sums of W columns at row rl and its column c, scaled, into
// global memory (row stride ld), rows at or past `limit` skipped
template <int W, typename T>
__device__ __forceinline__ void store_sums(T* dst, long long ld, const float* acc, int row0,
                                           int rl, int t, int limit, float scale) {
  constexpr int LDA = W + 8;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = rl + 8 * h8;
      const float2 a = *reinterpret_cast<const float2*>(acc + r * LDA + col);
      if (row0 + r < limit) store2(dst + (row0 + r) * ld + col, a.x * scale, a.y * scale);
    }
  }
}

// delta_r = sum_d dO_rd O_rd, one warp a query row r of (B, H, Sq).
template <typename T, int DV>
__global__ void __launch_bounds__(DELTA_THREADS)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
          Strides so, Strides sdo, int H, int Sq, long long rows) {
  const long long row = ((long long)blockIdx.x * DELTA_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / Sq;
  const int r = (int)(row % Sq), b = (int)(bh / H), h = (int)(bh % H);
  const T* orow = o + b * so.b + h * so.h + (long long)r * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + (long long)r * sdo.s;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv, int causal,
                                        int window) {
  return qi < Sq && kj < Skv && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// dK and dV of one key tile of one kv head: the G heads' query tiles walked
// in turn. Scores come transposed: s[n][e] is key (row g or g + 8 of this
// warp's 16) against query n * 8 + 2t + (e & 1) of the walked tile.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Strides sq,
         Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int B, int H, int HK,
         int Sq, int Skv, int causal, int window, float scale, float scale_log2) {
  using C = BwdTile<T, D, DV>;
  constexpr int BN = C::BN, NT = C::NT, LD = C::LD, LDV = C::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BM * LD;
  T* Qs = Vs + BM * LDV;
  T* dOs = Qs + BN * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BN * LDV);
  float* delta_s = lse_s + (BM > BN ? BM : BN);
  float* dk_s = delta_s + (BM > BN ? BM : BN);     // BM x (D + 8) f32 sums of dK
  float* dv_s = dk_s + BM * (D + 8);               // BM x (DV + 8) f32 sums of dV

  // the key tile is the slowest grid index: the first tiles, which the most
  // causal queries see, start first
  const int bhk = blockIdx.x % (B * HK), kt = blockIdx.x / (B * HK);
  const int b = bhk / HK, hk = bhk % HK;
  const int k0 = kt * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rl = warp * 16 + g;                   // this thread's first row in the tile
  const int kr0 = k0 + rl, kr1 = kr0 + 8;

  load_rows<T, D, BM, THREADS>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Skv);
  load_rows<T, DV, BM, THREADS>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Skv);
  cp_async_commit();

  // the queries that some key of the tile is visible to
  const int k_last = min(k0 + BM, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;

  float dka[D / 8][4], dva[DV / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  zero_sums<D>(dk_s, rl, t);
  zero_sums<DV>(dv_s, rl, t);

  for (int h = hk; h < H; h += HK) {
    const T* qb = q + b * sq.b + h * sq.h;
    const T* db = dout + b * sdo.b + h * sdo.h;
    const float* lb = lse + ((long long)b * H + h) * Sq;
    const float* deb = delta + ((long long)b * H + h) * Sq;
    for (int q0 = q_begin / BN * BN; q0 < q_end; q0 += BN) {
      __syncthreads();  // every warp is done with the previous walked tile
      load_rows<T, D, BN, THREADS>(Qs, qb, sq.s, q0, Sq);
      load_rows<T, DV, BN, THREADS>(dOs, db, sdo.s, q0, Sq);
      cp_async_commit();
      for (int i = threadIdx.x; i < BN; i += THREADS) {
        const bool ok = q0 + i < Sq;
        lse_s[i] = ok ? lb[q0 + i] * LOG2E : 0.f;
        delta_s[i] = ok ? deb[q0 + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      qk<D, NT>(s, Ks + warp * 16 * LD, Qs, g, t);      // S^T = K . Q^T
      qk<DV, NT>(dp, Vs + warp * 16 * LDV, dOs, g, t);  // dP^T = V . dO^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * t + (e & 1);
          const bool ok = visible(q0 + ql, e < 2 ? kr0 : kr1, Sq, Skv, causal, window);
          const float p = ok ? exp2f(s[n][e] * scale_log2 - lse_s[ql]) : 0.f;
          s[n][e] = p;                                   // P^T
          dp[n][e] = p * (dp[n][e] - delta_s[ql]);       // dS^T
        }
      }
      pv<DV, BN, DV / 8, false>(dva, s, nullptr, dOs, g, t);   // dV += P^T . dO
      pv<D, BN, D / 8, false>(dka, dp, nullptr, Qs, g, t);     // dK += dS^T . Q
      flush<D>(dk_s, dka, rl, t);
      flush<DV>(dv_s, dva, rl, t);
    }
  }
  cp_async_wait<0>();
  store_sums<D>(dk + b * sdk.b + hk * sdk.h, sdk.s, dk_s, k0, rl, t, Skv, scale);
  store_sums<DV>(dv + b * sdv.b + hk * sdv.h, sdv.s, dv_s, k0, rl, t, Skv, 1.f);
}

// dQ of one query tile of one head, its key tiles walked in turn: s[n][e] is
// query (row g or g + 8 of this warp's 16) against key n * 8 + 2t + (e & 1).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
       Strides sdo, Strides sdq, int B, int H, int HK, int Sq, int Skv, int causal, int window,
       float scale, float scale_log2, int n_qtiles) {
  using C = BwdTile<T, D, DV>;
  constexpr int BN = C::BN, NT = C::NT, LD = C::LD, LDV = C::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BM * LD;
  T* Ks = dOs + BM * LDV;
  T* Vs = Ks + BN * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BN * LDV);
  float* delta_s = lse_s + (BM > BN ? BM : BN);
  float* dq_s = delta_s + (BM > BN ? BM : BN);     // BM x (D + 8) f32 sums of dQ

  // heaviest causal query tiles first: the tile index is the slowest grid index
  const int bh = blockIdx.x % (B * H), tq = blockIdx.x / (B * H);
  const int qt = causal ? n_qtiles - 1 - tq : tq;
  const int b = bh / H, h = bh % H, hk = h % HK;
  const int q0 = qt * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = warp * 16 + g, rl1 = rl0 + 8;       // this thread's rows in the tile

  load_rows<T, D, BM, THREADS>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_rows<T, DV, BM, THREADS>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  cp_async_commit();
  const float* lb = lse + (long long)bh * Sq;
  const float* deb = delta + (long long)bh * Sq;
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const bool ok = q0 + i < Sq;
    lse_s[i] = ok ? lb[q0 + i] * LOG2E : 0.f;
    delta_s[i] = ok ? deb[q0 + i] : 0.f;
  }
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  // the keys that some query of the tile sees
  const int q_last = min(q0 + BM, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  zero_sums<D>(dq_s, rl0, t);

  for (int kv0 = kv_begin / BN * BN; kv0 < kv_end; kv0 += BN) {
    __syncthreads();  // every warp is done with the previous key tile
    load_rows<T, D, BN, THREADS>(Ks, kb, sk.s, kv0, Skv);
    load_rows<T, DV, BN, THREADS>(Vs, vb, sv.s, kv0, Skv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    qk<D, NT>(s, Qs + warp * 16 * LD, Ks, g, t);      // S = Q . K^T
    qk<DV, NT>(dp, dOs + warp * 16 * LDV, Vs, g, t);  // dP = dO . V^T
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kv0 + n * 8 + 2 * t + (e & 1), rl = e < 2 ? rl0 : rl1;
        const bool ok = visible(q0 + rl, kj, Sq, Skv, causal, window);
        const float p = ok ? exp2f(s[n][e] * scale_log2 - lse_s[rl]) : 0.f;
        dp[n][e] = p * (dp[n][e] - delta_s[rl]);       // dS
      }
    }
    pv<D, BN, D / 8, false>(dqa, dp, nullptr, Ks, g, t);   // dQ += dS . K
    flush<D>(dq_s, dqa, rl0, t);
  }
  cp_async_wait<0>();
  store_sums<D>(dq + b * sdq.b + h * sdq.h, sdq.s, dq_s, q0, rl0, t, Sq, scale);
}

template <typename T, int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv,
               const long long* st, int B, int H, int HK, int Sq, int Skv, int causal,
               int window, float scale, cudaStream_t stream) {
  using C = BwdTile<T, D, DV>;
  static size_t allowed_kv[MAX_DEVICES] = {}, allowed_q[MAX_DEVICES] = {};
  cudaError_t err = allow_smem((const void*)bwd_dkdv<T, D, DV>, C::SMEM, allowed_kv);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem((const void*)bwd_dq<T, D, DV>, C::SMEM, allowed_q);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]};
  const Strides so{st[9], st[10], st[11]}, sdo{st[12], st[13], st[14]};
  const Strides sdq{st[15], st[16], st[17]}, sdk{st[18], st[19], st[20]};
  const Strides sdv{st[21], st[22], st[23]};
  const long long rows = (long long)B * H * Sq;
  const long long delta_blocks = (rows * 32 + DELTA_THREADS - 1) / DELTA_THREADS;
  const long long kv_blocks = (long long)B * HK * ((Skv + BM - 1) / BM);
  const int n_qtiles = (Sq + BM - 1) / BM;
  const long long q_blocks = (long long)B * H * n_qtiles;
  if (delta_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  bwd_delta<T, DV><<<(unsigned)delta_blocks, DELTA_THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, so, sdo, H, Sq, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv<T, D, DV><<<(unsigned)kv_blocks, THREADS, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, sq, sk,
      sv, sdo, sdk, sdv, B, H, HK, Sq, Skv, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq<T, D, DV><<<(unsigned)q_blocks, THREADS, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, sq, sk, sv,
      sdo, sdq, B, H, HK, Sq, Skv, causal, window, scale, scale_log2, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: the head dim of q and k, Dv: that of
// v, o and dO; (D, Dv) one of (64, 64) and (128, 128). strides: (b, h, s)
// element strides of q, k, v, o, dO, dq, dk and dv, in that order; q, k, v
// and dO, and their s strides, must be 16-byte aligned (the wrapper sees to
// it). lse: the forward's contiguous (B, H, Sq) f32 log-sum-exp; delta: a
// contiguous (B, H, Sq) f32 scratch buffer. window <= 0 means no window.
// Launches the delta pre-pass, the dK/dV kernel and the dQ kernel on
// `stream`; returns the CUDA error code of the launches (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, const long long* strides, int B, int H,
                                   int HK, int Sq, int Skv, int D, int Dv, int dtype,
                                   int causal, int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_BWD_INSTANCE(DT, T, DQK, DVO)                                                   \
  if (dtype == DT && D == DQK && Dv == DVO)                                                \
    return launch_bwd<T, DQK, DVO>(q, k, v, o, dout, lse, delta, dq, dk, dv, strides, B, H, \
                                   HK, Sq, Skv, causal, window, scale, s);
  FA_BWD_INSTANCE(0, float, 64, 64)
  FA_BWD_INSTANCE(0, float, 128, 128)
  FA_BWD_INSTANCE(1, __nv_bfloat16, 64, 64)
  FA_BWD_INSTANCE(1, __nv_bfloat16, 128, 128)
#undef FA_BWD_INSTANCE
  return (int)cudaErrorInvalidValue;
}
