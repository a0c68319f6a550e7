// Backward flash attention with GQA, causal and sliding-window masks, on the
// tensor cores: FlashAttention-2's split of the gradient into a dK/dV pass
// over key tiles and a dQ pass over query tiles, laid out for the H100.
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
// read kv head hk.
//
// What bounds it on the H100: five products over the visible pairs (Q.K^T
// and dO.V^T recomputed in both passes, then dS.K, dS^T.Q and P^T.dO), 2 (3 D
// + 2 Dv) FLOP a pair. At qwen2-0.5b's training shape (f32, B = 8, H = 14,
// HK = 2, S = 512, D = 64, causal) that is 9.41 GFLOP over 14.7 M visible
// pairs, 0.057 ms at the 3xTF32 rate (165 TFLOP/s of f32 work); q, k, v, o,
// dO, lse and the three gradients are ~65 MB, 0.019 ms at 3.35 TB/s. So it is
// bound by operations. This kernel's first version took 0.9060 ms there: one 4-warp block
// a (64-key tile, kv head, batch row) gave 128 blocks for 132 SMs, one warp
// on each SM sub-partition to hide the tensor cores' latency; the block of
// the first key tile walked 7 heads x 8 query tiles while the last walked 7;
// each walked tile was loaded, waited for and only then multiplied.
//
// The design, for each of those causes:
//  - Work in flight and balance. A block is one warpgroup (4 warps, 16 of
//    its 64 own rows a warp), small enough in shared memory that two blocks
//    share an SM (8 warps) at every instance but (192, 128) and bf16's
//    (128, 128). A key tile's walk, its G heads' query tiles in turn, is
//    cut into parts of at most `chunk` tiles, and each part is a block.
//    plan_split (below; the wrapper asks it through
//    flash_attention_bwd_plan, for the workspace's size) picks `chunk` by
//    list-scheduling the parts, heaviest key tiles first as the grid runs
//    them, over the card's SMs x blocks an SM. At qwen2's shape (f32,
//    walked tiles of 64 queries) the 16 x 8 key tiles walk 56 down to 7
//    tiles; the plan cuts the first six into 3, 3, 3, 2, 2 and 2 parts, so
//    no block walks more than 19 tiles (272 blocks over 264 places). The parts of a split key
//    tile write their f32 sums into a workspace (the wrapper allocates it),
//    and a reduce pass (one block a 4-row block of a split tile) adds them
//    part by part, in order, and writes dK and dV; a tile that is not split
//    writes them itself. The dQ pass needs no
//    split: one block a (64-query tile, head, batch row) is 896 blocks at
//    qwen2's shape, launched heaviest first.
//  - Overlap. The walked tiles (Q and dO with their lse and delta rows in
//    the dK/dV pass, K and V in the dQ pass) come through a ring of two
//    stages filled by cp.async (16-byte copies, 4 bytes for lse and delta,
//    zero-filled past the edges): tile i + 1 is in flight while tile i is
//    multiplied.
//  - Tensor cores. bf16 runs all five products on wgmma (sm_90a), with f32
//    accumulators. The own tile and the walked tile sit in shared memory as
//    64-column panels of 128-byte rows in the 128-byte swizzle (8-row groups
//    of all panels side by side), which is the layout wgmma reads: S^T =
//    K.Q^T and dP^T = V.dO^T (dQ pass: S = Q.K^T, dP = dO.V^T) as m64n64k16
//    (m64n32k16 at (256, 256), below) with both operands K-major from
//    shared memory; dV += P^T.dO, dK +=
//    dS^T.Q and dQ += dS.K as m64n64k16 a 64-column panel, P and dS rounded
//    to bf16 as A fragments from registers (the f32 accumulator of a score
//    product is, pair by pair, the A fragment of the next), and the walked
//    tile read MN-major (transposed) from shared memory. f32 (3xTF32)
//    stays on mma.sync m16n8k8 for all five products: a tf32 wgmma takes
//    its shared-memory operands K-major only (no transpose flag), so dV +=
//    P^T.dO and dK += dS^T.Q would need a transposed copy of each walked
//    tile, and 3xTF32 would need each operand's big and small halves
//    staged apart in shared memory, three tiles for each one loaded; the
//    occupancy and balance above, and the TF32 split by integer operations
//    (common.cuh), are what the f32 path gains. The wgmma accumulator's
//    fragment (warp w: rows 16 w + g and + 8, columns 8 n + 2 t, + 1) is
//    mma.sync's, so the masks, the softmax and the sums are one code for
//    both.
//  - The sums (the first version's accuracy rule, kept): mma.sync's and wgmma's f32
//    accumulation does not round each addition to nearest as an f32 add
//    does, and at qwen2's shape a key's dK and dV sum G x Sq = 3,584
//    products. So the tensor cores' sums cover one walked tile and are then
//    added, by rounded f32 adds, into the block's f32 sums: in registers in
//    f32 at D <= 128 (which frees the shared memory for two blocks an SM),
//    in shared memory otherwise. Each element has one owner thread and one
//    order of adds, the split parts are added in part order, and nothing is
//    summed by atomics: two runs give the same bits.
//  - Registers: dV's and dK's tile products run one after the other, so at
//    (192, 128) a thread holds the scores and one of the two (96 columns of
//    dK), not both. The walked tile is 16 rows in f32 at D >= 128, 64 at D
//    <= 64 and in bf16. f32 (128, 128)'s dK/dV pass holds its sums in 255
//    registers without a spill; only f32 (48, 32)'s (the reduced MLA
//    width) spills, 16 bytes at 168 registers (nvcc -Xptxas -v).
//  - Masks: the walk covers only tiles that hold a visible pair (causal:
//    queries from the key tile's first key on, keys up to the query tile's
//    last query; window: the band); tiles that cross a boundary are masked
//    element by element (padded rows of ragged tiles are zero).
// Measured (scripts/kernel_timing.py --only flash_attention_bwd, device
// time as one CUDA graph, each kernel by CUDA events between its launches;
// NVIDIA H100 80GB HBM3 at 700 W, the first version timed in turn in the
// same call): f32, 0.3742 ms at qwen2's training shape (first version:
// 0.9221; dK/dV
// 0.2095, dQ 0.1407, the reduce pass 0.0236, delta 0.0233), 0.7831 at
// qwen3-0.6b's (8 x 16/8 x 512, D 128; first version: 1.5947), both below SDPA's
// backward (0.4419, 0.9454), and 0.7484 at deepseek-v2-lite-16b's (4 x
// 16/16 x 512, (192, 128)), behind SDPA's 0.7220: there one block of 4
// warps fills an SM's shared memory (own tiles, ring and f32 sums). bf16,
// 0.1342 ms at qwen2's shape (first version: 0.2642), 0.2422 at qwen3's
// (0.4461), 0.1623 at deepseek's, each behind SDPA's bf16 backward (0.12 to
// 0.18 eager in that call): the delta and reduce passes are a third of
// qwen2's bf16 time, and each product's wgmma group is waited for before
// the next is issued.
// Shared memory (dK/dV pass; the dQ pass needs less): f32 (64, 64) 105,472
// bytes, (128, 128) 101,632, (48, 32) 68,608 (two blocks an SM each),
// (192, 128) 212,224; bf16 88,064 (two), 169,984, 210,944 and 88,064 (two).
// recurrentgemma-2b's (256, 256), by pairs of warps (bwd_dkdv_pair,
// bwd_dq_pair, below). Its own tiles and ring leave no room for the f32
// sums of 64 rows x 512 columns in shared memory, and a 4-warp block's
// registers hold 128 columns of them; the first version kept them in
// device memory, so every walked tile read and wrote the block's 135 KB of
// sums (~1.6 GB a call at 4 x 10/1 x 512, one 4-warp block an SM). Now a
// block of 8 warps owns the 64 rows: warps w and w + 4 share rows 16 (w %
// 4), and each takes 128 of the 256 columns, its half of each score
// product's reduction (the halves meet in shared memory, one f32 add, so
// both warps hold the same scores) and its half of the gradients' columns,
// whose f32 sums it keeps in registers (64 a gradient a thread); the tile
// products are added into them by f32 adds, as at the other instances. f32
// walks 16-row tiles on 3xTF32 mma.sync, 64 columns a product. bf16 walks
// 32-row tiles on wgmma, each warpgroup (warps 0-3, 4-7) a column half: its
// scores as m64n32k16 over its two 64-column panels (both operands in
// shared memory in the 128-byte swizzle), then dV's and dK's (or dQ's) tile
// products as m64n64k16, both panels in one wgmma group, with P and dS as
// A fragments from registers. Shared memory: f32 216,320 bytes (dK/dV) and
// 216,576 (dQ), bf16 165,376 in both; one block an SM. Registers (nvcc
// -Xptxas -v): f32 255 (a 4-byte spill) and 226; bf16 254 and 184, no
// spill (with a wgmma group a panel rather than both in one, the dK/dV
// pass spilled 76 bytes and ran slower). Measured (scripts/kernel_timing.py
// --src, one CUDA graph a call, in turns on one NVIDIA H100 80GB HBM3 at
// 700 W) at recurrentgemma's train shape: bf16 0.1601-0.1610 ms against
// 0.1754-0.1784 for the same pairs on mma.sync with ldmatrix fragments
// (255 registers and spills in both passes) and 0.3768-0.3806 for the
// first version; f32 0.6031-0.6053 against the first version's
// 1.2120-1.2186. SDPA's backward and the other times in PERF.md.
// Instances (D, Dv) = (64, 64), (128, 128), (192, 128), (48, 32) and (256,
// 256), each in f32 and bf16; any other pair is refused (the wrapper raises
// before it calls).
#include <algorithm>
#include <functional>
#include <queue>
#include <vector>

#include "flash_attention.cuh"

namespace {

using namespace repro;
using namespace repro::flash;

constexpr int BM = 64;        // rows a block owns: one warpgroup, 16 a warp
constexpr int THREADS = 128;
constexpr int PAIR_THREADS = 256;  // (256, 256): two warps a 16-row group
constexpr int REDUCE_ROWS = 4;     // rows of a split key tile a reduce block adds
constexpr int DELTA_THREADS = 256;
constexpr int REDUCE_THREADS = 256;
constexpr int MAX_PARTS = 8;  // parts a key tile is cut into at most
constexpr int SM_SMEM = 233472;  // shared memory of an SM; a block also takes 1 KB of it

constexpr int round64(int w) { return (w + 63) / 64 * 64; }

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

// Bytes of a shared tile of ROWS rows of W values: rows padded by 16 bytes
// (mma.sync fragments free of bank conflicts), or, SWZ (bf16 for wgmma), as
// 64-column panels of 128-byte rows in the 128-byte swizzle.
template <typename T, int W, int ROWS, bool SWZ>
struct TileMem {
  static constexpr int PANELS = (W + 63) / 64;
  static constexpr int BYTES = SWZ ? ROWS * 128 * PANELS : ROWS * Row<T, W>::LD * (int)sizeof(T);
};

// One instance's tiles. OWN: the block's 64 rows (K and V in the dK/dV pass,
// Q and dO in the dQ pass); WALK: a ring stage's BN rows (Q and dO, or K
// and V). The split of the dK/dV pass (plan_split) reads BN and OCC.
template <typename T, int D, int DV>
struct BwdTile {
  // (256, 256): the pair kernels (below)
  static constexpr bool PAIR = D == 256 && DV == 256;
  static constexpr bool WG = IsBf16<T>::value;  // wgmma, else mma.sync
  static constexpr int BN = PAIR ? (WG ? 32 : 16) : WG ? 64 : D >= 128 ? 16 : 64;
  static constexpr int NTHREADS = PAIR ? PAIR_THREADS : THREADS;
  // f32 at D <= 128 and the pairs: the f32 sums stay in registers (a
  // thread's 16 x D / 4 of dK and of dV, or of dQ; a pair's warp holds half
  // the columns), which leaves the shared memory for two blocks an SM, or
  // for the pairs' tiles
  static constexpr bool REG_SUMS = PAIR || (!WG && D <= 128);
  static constexpr int NT = BN / 8;                   // 8-column groups of a score fragment
  static constexpr int STAGES = 2;
  static constexpr int DA = WG ? round64(D) : D;      // accumulator columns
  static constexpr int DVA = WG ? round64(DV) : DV;
  static constexpr int OWN_A = TileMem<T, D, BM, WG>::BYTES, OWN_B = TileMem<T, DV, BM, WG>::BYTES;
  static constexpr int WALK_A = TileMem<T, D, BN, WG>::BYTES;
  static constexpr int WALK_B = TileMem<T, DV, BN, WG>::BYTES;
  static constexpr int STAGE = WALK_A + WALK_B;
  static constexpr int ALIGN = WG ? 1024 : 0;         // the swizzle's 1024-byte atoms
  // own tiles, the ring, the walked rows' lse and delta
  static constexpr int BASE_KV = ALIGN + OWN_A + OWN_B + STAGES * STAGE + 4 * 2 * STAGES * BN;
  // own tiles, the ring, the own rows' lse and delta
  static constexpr int BASE_Q = ALIGN + OWN_A + OWN_B + STAGES * STAGE + 4 * 2 * BM;
  // the f32 sums of dK and dV, of dQ, where they are not in registers; the
  // pairs' exchange of their score halves (s and dp, 2 NT float4 a lane)
  static constexpr int SUMS_KV = REG_SUMS ? 0 : 4 * BM * (DA + 8 + DVA + 8);
  static constexpr int SUMS_Q = REG_SUMS ? 0 : 4 * BM * (DA + 8);
  static constexpr int XCH = PAIR ? (PAIR_THREADS / 32) * 2 * NT * 32 * 16 : 0;
  static constexpr int SMEM_KV = BASE_KV + SUMS_KV + XCH;
  static constexpr int SMEM_Q = BASE_Q + SUMS_Q + XCH;
  static constexpr int OCC = SM_SMEM / (SMEM_KV + 1024) >= 2 ? 2 : 1;  // dK/dV blocks an SM
  static_assert(SMEM_KV <= 232448 && SMEM_Q <= 232448, "shared memory over 227 KB");
  static_assert(!WG || BN == (PAIR ? 32 : 64), "the wgmma scores are m64n64k16, m64n32k16 at the pairs");
};

// The dK/dV pass's work: the walk of key tile kt (its G heads' query tiles
// of bn rows, head after head) is cut into parts of at most `chunk` tiles.
// Host (plan_split, the launch) and device enumerate it alike.
struct KvPlan {
  int Sq, Skv, G, causal, window, bn, chunk;

  // t0: the first query tile key tile kt walks, T: tiles a head
  __host__ __device__ void tiles(int kt, int& t0, int& T) const {
    const int k0 = kt * BM;
    const int k_last = (k0 + BM < Skv ? k0 + BM : Skv) - 1;
    const int q_begin = causal ? k0 : 0;
    const int q_end = window > 0 ? (Sq < k_last + window ? Sq : k_last + window) : Sq;
    t0 = q_begin / bn;
    T = q_end > q_begin ? (q_end + bn - 1) / bn - t0 : 0;
  }
  __host__ __device__ int parts(int kt) const {
    int t0, T;
    tiles(kt, t0, T);
    const int L = G * T;
    return L <= chunk ? 1 : (L + chunk - 1) / chunk;
  }
};

// Block item -> (key tile, part, parts, workspace slot of its first part):
// items run over the key tiles, then over each one's parts; only split
// tiles take slots. False past the last item.
__device__ bool find_item(const KvPlan& pl, int n_kt, int item, int& kt, int& part, int& np,
                          int& slot) {
  slot = 0;
  for (kt = 0; kt < n_kt; ++kt) {
    np = pl.parts(kt);
    if (item < np) {
      part = item;
      return true;
    }
    item -= np;
    if (np > 1) slot += np;
  }
  return false;
}

// The u-th split key tile: (key tile, parts, slot of its first part).
__device__ bool find_split(const KvPlan& pl, int n_kt, int u, int& kt, int& np, int& slot) {
  slot = 0;
  for (kt = 0; kt < n_kt; ++kt) {
    np = pl.parts(kt);
    if (np > 1) {
      if (u == 0) return true;
      --u;
      slot += np;
    }
  }
  return false;
}

// Walked tiles until the last dK/dV block ends when the grid's blocks (key
// tiles in order, each one's parts, then the `units` (batch row, kv head)
// pairs) go to the first free of `places` places, each block costing one
// tile more than its walk (its own tiles and its epilogue).
long long makespan(const KvPlan& pl, int n_kt, long long units, int places) {
  std::priority_queue<long long, std::vector<long long>, std::greater<long long>> ends;
  for (int i = 0; i < places; ++i) ends.push(0);
  for (int kt = 0; kt < n_kt; ++kt) {
    int t0, T;
    pl.tiles(kt, t0, T);
    const long long L = (long long)pl.G * T;
    const int P = pl.parts(kt);
    for (int p = 0; p < P; ++p) {
      const long long n = (p + 1) * L / P - p * L / P + 1;
      for (long long u = 0; u < units; ++u) {
        const long long f = ends.top();
        ends.pop();
        ends.push(f + n);
      }
    }
  }
  long long last = 0;
  for (; !ends.empty(); ends.pop()) last = std::max(last, ends.top());
  return last;
}

// Workspace parts a (batch row, kv head) under pl's chunk: the parts of its
// split key tiles; *longest, the longest block's walk in tiles.
int split_slots(const KvPlan& pl, int n_kt, int* longest) {
  int slots = 0;
  *longest = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    int t0, T;
    pl.tiles(kt, t0, T);
    const int np = pl.parts(kt);
    if (np > 1) slots += np;
    *longest = std::max(*longest, (pl.G * T + np - 1) / np);
  }
  return slots;
}

// The dK/dV pass's split on a card of `sms` SMs: the chunk, among the
// longest walk and its cuts into 2..MAX_PARTS parts, whose list schedule
// over sms x OCC places ends first; a cut within 3 % of the best that
// splits less is preferred (its parts cost workspace traffic and a reduce
// pass). At qwen2-0.5b's training shape (f32, 132 SMs) the 8 key tiles of a
// (batch row, kv head) walk 56 down to 7 tiles, and the split cuts the
// first six into 3, 3, 3, 2, 2 and 2 parts: no block walks more than 19.
template <typename T, int D, int DV>
KvPlan plan_split(int B, int H, int HK, int Sq, int Skv, int causal, int window, int sms) {
  using C = BwdTile<T, D, DV>;
  KvPlan pl{Sq, Skv, H / HK, causal, window, C::BN, 1};
  const int n_kt = (Skv + BM - 1) / BM;
  int longest = 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    int t0, tiles;
    pl.tiles(kt, t0, tiles);
    longest = std::max(longest, pl.G * tiles);
  }
  std::vector<int> chunks;   // from the least split to the most
  for (int p = 1; p <= MAX_PARTS; ++p) {
    const int c = (longest + p - 1) / p;
    if (chunks.empty() || chunks.back() != c) chunks.push_back(c);
  }
  std::vector<long long> spans;
  for (int c : chunks) {
    pl.chunk = c;
    spans.push_back(makespan(pl, n_kt, (long long)B * HK, sms * C::OCC));
  }
  const long long best = *std::min_element(spans.begin(), spans.end());
  size_t i = 0;
  while (100 * spans[i] > 103 * best) ++i;
  pl.chunk = chunks[i];
  return pl;
}

// ROWS f32 values from row0 (0 at or past limit) into shared memory
template <int ROWS, int NTH = THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int limit) {
  for (int i = threadIdx.x; i < ROWS; i += NTH) {
    const bool ok = row0 + i < limit;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok ? 4 : 0);
  }
}

// ROWS rows of W values from row0 (row stride `stride`) into the shared tile
// at dst; rows at or past `limit`, and bf16 columns past W in the last
// panel, are zero-filled. bf16: 16-byte chunk c of row r in panel p at
// (r / 8) x PANELS x 1024 + p x 1024 + (r % 8) x 128 + (c ^ (r % 8)) x 16.
template <typename T, int W, int ROWS, int NTH = THREADS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src, long long stride,
                                          int row0, int limit) {
  if constexpr (!IsBf16<T>::value) {
    load_rows<T, W, ROWS, NTH>(reinterpret_cast<T*>(dst), src, stride, row0, limit);
  } else {
    constexpr int PANELS = (W + 63) / 64;
    for (int i = threadIdx.x; i < ROWS * PANELS * 8; i += NTH) {
      const int c = i & 7, r = (i >> 3) % ROWS, p = (i >> 3) / ROWS;
      const int col = p * 64 + c * 8;
      const bool ok = row0 + r < limit && col < W;
      const T* g = src + (ok ? (long long)(row0 + r) * stride + col : 0);
      cp_async16(dst + (r >> 3) * PANELS * 1024 + p * 1024 + (r & 7) * 128 + ((c ^ (r & 7)) << 4),
                 g, ok ? 16 : 0);
    }
  }
}

// ---------------------------------------------------------------- wgmma

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across the wait.
template <int N>
__device__ __forceinline__ void keep(float (*d)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (*a)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
}

// Descriptor of an MN-major operand (its reduced dimension down the rows),
// one 64-column panel: 8-row groups PANELS x 1024 bytes apart. Both offset
// fields hold that stride (the other, between 64-column atoms, is unused
// at N = 64).
template <int PANELS>
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  constexpr uint64_t stride = (uint64_t)(PANELS * 1024 >> 4);
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 64, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 64), bf16,
// both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (*d)[4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = (accumulate ? d : 0) + A (64 x 16, bf16 fragments in
// registers, mma.sync's m16n8k16 A layout a warp) B (16 x 64), B MN-major
// in shared memory
__device__ __forceinline__ void wgmma_rs_t(float (*d)[4], const uint32_t* a, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// acc (64 x 64) = A . B^T over the W columns of two K-major tiles (A: the
// block's 64 rows, B: a walked tile of 64 rows); issue only
template <int W>
__device__ __forceinline__ void wg_scores(float (*acc)[4], const unsigned char* A,
                                          const unsigned char* B) {
  constexpr int P = (W + 63) / 64, KS = (W + 15) / 16;  // k steps that hold columns below W
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int off = (kk >> 2) * 1024 + (kk & 3) * 32;
    wgmma_ss(acc, desc_k<P>(A + off), desc_k<P>(B + off), kk > 0);
  }
}

// acc (64 x round64(W)) = A (64 x BN, bf16 fragments) . B (the walked tile,
// BN rows x W), a 64-column panel at a time; issue only
template <int W, int BN>
__device__ __forceinline__ void wg_accum(float (*acc)[4], uint32_t (*a)[4],
                                         const unsigned char* B) {
  constexpr int P = (W + 63) / 64;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_t(acc + 8 * p, a[kk], desc_mn<P>(B + kk * 2 * P * 1024 + p * 1024), kk > 0);
}

// the score fragments s (NT groups of 8 columns) as bf16 A fragments of
// NT / 2 k steps of 16
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], float (*s)[4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) p_frag16(s[2 * kk], s[2 * kk + 1], a[kk]);
}

// ---------------------------------------------------------------- sums

// Add this thread's fragment of W columns (rows rl and rl + 8 of the block's
// tile, columns n * 8 + 2t, + 1) into the f32 sums at acc (row stride W +
// 8, which keeps a half-warp's 8-byte accesses on distinct banks). Each
// element has one owner thread, so no barrier is needed.
template <int W>
__device__ __forceinline__ void add_sums(float* acc, float (*frag)[4], int rl, int t) {
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

// the block's sums (W columns, WR of them real) of this thread, scaled, into
// global memory (row stride ld), rows at or past `limit` skipped
template <int W, int WR, typename T>
__device__ __forceinline__ void store_sums(T* dst, long long ld, const float* acc, int row0,
                                           int rl, int t, int limit, float scale) {
  constexpr int LDA = W + 8;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= WR) continue;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = rl + 8 * h8;
      const float2 a = *reinterpret_cast<const float2*>(acc + r * LDA + col);
      if (row0 + r < limit) store2(dst + (row0 + r) * ld + col, a.x * scale, a.y * scale);
    }
  }
}

// the same sums, unscaled, into a part of the workspace (64 rows of ld f32)
template <int W, int WR>
__device__ __forceinline__ void store_part(float* dst, int ld, const float* acc, int rl, int t) {
  constexpr int LDA = W + 8;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= WR) continue;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = rl + 8 * h8;
      *reinterpret_cast<float2*>(dst + r * ld + col) =
          *reinterpret_cast<const float2*>(acc + r * LDA + col);
    }
  }
}

// register sums: sum[n] += frag[n], by rounded f32 adds
template <int N>
__device__ __forceinline__ void add_regs(float (*sum)[4], float (*frag)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] += frag[n][e];
}

// register sums of W columns (rows rl and rl + 8, columns n * 8 + 2t, + 1),
// scaled, into global memory, rows at or past `limit` skipped
template <int W, typename T>
__device__ __forceinline__ void store_regs(T* dst, long long ld, float (*sum)[4], int row0, int rl,
                                           int t, int limit, float scale) {
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 + rl < limit) store2(dst + (row0 + rl) * ld + col, sum[n][0] * scale, sum[n][1] * scale);
    if (row0 + rl + 8 < limit)
      store2(dst + (row0 + rl + 8) * ld + col, sum[n][2] * scale, sum[n][3] * scale);
  }
}

// the same, unscaled, into a part of the workspace (64 rows of ld f32)
template <int W>
__device__ __forceinline__ void store_regs_part(float* dst, int ld, float (*sum)[4], int rl, int t) {
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(dst + rl * ld + col) = make_float2(sum[n][0], sum[n][1]);
    *reinterpret_cast<float2*>(dst + (rl + 8) * ld + col) = make_float2(sum[n][2], sum[n][3]);
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv, int causal,
                                        int window) {
  return qi < Sq && kj < Skv && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// ---------------------------------------------------------------- kernels

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

// dK and dV of one part of one key tile's walk (kv head hk, batch row b):
// block item blockIdx.x / BHK, (b, hk) = blockIdx.x % BHK. Scores come
// transposed: s[n][e] is key (row rl or rl + 8 of the tile) against query
// n * 8 + 2t + (e & 1) of the walked tile.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
         float* __restrict__ ws, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
         Strides sdv, int BHK, int H, int HK, KvPlan pl, int n_kt, int slots, float scale,
         float scale_log2) {
  using C = BwdTile<T, D, DV>;
  constexpr int BN = C::BN, NT = C::NT, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Ks = smem_raw;
  if constexpr (C::WG) Ks += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* Vs = Ks + C::OWN_A;
  unsigned char* ring = Vs + C::OWN_B;
  float* lse_s = reinterpret_cast<float*>(ring + STAGES * C::STAGE);
  float* delta_s = lse_s + STAGES * BN;
  float* dk_s = delta_s + STAGES * BN;     // BM x (DA + 8) f32 sums of dK
  float* dv_s = dk_s + BM * (C::DA + 8);   // BM x (DVA + 8) f32 sums of dV

  const int bhk = blockIdx.x % BHK;
  int kt, part, np, slot;
  if (!find_item(pl, n_kt, blockIdx.x / BHK, kt, part, np, slot)) return;
  const int b = bhk / HK, hk = bhk % HK;
  const int Sq = pl.Sq, Skv = pl.Skv, causal = pl.causal, window = pl.window;
  const int k0 = kt * BM;
  int t0, TH;  // the first walked query tile, tiles a head
  pl.tiles(kt, t0, TH);
  const int L = pl.G * TH;
  const int s0 = (int)((long long)part * L / np);
  const int n = (int)((long long)(part + 1) * L / np) - s0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rl = warp * 16 + g;  // this thread's first row in the tile
  const int kr0 = k0 + rl;

  // step i of this part (walk step s0 + i) into ring stage i % STAGES
  auto load_step = [&](int i) {
    const int s = s0 + i, h = hk + (s / TH) * HK, q0 = (t0 + s % TH) * BN;
    unsigned char* st = ring + (i % STAGES) * C::STAGE;
    load_tile<T, D, BN>(st, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
    load_tile<T, DV, BN>(st + C::WALK_A, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
    const long long row = ((long long)b * H + h) * Sq;
    load_vec<BN>(lse_s + (i % STAGES) * BN, lse + row, q0, Sq);
    load_vec<BN>(delta_s + (i % STAGES) * BN, delta + row, q0, Sq);
  };

  load_tile<T, D, BM>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Skv);
  load_tile<T, DV, BM>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Skv);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load_step(i);
    cp_async_commit();
  }
  constexpr bool RS = C::REG_SUMS;
  float dks[RS ? D / 8 : 1][4] = {}, dvs[RS ? DV / 8 : 1][4] = {};  // REG_SUMS: the f32 sums
  if constexpr (!RS) {
    zero_sums<C::DA>(dk_s, rl, t);
    zero_sums<C::DVA>(dv_s, rl, t);
  }

  for (int i = 0; i < n; ++i) {
    if (i + STAGES - 1 < n) load_step(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // step i (and the own tiles) landed
    if constexpr (C::WG) fence_async_shared();
    __syncthreads();
    const unsigned char* Qs = ring + (i % STAGES) * C::STAGE;
    const unsigned char* dOs = Qs + C::WALK_A;
    const float* ls = lse_s + (i % STAGES) * BN;
    const float* ds = delta_s + (i % STAGES) * BN;
    const int q0 = (t0 + (s0 + i) % TH) * BN;
    const bool full = k0 + BM <= Skv && q0 + BN <= Sq && (!causal || k0 + BM - 1 <= q0) &&
                      (window <= 0 || q0 + BN - 1 - k0 < window);

    float s[NT][4] = {}, dp[NT][4] = {};
    if constexpr (C::WG) {
      keep<NT>(s);
      keep<NT>(dp);
      wgmma_fence();
      wg_scores<D>(s, Ks, Qs);     // S^T = K . Q^T
      wg_scores<DV>(dp, Vs, dOs);  // dP^T = V . dO^T
      wgmma_commit();
      wgmma_wait<0>();
      keep<NT>(s);
      keep<NT>(dp);
    } else {
      constexpr int LD = Row<T, D>::LD, LDV = Row<T, DV>::LD;
      qk<D, NT>(s, reinterpret_cast<const T*>(Ks) + warp * 16 * LD, reinterpret_cast<const T*>(Qs),
                g, t);
      qk<DV, NT>(dp, reinterpret_cast<const T*>(Vs) + warp * 16 * LDV,
                 reinterpret_cast<const T*>(dOs), g, t);
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nn * 8 + 2 * t + (e & 1);
        const bool ok = full || visible(q0 + ql, e < 2 ? kr0 : kr0 + 8, Sq, Skv, causal, window);
        const float p = ok ? exp2f(s[nn][e] * scale_log2 - ls[ql] * LOG2E) : 0.f;
        s[nn][e] = p;                               // P^T
        dp[nn][e] = p * (dp[nn][e] - ds[ql]);       // dS^T
      }
    }
    if constexpr (C::WG) {
      uint32_t pa[NT / 2][4], da[NT / 2][4];
      pack_a<NT>(pa, s);
      pack_a<NT>(da, dp);
      {
        float acc[C::DVA / 8][4] = {};
        keep<C::DVA / 8>(acc);
        wgmma_fence();
        wg_accum<DV, BN>(acc, pa, dOs);  // dV += P^T . dO
        wgmma_commit();
        wgmma_wait<0>();
        keep<C::DVA / 8>(acc);
        keep<NT / 2>(pa);
        add_sums<C::DVA>(dv_s, acc, rl, t);
      }
      {
        float acc[C::DA / 8][4] = {};
        keep<C::DA / 8>(acc);
        wgmma_fence();
        wg_accum<D, BN>(acc, da, Qs);    // dK += dS^T . Q
        wgmma_commit();
        wgmma_wait<0>();
        keep<C::DA / 8>(acc);
        keep<NT / 2>(da);
        add_sums<C::DA>(dk_s, acc, rl, t);
      }
    } else {
      {
        float acc[DV / 8][4] = {};
        pv<DV, BN, DV / 8, false>(acc, s, nullptr, reinterpret_cast<const T*>(dOs), g, t);
        if constexpr (RS) add_regs<DV / 8>(dvs, acc);
        else add_sums<DV>(dv_s, acc, rl, t);
      }
      {
        float acc[D / 8][4] = {};
        pv<D, BN, D / 8, false>(acc, dp, nullptr, reinterpret_cast<const T*>(Qs), g, t);
        if constexpr (RS) add_regs<D / 8>(dks, acc);
        else add_sums<D>(dk_s, acc, rl, t);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is filled again
  }
  cp_async_wait<0>();
  float* w = ws + ((long long)bhk * slots + slot + part) * (BM * (D + DV));
  if constexpr (RS) {
    if (np == 1) {
      store_regs<D>(dk + b * sdk.b + hk * sdk.h, sdk.s, dks, k0, rl, t, Skv, scale);
      store_regs<DV>(dv + b * sdv.b + hk * sdv.h, sdv.s, dvs, k0, rl, t, Skv, 1.f);
    } else {
      store_regs_part<D>(w, D + DV, dks, rl, t);
      store_regs_part<DV>(w + D, D + DV, dvs, rl, t);
    }
  } else if (np == 1) {
    store_sums<C::DA, D>(dk + b * sdk.b + hk * sdk.h, sdk.s, dk_s, k0, rl, t, Skv, scale);
    store_sums<C::DVA, DV>(dv + b * sdv.b + hk * sdv.h, sdv.s, dv_s, k0, rl, t, Skv, 1.f);
  } else {
    store_part<C::DA, D>(w, D + DV, dk_s, rl, t);
    store_part<C::DVA, DV>(w + D, D + DV, dv_s, rl, t);
  }
}

// dK and dV of the split key tiles: the parts' f32 sums added in part
// order, dK scaled. One block a REDUCE_ROWS-row block of a split key tile of
// a (batch row, kv head), so that the grid fills the card; each element is
// added as by one block a tile, so its bits do not depend on the grid.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(REDUCE_THREADS)
bwd_reduce(const float* __restrict__ ws, T* __restrict__ dk, T* __restrict__ dv, Strides sdk,
           Strides sdv, int BHK, int HK, KvPlan pl, int n_kt, int slots, float scale) {
  constexpr int W = D + DV, RB = BM / REDUCE_ROWS;
  static_assert(D % 4 == 0 && DV % 4 == 0, "four columns a thread, all of dK or of dV");
  const int bhk = blockIdx.x % BHK, rb = (blockIdx.x / BHK) % RB;
  int kt, np, slot;
  if (!find_split(pl, n_kt, blockIdx.x / BHK / RB, kt, np, slot)) return;
  const int b = bhk / HK, hk = bhk % HK, k0 = kt * BM;
  const float* w = ws + ((long long)bhk * slots + slot) * (BM * W);
  const int e_end = (rb + 1) * REDUCE_ROWS * W;
  for (int e = rb * REDUCE_ROWS * W + 4 * threadIdx.x; e < e_end; e += 4 * REDUCE_THREADS) {
    const int r = e / W, c = e % W;
    if (k0 + r >= pl.Skv) break;  // e grows with r
    float4 acc = *reinterpret_cast<const float4*>(w + e);
    for (int p = 1; p < np; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(w + (long long)p * BM * W + e);
      acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
    }
    if (c < D) {
      T* o = dk + b * sdk.b + hk * sdk.h + (long long)(k0 + r) * sdk.s + c;
      store2(o, acc.x * scale, acc.y * scale);
      store2(o + 2, acc.z * scale, acc.w * scale);
    } else {
      T* o = dv + b * sdv.b + hk * sdv.h + (long long)(k0 + r) * sdv.s + (c - D);
      store2(o, acc.x, acc.y);
      store2(o + 2, acc.z, acc.w);
    }
  }
}

// dQ of one query tile of one head, its key tiles walked in turn: s[n][e] is
// query (row rl or rl + 8 of the tile) against key n * 8 + 2t + (e & 1).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
       Strides sdo, Strides sdq, int BH, int H, int HK, int Sq, int Skv, int causal, int window,
       float scale, float scale_log2, int n_qtiles) {
  using C = BwdTile<T, D, DV>;
  constexpr int BN = C::BN, NT = C::NT, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw;
  if constexpr (C::WG) Qs += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* dOs = Qs + C::OWN_A;
  unsigned char* ring = dOs + C::OWN_B;
  float* lse_s = reinterpret_cast<float*>(ring + STAGES * C::STAGE);
  float* delta_s = lse_s + BM;
  float* dq_s = delta_s + BM;  // BM x (DA + 8) f32 sums of dQ

  // heaviest causal query tiles first: the tile index is the slowest grid index
  const int bh = blockIdx.x % BH, tq = blockIdx.x / BH;
  const int qt = causal ? n_qtiles - 1 - tq : tq;
  const int b = bh / H, h = bh % H, hk = h % HK;
  const int q0 = qt * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rl = warp * 16 + g;  // this thread's first row in the tile
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  // the keys that some query of the tile sees
  const int q_last = min(q0 + BM, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_first = (window > 0 ? max(0, q0 - window + 1) : 0) / BN * BN;
  const int n = kv_end > kv_first ? (kv_end - kv_first + BN - 1) / BN : 0;

  auto load_step = [&](int i) {
    unsigned char* st = ring + (i % STAGES) * C::STAGE;
    load_tile<T, D, BN>(st, kb, sk.s, kv_first + i * BN, Skv);
    load_tile<T, DV, BN>(st + C::WALK_A, vb, sv.s, kv_first + i * BN, Skv);
  };

  load_tile<T, D, BM>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile<T, DV, BM>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  load_vec<BM>(lse_s, lse + (long long)bh * Sq, q0, Sq);
  load_vec<BM>(delta_s, delta + (long long)bh * Sq, q0, Sq);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load_step(i);
    cp_async_commit();
  }
  constexpr bool RS = C::REG_SUMS;
  float dqs[RS ? D / 8 : 1][4] = {};  // REG_SUMS: the f32 sums
  if constexpr (!RS) zero_sums<C::DA>(dq_s, rl, t);

  for (int i = 0; i < n; ++i) {
    if (i + STAGES - 1 < n) load_step(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    if constexpr (C::WG) fence_async_shared();
    __syncthreads();
    const unsigned char* Ks = ring + (i % STAGES) * C::STAGE;
    const unsigned char* Vs = Ks + C::WALK_A;
    const int kv0 = kv_first + i * BN;
    const bool full = q0 + BM <= Sq && kv0 + BN <= Skv && (!causal || kv0 + BN - 1 <= q0) &&
                      (window <= 0 || q0 + BM - 1 - kv0 < window);

    float s[NT][4] = {}, dp[NT][4] = {};
    if constexpr (C::WG) {
      keep<NT>(s);
      keep<NT>(dp);
      wgmma_fence();
      wg_scores<D>(s, Qs, Ks);     // S = Q . K^T
      wg_scores<DV>(dp, dOs, Vs);  // dP = dO . V^T
      wgmma_commit();
      wgmma_wait<0>();
      keep<NT>(s);
      keep<NT>(dp);
    } else {
      constexpr int LD = Row<T, D>::LD, LDV = Row<T, DV>::LD;
      qk<D, NT>(s, reinterpret_cast<const T*>(Qs) + warp * 16 * LD, reinterpret_cast<const T*>(Ks),
                g, t);
      qk<DV, NT>(dp, reinterpret_cast<const T*>(dOs) + warp * 16 * LDV,
                 reinterpret_cast<const T*>(Vs), g, t);
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? rl : rl + 8;
        const int kj = kv0 + nn * 8 + 2 * t + (e & 1);
        const bool ok = full || visible(q0 + r, kj, Sq, Skv, causal, window);
        const float p = ok ? exp2f(s[nn][e] * scale_log2 - lse_s[r] * LOG2E) : 0.f;
        dp[nn][e] = p * (dp[nn][e] - delta_s[r]);  // dS
      }
    }
    if constexpr (C::WG) {
      uint32_t da[NT / 2][4];
      pack_a<NT>(da, dp);
      float acc[C::DA / 8][4] = {};
      keep<C::DA / 8>(acc);
      wgmma_fence();
      wg_accum<D, BN>(acc, da, Ks);  // dQ += dS . K
      wgmma_commit();
      wgmma_wait<0>();
      keep<C::DA / 8>(acc);
      keep<NT / 2>(da);
      add_sums<C::DA>(dq_s, acc, rl, t);
    } else {
      float acc[D / 8][4] = {};
      pv<D, BN, D / 8, false>(acc, dp, nullptr, reinterpret_cast<const T*>(Ks), g, t);
      if constexpr (RS) add_regs<D / 8>(dqs, acc);
      else add_sums<D>(dq_s, acc, rl, t);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if constexpr (RS) store_regs<D>(dq + b * sdq.b + h * sdq.h, sdq.s, dqs, q0, rl, t, Sq, scale);
  else store_sums<C::DA, D>(dq + b * sdq.b + h * sdq.h, sdq.s, dq_s, q0, rl, t, Sq, scale);
}

// ------------------------------------------------- (256, 256): the pairs
//
// A block of 8 warps owns 64 rows; warps w and w + 4 share rows 16 (w % 4)
// and each takes half of the 256 columns: its half of the score products'
// reduction, then its half of the gradients' columns. The two score halves
// meet through shared memory (one f32 add each, so both warps hold the same
// scores), and each warp keeps the f32 sums of its half of dK and dV (or
// dQ) in registers: 16 x 128 / 32 = 64 a gradient. In bf16 the two
// warpgroups (warps 0-3, 4-7) take their halves on wgmma: scores as
// m64n32k16 over their two 64-column panels, the gradients' tile products
// as m64n64k16 a panel with P and dS as A fragments from registers.

// the named barrier of the pair that holds rows 16 r4 .. 16 r4 + 15
__device__ __forceinline__ void pair_sync(int r4) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(r4 + 1) : "memory");
}

// s and dp (NT groups of 8 columns of this warp's half of the reduction)
// plus the partner's halves: each warp leaves its fragments in xch, the
// pair meets at its barrier, and each adds the other's (the block barrier
// before the next walked tile keeps xch from being written too early)
template <int NT>
__device__ __forceinline__ void pair_add(float (*s)[4], float (*dp)[4], float4* xch, int warp,
                                         int lane) {
  float4* mine = xch + warp * 2 * NT * 32 + lane;
  const float4* theirs = xch + (warp ^ 4) * 2 * NT * 32 + lane;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    mine[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    mine[(NT + n) * 32] = make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
  }
  pair_sync(warp & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 a = theirs[n * 32], c = theirs[(NT + n) * 32];
    s[n][0] += a.x, s[n][1] += a.y, s[n][2] += a.z, s[n][3] += a.w;
    dp[n][0] += c.x, dp[n][1] += c.y, dp[n][2] += c.z, dp[n][3] += c.w;
  }
}

// d (64 x 32, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 32), bf16,
// both K-major in shared memory
__device__ __forceinline__ void wgmma_ss32(float (*d)[4], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, "
      "1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// acc (64 x 32) = A . B^T over KS k steps of 16 columns of two K-major tiles
// of P panels (A: the block's 64 rows, B: a walked tile of 32 rows), from
// the panel at A and B on; issue only
template <int KS, int P>
__device__ __forceinline__ void wg_scores32(float (*acc)[4], const unsigned char* A,
                                            const unsigned char* B) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int off = (kk >> 2) * 1024 + (kk & 3) * 32;
    wgmma_ss32(acc, desc_k<P>(A + off), desc_k<P>(B + off), kk > 0);
  }
}

// sum (NPAN x 64 columns) += A (64 x BN, bf16 fragments) . X (the NPAN
// 64-column panels at X of a walked tile of P panels, BN rows), a panel a
// wgmma group: the tensor cores' sums cover one walked tile, then rounded
// f32 adds
template <int P, int NPAN, int BN>
__device__ __forceinline__ void wg_pair_accum(float (*sum)[4], uint32_t (*a)[4],
                                              const unsigned char* X) {
  float acc[8 * NPAN][4] = {};
  keep<8 * NPAN>(acc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NPAN; ++c)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_t(acc + 8 * c, a[kk], desc_mn<P>(X + kk * 2 * P * 1024 + c * 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  keep<8 * NPAN>(acc);
  keep<BN / 16>(a);
  add_regs<8 * NPAN>(sum, acc);
}

// f32: sum (NO x 8 columns) += P (the BN walked rows, from the score
// registers p) . X (the walked tile's columns at X, rows LD apart), 64
// columns at a time: the tensor cores' sums cover one walked tile, then
// rounded f32 adds
template <int BN, int NO, int LD>
__device__ __forceinline__ void pair_accum(float (*sum)[4], float (*p)[4], const float* X,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < NO / 8; ++c) {
    float acc[8][4] = {};
    pv<64, BN, 8, false, LD>(acc, p, nullptr, X + 64 * c, lane >> 2, lane & 3);
    add_regs<8>(sum + 8 * c, acc);
  }
}

// This warp's half of S = A . B^T and dP = A2 . B2^T, the own tiles (A, A2:
// 64 rows) against the walked ones (B, B2: BN rows), the half's columns from
// byte offset `half` of each row on (f32) or its two panels (bf16)
template <typename T, int HW, int NT, int P>
__device__ __forceinline__ void pair_scores(float (*s)[4], float (*dp)[4], const unsigned char* A,
                                            const unsigned char* B, const unsigned char* A2,
                                            const unsigned char* B2, int half, int warp,
                                            int lane) {
  if constexpr (IsBf16<T>::value) {
    keep<NT>(s);
    keep<NT>(dp);
    wgmma_fence();
    wg_scores32<HW / 16, P>(s, A + half, B + half);
    wg_scores32<HW / 16, P>(dp, A2 + half, B2 + half);
    wgmma_commit();
    wgmma_wait<0>();
    keep<NT>(s);
    keep<NT>(dp);
  } else {
    constexpr int LD = Row<T, 2 * HW>::LD;
    const int r0 = (warp & 3) * 16 * LD;
    qk<HW, NT, LD>(s, reinterpret_cast<const T*>(A + half) + r0,
                   reinterpret_cast<const T*>(B + half), lane >> 2, lane & 3);
    qk<HW, NT, LD>(dp, reinterpret_cast<const T*>(A2 + half) + r0,
                   reinterpret_cast<const T*>(B2 + half), lane >> 2, lane & 3);
  }
}

// This warp's half of the gradient columns: sum += P (the BN walked rows,
// from the score registers p) . X (the walked tile, its half at byte offset
// `half`)
template <typename T, int HW, int NT, int BN, int P>
__device__ __forceinline__ void pair_grad(float (*sum)[4], float (*p)[4], const unsigned char* X,
                                          int half, int lane) {
  if constexpr (IsBf16<T>::value) {
    uint32_t a[NT / 2][4];
    pack_a<NT>(a, p);
    wg_pair_accum<P, HW / 64, BN>(sum, a, X + half);
  } else {
    pair_accum<BN, HW / 8, Row<T, 2 * HW>::LD>(sum, p, reinterpret_cast<const T*>(X + half),
                                               lane);
  }
}

// dK and dV of one part of one key tile's walk, as bwd_dkdv, by pairs
template <typename T, int D, int DV>
__global__ void __launch_bounds__(PAIR_THREADS)
bwd_dkdv_pair(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ ws, Strides sq, Strides sk, Strides sv, Strides sdo,
              Strides sdk, Strides sdv, int BHK, int H, int HK, KvPlan pl, int n_kt, int slots,
              float scale, float scale_log2) {
  using C = BwdTile<T, D, DV>;
  static_assert(C::PAIR, "the pairs take (256, 256)");
  constexpr int HW = D / 2, BN = C::BN, NT = C::NT, P = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Ks = smem_raw;
  if constexpr (C::WG) Ks += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* Vs = Ks + C::OWN_A;
  unsigned char* ring = Vs + C::OWN_B;     // stage i: Q, then dO, BN rows each
  float* lse_s = reinterpret_cast<float*>(ring + 2 * C::STAGE);
  float* delta_s = lse_s + 2 * BN;
  float4* xch = reinterpret_cast<float4*>(delta_s + 2 * BN);

  const int bhk = blockIdx.x % BHK;
  int kt, part, np, slot;
  if (!find_item(pl, n_kt, blockIdx.x / BHK, kt, part, np, slot)) return;
  const int b = bhk / HK, hk = bhk % HK;
  const int Sq = pl.Sq, Skv = pl.Skv, causal = pl.causal, window = pl.window;
  const int k0 = kt * BM;
  int t0, TH;  // the first walked query tile, tiles a head
  pl.tiles(kt, t0, TH);
  const int L = pl.G * TH;
  const int s0 = (int)((long long)part * L / np);
  const int n = (int)((long long)(part + 1) * L / np) - s0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hc = (warp >> 2) * HW;           // this warp's half of the columns
  // its byte offset in a row: two 64-column panels in bf16's layout
  const int half = C::WG ? (warp >> 2) * 2 * 1024 : hc * (int)sizeof(T);
  const int rl = (warp & 3) * 16 + g;        // this thread's first row in the tile
  const int kr0 = k0 + rl;

  // step i of this part (walk step s0 + i) into ring stage i % 2
  auto load_step = [&](int i) {
    const int s = s0 + i, h = hk + (s / TH) * HK, q0 = (t0 + s % TH) * BN;
    unsigned char* st = ring + (i & 1) * C::STAGE;
    load_tile<T, D, BN, PAIR_THREADS>(st, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
    load_tile<T, DV, BN, PAIR_THREADS>(st + C::WALK_A, dout + b * sdo.b + h * sdo.h, sdo.s, q0,
                                       Sq);
    const long long row = ((long long)b * H + h) * Sq;
    load_vec<BN, PAIR_THREADS>(lse_s + (i & 1) * BN, lse + row, q0, Sq);
    load_vec<BN, PAIR_THREADS>(delta_s + (i & 1) * BN, delta + row, q0, Sq);
  };

  load_tile<T, D, BM, PAIR_THREADS>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, Skv);
  load_tile<T, DV, BM, PAIR_THREADS>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, Skv);
  if (n > 0) load_step(0);
  cp_async_commit();
  float dks[HW / 8][4] = {}, dvs[HW / 8][4] = {};  // the f32 sums of this warp's half

  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();  // step i (and the own tiles) landed
    if constexpr (C::WG) fence_async_shared();
    __syncthreads();     // for every thread; every warp is done with step i - 1's stage
    if (i + 1 < n) load_step(i + 1);
    cp_async_commit();
    const unsigned char* Qs = ring + (i & 1) * C::STAGE;
    const unsigned char* dOs = Qs + C::WALK_A;
    const float* ls = lse_s + (i & 1) * BN;
    const float* ds = delta_s + (i & 1) * BN;
    const int q0 = (t0 + (s0 + i) % TH) * BN;
    const bool full = k0 + BM <= Skv && q0 + BN <= Sq && (!causal || k0 + BM - 1 <= q0) &&
                      (window <= 0 || q0 + BN - 1 - k0 < window);

    float s[NT][4] = {}, dp[NT][4] = {};
    pair_scores<T, HW, NT, P>(s, dp, Ks, Qs, Vs, dOs, half, warp, lane);  // S^T, dP^T
    pair_add<NT>(s, dp, xch, warp, lane);
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nn * 8 + 2 * t + (e & 1);
        const bool ok = full || visible(q0 + ql, e < 2 ? kr0 : kr0 + 8, Sq, Skv, causal, window);
        const float p = ok ? exp2f(s[nn][e] * scale_log2 - ls[ql] * LOG2E) : 0.f;
        s[nn][e] = p;                               // P^T
        dp[nn][e] = p * (dp[nn][e] - ds[ql]);       // dS^T
      }
    }
    pair_grad<T, HW, NT, BN, P>(dvs, s, dOs, half, lane);   // dV += P^T . dO
    pair_grad<T, HW, NT, BN, P>(dks, dp, Qs, half, lane);   // dK += dS^T . Q
  }
  cp_async_wait<0>();
  if (np == 1) {
    store_regs<HW>(dk + b * sdk.b + hk * sdk.h + hc, sdk.s, dks, k0, rl, t, Skv, scale);
    store_regs<HW>(dv + b * sdv.b + hk * sdv.h + hc, sdv.s, dvs, k0, rl, t, Skv, 1.f);
  } else {
    float* w = ws + ((long long)bhk * slots + slot + part) * (BM * (D + DV));
    store_regs_part<HW>(w + hc, D + DV, dks, rl, t);
    store_regs_part<HW>(w + D + hc, D + DV, dvs, rl, t);
  }
}

// dQ of one query tile of one head, as bwd_dq, by pairs
template <typename T, int D, int DV>
__global__ void __launch_bounds__(PAIR_THREADS)
bwd_dq_pair(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dq, Strides sq, Strides sk,
            Strides sv, Strides sdo, Strides sdq, int BH, int H, int HK, int Sq, int Skv,
            int causal, int window, float scale, float scale_log2, int n_qtiles) {
  using C = BwdTile<T, D, DV>;
  static_assert(C::PAIR, "the pairs take (256, 256)");
  constexpr int HW = D / 2, BN = C::BN, NT = C::NT, P = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw;
  if constexpr (C::WG) Qs += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* dOs = Qs + C::OWN_A;
  unsigned char* ring = dOs + C::OWN_B;    // stage i: K, then V, BN rows each
  float* lse_s = reinterpret_cast<float*>(ring + 2 * C::STAGE);
  float* delta_s = lse_s + BM;
  float4* xch = reinterpret_cast<float4*>(delta_s + BM);

  // heaviest causal query tiles first: the tile index is the slowest grid index
  const int bh = blockIdx.x % BH, tq = blockIdx.x / BH;
  const int qt = causal ? n_qtiles - 1 - tq : tq;
  const int b = bh / H, h = bh % H, hk = h % HK;
  const int q0 = qt * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hc = (warp >> 2) * HW;           // this warp's half of the columns
  const int half = C::WG ? (warp >> 2) * 2 * 1024 : hc * (int)sizeof(T);
  const int rl = (warp & 3) * 16 + g;        // this thread's first row in the tile
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  // the keys that some query of the tile sees
  const int q_last = min(q0 + BM, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_first = (window > 0 ? max(0, q0 - window + 1) : 0) / BN * BN;
  const int n = kv_end > kv_first ? (kv_end - kv_first + BN - 1) / BN : 0;

  auto load_step = [&](int i) {
    unsigned char* st = ring + (i & 1) * C::STAGE;
    load_tile<T, D, BN, PAIR_THREADS>(st, kb, sk.s, kv_first + i * BN, Skv);
    load_tile<T, DV, BN, PAIR_THREADS>(st + C::WALK_A, vb, sv.s, kv_first + i * BN, Skv);
  };

  load_tile<T, D, BM, PAIR_THREADS>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile<T, DV, BM, PAIR_THREADS>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  load_vec<BM, PAIR_THREADS>(lse_s, lse + (long long)bh * Sq, q0, Sq);
  load_vec<BM, PAIR_THREADS>(delta_s, delta + (long long)bh * Sq, q0, Sq);
  if (n > 0) load_step(0);
  cp_async_commit();
  float dqs[HW / 8][4] = {};  // the f32 sums of this warp's half

  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    if constexpr (C::WG) fence_async_shared();
    __syncthreads();
    if (i + 1 < n) load_step(i + 1);
    cp_async_commit();
    const unsigned char* Ks = ring + (i & 1) * C::STAGE;
    const unsigned char* Vs = Ks + C::WALK_A;
    const int kv0 = kv_first + i * BN;
    const bool full = q0 + BM <= Sq && kv0 + BN <= Skv && (!causal || kv0 + BN - 1 <= q0) &&
                      (window <= 0 || q0 + BM - 1 - kv0 < window);

    float s[NT][4] = {}, dp[NT][4] = {};
    pair_scores<T, HW, NT, P>(s, dp, Qs, Ks, dOs, Vs, half, warp, lane);  // S, dP
    pair_add<NT>(s, dp, xch, warp, lane);
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? rl : rl + 8;
        const int kj = kv0 + nn * 8 + 2 * t + (e & 1);
        const bool ok = full || visible(q0 + r, kj, Sq, Skv, causal, window);
        const float p = ok ? exp2f(s[nn][e] * scale_log2 - lse_s[r] * LOG2E) : 0.f;
        dp[nn][e] = p * (dp[nn][e] - delta_s[r]);  // dS
      }
    }
    pair_grad<T, HW, NT, BN, P>(dqs, dp, Ks, half, lane);   // dQ += dS . K
  }
  cp_async_wait<0>();
  store_regs<HW>(dq + b * sdq.b + h * sdq.h + hc, sdq.s, dqs, q0, rl, t, Sq, scale);
}

template <typename T, int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, float* ws,
               const long long* st, int chunk, int slots, int B, int H, int HK, int Sq, int Skv,
               int causal, int window, float scale, void* const* events, cudaStream_t stream) {
  using C = BwdTile<T, D, DV>;
  static size_t allowed_kv[MAX_DEVICES] = {}, allowed_q[MAX_DEVICES] = {};
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const KvPlan pl{Sq, Skv, H / HK, causal, window, C::BN, chunk};
  const int n_kt = (Skv + BM - 1) / BM;
  long long items = 0, split = 0, need = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int np = pl.parts(kt);
    items += np;
    if (np > 1) {
      ++split;
      need += np;
    }
  }
  // the workspace the wrapper allocated for the plan: slots f32 parts of 64
  // x (D + Dv) for each (batch row, kv head)
  if (need != slots || (slots > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const void* kv_kernel;
  const void* q_kernel;
  if constexpr (C::PAIR) {
    kv_kernel = (const void*)bwd_dkdv_pair<T, D, DV>;
    q_kernel = (const void*)bwd_dq_pair<T, D, DV>;
  } else {
    kv_kernel = (const void*)bwd_dkdv<T, D, DV>;
    q_kernel = (const void*)bwd_dq<T, D, DV>;
  }
  cudaError_t err = allow_smem(kv_kernel, C::SMEM_KV, allowed_kv);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(q_kernel, C::SMEM_Q, allowed_q);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]};
  const Strides so{st[9], st[10], st[11]}, sdo{st[12], st[13], st[14]};
  const Strides sdq{st[15], st[16], st[17]}, sdk{st[18], st[19], st[20]};
  const Strides sdv{st[21], st[22], st[23]};
  const long long rows = (long long)B * H * Sq;
  const long long delta_blocks = (rows * 32 + DELTA_THREADS - 1) / DELTA_THREADS;
  const long long kv_blocks = items * B * HK;
  const long long reduce_blocks = split * B * HK * (BM / REDUCE_ROWS);
  const int n_qtiles = (Sq + BM - 1) / BM;
  const long long q_blocks = (long long)B * H * n_qtiles;
  if (delta_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL ||
      reduce_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  auto mark = [&](int i) {
    if (events != nullptr) cudaEventRecord((cudaEvent_t)events[i], stream);
  };
  mark(0);
  bwd_delta<T, DV><<<(unsigned)delta_blocks, DELTA_THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, so, sdo, H, Sq, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mark(1);
  if constexpr (C::PAIR)
    bwd_dkdv_pair<T, D, DV><<<(unsigned)kv_blocks, PAIR_THREADS, C::SMEM_KV, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, ws,
        sq, sk, sv, sdo, sdk, sdv, B * HK, H, HK, pl, n_kt, slots, scale, scale_log2);
  else
    bwd_dkdv<T, D, DV><<<(unsigned)kv_blocks, THREADS, C::SMEM_KV, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, ws,
        sq, sk, sv, sdo, sdk, sdv, B * HK, H, HK, pl, n_kt, slots, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mark(2);
  if (reduce_blocks > 0) {
    bwd_reduce<T, D, DV><<<(unsigned)reduce_blocks, REDUCE_THREADS, 0, stream>>>(
        ws, (T*)dk, (T*)dv, sdk, sdv, B * HK, HK, pl, n_kt, slots, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  mark(3);
  if constexpr (C::PAIR)
    bwd_dq_pair<T, D, DV><<<(unsigned)q_blocks, PAIR_THREADS, C::SMEM_Q, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, sq, sk, sv,
        sdo, sdq, B * H, H, HK, Sq, Skv, causal, window, scale, scale_log2, n_qtiles);
  else
    bwd_dq<T, D, DV><<<(unsigned)q_blocks, THREADS, C::SMEM_Q, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, sq, sk, sv,
        sdo, sdq, B * H, H, HK, Sq, Skv, causal, window, scale, scale_log2, n_qtiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mark(4);
  return (int)cudaSuccess;
}

}  // namespace

// The instances, dtype 0 = float32, 1 = bfloat16, (D, Dv) as below.
#define FA_BWD_INSTANCES(X)             \
  X(0, float, 64, 64)                   \
  X(0, float, 128, 128)                 \
  X(0, float, 192, 128)                 \
  X(0, float, 48, 32)                   \
  X(0, float, 256, 256)                 \
  X(1, __nv_bfloat16, 64, 64)           \
  X(1, __nv_bfloat16, 128, 128)         \
  X(1, __nv_bfloat16, 192, 128)         \
  X(1, __nv_bfloat16, 48, 32)           \
  X(1, __nv_bfloat16, 256, 256)

// The dK/dV pass's split of a call on a card of `sms` SMs (plan_split):
// out[0] the chunk, the most walked tiles a dK/dV block takes; out[1] the
// workspace parts of one (batch row, kv head), f32 64 x (D + Dv) each;
// out[2] the longest block's walk in tiles. Returns 0, or the CUDA error
// code of an invalid shape or a (D, Dv, dtype) without an instance.
extern "C" int flash_attention_bwd_plan(int B, int H, int HK, int Sq, int Skv, int D, int Dv,
                                        int dtype, int causal, int window, int sms, int* out) {
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK != 0 || Sq <= 0 || Skv <= 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
#define FA_BWD_PLAN(DT, T, DQK, DVO)                                                   \
  if (dtype == DT && D == DQK && Dv == DVO) {                                          \
    const KvPlan pl = plan_split<T, DQK, DVO>(B, H, HK, Sq, Skv, causal, window, sms); \
    out[0] = pl.chunk;                                                                 \
    out[1] = split_slots(pl, (Skv + BM - 1) / BM, &out[2]);                            \
    return (int)cudaSuccess;                                                           \
  }
  FA_BWD_INSTANCES(FA_BWD_PLAN)
#undef FA_BWD_PLAN
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. D: the head dim of q and k, Dv: that of
// v, o and dO; (D, Dv) one of (64, 64), (128, 128), (192, 128), (48, 32) and
// (256, 256).
// strides: (b, h, s) element strides of q, k, v, o, dO, dq, dk and dv, in
// that order; q, k, v and dO, and their s strides, must be 16-byte aligned
// (the wrapper sees to it). lse: the forward's contiguous (B, H, Sq) f32
// log-sum-exp; delta: a contiguous (B, H, Sq) f32 scratch buffer. chunk and
// slots: flash_attention_bwd_plan's out[0] and out[1] for this call (slots
// is checked against the chunk); ws: the workspace of B x HK x slots parts
// of 64 x (D + Dv) f32 (null when slots is 0). window <= 0 means no window.
// events: null, or five CUDA events recorded on `stream` before the delta
// pre-pass and after each of the delta, dK/dV, reduce (when a key tile is
// split) and dQ kernels' launches, to time each apart. Launches the four
// kernels on `stream`; returns the CUDA error code of the launches (0 =
// launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, float* ws, const long long* strides,
                                   int chunk, int slots, int B, int H, int HK, int Sq, int Skv,
                                   int D, int Dv, int dtype, int causal, int window, float scale,
                                   void* const* events, void* stream) {
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_BWD_INSTANCE(DT, T, DQK, DVO)                                                       \
  if (dtype == DT && D == DQK && Dv == DVO)                                                    \
    return launch_bwd<T, DQK, DVO>(q, k, v, o, dout, lse, delta, dq, dk, dv, ws, strides,      \
                                   chunk, slots, B, H, HK, Sq, Skv, causal, window, scale,     \
                                   events, s);
  FA_BWD_INSTANCES(FA_BWD_INSTANCE)
#undef FA_BWD_INSTANCE
  return (int)cudaErrorInvalidValue;
}
