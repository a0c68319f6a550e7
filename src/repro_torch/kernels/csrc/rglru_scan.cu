// RG-LRU diagonal linear recurrence: h_t = a_t * h_{t-1} + gx_t, h_{-1} = 0.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::rglru_scan
// (_rglru_kernel). a and gx are contiguous (B, S, W) float32 tensors (the
// gates of the Griffin recurrent mixer, already computed in f32); h_seq is
// written as a contiguous (B, S, W) float32 tensor and h_last, the state
// after the last step, as a contiguous (B, W) one. Any S >= 1 and any W: the
// kernel masks the ragged chunk of steps and the ragged channel tile itself,
// where the TPU kernel asserts S % bc == 0 and W % bw == 0, so the
// scheduler's left-padded cohorts of any length need no padding copy.
//
// What bounds it on the H100: per (b, t, w) one multiply-add on 12 bytes
// (a and gx read, h written). At recurrentgemma-2b's split shape (B=4,
// S=512, W=2560) that is 63 MB, 0.0188 ms at 3.35 TB/s; at its 2304-token
// prefill (2, 2304, 2560) 0.0423 ms. The FMAs are nothing: the kernel is
// bound by bytes, and the bytes come in only if enough loads are in flight
// (Little's law: ~25 KB an SM at ~1 us of loaded latency).
//
// The design: one block per tile of TILE = 32 channels of one batch row
// (one 128-byte segment of a row per step: coalesced), parallel in S inside
// the block, one launch, every element read once and written once.
// - The block walks S in chunks of 16 x warps steps. Warp j owns steps
//   [16 j, 16 j + 16) of each chunk; its lane is the channel.
// - Each thread issues all 32 loads of its 16 steps (evict-first: a and gx
//   are read once), and, walking, the next chunk's 32 before it folds the
//   current chunk's into its local pair (P = prod a, H = h from 0), so two
//   chunks' loads are in flight (64 KB a block of 8 warps).
// - The warps' pairs meet in shared memory: each warp's carry-in is the
//   chunk's carry with the pairs of the warps before it applied in order,
//   (a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2).
// - Each thread re-walks its 16 steps in registers from its carry-in and
//   stores h coalesced; the last warp's final state is the next chunk's
//   carry. The pairs and the carry are kept by chunk parity, so a chunk
//   costs one barrier.
// Where S fits one chunk of at most 32 warps (S <= 512: the split path, the
// scheduler's cohorts) the block takes all of S and loads nothing ahead.
// Nothing outlives the launch: every call and a CUDA-graph replay compute
// the same FMAs in the same order.
//
// Choices measured on the H100 (PERF.md): in a sweep, 16 steps a warp (32 loads in
// flight a thread) beat 8 and matched 32; chaining a tile's chunks across
// blocks in the same launch (a decoupled look-back, or a plain chained
// carry, through a workspace of chunk states) was slower at every path
// shape than one block walking its tile, and faster only where the tiles
// are far fewer than the SMs (one tile of 8192 steps); a walking thread
// holds two chunks (121 registers), so the wrapper's plan gives a
// walking block 16 warps where the tiles fit one an SM, 8 where two, else
// 4; evict-first loads helped where a, gx and h_seq exceed the 50 MB L2.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int TILE = 32;         // channels a block owns
constexpr int STEPS = 16;        // steps a warp owns in a chunk
constexpr int MAX_WARPS = 32;    // warps of a block that takes all of S
constexpr int WALK_WARPS = 16;   // warps of a block that walks chunks

template <bool WALK>
__global__ void __launch_bounds__(WALK ? WALK_WARPS * 32 : MAX_WARPS * 32)
rglru_scan(const float* __restrict__ a, const float* __restrict__ gx, float* __restrict__ y,
           float* __restrict__ h_last, int S, int W, int tiles) {
  __shared__ float sp[2][MAX_WARPS][TILE], sh[2][MAX_WARPS][TILE];
  __shared__ float s_carry[2][TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int b = blockIdx.x / tiles, w = (blockIdx.x - b * tiles) * TILE + lane;
  const bool live = w < W;
  const long long chunk = (long long)nw * STEPS, row = (long long)b * S * W + w;
  const long long chunks = WALK ? (S + chunk - 1) / chunk : 1;

  // steps past S (and channels past W) are the identity
  float av[STEPS], gv[STEPS];
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const long long t = (long long)warp * STEPS + u;
    const bool ok = live && t < S;
    av[u] = ok ? __ldcs(a + row + t * W) : 1.f;  // read once: evict first
    gv[u] = ok ? __ldcs(gx + row + t * W) : 0.f;
  }
  if (threadIdx.x < TILE) s_carry[0][threadIdx.x] = 0.f;
  for (long long c = 0; c < chunks; ++c) {
    const long long t0 = c * chunk + warp * STEPS;  // this warp's first step
    const int k = (int)(c & 1);
    // the next chunk's loads, in flight while this one is folded
    float an[STEPS], gn[STEPS];
    if (WALK) {
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const long long t = t0 + chunk + u;
        const bool ok = live && t < S;
        an[u] = ok ? __ldcs(a + row + t * W) : 1.f;
        gn[u] = ok ? __ldcs(gx + row + t * W) : 0.f;
      }
    }
    float P = 1.f, H = 0.f;
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      H = fmaf(av[u], H, gv[u]);
      P *= av[u];
    }
    sp[k][warp][lane] = P;
    sh[k][warp][lane] = H;
    __syncthreads();

    // this warp's carry-in (the warps before it applied to the chunk's
    // carry), then the re-walk from it
    float h = s_carry[k][lane];
    for (int j = 0; j < warp; ++j) h = fmaf(sp[k][j][lane], h, sh[k][j][lane]);
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      h = fmaf(av[u], h, gv[u]);
      if (live && t0 + u < S) y[row + (t0 + u) * W] = h;
    }
    if (warp == nw - 1) s_carry[k ^ 1][lane] = h;
    if (live && t0 <= S - 1 && S - 1 < t0 + STEPS) h_last[(long long)b * W + w] = h;
    if (WALK) {
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        av[u] = an[u];
        gv[u] = gn[u];
      }
    }
  }
}

// ---------------------------------------------------------------- backward
//
// The gradient of the recurrence (from h = 0) for a train step on the card;
// the TPU kernel has no backward (the JAX package differentiates its jnp
// scan). With g the gradient of h_t:
//   g_t = dy_t + a_{t+1} g_{t+1}  (g_{S-1} = dy_{S-1} + dh_last);
//   dgx_t = g_t;  da_t = g_t h_{t-1}  (h_{-1} = 0, h read from the forward's h_seq).
// This is the forward's recurrence run backwards in time with a shifted by
// one step, so the kernel is the forward's plan over reversed time r = S -
// 1 - t: step r combines a'_r = a_{t+1} (0 at r = 0, where the carry is 0)
// and g'_r = dy_t (+ dh_last at r = 0); steps past the sequence's start are
// the identity. da's product is fused into the re-walk, its h_{t-1} loaded
// there. What bounds it on the H100: bytes, 5 x 4 B a (b, t, w) (a, h_seq
// and dy read, da and dgx written): 105 MB at recurrentgemma-2b's train
// shape (4, 512, 2560), ~0.031 ms at 3.35 TB/s. A block takes at most
// BWD_WARPS warps (a re-walking thread holds a chunk of h besides the
// forward's two of loads); as in the forward, a walking block is smaller
// where the tiles outnumber the SMs. Nothing is summed across threads: every
// call gives the same bits.
constexpr int BWD_WARPS = 16;

template <bool WALK>
__global__ void __launch_bounds__(BWD_WARPS * 32)
rglru_scan_bwd(const float* __restrict__ a, const float* __restrict__ hs,
               const float* __restrict__ dy, const float* __restrict__ dh_last,
               float* __restrict__ da, float* __restrict__ dgx, int S, int W, int tiles) {
  __shared__ float sp[2][BWD_WARPS][TILE], sh[2][BWD_WARPS][TILE];
  __shared__ float s_carry[2][TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int b = blockIdx.x / tiles, w = (blockIdx.x - b * tiles) * TILE + lane;
  const bool live = w < W;
  const long long chunk = (long long)nw * STEPS, row = (long long)b * S * W + w;
  const long long chunks = WALK ? (S + chunk - 1) / chunk : 1;
  const float dhl = live && dh_last != nullptr ? dh_last[(long long)b * W + w] : 0.f;

  // reversed step r (time t = S - 1 - r): (a_{t+1}, dy_t), the identity past t = 0
  auto load = [&](long long r, float& av, float& gv) {
    const long long t = S - 1 - r;
    const bool ok = live && t >= 0;
    av = ok && r > 0 ? __ldcs(a + row + (t + 1) * W) : (ok ? 0.f : 1.f);
    gv = ok ? __ldcs(dy + row + t * W) + (r == 0 ? dhl : 0.f) : 0.f;
  };
  float av[STEPS], gv[STEPS];
#pragma unroll
  for (int u = 0; u < STEPS; ++u) load((long long)warp * STEPS + u, av[u], gv[u]);
  if (threadIdx.x < TILE) s_carry[0][threadIdx.x] = 0.f;
  for (long long c = 0; c < chunks; ++c) {
    const long long r0 = c * chunk + warp * STEPS;  // this warp's first reversed step
    const int k = (int)(c & 1);
    float an[STEPS], gn[STEPS];
    if (WALK) {
#pragma unroll
      for (int u = 0; u < STEPS; ++u) load(r0 + chunk + u, an[u], gn[u]);
    }
    float P = 1.f, H = 0.f;
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      H = fmaf(av[u], H, gv[u]);
      P *= av[u];
    }
    sp[k][warp][lane] = P;
    sh[k][warp][lane] = H;
    __syncthreads();

    float g = s_carry[k][lane];
    for (int j = 0; j < warp; ++j) g = fmaf(sp[k][j][lane], g, sh[k][j][lane]);
    float hv[STEPS];  // h_{t-1} of each step
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const long long t = S - 1 - (r0 + u);
      hv[u] = live && t >= 1 ? __ldcs(hs + row + (t - 1) * W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      g = fmaf(av[u], g, gv[u]);
      const long long t = S - 1 - (r0 + u);
      if (live && t >= 0) {
        __stcs(dgx + row + t * W, g);
        __stcs(da + row + t * W, g * hv[u]);
      }
    }
    if (warp == nw - 1) s_carry[k ^ 1][lane] = g;
    if (WALK) {
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        av[u] = an[u];
        gv[u] = gn[u];
      }
    }
  }
}

}  // namespace

// a, gx and y are contiguous (B, S, W) float32 buffers, h_last a contiguous
// (B, W) float32 one; warps the plan's warps a block (a chunk is 16 x warps
// steps; one chunk takes up to MAX_WARPS, a walk up to WALK_WARPS). One
// block a (b, tile). Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int rglru_scan_fwd(const void* a, const void* gx, void* y, void* h_last, int B,
                              int S, int W, int warps, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || warps < 1 || warps > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const int tiles = (W + TILE - 1) / TILE;
  const long long blocks = (long long)B * tiles;
  const bool walk = S > (long long)STEPS * warps;
  if (blocks > INT_MAX || (walk && warps > WALK_WARPS)) return (int)cudaErrorInvalidValue;
  const auto kernel = walk ? rglru_scan<true> : rglru_scan<false>;
  kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)gx, (float*)y, (float*)h_last, S, W, tiles);
  return (int)cudaGetLastError();
}

// The backward. a, h_seq (the forward's output), dy, da and dgx are
// contiguous (B, S, W) float32 buffers; dh_last null or the (B, W) gradient
// of h_last. warps: the plan's warps a block, at most BWD_WARPS (16); a
// chunk is 16 x warps steps of reversed time. One block a (b, tile).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int rglru_scan_bwd(const void* a, const void* h_seq, const void* dy,
                              const void* dh_last, void* da, void* dgx, int B, int S, int W,
                              int warps, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || warps < 1 || warps > BWD_WARPS)
    return (int)cudaErrorInvalidValue;
  const int tiles = (W + TILE - 1) / TILE;
  const long long blocks = (long long)B * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool walk = S > (long long)STEPS * warps;
  const auto kernel = walk ? rglru_scan_bwd<true> : rglru_scan_bwd<false>;
  kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h_seq, (const float*)dy, (const float*)dh_last, (float*)da,
      (float*)dgx, S, W, tiles);
  return (int)cudaGetLastError();
}
