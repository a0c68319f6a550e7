// Flash decode: one query token per (batch row, head) over a ring KV cache.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode
// (_decode_kernel). q is (B, H, D) and k, v are (B, HK, C, D) ring caches,
// each given by its strides with d contiguous, so the model's (B, C, HK, D)
// cache layers are read in place. Query head h reads kv head h % HK, as the
// TPU kernel's index map does. Slot s holds position pos - ((pos - s) mod C);
// it is visible when that position is >= 0 and, with a window, when
// pos - position < window. m, l and the output accumulator are f32; the
// denominator is clamped at 1e-30; the output has q's type.
//
// What bounds it on the H100: decode reads the visible part of the cache
// once for one query. On qwen2-0.5b's decode path (f32, B=8, H=14, HK=2,
// C=576, D=64) k and v are 4.7 MB, 1.4 us at 3.35 TB/s, against 16.5 MFLOP;
// on recurrentgemma-2b's (B=2, H=10, HK=1, a full ring of C=2048 under its
// 2048 window, D=256) 8.4 MB, 2.5 us. The kernel is bound by bytes, and at
// these sizes by the latency of getting them in flight on enough SMs.
//
// The design:
//  - Head grouping: one block per (batch row, kv head, split), holding the
//    G = H / HK query heads that read kv head hk. Under h % HK these are
//    h = hk, hk + HK, hk + 2 HK, ... (not the contiguous h // G group). Each
//    cache row is read once for G dot products. (G above 16 is cut into
//    groups of 16, each its own block.)
//  - Splits: the visible slots form one arc of the ring ending at slot
//    pos % C; the kernel walks it by distance from the query, slot =
//    (pos - dist) mod C for dist < nvis = min(pos + 1, C, window). Masked
//    slots are never read, no split is wholly masked, and the arc may wrap
//    past slot 0 inside a chunk, since every row's address is its own. The
//    wrapper cuts the arc into chunks of 8-64 rows and the chunks into
//    splits so that batch x kv heads x splits fills the 132 SMs about once:
//    9 splits of one 64-row chunk on qwen2's path (144 blocks), 64 splits of
//    two 16-row chunks on recurrentgemma's (128 blocks). More splits would
//    shorten each block's walk but lengthen the merge, which one block does
//    over G x D floats a split.
//  - Loads: K and V rows of a chunk are issued together as 16-byte cp.async
//    copies into a two-stage shared ring, so V is not behind the softmax
//    and the next chunk lands while this one is used.
//  - Merge: each split writes its (m, l, acc[G][D]) partial to a workspace;
//    after a __threadfence, the last block of a (b, hk) to finish (an
//    atomicAdd on a per-(b, hk) counter) merges the partials with weights
//    exp2(m_s - m_all) / sum_s exp2(m_s - m_all) l_s, writes o and resets
//    its counter to 0. A call stays one launch. The counters are shared
//    between calls, so launches that use one workspace must be ordered:
//    the wrapper keeps one workspace per stream, made once at the size
//    every plan fits in (so a CUDA graph's captured pointers stay valid).
//    A single split writes o directly.
//  - Scores are kept in log2 units (q is pre-scaled by scale * log2 e), so
//    the softmax uses exp2. m starts at the finite -1e30, so alpha =
//    exp2(m_prev - m_new) is never inf - inf.
// Head dims 32, 64, 128 and 256.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128, WARPS = THREADS / 32, GMAX = 16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
struct Dec {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int LD = D + VEC;          // padded ring row, in elements
  static constexpr int CPR = D / VEC;         // 16-byte pieces per row
  static constexpr int DQ = D / 4;            // 4-element columns of a row
  static constexpr int HG = THREADS / DQ;     // head groups in the PV product
  static constexpr int NJ = (GMAX + HG - 1) / HG;
};

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 x, float s) {
  from_f(x.x * s, p);
  from_f(x.y * s, p + 1);
  from_f(x.z * s, p + 2);
  from_f(x.w * s, p + 3);
}

// floats before the ring in shared memory: q (gu x D), scores (gu x chunk),
// m, l, alpha (gu each) and the last-block flag, rounded to 16 bytes
__host__ __device__ inline int head_floats(int gu, int D, int chunk) {
  return (gu * D + gu * chunk + 3 * gu + 1 + 3) & ~3;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides sq, Strides sk, Strides sv, int H, int HK, int NG, int C,
             int pos, int nvis, int chunk, int per_split, int splits, float scale_log2,
             float* __restrict__ part, int* __restrict__ counters) {
  using P = Dec<T, D>;
  constexpr int LD = P::LD, DQ = P::DQ, HG = P::HG, NJ = P::NJ;
  const int sp = blockIdx.x, hk = blockIdx.y / NG, gi = blockIdx.y % NG, b = blockIdx.z;
  const int G = H / HK, j0 = gi * GMAX, gu = min(GMAX, G - j0);
  const int units = gridDim.y * gridDim.z, unit = (b * HK + hk) * NG + gi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // q of the group's heads, x scale * log2 e
  float* sc = qs + gu * D;           // scores, then probabilities, [j][row]
  float* ms = sc + gu * chunk;
  float* ls = ms + gu;
  float* as = ls + gu;
  int* last = reinterpret_cast<int*>(as + gu);
  T* ring = reinterpret_cast<T*>(smem + head_floats(gu, D, chunk));

  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int nchunks = (nvis + chunk - 1) / chunk;
  const int c_begin = sp * per_split, c_end = min(c_begin + per_split, nchunks);
  const int slot0 = pos % C;
  auto issue = [&](int c, int stage) {
    const int d0 = c * chunk, rows = min(chunk, nvis - d0);
    T* Kd = ring + stage * 2 * chunk * LD;
    T* Vd = Kd + chunk * LD;
    for (int i = tid; i < rows * P::CPR; i += THREADS) {
      const int r = i / P::CPR, col = (i % P::CPR) * P::VEC;
      int slot = slot0 - (d0 + r);
      if (slot < 0) slot += C;
      cp_async16(Kd + r * LD + col, kb + slot * sk.s + col, 16);
      cp_async16(Vd + r * LD + col, vb + slot * sv.s + col, 16);
    }
    cp_async_commit();
  };

  // scores: P = THREADS / chunk threads per row, each a strided part of D;
  // PV: thread (head group hg, 4-column pc) owns heads hg, hg + HG, ...
  const int parts = THREADS / chunk, sr = tid / parts, spp = tid % parts;
  const int pc = tid % DQ, hg = tid / DQ;
  float acc[NJ][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;

  if (c_begin < c_end) issue(c_begin, 0);  // in flight while q is read
  for (int i = tid; i < gu * D; i += THREADS) {
    const int j = i / D, d = i % D;
    qs[i] = to_f(q[b * sq.b + (hk + (j0 + j) * HK) * sq.h + d]) * scale_log2;
  }
  if (tid < gu) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }
  for (int c = c_begin; c < c_end; ++c) {
    const int st = (c - c_begin) & 1;
    if (c + 1 < c_end) {
      issue(c + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(chunk, nvis - c * chunk);
    const T* Ks = ring + st * 2 * chunk * LD;
    const T* Vs = Ks + chunk * LD;

    float s[GMAX];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) s[j] = 0.f;
    if (sr < rows) {
      for (int i = spp; i < DQ; i += parts) {
        const float4 kv = load4(Ks + sr * LD + 4 * i);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j < gu) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + j * D + 4 * i);
            s[j] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[j]))));
          }
        }
      }
    }
    for (int off = parts >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < GMAX; ++j)
        if (j < gu) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);  // gu: same in the block
    }
    if (spp == 0 && sr < rows) {
#pragma unroll
      for (int j = 0; j < GMAX; ++j)
        if (j < gu) sc[j * chunk + sr] = s[j];
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int j = warp; j < gu; j += WARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sc[j * chunk + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(ms[j], mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = exp2f(sc[j * chunk + r] - m_new);
        sc[j * chunk + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(ms[j] - m_new);
        ls[j] = ls[j] * alpha + sum;
        ms[j] = m_new;
        as[j] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = hg + HG * jj;
      if (j < gu) {
        const float alpha = as[j];
        float4 a = make_float4(acc[jj][0] * alpha, acc[jj][1] * alpha, acc[jj][2] * alpha,
                               acc[jj][3] * alpha);
        const float* pj = sc + j * chunk;
        for (int r = 0; r < rows; ++r) {
          const float p = pj[r];
          const float4 vv = load4(Vs + r * LD + 4 * pc);
          a.x = fmaf(p, vv.x, a.x);
          a.y = fmaf(p, vv.y, a.y);
          a.z = fmaf(p, vv.z, a.z);
          a.w = fmaf(p, vv.w, a.w);
        }
        acc[jj][0] = a.x;
        acc[jj][1] = a.y;
        acc[jj][2] = a.z;
        acc[jj][3] = a.w;
      }
    }
    __syncthreads();  // the stage, the scores and alpha are free again
  }

  if (splits == 1) {
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = hg + HG * jj;
      if (j < gu) {
        const int h = hk + (j0 + j) * HK;
        store4(o + ((long long)b * H + h) * D + 4 * pc,
               make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]),
               1.f / fmaxf(ls[j], 1e-30f));
      }
    }
    return;
  }

  // partial of this split: acc [units][splits][GMAX][D], then (m, l)
  // [units][splits][GMAX][2]
  float* pacc = part + ((long long)unit * splits + sp) * GMAX * D;
  float* pml_all = part + (long long)units * splits * GMAX * D;
  float* pml = pml_all + ((long long)unit * splits + sp) * GMAX * 2;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = hg + HG * jj;
    if (j < gu)
      *reinterpret_cast<float4*>(pacc + j * D + 4 * pc) =
          make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
  }
  if (tid < gu) {
    pml[2 * tid] = ms[tid];
    pml[2 * tid + 1] = ls[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counters + unit, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // the last block of this (b, hk, group): weights w[s][j] into the ring.
  // The loops over splits are unrolled so that many L2 reads are in flight.
  float* w = reinterpret_cast<float*>(ring);
  const float2* um = reinterpret_cast<const float2*>(pml_all) + (long long)unit * splits * GMAX;
  for (int j = warp; j < gu; j += WARPS) {
    float mx = NEG_INF;
#pragma unroll 4
    for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, __ldcg(um + s * GMAX + j).x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float den = 0.f;
#pragma unroll 4
    for (int s = lane; s < splits; s += 32) {
      const float2 ml = __ldcg(um + s * GMAX + j);
      const float e = exp2f(ml.x - mx);
      w[s * gu + j] = e;
      den = fmaf(e, ml.y, den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    const float inv = 1.f / fmaxf(den, 1e-30f);
    for (int s = lane; s < splits; s += 32) w[s * gu + j] *= inv;
  }
  __syncthreads();
  // splits outermost, every head of the thread inside: up to 4 x NJ reads
  // in flight a thread
  const float* uacc = part + (long long)unit * splits * GMAX * D;
  float4 a[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) a[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = hg + HG * jj;
      if (j < gu) {
        const float wt = w[s * gu + j];
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(uacc + (s * GMAX + j) * D + 4 * pc));
        a[jj].x = fmaf(wt, x.x, a[jj].x);
        a[jj].y = fmaf(wt, x.y, a[jj].y);
        a[jj].z = fmaf(wt, x.z, a[jj].z);
        a[jj].w = fmaf(wt, x.w, a[jj].w);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = hg + HG * jj;
    if (j < gu) store4(o + ((long long)b * H + hk + (j0 + j) * HK) * D + 4 * pc, a[jj], 1.f);
  }
  if (tid == 0) counters[unit] = 0;  // ready for the next call on this stream
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
           int H, int HK, int C, int pos, int nvis, int chunk, int per_split, int splits,
           float scale, float* part, int* counters, cudaStream_t stream) {
  // a chunk's rows are split over THREADS / chunk threads, each taking whole
  // 4-element columns
  if (chunk < 8 || chunk > THREADS || (chunk & (chunk - 1)) || THREADS / chunk > D / 4)
    return (int)cudaErrorInvalidValue;
  const int G = H / HK, NG = (G + GMAX - 1) / GMAX, GU = G < GMAX ? G : GMAX;
  const size_t ring = 2 * 2 * (size_t)chunk * Dec<T, D>::LD * sizeof(T);
  const size_t weights = (size_t)splits * GU * sizeof(float);
  const size_t smem = sizeof(float) * head_floats(GU, D, chunk) + (ring > weights ? ring : weights);
  static size_t allowed[MAX_DEVICES] = {};  // one record per instantiation
  cudaError_t err = allow_smem((const void*)flash_decode<T, D>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], 0}, sk{st[2], st[3], st[4]}, sv{st[5], st[6], st[7]};
  const dim3 grid(splits, HK * NG, B);
  flash_decode<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, H, HK, NG, C, pos, nvis, chunk,
      per_split, splits, scale * LOG2E, part, counters);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o, const long long* st,
             int B, int H, int HK, int C, int pos, int nvis, int chunk, int per_split, int splits,
             float scale, float* part, int* counters, cudaStream_t s) {
  if (D == 32)
    return launch<T, 32>(q, k, v, o, st, B, H, HK, C, pos, nvis, chunk, per_split, splits, scale,
                         part, counters, s);
  if (D == 64)
    return launch<T, 64>(q, k, v, o, st, B, H, HK, C, pos, nvis, chunk, per_split, splits, scale,
                         part, counters, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, st, B, H, HK, C, pos, nvis, chunk, per_split, splits,
                          scale, part, counters, s);
  if (D == 256)
    return launch<T, 256>(q, k, v, o, st, B, H, HK, C, pos, nvis, chunk, per_split, splits,
                          scale, part, counters, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// geometry: 18 int64 values, fixed for the layers of a decode step, so the
// wrapper builds them once and a call converts six arguments, not twenty:
//   [0:8)   the (b, h) element strides of q, then (b, h, s) of k and of v;
//           every pointer and s stride of k and v must be 16-byte aligned
//           (the wrapper sees to it);
//   [8:14)  B, H, HK, C, D, dtype (0 = float32, 1 = bfloat16);
//   [14:18) nvis, chunk, per_split, splits: nvis = min(pos + 1, C, window)
//           slots are visible, cut into chunks of `chunk` rows, `per_split`
//           chunks to a split, `splits` splits per (b, kv head).
// o is a contiguous (B, H, D) buffer. With splits > 1, `part` holds B x HK x
// ceil(G / 16) x splits x 16 x (D + 2) floats and `counters` B x HK x
// ceil(G / 16) ints, all 0 before the first call (each call leaves them 0).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                                const long long* geometry, int pos, float scale, void* part,
                                void* counters, void* stream) {
  const long long* g = geometry + 8;
  for (int i = 0; i < 10; ++i)
    if (g[i] < 0 || g[i] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int B = (int)g[0], H = (int)g[1], HK = (int)g[2], C = (int)g[3], D = (int)g[4];
  const int dtype = (int)g[5], nvis = (int)g[6], chunk = (int)g[7], per_split = (int)g[8];
  const int splits = (int)g[9];
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK != 0 || C <= 0 || pos < 0 || nvis <= 0 ||
      nvis > C || nvis > pos + 1 || per_split <= 0 || splits <= 0 ||
      (long long)per_split * (splits - 1) * chunk >= nvis ||
      (long long)per_split * splits * chunk < nvis || B > 65535 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long NG = (H / HK + GMAX - 1) / GMAX;
  if (HK * NG > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, geometry, B, H, HK, C, pos, nvis, chunk, per_split,
                           splits, scale, (float*)part, (int*)counters, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, geometry, B, H, HK, C, pos, nvis, chunk,
                                   per_split, splits, scale, (float*)part, (int*)counters, s);
  return (int)cudaErrorInvalidValue;
}
