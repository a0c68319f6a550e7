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
// (a and gx read, h written). On the split path (B=4, S=512, W=2560) that is
// 63 MB, ~0.019 ms at 3.35 TB/s, against 5.2 M FMAs, nothing at 67 TFLOP/s:
// the kernel is bound by bytes. The recurrence is sequential in S and
// parallel in (b, w) only, so one thread walks S for one channel: 10,240
// threads on that path, 160 blocks of 64 for 132 SMs. A warp's loads of one
// step are 32 neighbouring floats of a row (coalesced along W). The step's
// chain is one FMA, so the time goes to waiting on loads: each thread loads
// a chunk of U steps of a and gx (2U independent loads in flight) before it
// runs the chunk's FMAs and stores. Later work: a chunked two-pass scan
// over S (each chunk's local scan and product of a, then the carried state)
// to put more threads and loads in flight, and bf16 inputs.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;  // steps loaded ahead per chunk

__global__ void __launch_bounds__(THREADS)
rglru_scan(const float* __restrict__ a, const float* __restrict__ gx, float* __restrict__ y,
           float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const long long base = (long long)b * S * W + w;  // (b, 0, w)
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float av[U], gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = t0 + u < S;
      const long long off = base + (long long)(t0 + u) * W;
      av[u] = ok ? a[off] : 0.f;
      gv[u] = ok ? gx[off] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        h = fmaf(av[u], h, gv[u]);
        y[base + (long long)(t0 + u) * W] = h;
      }
    }
  }
  h_last[(long long)b * W + w] = h;
}

}  // namespace

// a, gx and y are contiguous (B, S, W) float32 buffers, h_last a contiguous
// (B, W) float32 one. Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int rglru_scan_fwd(const void* a, const void* gx, void* y, void* h_last, int B, int S,
                              int W, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)gx, (float*)y, (float*)h_last, S, W);
  return (int)cudaGetLastError();
}
