// gather_distance: neighbor-row gather + fused distance, for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gather_distance/kernel.py::gather_distance_pallas
//   (body _gather_distance_kernel), which pulls one row per grid step by DMA
//   into a double-buffered VMEM slot.
//
// What it computes: for each (query b, slot j) with id = ids[b, j],
//   l2: sum_k (x[id, k] - q[b, k])^2      ip: -sum_k x[id, k] * q[b, k]
// The id is clipped into [0, n-1] before the load, and an id < 0 writes +inf,
// exactly as the TPU kernel does.
//
// What bounds it on an H100: bytes.  Each output costs one random d-float row
// read (512 B at d = 128) and 2-3 flops per element, far below the card's
// operations-per-byte balance.  At the search path's shape (B = 256 queries,
// M = 32 neighbours, d = 128) the whole call moves about 4.3 MB, so its bound
// is about 1.3 us at 3.35 TB/s; one launch costs more than that, so launch
// overhead dominates at this shape.
//
// Design: one warp per (query, neighbour).  The warp reads the row
// coalesced (one float4 per lane when d % 4 == 0, so one 512 B transaction
// group at d = 128), does the elementwise work in registers and reduces with
// warp shuffles; lane 0 writes the result.  Rows are gathers, so there is no
// tile for TMA to move and no reuse for shared memory to serve.  No
// allocation, no synchronisation; launched on the caller's stream.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kIp, bool kVec4>
__global__ void gather_distance_kernel(const int* __restrict__ ids,
                                       const float* __restrict__ q,
                                       const float* __restrict__ x,
                                       float* __restrict__ out,
                                       long long total, int m, int n, int d) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= total) return;  // whole warp leaves together
  const long long b = warp / m;
  const int id = ids[warp];
  const int row = min(max(id, 0), n - 1);
  const float* xr = x + static_cast<long long>(row) * d;
  const float* qr = q + b * d;
  float acc = 0.f;
  if (kVec4) {
    const float4* xr4 = reinterpret_cast<const float4*>(xr);
    const float4* qr4 = reinterpret_cast<const float4*>(qr);
    for (int k = lane; k < (d >> 2); k += 32) {
      const float4 a = __ldg(xr4 + k);
      const float4 c = __ldg(qr4 + k);
      if (kIp) {
        acc += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      } else {
        const float e0 = a.x - c.x, e1 = a.y - c.y, e2 = a.z - c.z,
                    e3 = a.w - c.w;
        acc += e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3;
      }
    }
  } else {
    for (int k = lane; k < d; k += 32) {
      const float a = __ldg(xr + k);
      const float c = __ldg(qr + k);
      if (kIp) {
        acc += a * c;
      } else {
        const float e = a - c;
        acc += e * e;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    out[warp] = id >= 0 ? (kIp ? -acc : acc) : CUDART_INF_F;
  }
}

template <bool kIp>
void launch(const int* ids, const float* q, const float* x, float* out,
            long long total, int m, int n, int d, cudaStream_t stream) {
  const int threads = kWarpsPerBlock * 32;
  const long long blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec4 = (d % 4) == 0 &&
                    (reinterpret_cast<unsigned long long>(x) % 16) == 0 &&
                    (reinterpret_cast<unsigned long long>(q) % 16) == 0;
  if (vec4) {
    gather_distance_kernel<kIp, true><<<static_cast<unsigned>(blocks), threads,
                                        0, stream>>>(ids, q, x, out, total, m,
                                                     n, d);
  } else {
    gather_distance_kernel<kIp, false><<<static_cast<unsigned>(blocks),
                                         threads, 0, stream>>>(ids, q, x, out,
                                                               total, m, n, d);
  }
}

}  // namespace

// C entry point.  ids (b, m) int32, q (b, d) f32, x (n, d) f32, out (b, m)
// f32, all contiguous on the current device; metric_ip 0 = l2, 1 = ip.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_gather_distance(const void* ids, const void* q,
                                     const void* x, void* out, int b, int m,
                                     int n, int d, int metric_ip,
                                     void* stream) {
  const long long total = static_cast<long long>(b) * m;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (metric_ip) {
    launch<true>(static_cast<const int*>(ids), static_cast<const float*>(q),
                 static_cast<const float*>(x), static_cast<float*>(out), total,
                 m, n, d, s);
  } else {
    launch<false>(static_cast<const int*>(ids), static_cast<const float*>(q),
                  static_cast<const float*>(x), static_cast<float*>(out),
                  total, m, n, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
