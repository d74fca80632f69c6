// gather_distance: neighbor-row gather + fused distance, for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gather_distance/kernel.py::gather_distance_pallas
//   (body _gather_distance_kernel), which pulls one row per grid step by DMA
//   into a double-buffered VMEM slot.
//
// What it computes: for each (query b, slot j) with id = ids[b, j],
//   l2: sum_k (x[id, k] - q[b, k])^2      ip: -sum_k x[id, k] * q[b, k]
// An id >= n is clipped to n - 1 before the load, and an id < 0 writes +inf,
// exactly as the TPU kernel does.
//
// What bounds it on an H100: bytes, and at the search path's shape the
// latency of one launch.  Each output costs one random d-float row read
// (512 B at d = 128) and 2-3 flops per element, far below the card's
// operations-per-byte balance.  At B = 256 queries, M = 32 neighbours,
// d = 128 a call moves about 4 MB, about 1.2 us at 3.35 TB/s: less than a
// launch, so the time is the launch plus two dependent DRAM round trips
// (ids, then rows) and the rows' transfer.
//
// Design: one CTA per query, ceil(M / 4) warps (at most 8), each warp owning
// 4 of the query's M slots at a time.  A warp loads its 4 ids with one
// coalesced load (lane r takes slot r, then shuffles), issues the loads of
// all 4 rows before it uses any (one float4 per lane per row at d = 128: 4
// independent 16 B loads in flight a lane, beside the query's float4, read
// once a warp through the read-only cache), accumulates 4 partial sums in
// registers, reduces them with warp shuffles, and lane r writes slot r.
// Rows of ids < 0 are never read.  A scalar variant serves d % 4 != 0 or
// q, x not 16 B aligned.  Rows are gathers, so there is no tile for TMA to
// move.  More rows a warp (8) or fewer (1, 2) were no faster.  No shared
// memory, no barrier, no allocation; launched on the caller's stream.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 4;       // slots a warp owns at a time
constexpr int kMaxWarps = 8;   // warps a CTA

template <bool kIp, bool kVec4>
__global__ void gather_distance_kernel(const int* __restrict__ ids,
                                       const float* __restrict__ q,
                                       const float* __restrict__ x,
                                       float* __restrict__ out, int m, int n,
                                       int d) {
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int* ib = ids + b * m;
  const float* qb = q + b * d;
  float* ob = out + b * m;
  for (int g = warp * kRows; g < m; g += warps * kRows) {
    const int my_id = lane < kRows && g + lane < m ? ib[g + lane] : -1;
    int id[kRows];
    const float* xr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      id[r] = __shfl_sync(0xffffffffu, my_id, r);
      xr[r] = x + static_cast<long long>(min(max(id[r], 0), n - 1)) * d;
    }
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    if (kVec4) {
      for (int k = lane; k < (d >> 2); k += 32) {
        float4 a[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          a[r] = id[r] >= 0
                     ? __ldg(reinterpret_cast<const float4*>(xr[r]) + k)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float4 c = __ldg(reinterpret_cast<const float4*>(qb) + k);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (kIp) {
            acc[r] += a[r].x * c.x + a[r].y * c.y + a[r].z * c.z +
                      a[r].w * c.w;
          } else {
            const float e0 = a[r].x - c.x, e1 = a[r].y - c.y,
                        e2 = a[r].z - c.z, e3 = a[r].w - c.w;
            acc[r] += e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3;
          }
        }
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        float a[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          a[r] = id[r] >= 0 ? __ldg(xr[r] + k) : 0.f;
        }
        const float c = __ldg(qb + k);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (kIp) {
            acc[r] += a[r] * c;
          } else {
            const float e = a[r] - c;
            acc[r] += e * e;
          }
        }
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      if (lane == r) mine = acc[r];
    }
    if (lane < kRows && g + lane < m) {
      ob[g + lane] = my_id >= 0 ? (kIp ? -mine : mine) : CUDART_INF_F;
    }
  }
}

template <bool kIp, bool kVec4>
int launch(const int* ids, const float* q, const float* x, float* out, int b,
           int m, int n, int d, cudaStream_t stream) {
  const int groups = (m + kRows - 1) / kRows;
  const int warps = groups < kMaxWarps ? groups : kMaxWarps;
  gather_distance_kernel<kIp, kVec4><<<b, warps * 32, 0, stream>>>(
      ids, q, x, out, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

template <bool kIp>
int launch_metric(const int* ids, const float* q, const float* x, float* out,
                  int b, int m, int n, int d, cudaStream_t stream) {
  const bool vec4 = (d % 4) == 0 &&
                    (reinterpret_cast<unsigned long long>(x) % 16) == 0 &&
                    (reinterpret_cast<unsigned long long>(q) % 16) == 0;
  return vec4 ? launch<kIp, true>(ids, q, x, out, b, m, n, d, stream)
              : launch<kIp, false>(ids, q, x, out, b, m, n, d, stream);
}

}  // namespace

// C entry point.  ids (b, m) int32, q (b, d) f32, x (n, d) f32, out (b, m)
// f32, all contiguous on the current device; metric_ip 0 = l2, 1 = ip;
// n >= 1.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_gather_distance(const void* ids, const void* q,
                                     const void* x, void* out, int b, int m,
                                     int n, int d, int metric_ip,
                                     void* stream) {
  if (static_cast<long long>(b) * m == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(ids);
  auto qf = static_cast<const float*>(q);
  auto xf = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  return metric_ip ? launch_metric<true>(i, qf, xf, o, b, m, n, d, s)
                   : launch_metric<false>(i, qf, xf, o, b, m, n, d, s);
}
