// filtered_topk: masked score + exact top-k over a corpus, for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/filtered_topk/kernel.py::filtered_topk_pallas
//   (body _topk_block_kernel), which scores a (query tile, corpus tile) on the
//   MXU, takes a tile-local top-k by k argmax passes (k <= 64), and leaves the
//   reduction over tiles to lax.top_k in ops.py.
//
// What it computes: for each query b, the k best rows of x among those with
// mask[b, row] set, ordered by (score descending, id ascending), where
//   l2: score = 2 q.x - |x|^2   (returned as |q|^2 - score)
//   ip: score = q.x             (returned as is: +q.x, as the reference does)
// Slots past the last passing row get id -1 and score -inf (so l2 returns
// +inf and ip -inf there, as the reference's plain route does).
//
// What bounds it on an H100: bytes.  Only rows that pass some query's mask
// must be read, so a call needs the mask (B n bytes) plus those rows (d
// floats each).  At the two-tower path's shape (B = 1, n = 2^20, d = 256,
// one of 12 labels passing) that is about 1 MB of mask and 89 MB of rows,
// some 27 us at 3.35 TB/s; the fp32 work (2 d flops per passing row and
// query) is far below the card's balance point.
//
// Design, two kernels on the caller's stream:
//   tile_topk_kernel   one CTA per (query, corpus tile of up to 8192 rows).
//       It loads the tile's mask bytes coalesced and compacts the passing
//       rows into shared memory (warp ballot + one shared atomic per warp),
//       so masked rows are never read.  Each warp then scores four passing
//       rows at a time (lanes split d, float4 loads when d % 4 == 0 and x is
//       16 B aligned, warp-shuffle sums) and stores a 64-bit key
//       (order-preserving score bits << 32 | ~id), so one unsigned compare
//       ranks by score and breaks ties to the lower id.  Only the first
//       max(K2, next_pow2(passing)) keys are ranked (the rest are 0, below
//       any real key): a bitonic sort of runs of K2 = next_pow2(k) keys, then
//       pairwise merges that keep the top K2 of two sorted runs
//       (max(A[i], B[K2-1-i]) then a bitonic half-cleaner).  The tile writes
//       its top K2 keys.
//   topk_merge_kernel  one CTA per (query, group of up to 16384 / K2 tile
//       lists) merges them the same way; rounds repeat until one list is
//       left, and the last round decodes the top k into ids and dists.
// k is capped at kMaxK = 256.  Scratch (the tile lists) is allocated by the
// caller; see repro_filtered_topk_workspace.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxK = 256;           // largest k this kernel takes
constexpr int kMaxTile = 8192;       // corpus rows per tile CTA
constexpr int kMinTile = 64;
constexpr int kMergeKeys = 16384;    // keys one merge CTA holds (128 KB)
constexpr int kThreads = 1024;
constexpr int kRows = 4;             // passing rows a warp scores at once
constexpr uint32_t kNegInfOrd = 0x007FFFFFu;   // ordered(-inf)
constexpr int kSmemLimit = 232448;   // opt-in shared memory of one H100 block

typedef unsigned long long Key;

__host__ __device__ inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// float -> uint32 whose unsigned order is the float order (-0 ties +0)
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = (f == 0.f) ? 0u : __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ Key make_key(float s, long long id) {
  return (static_cast<Key>(ordered(s)) << 32) |
         static_cast<Key>(0xFFFFFFFFu - static_cast<uint32_t>(id));
}

// Sort every run of k2 keys of keys[0, m) descending (bitonic network;
// m and k2 powers of two, k2 <= m).  Block-wide.
__device__ void sort_runs_desc(Key* keys, int m, int k2) {
  for (int size = 2; size <= k2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < (m >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (stride - 1));
        const int j = i + stride;
        const bool desc = ((i & (k2 - 1)) & size) == 0;
        const Key a = keys[i], b = keys[j];
        if ((a < b) == desc) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// keys[0, lists * k2) holds `lists` (a power of two) runs of k2 keys, each
// sorted descending.  Leaves the top k2 of all of them, sorted descending,
// in keys[0, k2).  Block-wide.
__device__ void merge_runs_desc(Key* keys, int lists, int k2) {
  const int lg = __ffs(k2) - 1;
  for (int span = 1; span < lists; span <<= 1) {
    const int pairs = lists / (2 * span);
    // A = run 2 span g, B = the run span after it: A[i] = max(A[i],
    // B[k2-1-i]) leaves the top k2 of A and B in A as a bitonic sequence
    for (int t = threadIdx.x; t < (pairs << lg); t += blockDim.x) {
      Key* a = keys + (static_cast<long long>(2 * span * (t >> lg)) << lg);
      const int i = t & (k2 - 1);
      const Key bv = a[(span << lg) + k2 - 1 - i];
      if (bv > a[i]) a[i] = bv;
    }
    __syncthreads();
    // bitonic half-cleaners sort each A descending
    for (int stride = k2 >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (pairs << (lg - 1)); t += blockDim.x) {
        Key* a = keys + (static_cast<long long>(2 * span * (t >> (lg - 1)))
                         << lg);
        const int p = t & ((k2 >> 1) - 1);
        const int i = 2 * p - (p & (stride - 1));
        const int j = i + stride;
        const Key x = a[i], y = a[j];
        if (x < y) {
          a[i] = y;
          a[j] = x;
        }
      }
      __syncthreads();
    }
  }
}

template <bool kIp, bool kVec4>
__global__ void __launch_bounds__(kThreads, 1)
tile_topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const unsigned char* __restrict__ mask,
                 Key* __restrict__ out, int n, int d, int tile, int k2) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* keys = reinterpret_cast<Key*>(smem);                    // tile keys
  float* qs = reinterpret_cast<float*>(keys + tile);           // d floats
  unsigned short* rows =
      reinterpret_cast<unsigned short*>(qs + ((d + 3) & ~3));  // tile rows
  __shared__ int count;

  const int b = blockIdx.x;
  const long long base = static_cast<long long>(blockIdx.y) * tile;
  const int valid = static_cast<int>(min(static_cast<long long>(tile),
                                         static_cast<long long>(n) - base));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) count = 0;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    qs[i] = q[static_cast<long long>(b) * d + i];
  }
  __syncthreads();

  // compact the tile's passing rows (order is free: keys carry the id)
  const unsigned char* mrow = mask + static_cast<long long>(b) * n + base;
  for (int i0 = 0; i0 < tile; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool pass = i < valid && mrow[i] != 0;
    const unsigned ball = __ballot_sync(0xffffffffu, pass);
    int slot = 0;
    if (lane == 0 && ball != 0u) slot = atomicAdd(&count, __popc(ball));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (pass) {
      rows[slot + __popc(ball & ((1u << lane) - 1u))] =
          static_cast<unsigned short>(i);
    }
  }
  __syncthreads();
  const int cnt = count;
  const int m = max(k2, next_pow2(cnt));   // <= tile

  // score the passing rows, kRows per warp in flight
  for (int i = warp * kRows; i < cnt; i += nwarps * kRows) {
    bool on[kRows];
    const float* xr[kRows];
    float qx[kRows], xn[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      on[u] = i + u < cnt;
      xr[u] = x + (base + (on[u] ? rows[i + u] : 0)) * d;
      qx[u] = 0.f;
      xn[u] = 0.f;
    }
    if (kVec4) {
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      for (int c = lane; c < (d >> 2); c += 32) {
        const float4 qv = q4[c];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (on[u]) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(xr[u]) + c);
            qx[u] += a.x * qv.x + a.y * qv.y + a.z * qv.z + a.w * qv.w;
            if (!kIp) xn[u] += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
          }
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float qv = qs[c];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (on[u]) {
            const float a = __ldg(xr[u] + c);
            qx[u] += a * qv;
            if (!kIp) xn[u] += a * a;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        qx[u] += __shfl_xor_sync(0xffffffffu, qx[u], off);
        if (!kIp) xn[u] += __shfl_xor_sync(0xffffffffu, xn[u], off);
      }
      if (lane == u && on[u]) {
        const float s = kIp ? qx[u] : 2.f * qx[u] - xn[u];
        keys[i + u] = make_key(s, base + rows[i + u]);
      }
    }
  }
  for (int i = cnt + threadIdx.x; i < m; i += blockDim.x) keys[i] = 0ull;
  __syncthreads();

  sort_runs_desc(keys, m, k2);
  merge_runs_desc(keys, m / k2, k2);
  Key* dst = out + (static_cast<long long>(b) * gridDim.y + blockIdx.y) * k2;
  for (int i = threadIdx.x; i < k2; i += blockDim.x) dst[i] = keys[i];
}

// Merge `group` (a power of two) consecutive lists of k2 keys per query
// into one.  Not the last round: write the top k2 keys to out_keys
// (b, gridDim.y, k2).  The last round (gridDim.y == 1, out_keys null):
// decode the top k into ids / dists.
__global__ void __launch_bounds__(kThreads, 1)
topk_merge_kernel(const Key* __restrict__ in, int lists, int k2, int group,
                  Key* __restrict__ out_keys, const float* __restrict__ q,
                  int d, int k, int metric_ip, int* __restrict__ ids,
                  float* __restrict__ dists) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* keys = reinterpret_cast<Key*>(smem);
  __shared__ float qn;
  const int b = blockIdx.x;
  const int first = blockIdx.y * group;
  const long long avail =
      static_cast<long long>(min(group, lists - first)) * k2;
  const Key* src = in + (static_cast<long long>(b) * lists + first) * k2;
  for (int i = threadIdx.x; i < group * k2; i += blockDim.x) {
    keys[i] = i < avail ? src[i] : 0ull;
  }
  __syncthreads();
  merge_runs_desc(keys, group, k2);

  if (out_keys != nullptr) {
    Key* dst =
        out_keys + (static_cast<long long>(b) * gridDim.y + blockIdx.y) * k2;
    for (int i = threadIdx.x; i < k2; i += blockDim.x) dst[i] = keys[i];
    return;
  }
  if (!metric_ip && threadIdx.x < 32) {
    float acc = 0.f;
    for (int c = threadIdx.x; c < d; c += 32) {
      const float v = q[static_cast<long long>(b) * d + c];
      acc += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (threadIdx.x == 0) qn = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const Key key = keys[i];
    const uint32_t hi = static_cast<uint32_t>(key >> 32);
    const float s = hi <= kNegInfOrd ? -CUDART_INF_F : unordered(hi);
    const int id =
        static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    const long long o = static_cast<long long>(b) * k + i;
    ids[o] = isfinite(s) ? id : -1;
    dists[o] = metric_ip ? s : qn - s;
  }
}

struct Plan {
  int tile, k2, lists, group;
};

Plan make_plan(int n, int k) {
  Plan p;
  p.k2 = next_pow2(k);
  p.tile = std::min(std::max(next_pow2(n), kMinTile), kMaxTile);
  p.lists = (n + p.tile - 1) / p.tile;
  p.group = kMergeKeys / p.k2;
  return p;
}

template <bool kIp, bool kVec4>
cudaError_t launch_tiles(const float* q, const float* x,
                         const unsigned char* mask, Key* out, int b, int n,
                         int d, const Plan& p, cudaStream_t stream) {
  const int smem = p.tile * 8 + 4 * ((d + 3) & ~3) + 2 * p.tile;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tile_topk_kernel<kIp, kVec4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tile_topk_kernel<kIp, kVec4>
      <<<dim3(b, p.lists), kThreads, smem, stream>>>(q, x, mask, out, n, d,
                                                     p.tile, p.k2);
  return cudaGetLastError();
}

cudaError_t launch_merge(const Key* in, int lists, int group, Key* out_keys,
                         int groups, const float* q, int b, int d, int k,
                         int metric_ip, int* ids, float* dists, int k2,
                         cudaStream_t stream) {
  const int smem = group * k2 * 8;
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<dim3(b, groups), kThreads, smem, stream>>>(
      in, lists, k2, group, out_keys, q, d, k, metric_ip, ids, dists);
  return cudaGetLastError();
}

}  // namespace

// Scratch the call needs, in 64-bit words: the tile lists (b, lists, K2)
// and, when one merge round is not enough, the first round's output.
extern "C" long long repro_filtered_topk_workspace(int b, int n, int k) {
  if (b <= 0 || n <= 0 || k <= 0) return 0;
  const Plan p = make_plan(n, k);
  const int second = p.lists > p.group ? (p.lists + p.group - 1) / p.group
                                       : 0;
  return static_cast<long long>(b) * (p.lists + second) * p.k2;
}

// C entry point.  q (b, d) f32, x (n, d) f32, mask (b, n) bool (1 byte),
// ids (b, k) int32 and dists (b, k) f32 outputs, workspace of
// repro_filtered_topk_workspace(b, n, k) 64-bit words; all contiguous on
// the current device; 1 <= k <= min(n, 256); metric_ip 0 = l2, 1 = ip.
// Returns the first cudaError_t of its launches (0 = all launched).
extern "C" int repro_filtered_topk(const void* q, const void* x,
                                   const void* mask, void* ids, void* dists,
                                   void* workspace, int b, int n, int d, int k,
                                   int metric_ip, void* stream) {
  if (b == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  if (k < 0 || k > kMaxK || k > n || d < 1 || b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(n, k);
  if (p.lists > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto xf = static_cast<const float*>(x);
  auto mk = static_cast<const unsigned char*>(mask);
  Key* cur = static_cast<Key*>(workspace);
  Key* other = cur + static_cast<long long>(b) * p.lists * p.k2;
  const bool vec4 =
      (d % 4) == 0 && (reinterpret_cast<unsigned long long>(x) % 16) == 0;
  cudaError_t err;
  if (metric_ip) {
    err = vec4 ? launch_tiles<true, true>(qf, xf, mk, cur, b, n, d, p, s)
               : launch_tiles<true, false>(qf, xf, mk, cur, b, n, d, p, s);
  } else {
    err = vec4 ? launch_tiles<false, true>(qf, xf, mk, cur, b, n, d, p, s)
               : launch_tiles<false, false>(qf, xf, mk, cur, b, n, d, p, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int lists = p.lists;
  while (lists > p.group) {
    const int groups = (lists + p.group - 1) / p.group;
    err = launch_merge(cur, lists, p.group, other, groups, qf, b, d, k,
                       metric_ip, nullptr, nullptr, p.k2, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    Key* t = cur;
    cur = other;
    other = t;
    lists = groups;
  }
  err = launch_merge(cur, lists, next_pow2(lists), nullptr, 1, qf, b, d, k,
                     metric_ip, static_cast<int*>(ids),
                     static_cast<float*>(dists), p.k2, s);
  return static_cast<int>(err);
}
