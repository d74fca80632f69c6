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
// some 27 us at 3.35 TB/s.  No tensor cores: at B = 1 a row is one dot
// product, 2 flops per 4 bytes read, far below the card's balance point
// (67 TFLOP/s fp32 over 3.35 TB/s is 20 flops a byte).
//
// Design: ONE launch, one CTA of 256 threads per (query, tile of 2048 rows),
// a 1-D grid of B x ceil(n / 2048) CTAs (512 at the path's shape), ordered
// tile-major so that the B CTAs of one tile run together and share its rows
// in L2 (still one query per CTA, so at B > 1 each CTA reads its rows from
// L2 again; a query-tiled design would read them once).
//   1. Mask.  Each thread loads its 8 mask bytes (all loads issued before
//      any is used) while q is staged in shared memory; the passing rows are
//      compacted into a shared list (warp ballot, one shared atomic per warp
//      and byte), so masked rows are never read.
//   2. Score.  Each warp scores four passing rows at a time (lanes split d;
//      float4 loads when d % 4 == 0 and x is 16 B aligned, two per row
//      issued together; warp-shuffle sums) and stores a 64-bit key
//      (order-preserving score bits << 32 | ~id): one unsigned compare ranks
//      by score and breaks ties to the lower id, and every key of a query is
//      distinct and non-zero.
//   3. Select.  The query's running threshold T (a word of `state`, raised
//      with atomicMax) says that some tile already holds k keys >= T, so a
//      key below T cannot be in the answer; a CTA reads T once it has
//      scored its rows (a late read prunes more) and counts its keys >= T.
//      Up to 256 of them (the usual case: ~170 pass in a tile at the path),
//      each thread takes one and counts the larger ones: that rank is the
//      key's place, so the k-th key and the sorted list come from one pass
//      over shared memory.  Past 256 (dense masks), a radix select finds
//      the k-th key (8-bit digits from the top, a 256-bin shared histogram
//      per digit, warp-aggregated atomics, two barriers a digit, stopping
//      once one key is left in the chosen bin), and the kept keys are
//      ranked the same way.  The k-th key raises T (an atomicMax whose
//      result is not waited for).  No sort network and no merge network.
//   4. Publish.  The CTA writes its keys >= its k-th key (all its keys >=
//      T when it has fewer than k) -- at most k, sorted descending, ended
//      by a 0 key when fewer -- to its list in `workspace`, then
//      __threadfence() and an atomicAdd on the query's arrival counter (the
//      other word of `state`).
//   5. Finish (`finish`, not inlined, so that its registers do not crowd
//      the tile steps').  The CTA that arrives last for its query reads the
//      final T: at least k keys are >= T, so the answer's k-th key is >= T.
//      T alone is weak when a tile passes few more than k rows (at the path
//      most of every list is >= T), so each thread takes the largest head
//      >= T of its lists, and a radix floor of the k-th largest of those 256
//      (k of them, from k lists, reach it) bounds the answer from below; the
//      first four keys of each list are read once, into registers, for both
//      steps (at up to 512 lists).  Every published key >= that bound -- a
//      little over k at the path, a prefix of each sorted list -- goes to
//      shared memory (places from a block scan), and each is placed by its
//      rank (warp ballots against 32 keys at a time).  Past 256 such keys a
//      radix select finds the exact k-th key first; past the 2048-key
//      buffer it works on the lists in global memory, so any count is
//      exact, up to lists x k when every tile holds the same scores.  It
//      decodes ids and dists and sets T and the counter back to 0.
//      This step runs on one SM while the others idle, and its time is
//      latency: one CTA's barriers and shared loads, and the instruction
//      fetches of code that runs once per call.
// Occupancy: 256 threads, ~25 KB of static shared memory plus d floats of
// q, launch bounds of 4 CTAs (<= 64 registers a thread); so 4 to 8 CTAs
// share an SM and one CTA's select overlaps the others' row loads.  The
// mask bytes and rows are read with plain loads (no TMA / cp.async.bulk:
// the rows a tile needs are not contiguous, and the mask is 2 KB a CTA).
// Buffers: `state` holds 2 64-bit words per query (T, arrival count) that
// must be zero before the first call and are zero again after each call;
// `workspace` (repro_filtered_topk_workspace words, no initial value) holds
// each tile's list of up to k keys.  k is capped at kMaxK = 256.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 256;           // largest k this kernel takes
constexpr int kTile = 2048;          // corpus rows per CTA
constexpr int kThreads = 256;
constexpr int kPerThread = kTile / kThreads;   // mask bytes a thread loads
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;             // passing rows a warp scores at once
constexpr int kBins = 256;           // radix-select digit: 8 bits
constexpr int kMinBlocks = 4;
constexpr int kFloorSlack = 8;       // keys a radix floor may let through
constexpr uint32_t kNegInfOrd = 0x007FFFFFu;   // ordered(-inf)
constexpr int kSmemLimit = 232448;   // opt-in shared memory of one H100 block

typedef unsigned long long Key;

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

struct __align__(16) Shared {
  Key keys[kTile];             // the tile's keys; the last CTA's candidates
  Key top[kMaxK];              // kept keys, unsorted
  int hist[2][kBins];          // radix-select histograms, used in turns
  unsigned short rows[kTile];  // the tile's passing rows
  Key thr, kth;
  Key ones, zeros;             // bits set, and clear, in any candidate
  int count, ge, kept, bin, above, bin_count;
  int wsum[kWarps];
  float qn;
  bool last;
};

// A slot of *counter for each calling thread, one shared atomic per warp.
__device__ __forceinline__ int warp_slot(int* counter) {
  const unsigned act = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(act) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(act));
  base = __shfl_sync(act, base, leader);
  return base + __popc(act & ((1u << lane) - 1u));
}

// The block's shared memory (static; q follows it, dynamic).
__shared__ Shared sh;

// The keys of a shared buffer, visited one per thread in turn.
struct SharedKeys {
  const Key* keys;
  int n;
  template <class F>
  __device__ void each(F f) const {
    for (int i = threadIdx.x; i < n; i += kThreads) f(keys[i]);
  }
};

// The published tile lists of one query in global memory (written by other
// CTAs of this launch: read through L2), one list per thread in turn.  Each
// list holds up to k keys sorted descending, ended by a 0 key when shorter,
// so a list is read only up to its first key below `stop`.  Used only where
// the last CTA's candidates overflow sh.keys.
struct ListKeys {
  const Key* lists;
  int nlists, k;
  Key stop;
  template <class F>
  __device__ void each(F f) const {
    for (int l = threadIdx.x; l < nlists; l += kThreads) {
      const Key* src = lists + static_cast<long long>(l) * k;
      for (int i = 0; i < k; ++i) {
        const Key key = __ldcg(src + i);
        if (key == 0ull || key < stop) break;
        f(key);
      }
    }
  }
};

// How many of keys[0, n) are larger than key (its place, largest first:
// keys are distinct).  keys is 16 B aligned; two keys a load.
__device__ __forceinline__ int rank_of(const Key* keys, int n, Key key) {
  const ulonglong2* pairs = reinterpret_cast<const ulonglong2*>(keys);
  int r0 = 0, r1 = 0, j = 0;
  for (; j + 1 < n; j += 2) {
    const ulonglong2 p = pairs[j >> 1];
    r0 += p.x > key;
    r1 += p.y > key;
  }
  if (j < n) r0 += keys[j] > key;
  return r0 + r1;
}

// The place of each lane's `key` among keys[0, n) (shared), largest first:
// how many are larger.  Warp-synchronous: every lane of the warp calls it.
// The keys come in 32 at a time, one a lane, and each lane's key is held
// against all 32 with one ballot, so no shared load waits in the loop.
__device__ int rank_warp(const Key* keys, int n, Key key) {
  const int lane = threadIdx.x & 31;
  int r = 0;
  for (int m = 0; m < n; m += 32) {
    const Key c = m + lane < n ? keys[m + lane] : 0ull;
    for (int i = 0; i < 32; ++i) {
      const Key ki = __shfl_sync(0xffffffffu, key, i);
      const int above = __popc(__ballot_sync(0xffffffffu, c > ki));
      if (lane == i) r += above;
    }
  }
  return r;
}

// Slot r of the output row o: the id and dist of `key` (0 = padding).
template <bool kIp>
__device__ __forceinline__ void put(int* ids, float* dists, long long o,
                                    Key key, float qn) {
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const float s = hi <= kNegInfOrd ? -CUDART_INF_F : unordered(hi);
  const int id = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
  ids[o] = isfinite(s) ? id : -1;
  dists[o] = kIp ? s : qn - s;
}

// The k-th largest of the keys >= lo that `src` visits (at least k of them
// must be).  The keys may differ only in the bits of `span` and hold the
// bits of `ones` elsewhere (~0 and 0 when unknown): the first digit starts
// at span's top bit.  With `floor`, it stops once the chosen digit holds
// at most kFloorSlack keys and returns the least key of that digit (all
// lower bits 0), which at least k of the keys reach.  hist[hc] is zero on entry and on return (hc
// is updated alike in every thread).  Block-wide; ends with a barrier.
template <class Src>
__device__ Key select_kth(const Src& src, Key lo, int k, Key span, Key ones,
                          int& hc, bool floor = false) {
  const int lane = threadIdx.x & 31;
  const int top = span != 0ull ? 63 - __clzll(span) : 0;
  int shift = max(top - 7, 0);
  Key fixed = shift + 8 >= 64 ? 0ull : ~((1ull << (shift + 8)) - 1ull);
  Key prefix = ones & fixed;
  int kr = k;
  for (int p = hc;; p ^= 1) {
    int* h = sh.hist[p];
    src.each([&](Key key) {
      if (key >= lo && (key & fixed) == prefix) {
        // one atomic per warp and bin: the keys of a tile crowd few bins
        const int bin = static_cast<int>(key >> shift) & (kBins - 1);
        const unsigned peers = __match_any_sync(__activemask(), bin);
        if ((threadIdx.x & 31) == __ffs(peers) - 1) {
          atomicAdd(&h[bin], __popc(peers));
        }
      }
    });
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l: the top bins first
      int v[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = h[kBins - 1 - 8 * lane - j];
        s += v[j];
      }
      int incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      int acc = incl - s;
      if (acc < kr && kr <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc < kr && acc + v[j] >= kr) {
            sh.bin = kBins - 1 - 8 * lane - j;
            sh.above = acc;
            sh.bin_count = v[j];
          }
          acc += v[j];
        }
      }
    } else {
      int* other = sh.hist[p ^ 1];
      for (int i = threadIdx.x - 32; i < kBins; i += kThreads - 32) {
        other[i] = 0;
      }
    }
    __syncthreads();
    prefix |= static_cast<Key>(sh.bin) << shift;
    fixed |= static_cast<Key>(kBins - 1) << shift;
    kr -= sh.above;
    hc = p ^ 1;
    if (sh.bin_count == 1 && shift > 0) {   // one key left: it is the k-th
      src.each([&](Key key) {
        if (key >= lo && (key & fixed) == prefix) sh.kth = key;
      });
      __syncthreads();
      return sh.kth;
    }
    if (shift == 0 || (floor && sh.bin_count <= kFloorSlack)) return prefix;
    shift = max(shift - 8, 0);
  }
}

// Append the keys >= lo that `src` visits to dst, counted in sh.kept (zero
// on entry; the caller makes sure dst has room).  Block-wide.
template <class Src>
__device__ void keep_above(const Src& src, Key lo, Key* dst) {
  src.each([&](Key key) {
    if (key >= lo) dst[warp_slot(&sh.kept)] = key;
  });
}

// Step 5, run by the last CTA of a query (lists_b: its lists; o: its first
// output slot).  Not inlined: the registers of the tile steps, which every
// CTA runs, are allocated without this code's.
template <bool kIp>
__device__ __noinline__ void finish(int hc, const float* qs, int d,
                                    const Key* lists_b, int nlists, int k,
                                    int* ids, float* dists, long long o,
                                    Key* thr_g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Key* arrive_g = thr_g + 1;
  if (!kIp && warp == 1) {
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += qs[i] * qs[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) sh.qn = acc;
  }
  const Key t = sh.thr;
  // the first four keys of this thread's first two lists stay in registers
  // for both passes below (all lists, at up to 512)
  Key v[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = threadIdx.x + h * kThreads;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[h][u] = l < nlists && u < k
                    ? __ldcg(lists_b + static_cast<long long>(l) * k + u)
                    : 0ull;
    }
  }
  // a tighter bound first: each thread takes the largest first key >= T of
  // its lists; if k threads hold one, the k-th largest of those has k keys
  // >= it (from k lists), so the answer's k-th key is >= it too
  Key hd = 0ull;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (v[h][0] >= t && v[h][0] > hd) hd = v[h][0];
  }
  for (int l = threadIdx.x + 2 * kThreads; l < nlists; l += kThreads) {
    const Key key = __ldcg(lists_b + static_cast<long long>(l) * k);
    if (key >= t && key > hd) hd = key;
  }
  // (a floor of it is enough: the least key of a radix digit that holds it
  // and at most kFloorSlack heads, digits from the top bit in which the
  // heads differ)
  sh.keys[threadIdx.x] = hd;
  Key all = hd != 0ull ? hd : ~0ull, any = hd;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    all &= __shfl_xor_sync(0xffffffffu, all, off);
    any |= __shfl_xor_sync(0xffffffffu, any, off);
  }
  if (lane == 0 && any != 0ull) {
    atomicOr(&sh.ones, any);
    atomicOr(&sh.zeros, ~all);
  }
  Key lo = t;
  if (__syncthreads_count(hd != 0ull) >= k) {
    const Key floor = select_kth(SharedKeys{sh.keys, kThreads},
                                 t > 0ull ? t : 1ull, k, sh.ones & sh.zeros,
                                 sh.ones, hc, true);
    lo = floor > t ? floor : t;
  }
  if (threadIdx.x == 0) sh.ones = sh.zeros = 0ull;
  __syncthreads();
  // every published key >= lo (the answer and, at most, a few others) into
  // sh.keys (the first kTile of them), with the bits that are 1, and 0, in
  // any of them in sh.ones and sh.zeros.  The cached chunks' keys >= lo
  // (a prefix of each: lists are sorted) go to places from a block scan;
  // the rest (lists past the first 512, chunks past the first) after them.
  int in_chunk[2], mine = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int c = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c += c == u && v[h][u] != 0ull && v[h][u] >= lo;
    }
    in_chunk[h] = c;
    mine += c;
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh.wsum[warp] = incl;
  __syncthreads();
  int pos = incl - mine, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? sh.wsum[w] : 0;
    total += sh.wsum[w];
  }
  all = ~0ull;
  any = 0ull;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < in_chunk[h]) {
        if (pos < kTile) sh.keys[pos] = v[h][u];
        ++pos;
        all &= v[h][u];
        any |= v[h][u];
      }
    }
  }
  auto add = [&](Key key) {
    const int s = total + warp_slot(&sh.ge);
    if (s < kTile) sh.keys[s] = key;
    all &= key;
    any |= key;
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Key* src =
        lists_b + static_cast<long long>(threadIdx.x + h * kThreads) * k;
    if (in_chunk[h] == 4) {
      for (int i = 4; i < k; ++i) {
        const Key key = __ldcg(src + i);
        if (key == 0ull || key < lo) break;
        add(key);
      }
    }
  }
  for (int l = threadIdx.x + 2 * kThreads; l < nlists; l += kThreads) {
    const Key* src = lists_b + static_cast<long long>(l) * k;
    for (int i = 0; i < k; ++i) {
      const Key key = __ldcg(src + i);
      if (key == 0ull || key < lo) break;
      add(key);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    all &= __shfl_xor_sync(0xffffffffu, all, off);
    any |= __shfl_xor_sync(0xffffffffu, any, off);
  }
  if (lane == 0 && any != 0ull) {
    atomicOr(&sh.ones, any);
    atomicOr(&sh.zeros, ~all);
  }
  __syncthreads();
  const int cand = total + sh.ge;
  const ListKeys cands{lists_b, nlists, k, lo};
  const float qn = sh.qn;
  if (cand <= kThreads) {
    // a key a thread, placed by its rank
    if (warp * 32 < cand) {   // warps that hold a key
      const Key key = threadIdx.x < cand ? sh.keys[threadIdx.x] : 0ull;
      const int r = rank_warp(sh.keys, cand, key);
      if (threadIdx.x < cand && r < k) put<kIp>(ids, dists, o + r, key, qn);
    }
    for (int i = cand + threadIdx.x; i < k; i += kThreads) {
      put<kIp>(ids, dists, o + i, 0ull, qn);
    }
  } else {
    // more than a block: the exact k-th key, then the k keys >= it ranked
    const SharedKeys gathered{sh.keys, cand};
    const Key span = sh.ones & sh.zeros;
    Key kth;
    if (cand <= kTile) {
      kth = select_kth(gathered, lo, k, span, sh.ones, hc);
      keep_above(gathered, kth, sh.top);
    } else {
      kth = select_kth(cands, lo, k, span, sh.ones, hc);
      keep_above(cands, kth, sh.top);
    }
    __syncthreads();
    if (warp * 32 < k) {
      const Key key = threadIdx.x < k ? sh.top[threadIdx.x] : 0ull;
      const int r = rank_warp(sh.top, k, key);
      if (threadIdx.x < k) put<kIp>(ids, dists, o + r, key, qn);
    }
  }
  if (threadIdx.x == 0) {   // ready for the next call on this stream
    thr_g[0] = 0ull;
    arrive_g[0] = 0ull;
  }
}

template <bool kIp, bool kVec4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
filtered_topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
                     const unsigned char* __restrict__ mask,
                     Key* __restrict__ state, Key* __restrict__ lists,
                     int* __restrict__ ids,
                     float* __restrict__ dists, int n, int d, int nlists,
                     int k) {
  extern __shared__ float4 q_smem[];
  float* qs = reinterpret_cast<float*>(q_smem);

  const int nq = static_cast<int>(gridDim.x / nlists);
  const int b = static_cast<int>(blockIdx.x % nq);
  const int tile = static_cast<int>(blockIdx.x / nq);
  const long long base = static_cast<long long>(tile) * kTile;
  const int valid = static_cast<int>(min(static_cast<long long>(kTile),
                                         static_cast<long long>(n) - base));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Key* thr_g = state + 2 * b;
  Key* arrive_g = thr_g + 1;

  // 1. mask bytes in flight while q is staged; then compact passing rows
  const unsigned char* mrow = mask + static_cast<long long>(b) * n + base;
  unsigned char mb[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = j * kThreads + threadIdx.x;
    mb[j] = i < valid ? mrow[i] : 0;
  }
  if (threadIdx.x == 0) {
    sh.count = 0;
    sh.ge = 0;
    sh.kept = 0;
  }
  for (int i = threadIdx.x; i < kBins; i += kThreads) sh.hist[0][i] = 0;
  int hc = 0;   // the zeroed radix-select histogram
  for (int i = threadIdx.x; i < d; i += kThreads) {
    qs[i] = q[static_cast<long long>(b) * d + i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const bool pass = mb[j] != 0;
    const unsigned ball = __ballot_sync(0xffffffffu, pass);
    int slot = 0;
    if (lane == 0 && ball != 0u) slot = atomicAdd(&sh.count, __popc(ball));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (pass) {
      sh.rows[slot + __popc(ball & ((1u << lane) - 1u))] =
          static_cast<unsigned short>(j * kThreads + threadIdx.x);
    }
  }
  __syncthreads();
  const int cnt = sh.count;

  // 2. score the passing rows, kRows per warp in flight
  for (int i = warp * kRows; i < cnt; i += kWarps * kRows) {
    bool on[kRows];
    const float* xr[kRows];
    float qx[kRows], xn[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      on[u] = i + u < cnt;
      xr[u] = x + (base + (on[u] ? sh.rows[i + u] : 0)) * d;
      qx[u] = 0.f;
      xn[u] = 0.f;
    }
    if (kVec4) {
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      const int d4 = d >> 2;
      for (int c = lane; c < d4; c += 64) {
        const bool two = c + 32 < d4;
        float4 a0[kRows], a1[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (on[u]) {
            a0[u] = __ldg(reinterpret_cast<const float4*>(xr[u]) + c);
            if (two) {
              a1[u] = __ldg(reinterpret_cast<const float4*>(xr[u]) + c + 32);
            }
          }
        }
        const float4 qv = q4[c];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (on[u]) {
            const float4 a = a0[u];
            qx[u] += a.x * qv.x + a.y * qv.y + a.z * qv.z + a.w * qv.w;
            if (!kIp) xn[u] += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
          }
        }
        if (two) {
          const float4 qw = q4[c + 32];
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            if (on[u]) {
              const float4 a = a1[u];
              qx[u] += a.x * qw.x + a.y * qw.y + a.z * qw.z + a.w * qw.w;
              if (!kIp) xn[u] += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
            }
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
        sh.keys[i + u] = make_key(s, base + sh.rows[i + u]);
      }
    }
  }
  if (threadIdx.x == 0) sh.thr = *reinterpret_cast<volatile Key*>(thr_g);
  __syncthreads();

  // 3. the tile's k-th key among its keys >= T, T raised to it, and
  // 4. its keys >= its k-th key (or >= T, when fewer than k) published,
  // sorted descending
  const SharedKeys tile_keys{sh.keys, cnt};
  const Key t0 = sh.thr;
  int above = 0;
  tile_keys.each([&](Key key) { above += key >= t0; });
  above = __reduce_add_sync(0xffffffffu, above);
  if (lane == 0 && above > 0) atomicAdd(&sh.ge, above);
  __syncthreads();
  const int c = sh.ge;
  const long long list = static_cast<long long>(b) * nlists + tile;
  Key* dst = lists + list * k;
  int m_pub;
  if (c <= kThreads) {
    // a key a thread: its rank among the keys >= T is its place
    const Key* ck = sh.keys;
    if (c < cnt) {
      keep_above(tile_keys, t0, sh.top);
      __syncthreads();
      ck = sh.top;
    }
    const bool mine = threadIdx.x < c;
    const Key key = mine ? ck[threadIdx.x] : 0ull;
    const int r = mine ? rank_of(ck, c, key) : kThreads;
    if (c >= k && r == k - 1) {   // else sh.thr stays T
      atomicMax(thr_g, key);
      sh.thr = key;
    }
    __syncthreads();
    const bool pub = mine && key >= sh.thr;   // the places 0 .. m_pub - 1
    if (pub) dst[r] = key;
    m_pub = __syncthreads_count(pub);
  } else {
    const Key kth = select_kth(tile_keys, t0, k, ~0ull, 0ull, hc);
    if (threadIdx.x == 0) {
      atomicMax(thr_g, kth);
      sh.thr = kth;
    }
    __syncthreads();
    keep_above(tile_keys, sh.thr, sh.top);
    __syncthreads();
    m_pub = sh.kept;
    if (threadIdx.x < m_pub) {
      const Key key = sh.top[threadIdx.x];
      dst[rank_of(sh.top, m_pub, key)] = key;
    }
  }
  if (threadIdx.x == 0 && m_pub < k) dst[m_pub] = 0ull;   // end of list
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last =
        atomicAdd(arrive_g, 1ull) == static_cast<Key>(nlists - 1);
    if (last) {
      __threadfence();
      sh.thr = *reinterpret_cast<volatile Key*>(thr_g);
      sh.count = 0;
      sh.ge = 0;
      sh.kept = 0;
      sh.ones = sh.zeros = 0ull;
    }
    sh.last = last;
  }
  __syncthreads();
  if (!sh.last) return;

  // 5. the query's last CTA: the exact top k of the published keys >= T
  finish<kIp>(hc, qs, d, lists + static_cast<long long>(b) * nlists * k,
              nlists, k, ids, dists, static_cast<long long>(b) * k, thr_g);
}

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

template <bool kIp, bool kVec4>
cudaError_t launch(const float* q, const float* x, const unsigned char* mask,
                   Key* state, Key* lists, int* ids, float* dists, int b,
                   int n, int d, int k, cudaStream_t stream) {
  const int nlists = tiles_of(n);
  const int smem = 4 * ((d + 3) & ~3);
  if (smem + static_cast<int>(sizeof(Shared)) > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      filtered_topk_kernel<kIp, kVec4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  filtered_topk_kernel<kIp, kVec4>
      <<<static_cast<unsigned>(b) * nlists, kThreads, smem, stream>>>(
          q, x, mask, state, lists, ids, dists, n, d, nlists, k);
  return cudaGetLastError();
}

}  // namespace

// Scratch the call needs, in 64-bit words, with no initial value: the tile
// lists, (b, tiles, k) keys.  This covers the worst case, where every list
// is full (every tile holds k keys >= T, as when all tiles hold the same
// scores).
extern "C" long long repro_filtered_topk_workspace(int b, int n, int k) {
  if (b <= 0 || n <= 0 || k <= 0) return 0;
  return static_cast<long long>(b) * tiles_of(n) * k;
}

// C entry point.  q (b, d) f32, x (n, d) f32, mask (b, n) bool (1 byte),
// ids (b, k) int32 and dists (b, k) f32 outputs; state: 2 b 64-bit words,
// zero before the call and zero again after it (the caller keeps one
// zeroed buffer per stream); workspace of repro_filtered_topk_workspace(b,
// n, k) 64-bit words; all contiguous on the current device;
// 1 <= k <= min(n, 256); metric_ip 0 = l2, 1 = ip.  One kernel launch.
// Returns its cudaError_t (0 = launched).
extern "C" int repro_filtered_topk(const void* q, const void* x,
                                   const void* mask, void* ids, void* dists,
                                   void* state, void* workspace, int b, int n,
                                   int d, int k, int metric_ip,
                                   void* stream) {
  if (b == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  if (k < 0 || k > kMaxK || k > n || d < 1 || b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(b) * tiles_of(n) > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto xf = static_cast<const float*>(x);
  auto mk = static_cast<const unsigned char*>(mask);
  auto st = static_cast<Key*>(state);
  auto ws = static_cast<Key*>(workspace);
  auto id = static_cast<int*>(ids);
  auto di = static_cast<float*>(dists);
  const bool vec4 =
      (d % 4) == 0 && (reinterpret_cast<unsigned long long>(x) % 16) == 0;
  cudaError_t err;
  if (metric_ip) {
    err = vec4 ? launch<true, true>(qf, xf, mk, st, ws, id, di, b, n, d, k, s)
               : launch<true, false>(qf, xf, mk, st, ws, id, di, b, n, d, k,
                                     s);
  } else {
    err = vec4 ? launch<false, true>(qf, xf, mk, st, ws, id, di, b, n, d, k,
                                     s)
               : launch<false, false>(qf, xf, mk, st, ws, id, di, b, n, d, k,
                                      s);
  }
  return static_cast<int>(err);
}
