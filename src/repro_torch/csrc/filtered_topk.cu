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
// each tile's list of up to k keys.  This one-launch design takes k up to
// kMaxK = 256.
//
// Element types.  x is fp32, bf16 or fp16, and so is q.  A 16-bit row is
// read as it is stored (half the bytes; 16-byte loads of 8 elements when
// d % 8 == 0 and x is 16 B aligned, else one element a lane) and widened
// to fp32 in registers; q is widened once, into shared memory.  Everything
// after the loads is the fp32 arithmetic: a bf16 x bf16 or fp16 x fp16
// product is exact in fp32, as the TPU kernel's dot_general with
// preferred_element_type=f32 computes it.  An fp32 corpus keeps its own
// float4 (or scalar) loads and order of operations.
//
// k above kMaxK (any k <= n): a second path of three steps, per chunk of
// queries sized so that the chunk's keys fit kDenseKeys words of the
// workspace:
//   a. `score_keys_kernel`: the tiles' steps 1-2 as above, but each
//      (query, tile) CTA writes the key of every row of its tile to the
//      query's row of keys in the workspace (0 for a masked row), so a
//      query's keys are n words in row order;
//   b. `select_sort_kernel`, one CTA of 1024 threads per query: a radix
//      select over those n keys in global memory (8-bit digits from the
//      top, a shared histogram a pass, stopping at the first digit whose
//      bin holds exactly the keys still wanted) gives a threshold that
//      exactly min(k, passing rows) keys reach; they are compacted (warp
//      slots) into shared memory and sorted there by a bitonic network
//      when they fit kSortKeys (128 KB); past that, into global memory,
//      sorted there in runs of kSortKeys by the same network, and merged
//      in passes (each key's place in the merged run is its place in its
//      own run plus its rank in the partner run, by binary search: keys
//      are distinct);
//   c. the same CTA decodes the k slots, padding past the passing rows
//      with id -1 and score -inf, as the one-launch design does.
// No library sort or select runs on either path.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 256;           // largest k of the one-launch design
constexpr int kSelThreads = 1024;    // select_sort_kernel's CTA
constexpr int kSortKeys = 16384;     // keys sorted in shared memory (128 KB)
constexpr long long kDenseKeys = 1LL << 25;   // workspace keys a chunk (256 MB)
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

// The element types of x and q: how a stored element becomes an fp32
// value.  kVec elements make one 16-byte load.
struct F32 {
  using T = float;
  static constexpr int kVec = 4;
  __device__ static float at(const T* p, long long i) { return __ldg(p + i); }
};
struct BF16 {
  using T = unsigned short;
  static constexpr int kVec = 8;
  __device__ static float bits(uint32_t h) {
    return __uint_as_float(h << 16);
  }
  __device__ static float at(const T* p, long long i) {
    return bits(__ldg(p + i));
  }
  // the two elements of a 32-bit word, the lower address first
  __device__ static float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ static float hi(uint32_t w) {
    return __uint_as_float(w & 0xFFFF0000u);
  }
};
struct F16 {
  using T = unsigned short;
  static constexpr int kVec = 8;
  __device__ static float bits(uint32_t h) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
  }
  __device__ static float at(const T* p, long long i) {
    return bits(__ldg(p + i));
  }
  __device__ static float lo(uint32_t w) { return bits(w & 0xFFFFu); }
  __device__ static float hi(uint32_t w) { return bits(w >> 16); }
};

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Element i of q, stored as `q_type`, as an fp32 value.
__device__ __forceinline__ float q_at(const void* q, int q_type,
                                      long long i) {
  if (q_type == kBF16) {
    return BF16::at(static_cast<const unsigned short*>(q), i);
  }
  if (q_type == kF16) {
    return F16::at(static_cast<const unsigned short*>(q), i);
  }
  return static_cast<const float*>(q)[i];
}

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

// The 8 elements of each row's 16-byte load `a` (a 16-bit E) against the
// 8 fp32 values of q at q8, added to the rows' q.x (and |x|^2 under l2).
template <class E, bool kIp>
__device__ __forceinline__ void dot8(const uint4 (&a)[kRows],
                                     const bool (&on)[kRows],
                                     const float4* q8, float (&qx)[kRows],
                                     float (&xn)[kRows]) {
  const float4 qa = q8[0], qb = q8[1];
  const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    if (on[u]) {
      const uint32_t w[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f0 = E::lo(w[j]), f1 = E::hi(w[j]);
        qx[u] += f0 * qv[2 * j] + f1 * qv[2 * j + 1];
        if (!kIp) xn[u] += f0 * f0 + f1 * f1;
      }
    }
  }
}

// Steps 1 and 2 of the CTA of query b and the tile of rows [base, base +
// valid): q staged in qs as fp32, the tile's passing rows compacted into
// sh.rows and scored, their keys in sh.keys[0, cnt); returns cnt.  With
// kDense the keys go instead to dense[row - base] for every row of the
// tile, 0 for a row the mask fails.  Its first barrier publishes what the
// caller wrote to sh before the call.
template <class E, bool kIp, bool kVec, bool kDense>
__device__ __forceinline__ int score_tile(
    const void* __restrict__ q, int q_type,
    const typename E::T* __restrict__ x,
    const unsigned char* __restrict__ mask, float* qs, int b, int n, int d,
    long long base, int valid, Key* __restrict__ dense) {
  using T = typename E::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. mask bytes in flight while q is staged; then compact passing rows
  const unsigned char* mrow = mask + static_cast<long long>(b) * n + base;
  unsigned char mb[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = j * kThreads + threadIdx.x;
    mb[j] = i < valid ? mrow[i] : 0;
  }
  if (threadIdx.x == 0) sh.count = 0;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    qs[i] = q_at(q, q_type, static_cast<long long>(b) * d + i);
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
    } else if (kDense && j * kThreads + threadIdx.x < valid) {
      dense[j * kThreads + threadIdx.x] = 0ull;
    }
  }
  __syncthreads();
  const int cnt = sh.count;

  // 2. score the passing rows, kRows per warp in flight
  for (int i = warp * kRows; i < cnt; i += kWarps * kRows) {
    bool on[kRows];
    const T* xr[kRows];
    float qx[kRows], xn[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      on[u] = i + u < cnt;
      xr[u] = x + (base + (on[u] ? sh.rows[i + u] : 0)) * d;
      qx[u] = 0.f;
      xn[u] = 0.f;
    }
    if constexpr (kVec && E::kVec == 4) {   // fp32: float4 loads
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
    } else if constexpr (kVec) {   // 16-bit: 8 elements a 16-byte load
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      const int d8 = d >> 3;
      for (int c = lane; c < d8; c += 64) {
        const bool two = c + 32 < d8;
        uint4 a0[kRows], a1[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (on[u]) {
            a0[u] = __ldg(reinterpret_cast<const uint4*>(xr[u]) + c);
            if (two) {
              a1[u] = __ldg(reinterpret_cast<const uint4*>(xr[u]) + c + 32);
            }
          }
        }
        dot8<E, kIp>(a0, on, q4 + 2 * c, qx, xn);
        if (two) dot8<E, kIp>(a1, on, q4 + 2 * (c + 32), qx, xn);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float qv = qs[c];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (on[u]) {
            const float a = E::at(xr[u], c);
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
        const Key key = make_key(s, base + sh.rows[i + u]);
        if (kDense) {
          dense[sh.rows[i + u]] = key;
        } else {
          sh.keys[i + u] = key;
        }
      }
    }
  }
  return cnt;
}

template <class E, bool kIp, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
filtered_topk_kernel(const void* __restrict__ q, int q_type,
                     const typename E::T* __restrict__ x,
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
  Key* thr_g = state + 2 * b;
  Key* arrive_g = thr_g + 1;

  // 1-2. the tile's passing rows scored into sh.keys
  if (threadIdx.x == 0) {
    sh.ge = 0;
    sh.kept = 0;
  }
  for (int i = threadIdx.x; i < kBins; i += kThreads) sh.hist[0][i] = 0;
  int hc = 0;   // the zeroed radix-select histogram
  const int cnt = score_tile<E, kIp, kVec, false>(q, q_type, x, mask, qs, b,
                                                  n, d, base, valid,
                                                  nullptr);
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

// ---------------------------------------------------------------------------
// k > kMaxK: dense keys, a per-query radix select, a hand-written sort
// ---------------------------------------------------------------------------

// Steps 1-2 of (query b0 + blockIdx.x % nq, tile blockIdx.x / nq), the
// tile's keys written to that query's row of `keys` (n words, row order).
template <class E, bool kIp, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
score_keys_kernel(const void* __restrict__ q, int q_type,
                  const typename E::T* __restrict__ x,
                  const unsigned char* __restrict__ mask,
                  Key* __restrict__ keys, int b0, int n, int d, int nlists) {
  extern __shared__ float4 q_smem[];
  const int nq = static_cast<int>(gridDim.x / nlists);
  const int qi = static_cast<int>(blockIdx.x % nq);
  const int tile = static_cast<int>(blockIdx.x / nq);
  const long long base = static_cast<long long>(tile) * kTile;
  const int valid = static_cast<int>(min(static_cast<long long>(kTile),
                                         static_cast<long long>(n) - base));
  score_tile<E, kIp, kVec, true>(q, q_type, x, mask,
                                 reinterpret_cast<float*>(q_smem), b0 + qi,
                                 n, d, base, valid,
                                 keys + static_cast<long long>(qi) * n + base);
}

struct SelShared {
  int hist[kBins];
  int bin, above, bin_count, total, kept;
  float qn;
};

// select_sort_kernel's shared memory (static; the sort buffer, dynamic)
__shared__ SelShared ss;

// Warp 0: the bin of ss.hist, counted from the top, that holds the
// need-th largest key (ss.bin, ss.above the keys in higher bins,
// ss.bin_count), and the keys counted in all bins (ss.total).  No bin is
// chosen when ss.total < need.
__device__ void pick_bin(int need) {
  const int lane = threadIdx.x & 31;
  int v[8], s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = ss.hist[kBins - 1 - 8 * lane - j];
    s += v[j];
  }
  int incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) ss.total = incl;
  int acc = incl - s;
  if (acc < need && need <= incl) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (acc < need && acc + v[j] >= need) {
        ss.bin = kBins - 1 - 8 * lane - j;
        ss.above = acc;
        ss.bin_count = v[j];
      }
      acc += v[j];
    }
  }
}

// Sort a[0, p) descending, p a power of two, by a bitonic network.
// Block-wide; ends with a barrier.
__device__ void bitonic_desc(Key* a, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += kSelThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const Key u = a[lo], v = a[hi];
        if ((u < v) == ((lo & size) == 0)) {
          a[lo] = v;
          a[hi] = u;
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// One CTA per query b0 + blockIdx.x: the exact top k of the query's n
// dense keys (0 = masked), decoded into ids and dists.  runs: 2 k words a
// query, used only when more than kSortKeys keys are kept.
template <bool kIp>
__global__ void __launch_bounds__(kSelThreads)
select_sort_kernel(const Key* __restrict__ keys, const void* __restrict__ q,
                   int q_type, Key* __restrict__ runs, int* __restrict__ ids,
                   float* __restrict__ dists, int b0, int n, int d, int k) {
  extern __shared__ Key sbuf[];
  const int qi = blockIdx.x;
  const int b = b0 + qi;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Key* kr = keys + static_cast<long long>(qi) * n;
  if (!kIp && warp == 1) {   // |q|^2, as finish computes it
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = q_at(q, q_type, static_cast<long long>(b) * d + i);
      acc += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) ss.qn = acc;
  }
  for (int i = threadIdx.x; i < kBins; i += kSelThreads) ss.hist[i] = 0;
  if (threadIdx.x == 0) ss.kept = 0;
  __syncthreads();

  // the threshold thr that exactly m = min(k, passing rows) keys reach:
  // 8-bit digits from the top, the bits decided so far in `prefix`
  Key prefix = 0ull, fixed = 0ull, thr = 1ull;
  int need = k, m = k;
  for (int shift = 56;; shift -= 8) {
    for (int i = threadIdx.x; i < n; i += kSelThreads) {
      const Key key = __ldg(kr + i);
      if (key != 0ull && (key & fixed) == prefix) {
        const int bin = static_cast<int>(key >> shift) & (kBins - 1);
        const unsigned peers = __match_any_sync(__activemask(), bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&ss.hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) pick_bin(need);
    __syncthreads();
    const int bin = ss.bin, above = ss.above, bin_count = ss.bin_count;
    const int total = ss.total;
    __syncthreads();
    for (int i = threadIdx.x; i < kBins; i += kSelThreads) ss.hist[i] = 0;
    if (shift == 56 && total <= k) {   // every passing row is kept
      m = total;
      break;
    }
    prefix |= static_cast<Key>(bin) << shift;
    fixed |= static_cast<Key>(kBins - 1) << shift;
    need -= above;
    // every key of this digit is wanted: the digit's least key is thr
    // (keys are distinct, so at shift 0 the bin holds one key: need = 1)
    if (bin_count == need || shift == 0) {
      thr = prefix > 0ull ? prefix : 1ull;
      break;
    }
    __syncthreads();
  }

  // the m kept keys, compacted: into shared memory when they fit
  const bool in_smem = m <= kSortKeys;
  Key* buf = in_smem ? sbuf : runs + static_cast<long long>(qi) * 2 * k;
  for (int i = threadIdx.x; i < n; i += kSelThreads) {
    const Key key = __ldg(kr + i);
    if (key >= thr) buf[warp_slot(&ss.kept)] = key;
  }
  __syncthreads();
  if (in_smem) {
    const int p = next_pow2(max(m, 1));
    for (int i = m + threadIdx.x; i < p; i += kSelThreads) sbuf[i] = 0ull;
    __syncthreads();
    bitonic_desc(sbuf, p);
  } else {
    // runs of kSortKeys sorted in shared memory, then merged in passes
    for (int r0 = 0; r0 < m; r0 += kSortKeys) {
      const int len = min(kSortKeys, m - r0);
      const int p = next_pow2(len);
      for (int i = threadIdx.x; i < p; i += kSelThreads) {
        sbuf[i] = i < len ? buf[r0 + i] : 0ull;
      }
      __syncthreads();
      bitonic_desc(sbuf, p);
      for (int i = threadIdx.x; i < len; i += kSelThreads) {
        buf[r0 + i] = sbuf[i];
      }
      __syncthreads();
    }
    Key* src = buf;
    Key* dst = buf + k;
    for (int len = kSortKeys; len < m; len <<= 1) {
      for (int i = threadIdx.x; i < m; i += kSelThreads) {
        const Key key = src[i];
        const int r = i / len;
        const int ps = (r ^ 1) * len;
        int lo = ps, hi = min(ps + len, m);   // first key of the partner
        while (lo < hi) {                     // run below key
          const int mid = (lo + hi) >> 1;
          if (src[mid] > key) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        const int rank = ps < m ? lo - ps : 0;
        dst[(r & ~1) * len + (i - r * len) + rank] = key;
      }
      __syncthreads();
      Key* t = src;
      src = dst;
      dst = t;
    }
    buf = src;
  }
  const long long o = static_cast<long long>(b) * k;
  const float qn = ss.qn;
  for (int r = threadIdx.x; r < k; r += kSelThreads) {
    put<kIp>(ids, dists, o + r, r < m ? buf[r] : 0ull, qn);
  }
}

// Queries a chunk of the k > kMaxK path: its dense keys fit kDenseKeys.
int big_chunk(int b, int n) {
  const long long fit = kDenseKeys / (n > 1 ? n : 1);
  return static_cast<int>(fit < 1 ? 1 : fit < b ? fit : b);
}

template <class E, bool kIp, bool kVec>
cudaError_t launch(const void* q, int q_type, const void* x,
                   const unsigned char* mask, Key* state, Key* ws, int* ids,
                   float* dists, int b, int n, int d, int k,
                   cudaStream_t stream) {
  using T = typename E::T;
  const int nlists = tiles_of(n);
  const int smem = 4 * ((d + 3) & ~3);
  if (smem + static_cast<int>(sizeof(Shared)) > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  const T* xt = static_cast<const T*>(x);
  if (k <= kMaxK) {
    cudaError_t err = cudaFuncSetAttribute(
        filtered_topk_kernel<E, kIp, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    filtered_topk_kernel<E, kIp, kVec>
        <<<static_cast<unsigned>(b) * nlists, kThreads, smem, stream>>>(
            q, q_type, xt, mask, state, ws, ids, dists, n, d, nlists, k);
    return cudaGetLastError();
  }
  const int sort_keys = k < kSortKeys ? next_pow2(k) : kSortKeys;
  const int sort_bytes = static_cast<int>(sizeof(Key)) * sort_keys;
  cudaError_t err = cudaFuncSetAttribute(
      score_keys_kernel<E, kIp, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(select_sort_kernel<kIp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sort_bytes);
  if (err != cudaSuccess) return err;
  const int qc = big_chunk(b, n);
  Key* runs = ws + static_cast<long long>(qc) * n;
  for (int b0 = 0; b0 < b; b0 += qc) {
    const int nq = qc < b - b0 ? qc : b - b0;
    score_keys_kernel<E, kIp, kVec>
        <<<static_cast<unsigned>(nq) * nlists, kThreads, smem, stream>>>(
            q, q_type, xt, mask, ws, b0, n, d, nlists);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    select_sort_kernel<kIp><<<nq, kSelThreads, sort_bytes, stream>>>(
        ws, q, q_type, runs, ids, dists, b0, n, d, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The launch of element type E: its metric, and 16-byte loads when d is a
// multiple of E::kVec and x is 16 B aligned.
template <class E>
cudaError_t dispatch(const void* q, int q_type, const void* x,
                     const unsigned char* mask, Key* state, Key* ws,
                     int* ids, float* dists, int b, int n, int d, int k,
                     bool ip, cudaStream_t s) {
  const bool vec = (d % E::kVec) == 0 &&
                   (reinterpret_cast<unsigned long long>(x) % 16) == 0;
  if (ip) {
    return vec ? launch<E, true, true>(q, q_type, x, mask, state, ws, ids,
                                       dists, b, n, d, k, s)
               : launch<E, true, false>(q, q_type, x, mask, state, ws, ids,
                                        dists, b, n, d, k, s);
  }
  return vec ? launch<E, false, true>(q, q_type, x, mask, state, ws, ids,
                                      dists, b, n, d, k, s)
             : launch<E, false, false>(q, q_type, x, mask, state, ws, ids,
                                       dists, b, n, d, k, s);
}

}  // namespace

// Scratch the call needs, in 64-bit words, with no initial value.  k <=
// 256: the tile lists, (b, tiles, k) keys, which covers the worst case,
// where every list is full (every tile holds k keys >= T, as when all
// tiles hold the same scores).  k > 256: one chunk's dense keys, (chunk,
// n), and past kSortKeys kept keys two runs of k a query of the chunk.
extern "C" long long repro_filtered_topk_workspace(int b, int n, int k) {
  if (b <= 0 || n <= 0 || k <= 0) return 0;
  if (k <= kMaxK) return static_cast<long long>(b) * tiles_of(n) * k;
  const long long qc = big_chunk(b, n);
  return qc * n + (k > kSortKeys ? 2 * qc * k : 0);
}

// C entry point.  q (b, d) and x (n, d) of q_type and x_type (0 = fp32,
// 1 = bf16, 2 = fp16), mask (b, n) bool (1 byte), ids (b, k) int32 and
// dists (b, k) f32 outputs; state: 2 b 64-bit words, zero before the call
// and zero again after it (the caller keeps one zeroed buffer per stream;
// read only for k <= 256); workspace of repro_filtered_topk_workspace(b,
// n, k) 64-bit words; all contiguous on the current device; 0 <= k <= n;
// metric_ip 0 = l2, 1 = ip.  One kernel launch for k <= 256, two a chunk
// of queries above.  Returns the first cudaError_t (0 = launched).
extern "C" int repro_filtered_topk(const void* q, const void* x,
                                   const void* mask, void* ids, void* dists,
                                   void* state, void* workspace, int b, int n,
                                   int d, int k, int metric_ip, int q_type,
                                   int x_type, void* stream) {
  if (b == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  if (k < 0 || k > n || d < 1 || b < 0 || q_type < kF32 || q_type > kF16 ||
      x_type < kF32 || x_type > kF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= kMaxK && static_cast<long long>(b) * tiles_of(n) > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto mk = static_cast<const unsigned char*>(mask);
  auto st = static_cast<Key*>(state);
  auto ws = static_cast<Key*>(workspace);
  auto id = static_cast<int*>(ids);
  auto di = static_cast<float*>(dists);
  const bool ip = metric_ip != 0;
  cudaError_t err;
  if (x_type == kBF16) {
    err = dispatch<BF16>(q, q_type, x, mk, st, ws, id, di, b, n, d, k, ip, s);
  } else if (x_type == kF16) {
    err = dispatch<F16>(q, q_type, x, mk, st, ws, id, di, b, n, d, k, ip, s);
  } else {
    err = dispatch<F32>(q, q_type, x, mk, st, ws, id, di, b, n, d, k, ip, s);
  }
  return static_cast<int>(err);
}
