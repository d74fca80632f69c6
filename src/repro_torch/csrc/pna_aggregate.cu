// pna_aggregate: PNA's fused mean / max / min / std of in-neighbours over
// padded dense graphs, for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/pna_aggregate/kernel.py::pna_aggregate_pallas
//   (body _pna_kernel), which takes one graph per grid step, runs the sum
//   and the sum of squares as two MXU products adj @ h and adj @ h^2, and
//   the max and min as masked (N, N, F) reductions in VMEM.
//
// What it computes, for graph b, destination node i and feature f, with
// a_j = adj[b, i, j] (row = destination, column = source; any finite value)
// and h_j = feats[b, j, f], summing over the j with a_j != 0 in ascending j:
//   cnt = sum_j a_j,  s = sum_j a_j h_j,  ssq = sum_j a_j h_j^2
//   mean = s / max(cnt, 1)
//   std  = sqrt(max(ssq / max(cnt, 1) - mean^2, 0) + 1e-12)
//   max / min over the j with a_j > 0 (from -1e30 / 1e30), and 0 where
//   cnt <= 0
// written to out[b, i, :] as [mean | max | min | std] (4F floats).  The
// variance is the reference's formula, not Welford's: the two differ, and
// the port computes the reference's function.  Everything is fp32: no
// tensor cores, so no TF32 rounding.
//
// What bounds it on an H100: bytes.  Each graph reads N^2 + N F floats and
// writes 4 N F, the writes being most of it (36,000 of 48,600 bytes at the
// molecule shape N = 30, F = 75); the arithmetic is ~7 flops per (edge,
// feature).  At the serving shape (B = 128 graphs) a call moves 6.2 MB
// (~1.9 us at 3.35 TB/s, less than a launch costs); at the bulk shape
// (16,384 graphs) 796 MB, ~0.24 ms.
//
// Design.  A work item is (graph, block of destination rows, block of at
// most 96 features); a persistent grid of 256-thread CTAs, as many as the
// card holds at once, walks the items, one step per item and tile of
// sources.  What it does about the faults of the dense design it replaced
// (a CTA per 8 rows x 32 features, a loop over all N sources):
//   1. Only real edges.  Warp w takes rows w, w + 8, ...; one ballot per 32
//      sources gives the row's edges (a_j != 0) as a bitmask that the whole
//      warp walks with __ffs, reading a_j (a broadcast) and h_j (lane l
//      holds features l + 32 k) from shared memory.  At the molecule shape
//      that is ~3 steps a real row and none for a padding row, not N = 30,
//      and every lane of a warp walks the same row, so nothing diverges.
//   2. Inputs staged once an item.  An item's rows of the adjacency and
//      all of its sources' features go into shared memory with
//      asynchronous copies (cp.async): a contiguous span (a whole graph's
//      features, a block of adjacency rows) as 16-byte copies between
//      16-byte-aligned global addresses, landing at the same alignment in
//      shared memory, and its < 4 first and last floats one by one, since
//      graph starts are not aligned (feats of graph b start at 9,000 b
//      bytes at the molecule shape, adj at 4 N^2 b).  Nothing outside the
//      tensors is read.  A graph is split over several CTAs only when the
//      call has fewer graphs than the card holds CTAs (the serving shape:
//      128 graphs, split in blocks of 8 rows, one a warp).
//   3. Idle lanes stay: F = 75 fills 75 of 96 lane slots, as before.
//      They cost less, since a step is now an edge and not a source, and
//      keeping a warp on one row is what keeps its walk from diverging.
//   4. Overlap.  The next step's copies are issued right after the barrier
//      that opens a step, into the other of two buffers, so they are in
//      flight while the CTA walks and stores (and the two or three other
//      CTAs of the SM overlap it too).
//   5. Aligned output.  A row's [mean | max | min | std] is staged in
//      shared memory; with all F features it is one contiguous span of
//      16 F bytes, always 16-byte aligned, which the warp sends out with one
//      bulk copy (cp.async.bulk, the TMA unit) as soon as it is staged.
// Any N and F: an item holds a whole graph when it fits the shared-memory
// budget (N = 30, F = 75: 61.8 KB, three CTAs an SM); otherwise the
// sources are tiled by multiples of 32 (the partial sums, max and min wait
// in the staging buffer between tiles), then the rows are split, then the
// features (rows of a feature block go out as four pieces each).  The
// results are the dense design's to the bit: the same operations in the
// same order, the zero a_j left out.  No allocation, no synchronisation;
// launched on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneFeats = 3;  // features a lane holds: an item's <= 96
constexpr int kSmemBudget = 100 * 1024;  // per CTA: two or more an SM
constexpr int kMaxDevices = 64;

// ---- inline assembly: asynchronous copies, global -> shared ----
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// ---- bulk copies, shared -> global (the TMA unit) ----
// orders this thread's writes to shared memory before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// bytes (a multiple of 16) from src to dst, both 16-byte aligned
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(s), "r"(bytes)
      : "memory");
}
// waits until the bulk copies have read their sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// waits until the bulk copies are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// ---- end of inline assembly ----

inline long long round4l(long long x) { return (x + 3) & ~3LL; }

// How a call is cut into work items; the same for every CTA.
struct Tiling {
  int n, f;                  // nodes per graph, features
  int rows, srcs, feats;     // per item: destination rows, features; per
                             // tile: sources
  int row_blocks, feat_blocks, src_tiles;
  long long items;           // b * row_blocks * feat_blocks
  int adj_cap, feat_cap;     // floats of one buffer's adjacency / features
  int stage_cap;             // floats of the staging buffer
};

// Floats of shared memory a CTA needs for items of `rows` rows and `feats`
// features, with tiles of `srcs` sources; fills t's buffer sizes if given.
inline long long smem_floats(long long rows, long long srcs, long long feats,
                             Tiling* t = nullptr) {
  // + 4: a span's offset; + 32: what lanes past the last feature read
  const long long adj_cap = round4l(rows * srcs) + 4;
  const long long feat_cap = round4l(srcs * feats) + 36;
  const long long stage_cap = rows * 4 * feats;
  if (t != nullptr) {
    t->adj_cap = static_cast<int>(adj_cap);
    t->feat_cap = static_cast<int>(feat_cap);
    t->stage_cap = static_cast<int>(stage_cap);
  }
  return 2 * (adj_cap + feat_cap) + stage_cap + 2 * rows;
}

// One step: graph b, rows [r0, r0 + nr), features [f0, f0 + nf), sources
// [j0, j0 + nj) of the item; a and h point at its adjacency and feature
// boxes in global memory.
struct Box {
  long long b;
  int r0, nr, f0, nf, j0, nj, tile;
  const float* a;
  const float* h;
};

// Step s of this CTA: tile s % src_tiles of item blockIdx.x + (s /
// src_tiles) gridDim.x (32-bit division where the item count allows it).
__device__ __forceinline__ Box step_box(const Tiling& t, const float* adj,
                                        const float* feats, long long s) {
  Box x;
  x.tile = static_cast<int>(s % t.src_tiles);
  const long long item = blockIdx.x + s / t.src_tiles * gridDim.x;
  int fb, rb;
  if (t.items <= 0x7fffffffLL) {
    const unsigned g = static_cast<unsigned>(item) / t.feat_blocks;
    fb = static_cast<int>(item - g * t.feat_blocks);
    x.b = g / t.row_blocks;
    rb = static_cast<int>(g - x.b * t.row_blocks);
  } else {
    const long long g = item / t.feat_blocks;
    fb = static_cast<int>(item - g * t.feat_blocks);
    x.b = g / t.row_blocks;
    rb = static_cast<int>(g - x.b * t.row_blocks);
  }
  x.r0 = rb * t.rows;
  x.nr = min(t.rows, t.n - x.r0);
  x.f0 = fb * t.feats;
  x.nf = min(t.feats, t.f - x.f0);
  x.j0 = x.tile * t.srcs;
  x.nj = min(t.srcs, t.n - x.j0);
  const long long n = t.n;
  x.a = adj + (x.b * n + x.r0) * n + x.j0;
  x.h = feats + (x.b * n + x.j0) * t.f + x.f0;
  return x;
}

// Where load_box puts a box's first element, in floats past its buffer:
// a contiguous box keeps its source's alignment mod 16 bytes.
__device__ __forceinline__ int box_offset(const float* src, int rows,
                                          int cols, long long stride) {
  return cols == stride || rows == 1
             ? static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3)
             : 0;
}

// Issues the copies of the rows x cols box at src (row stride `stride`
// floats) into dst, which is 16-byte aligned with room for rows * cols + 3
// floats.  A contiguous box goes as 16-byte copies from 16-byte-aligned
// addresses to dst + box_offset (the same alignment), its < 4 head and
// tail floats one by one; any other box one float at a time.
__device__ __forceinline__ void load_box(float* dst, const float* src,
                                         int rows, int cols,
                                         long long stride) {
  const int tid = threadIdx.x;
  const int len = rows * cols;
  if (cols == stride || rows == 1) {
    const int off = box_offset(src, rows, cols, stride);
    const int head = min(len, (4 - off) & 3);
    const int body = (len - head) >> 2;  // 16-byte chunks
    float* d = dst + off;
    for (int c = tid; c < body; c += kThreads)
      cp_async16(d + head + 4 * c, src + head + 4 * c);
    for (int e = tid; e < len - 4 * body; e += kThreads) {
      const int k = e < head ? e : 4 * body + e;  // head, then tail
      cp_async4(d + k, src + k);
    }
    return;
  }
  for (int e = tid; e < len; e += kThreads) {
    const int r = e / cols;
    cp_async4(dst + e, src + r * stride + (e - r * cols));
  }
}

__global__ void __launch_bounds__(kThreads)
pna_aggregate_kernel(const float* __restrict__ adj,
                     const float* __restrict__ feats,
                     float* __restrict__ out, const Tiling t) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const s_feat = smem + 2 * t.adj_cap;
  float* const stage = s_feat + 2 * t.feat_cap;
  float* const s_cnt = stage + t.stage_cap;  // [2][rows], by tile parity
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = t.n;
  if (blockIdx.x >= t.items) return;
  const long long steps =
      (t.items - blockIdx.x + gridDim.x - 1) / gridDim.x * t.src_tiles;
  // std of a row that no edge reaches: sqrt(0 + 1e-12)
  const float std0 = sqrtf(1e-12f);

  // step s reads buffer s % 2; its loads are issued one step ahead
  Box x = step_box(t, adj, feats, 0);
  load_box(smem, x.a, x.nr, x.nj, n);
  load_box(s_feat, x.h, x.nj, x.nf, t.f);
  cp_async_commit();
  for (long long step = 0; step < steps; ++step) {
    cp_async_wait_all();
    if (lane == 0) bulk_wait_read();
    // This step's boxes have landed, and every thread is done with the
    // last step: its buffers, and the bulk copies out of the staging
    // buffer have read it.
    __syncthreads();
    const int buf = static_cast<int>(step & 1);
    Box next = x;
    if (step + 1 < steps) {
      next = step_box(t, adj, feats, step + 1);
      load_box(smem + (buf ^ 1) * t.adj_cap, next.a, next.nr, next.nj, n);
      load_box(s_feat + (buf ^ 1) * t.feat_cap, next.h, next.nj, next.nf,
               t.f);
      cp_async_commit();
    }
    const float* const s_adj =
        smem + buf * t.adj_cap + box_offset(x.a, x.nr, x.nj, n);
    const float* const s_h =
        s_feat + buf * t.feat_cap + box_offset(x.h, x.nj, x.nf, t.f);

    // 2. warp w walks rows w, w + kWarps, ...; lane l holds features
    // l + 32 k (k < lane_feats), whose sums it keeps in registers
    const int tile = x.tile;
    const bool first = tile == 0, last = tile == t.src_tiles - 1;
    const float* const cnt_in = s_cnt + (tile & 1) * t.rows;
    float* const cnt_out = s_cnt + ((tile + 1) & 1) * t.rows;
    const int nf = x.nf;
    const int lane_feats = (nf + 31) >> 5;
    // 4. the output: a row of all F features is one contiguous span of
    // 16 F bytes, 16-byte aligned, which the warp sends out with one bulk
    // copy as soon as it is staged; other rows go out below
    float* const dst = out + (x.b * n + x.r0) * 4LL * t.f + x.f0;
    const bool row_copies =
        nf == t.f && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
    for (int r = warp; r < x.nr; r += kWarps) {
      float* const o = stage + r * 4 * nf + lane;  // feature lane + 32 k
      float cnt = 0.f, s[kLaneFeats], ssq[kLaneFeats], mx[kLaneFeats],
            mn[kLaneFeats];
#pragma unroll
      for (int k = 0; k < kLaneFeats; ++k) {
        s[k] = 0.f;
        ssq[k] = 0.f;
        mx[k] = -1e30f;
        mn[k] = 1e30f;
      }
      if (!first) {
        cnt = cnt_in[r];
#pragma unroll
        for (int k = 0; k < kLaneFeats; ++k) {
          if (k < lane_feats && lane + 32 * k < nf) {
            s[k] = o[32 * k];
            mx[k] = o[32 * k + nf];
            mn[k] = o[32 * k + 2 * nf];
            ssq[k] = o[32 * k + 3 * nf];
          }
        }
      }
      // 3. one ballot per 32 sources leaves the row's edges (a_j != 0) as a
      // bitmask the whole warp walks, so only real edges cost a step: at
      // the molecule shape ~3 a real row, none for a padding row.  Lanes
      // past nf read other features (or the buffer's slack) and store
      // nothing.
      const float* const a_row = s_adj + r * x.nj;
      const float* const h_col = s_h + lane;
      for (int w = 0; w < x.nj; w += 32) {
        unsigned bits = __ballot_sync(
            0xffffffffu, w + lane < x.nj && a_row[w + lane] != 0.f);
        while (bits) {
          const int j = w + __ffs(bits) - 1;
          bits &= bits - 1;
          const float a = a_row[j];
          const float* const h_j = h_col + j * nf;
          cnt += a;
#pragma unroll
          for (int k = 0; k < kLaneFeats; ++k) {
            if (k < lane_feats) {
              const float h = h_j[32 * k];
              s[k] = fmaf(a, h, s[k]);
              ssq[k] = fmaf(a, __fmul_rn(h, h), ssq[k]);
              if (a > 0.f) {
                mx[k] = fmaxf(mx[k], h);
                mn[k] = fminf(mn[k], h);
              }
            }
          }
        }
      }
      if (!last) {  // partial sums wait in the staging buffer
#pragma unroll
        for (int k = 0; k < kLaneFeats; ++k) {
          if (k < lane_feats && lane + 32 * k < nf) {
            o[32 * k] = s[k];
            o[32 * k + nf] = mx[k];
            o[32 * k + 2 * nf] = mn[k];
            o[32 * k + 3 * nf] = ssq[k];
          }
        }
        if (lane == 0) cnt_out[r] = cnt;
        continue;
      }
      const float denom = fmaxf(cnt, 1.f);
      const bool has = cnt > 0.f;
#pragma unroll
      for (int k = 0; k < kLaneFeats; ++k) {
        if (k >= lane_feats || lane + 32 * k >= nf) continue;
        float* const ok = o + 32 * k;
        if (cnt == 0.f && s[k] == 0.f && ssq[k] == 0.f) {
          // what the lines below give for these sums (a padding row),
          // with no division or square root
          ok[0] = 0.f;
          ok[nf] = 0.f;
          ok[2 * nf] = 0.f;
          ok[3 * nf] = std0;
          continue;
        }
        const float mean = s[k] / denom;
        const float var =
            fmaxf(__fsub_rn(ssq[k] / denom, __fmul_rn(mean, mean)), 0.f);
        ok[0] = mean;
        ok[nf] = has ? mx[k] : 0.f;
        ok[2 * nf] = has ? mn[k] : 0.f;
        ok[3 * nf] = sqrtf(var + 1e-12f);
      }
      if (row_copies) {
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) bulk_store(dst + r * 4LL * nf, o - lane, 16 * nf);
      }
    }

    // rows of a block of features: four pieces of nf floats each
    if (last && !row_copies) {
      __syncthreads();
      const int len = x.nr * 4 * nf;
      for (int e = threadIdx.x; e < len; e += kThreads) {
        const int r = e / (4 * nf), c = e - r * 4 * nf;
        const int k = c / nf;
        __stcs(dst + static_cast<long long>(r) * 4 * t.f + k * t.f +
                   (c - k * nf),
               stage[e]);
      }
    }
    x = next;
  }
  if (lane == 0) bulk_wait();
}

// The card's SM count, read once per device; the kernel's shared-memory
// ceiling raised to the budget at the same time.
int sm_count(int dev) {
  static int cached[kMaxDevices];
  int* slot = dev >= 0 && dev < kMaxDevices ? &cached[dev] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(pna_aggregate_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBudget);
  if (slot != nullptr) *slot = sms;
  return sms;
}

void set_blocks(Tiling& t, long long b) {
  t.row_blocks = (t.n + t.rows - 1) / t.rows;
  t.feat_blocks = (t.f + t.feats - 1) / t.feats;
  t.src_tiles = (t.n + t.srcs - 1) / t.srcs;
  t.items = b * t.row_blocks * t.feat_blocks;
}

// CTAs of this tiling the card holds at once
long long slots(const Tiling& t, int sms) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pna_aggregate_kernel, kThreads,
      static_cast<size_t>(4 * smem_floats(t.rows, t.srcs, t.feats)));
  return static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// C entry point.  adj (b, n, n) f32, feats (b, n, f) f32, out (b, n, 4f)
// f32, all contiguous on the current device.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int repro_pna_aggregate(const void* adj, const void* feats,
                                   void* out, int b, int n, int f,
                                   void* stream) {
  if (b == 0 || n == 0 || f == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  cudaGetDevice(&dev);
  const int sms = sm_count(dev);

  // the largest item that fits the budget: whole graphs (at most 32
  // kLaneFeats features), else tiles of sources (multiples of 32), then
  // fewer rows or fewer features (the one whose re-reads cost less), down
  // to one row and one feature
  Tiling t{};
  t.n = n;
  t.f = f;
  t.rows = n;
  t.srcs = n;
  const int feat_blocks = (f + 32 * kLaneFeats - 1) / (32 * kLaneFeats);
  t.feats = (f + feat_blocks - 1) / feat_blocks;
  while (4LL * smem_floats(t.rows, t.srcs, t.feats) > kSmemBudget) {
    if (t.srcs > 32)
      t.srcs = ((t.srcs + 1) / 2 + 31) / 32 * 32;
    else if (t.feats > 32 && f >= n)
      t.feats = (t.feats + 1) / 2;
    else if (t.rows > 1)
      t.rows = (t.rows + 1) / 2;
    else
      t.feats = (t.feats + 1) / 2;
  }
  set_blocks(t, b);
  // fewer items than the card holds CTAs: split the rows to fill it, in
  // blocks of whole rounds of kWarps rows where they are that large
  const long long whole = slots(t, sms);
  if (t.items < whole) {
    const long long blocks =
        whole / (static_cast<long long>(b) * t.feat_blocks);
    if (blocks > t.row_blocks) {
      t.rows = static_cast<int>((n + blocks - 1) / blocks);
      if (t.rows > kWarps) t.rows -= t.rows % kWarps;
      set_blocks(t, b);
    }
  }
  const long long held = slots(t, sms);
  const int smem = static_cast<int>(4 * smem_floats(t.rows, t.srcs, t.feats,
                                                     &t));
  const long long grid = t.items < held ? t.items : held;
  pna_aggregate_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<const float*>(feats),
      static_cast<float*>(out), t);
  return static_cast<int>(cudaGetLastError());
}
