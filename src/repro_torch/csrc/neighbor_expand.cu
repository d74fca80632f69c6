// neighbor_expand: fused Figure 4 candidate expansion, for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/neighbor_expand/kernel.py::neighbor_expand_pallas
//   (body _neighbor_expand_kernel), which per query lane DMAs the 2-hop rows
//   into VMEM and runs one sequential scalar scan over the candidate stream.
//
// What it computes, per query lane b: walk the candidate stream of the
// strategy in order and pack the first m candidates that are valid (>= 0),
// pass the predicate (pass_mask[b, c]), are unvisited (!visited[b, c]) and,
// except under 'filter', are the first occurrence of their id.  Streams:
//   filter   row[0:cap]                                    (no dedup)
//   compress row[0:m_beta], then for each tail id t = row[m_beta + i]:
//            t itself, then its level row N(t) left to right
//   two_hop  row[0:cap], then the j-th entry of every 1-hop node's row
//            before the (j+1)-th of any (breadth-first interleave)
// A tail id whose row is absent (invalid, pos = -1, or an empty level table)
// contributes -1s, but under 'compress' the tail id itself still counts.
//
// What bounds it on an H100: random DRAM accesses and the chain of
// dependent round trips, not bytes.  Every stream position a lane reaches
// costs one random pass_mask byte (its own 32 B sector), and a lane reaches
// many: on the search path level-0 rows are 144 wide (cap0 = 128 plus 16
// reverse-slack slots), so a compress stream at m_beta = 64 is 11,664
// positions, and at label selectivity 1/12 a lane passes several hundred of
// them, past duplicates and visited ids, before 32 pack; late in a search
// it may walk the whole stream (chip_smoke.py logs the mean and largest stop
// position per shape).  Before its first test a lane waits on row -> pos ->
// neighbour row -> pass_mask -> visited.
//
// Design: one CTA (256 threads) per query lane, walking the stream in
// rounds of at most 512 positions, 2 per thread (thread t takes positions
// base + k * 256 + t, k < 2, so a warp reads 32 consecutive entries of one
// neighbour row).  A round reads mask bytes up to its end, so it is kept
// narrow: wider rounds read more bytes past a lane's stop than they save in
// round trips.  Per round:
//  1. the candidates were fetched by the round before (the first by the
//     prologue): head and tail ids from the lane's 1-hop row in shared
//     memory, the rest one table load each, issued together.  The round
//     issues its pass_mask loads together, then, while they are in flight,
//     the next round's table loads and the level-row lookups (pos) of the
//     tails two rounds ahead, so only the tails the walk reaches are looked
//     up; then the visited loads of the candidates that passed the
//     predicate (skipping the ~11/12 that fail saves a sector each).  A
//     round after the first costs two round trips (pass_mask, visited).
//     Index arithmetic is 32-bit;
//  2. dedup (not under 'filter') by one open-addressed hash set in shared
//     memory, keyed by id (Fibonacci hash, linear probing), holding only
//     candidates that passed both tests.  A slot is one 64-bit word,
//     (id << 32) | stream position: atomicCAS inserts an id, atomicMin keeps
//     the smallest position seen for it, and after a barrier a candidate
//     survives iff its position is its slot's.  The tests are pure
//     functions of the id, so the first passing occurrence is the first
//     occurrence, and an id inserted in an earlier round either packed or
//     the lane stopped: the one set replaces both the packed-id scan and the
//     in-round dedup.  It holds < m ids from earlier rounds plus <= 512 from
//     this one, so 2^bits >= 2 (m + 512) slots keep it at most half full
//     (2,048 slots, 16 KB, at m = 32);
//  3. one block-wide exclusive scan in stream order packs the survivors:
//     a ballot per (k, warp), 16 counts in shared memory, and each thread
//     sums the counts that precede it.  Survivors with rank < m write their
//     slot of out; candidates read past the m-th are dropped, so the output
//     is still the first m in stream order.  The loop stops once m packed.
//     Otherwise the next round takes 256 or 512 positions: as many as the
//     yield so far says the missing ids need.
// Two barriers a round (one under 'filter').  Above 48 KB of shared memory
// (m > 1,536) the entry point opts in to the larger carve-out.  Launched on
// the caller's stream; allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;                  // most positions a thread, a round
constexpr int kRound = kThreads * kPer;  // widest round: 512 positions
// survivors per (round parity, k, warp), for the scan
constexpr int kCountInts = 2 * kPer * kWarps;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kDefaultSmem = 48 * 1024;  // above it a launch must opt in

enum Strategy { kFilter = 0, kCompress = 1, kTwoHop = 2 };

// log2 of the hash set's slots: the least power of two >= 2 (m + kRound)
int hash_bits(int m) {
  int bits = 1;
  while ((1LL << bits) < 2LL * (m + kRound)) ++bits;
  return bits;
}

// Insert (id c, stream position s) and return its slot; the slot keeps the
// smallest position inserted for c.
__device__ __forceinline__ int set_insert(unsigned long long* set, int bits,
                                          int c, int s) {
  const unsigned long long key =
      (static_cast<unsigned long long>(static_cast<unsigned>(c)) << 32) |
      static_cast<unsigned>(s);
  const unsigned mask = (1u << bits) - 1u;
  unsigned slot = (static_cast<unsigned>(c) * 0x9E3779B1u) >> (32 - bits);
  while (true) {
    const unsigned long long prev = atomicCAS(set + slot, kEmpty, key);
    if (prev == kEmpty) return static_cast<int>(slot);
    if (static_cast<unsigned>(prev >> 32) == static_cast<unsigned>(c)) {
      atomicMin(set + slot, key);
      return static_cast<int>(slot);
    }
    slot = (slot + 1u) & mask;
  }
}

// The shape of a lane's stream: positions [0, head) are s_row[0, head);
// under compress, position head + i * (cap + 1) is tail id i and the next
// cap its level row; under two_hop, position head + j * t_len + i is entry
// j of expanded row i.
struct Stream {
  int strategy, head, t_off, t_len, total, cap;
  unsigned row_len;
  // tails whose level row some position < limit reads, as a count
  __device__ int tails_before(int limit) const {
    if (strategy == kTwoHop) return limit > head ? t_len : 0;
    if (strategy == kFilter || limit <= head) return 0;
    return min(t_len, static_cast<int>((limit - head - 1) / row_len) + 1);
  }
};

// The level-table row of tail id t (-1 if invalid or absent), issued as a
// load; clamp_row finishes it once the load has landed.
__device__ __forceinline__ int pos_load(const int* __restrict__ pos, int t,
                                        int n, int n_l) {
  return t >= 0 && n_l > 0 ? __ldg(pos + min(t, n - 1)) : -1;
}
__device__ __forceinline__ int clamp_row(int p, int n_l) {
  return p >= 0 ? min(p, n_l - 1) : -1;
}

// The candidates at positions start + k * kThreads + tid, k < kPer (-1 past
// the stream): head and tail ids from shared memory, the rest as kPer
// table loads issued together.  The level rows they read must be in
// s_exp_rows.
__device__ __forceinline__ void fetch(const Stream& st, int start, int tid,
                                      const int* s_row,
                                      const int* s_exp_rows,
                                      const int* __restrict__ tbl,
                                      int (&c)[kPer]) {
  long long at[kPer];  // table entry to load, or -1
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int s = start + k * kThreads + tid;
    c[k] = -1;
    at[k] = -1;
    if (s >= st.total) continue;
    if (s < st.head) {
      c[k] = s_row[s];
      continue;
    }
    // compress: tail hi, offset lo in [t, N(t)]; two_hop: entry hi of
    // expanded row lo
    const unsigned u = static_cast<unsigned>(s - st.head);
    const unsigned hi = u / st.row_len;
    const unsigned lo = u - hi * st.row_len;
    if (st.strategy == kCompress) {
      if (lo == 0) {
        c[k] = s_row[st.t_off + hi];
      } else {
        const int p = s_exp_rows[hi];
        if (p >= 0) at[k] = static_cast<long long>(p) * st.cap + lo - 1;
      }
    } else {
      const int p = s_exp_rows[lo];
      if (p >= 0) at[k] = static_cast<long long>(p) * st.cap + hi;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (at[k] >= 0) c[k] = __ldg(tbl + at[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
neighbor_expand_kernel(const int* __restrict__ row,
                       const int* __restrict__ tbl,
                       const int* __restrict__ pos,
                       const unsigned char* __restrict__ pass_mask,
                       const unsigned char* __restrict__ visited,
                       int* __restrict__ out, int strategy, int m, int m_beta,
                       int n, int n_l, int cap, int bits) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_set = smem;                          // (2^bits)
  int* s_cnt = reinterpret_cast<int*>(smem + (1 << bits));   // (kCountInts)
  int* s_row = s_cnt + kCountInts;                           // (cap)
  int* s_exp_rows = s_row + cap;   // (cap) level row of each expanded id

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long lane_b = blockIdx.x;
  const int* r = row + lane_b * cap;
  int* o = out + lane_b * m;
  const bool dedup = strategy != kFilter;
  if (dedup) {
    for (int i = tid; i < (1 << bits); i += kThreads) s_set[i] = kEmpty;
  }
  for (int i = tid; i < cap; i += kThreads) s_row[i] = r[i];

  Stream st;
  st.strategy = strategy;
  st.cap = cap;
  if (strategy == kFilter) {
    st.head = cap; st.t_off = 0; st.t_len = 0; st.total = cap;
  } else if (strategy == kCompress) {
    st.head = m_beta; st.t_off = m_beta; st.t_len = cap - m_beta;
    st.total = st.head + st.t_len * (cap + 1);
  } else {
    st.head = cap; st.t_off = 0; st.t_len = cap; st.total = cap + cap * cap;
  }
  st.row_len = strategy == kCompress ? cap + 1 : st.t_len;
  __syncthreads();
  // level rows of the tails the first two rounds can reach
  int pos_ready = st.tails_before(2 * kRound);
  for (int i = tid; i < pos_ready; i += kThreads) {
    s_exp_rows[i] = clamp_row(pos_load(pos, s_row[st.t_off + i], n, n_l),
                              n_l);
  }
  __syncthreads();

  const unsigned char* pm = pass_mask ? pass_mask + lane_b * n : nullptr;
  const unsigned char* vis = visited ? visited + lane_b * n : nullptr;
  const unsigned lt_mask = (1u << lane) - 1u;
  int count = 0;
  int kr = kPer;  // this round's positions per thread
  int c[kPer];
  fetch(st, 0, tid, s_row, s_exp_rows, tbl, c);

  for (int base = 0, rnd = 0; base < st.total; rnd ^= 1) {
    const int end = min(base + kr * kThreads, st.total);
    // 1. the predicate loads of this round, all issued together
    bool ok[kPer];
    unsigned char pv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      ok[k] = k < kr && c[k] >= 0;
      pv[k] = ok[k] && pm ? __ldg(pm + min(c[k], n - 1)) : 1;
    }
    // meanwhile: the next round's table entries (its level rows are in
    // s_exp_rows) and the level rows two rounds ahead
    int next[kPer];
    fetch(st, end, tid, s_row, s_exp_rows, tbl, next);
    const int pos_to = st.tails_before(end + 2 * kRound);
    const int my_tail = pos_ready + tid;
    const int my_pos = my_tail < pos_to
        ? pos_load(pos, s_row[st.t_off + my_tail], n, n_l) : -1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) ok[k] = ok[k] && pv[k] != 0;
    if (vis) {
      unsigned char vv[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        vv[k] = ok[k] ? __ldg(vis + min(c[k], n - 1)) : 1;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) ok[k] = vv[k] == 0;
    }

    // 2. first occurrence: the slot keeps the smallest position of its id
    if (dedup) {
      int slot[kPer] = {};
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (ok[k]) slot[k] = set_insert(s_set, bits, c[k],
                                        base + k * kThreads + tid);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (ok[k]) {
          ok[k] = static_cast<unsigned>(s_set[slot[k]]) ==
                  static_cast<unsigned>(base + k * kThreads + tid);
        }
      }
    }
    if (my_tail < pos_to) s_exp_rows[my_tail] = clamp_row(my_pos, n_l);
    for (int i = my_tail + kThreads; i < pos_to; i += kThreads) {
      s_exp_rows[i] = clamp_row(pos_load(pos, s_row[st.t_off + i], n, n_l),
                                n_l);
    }
    pos_ready = max(pos_ready, pos_to);

    // 3. exclusive scan in stream order: (k, warp, lane)
    unsigned bal[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      bal[k] = __ballot_sync(0xffffffffu, ok[k]);
      if (lane == 0) {
        s_cnt[(rnd * kPer + k) * kWarps + warp] = __popc(bal[k]);
      }
    }
    __syncthreads();
    int before[kPer] = {};
    int run = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) before[k] = run;
        run += s_cnt[(rnd * kPer + k) * kWarps + w];
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (ok[k]) {
        const int rank = count + before[k] + __popc(bal[k] & lt_mask);
        if (rank < m) o[rank] = c[k];
      }
    }
    count += run;  // the same in every thread: the loop exits together
    if (count >= m) break;
    // the next round: as many positions as the yield so far says the
    // missing ids need, in whole multiples of kThreads, at most kPer
    const long long need =
        count > 0 ? (static_cast<long long>(m - count) * end + count - 1) /
                        count
                  : static_cast<long long>(kRound);
    kr = static_cast<int>(min(static_cast<long long>(kPer),
                              (need + kThreads - 1) / kThreads));
    base = end;
#pragma unroll
    for (int k = 0; k < kPer; ++k) c[k] = next[k];
  }
  for (int i = min(count, m) + tid; i < m; i += kThreads) o[i] = -1;
}

}  // namespace

// Dynamic shared memory the kernel needs for a (cap, m) launch, in bytes.
extern "C" int repro_neighbor_expand_smem_bytes(int cap, int m) {
  return static_cast<int>((1LL << hash_bits(m)) * sizeof(unsigned long long) +
                          (kCountInts + 2LL * cap) * sizeof(int));
}

// C entry point.  row (b, cap) int32; tbl (n_l, cap) int32; pos (n,) int32;
// pass_mask, visited (b, n) bool or null; out (b, m) int32.  All contiguous
// on the current device.  strategy 0 = filter, 1 = compress, 2 = two_hop;
// b, m, cap >= 1; 0 <= m_beta <= cap; the stream (cap + cap^2 at most) must
// fit in 31 bits and the shared memory in the device's opt-in limit.  Every
// slot of out is written (-1 where nothing packs).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_neighbor_expand(const void* row, const void* tbl,
                                     const void* pos, const void* pass_mask,
                                     const void* visited, void* out, int b,
                                     int cap, int n, int n_l, int m,
                                     int m_beta, int strategy, void* stream) {
  if (static_cast<long long>(cap) * (cap + 1) + cap >= (1LL << 31) - kRound) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = repro_neighbor_expand_smem_bytes(cap, m);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        neighbor_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  neighbor_expand_kernel<<<b, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row), static_cast<const int*>(tbl),
      static_cast<const int*>(pos),
      static_cast<const unsigned char*>(pass_mask),
      static_cast<const unsigned char*>(visited), static_cast<int*>(out),
      strategy, m, m_beta, n, n_l, cap, hash_bits(m));
  return static_cast<int>(cudaGetLastError());
}
