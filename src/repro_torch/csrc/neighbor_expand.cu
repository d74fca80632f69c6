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
// What bounds it on an H100: latency of dependent random reads (row ->
// pos -> neighbour row -> mask bytes), not bandwidth: a lane usually fills m
// within its first chunk of candidates, so each lane touches a few KB.
//
// Design: one CTA (256 threads) per query lane; one candidate per thread per
// chunk of 256 stream positions.  The TPU kernel's own observation makes the
// scan parallel: the predicate and visited tests are pure functions of the
// id, so a repeat of an id that did not pack can never pack, and the only
// dedup set needed is the <= m ids already packed (kept in shared memory).
// Per chunk: each thread computes its candidate (the lane's 1-hop row and
// the table row of every expanded id sit in shared memory, loaded once),
// tests it, drops it if already packed or if an earlier thread of the chunk
// holds the same id, and a block prefix sum (warp ballots) gives its output
// slot.  The loop stops as soon as m ids are packed.  Launched on the
// caller's stream; allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Strategy { kFilter = 0, kCompress = 1, kTwoHop = 2 };

__global__ void neighbor_expand_kernel(const int* __restrict__ row,
                                       const int* __restrict__ tbl,
                                       const int* __restrict__ pos,
                                       const unsigned char* __restrict__ pass_mask,
                                       const unsigned char* __restrict__ visited,
                                       int* __restrict__ out, int strategy,
                                       int m, int m_beta, int n, int n_l,
                                       int cap) {
  extern __shared__ int smem[];
  int* s_row = smem;                // (cap) the lane's 1-hop row
  int* s_exp_rows = s_row + cap;    // (cap) table row of each expanded id
  int* s_packed = s_exp_rows + cap; // (m) ids packed so far
  int* s_cand = s_packed + m;       // (kThreads) this chunk's survivors
  __shared__ int s_warp_tot[kWarps];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const long long lane_b = blockIdx.x;
  const int* r = row + lane_b * cap;
  int* o = out + lane_b * m;
  for (int i = tid; i < cap; i += kThreads) s_row[i] = r[i];
  for (int i = tid; i < m; i += kThreads) o[i] = -1;
  if (tid == 0) s_count = 0;

  int head, t_off, t_len;
  if (strategy == kFilter) {
    head = cap; t_off = 0; t_len = 0;
  } else if (strategy == kCompress) {
    head = m_beta; t_off = m_beta; t_len = cap - m_beta;
  } else {
    head = cap; t_off = 0; t_len = cap;
  }
  __syncthreads();
  for (int i = tid; i < t_len; i += kThreads) {
    const int t = s_row[t_off + i];
    int p = -1;
    if (t >= 0 && n_l > 0) {
      p = pos[min(t, n - 1)];
      if (p >= 0) p = min(p, n_l - 1);
    }
    s_exp_rows[i] = p;
  }
  __syncthreads();

  long long total = head;
  if (strategy == kCompress) total += static_cast<long long>(t_len) * (cap + 1);
  if (strategy == kTwoHop) total += static_cast<long long>(t_len) * cap;
  const bool dedup = strategy != kFilter;
  const unsigned char* pm = pass_mask ? pass_mask + lane_b * n : nullptr;
  const unsigned char* vis = visited ? visited + lane_b * n : nullptr;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (long long base = 0; base < total; base += kThreads) {
    const long long s = base + tid;
    int c = -1;
    if (s < total) {
      if (s < head) {
        c = s_row[s];
      } else {
        const long long u = s - head;
        if (strategy == kCompress) {
          const int tt = static_cast<int>(u / (cap + 1));
          const int rr = static_cast<int>(u % (cap + 1));
          if (rr == 0) {
            c = s_row[t_off + tt];
          } else {
            const int p = s_exp_rows[tt];
            c = p >= 0 ? tbl[static_cast<long long>(p) * cap + rr - 1] : -1;
          }
        } else {  // two_hop
          const int j = static_cast<int>(u / t_len);
          const int tt = static_cast<int>(u % t_len);
          const int p = s_exp_rows[tt];
          c = p >= 0 ? tbl[static_cast<long long>(p) * cap + j] : -1;
        }
      }
    }
    bool ok = c >= 0;
    if (ok) {
      const int sc = min(c, n - 1);
      if (pm) ok = pm[sc] != 0;
      if (ok && vis) ok = vis[sc] == 0;
    }
    const int count = s_count;
    if (ok && dedup) {
      for (int i = 0; i < count; ++i) {
        if (s_packed[i] == c) { ok = false; break; }
      }
    }
    s_cand[tid] = ok ? c : -1;
    __syncthreads();
    if (ok && dedup) {
      // every occurrence of an id shares its verdict, so the earliest
      // surviving occurrence in the chunk is the one that packs
      for (int i = 0; i < tid; ++i) {
        if (s_cand[i] == c) { ok = false; break; }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) s_warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, chunk_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_warp_tot[w];
      if (w < warp) before += v;
      chunk_total += v;
    }
    const int rank = count + before + __popc(ballot & ((1u << lane) - 1u));
    if (ok && rank < m) {
      s_packed[rank] = c;
      o[rank] = c;
    }
    __syncthreads();
    if (tid == 0) s_count = min(count + chunk_total, m);
    __syncthreads();
    if (s_count >= m) break;
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for a (cap, m) launch, in bytes.
extern "C" int repro_neighbor_expand_smem_bytes(int cap, int m) {
  return static_cast<int>((2LL * cap + m + kThreads) * sizeof(int));
}

// C entry point.  row (b, cap) int32; tbl (n_l, cap) int32; pos (n,) int32;
// pass_mask, visited (b, n) bool or null; out (b, m) int32.  All contiguous
// on the current device.  strategy 0 = filter, 1 = compress, 2 = two_hop;
// b, m, cap >= 1; 0 <= m_beta <= cap.  Every slot of out is written (-1
// where nothing packs).  Returns cudaGetLastError() after the launch.
extern "C" int repro_neighbor_expand(const void* row, const void* tbl,
                                     const void* pos, const void* pass_mask,
                                     const void* visited, void* out, int b,
                                     int cap, int n, int n_l, int m,
                                     int m_beta, int strategy, void* stream) {
  const int smem = repro_neighbor_expand_smem_bytes(cap, m);
  neighbor_expand_kernel<<<b, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row), static_cast<const int*>(tbl),
      static_cast<const int*>(pos),
      static_cast<const unsigned char*>(pass_mask),
      static_cast<const unsigned char*>(visited), static_cast<int*>(out),
      strategy, m, m_beta, n, n_l, cap);
  return static_cast<int>(cudaGetLastError());
}
