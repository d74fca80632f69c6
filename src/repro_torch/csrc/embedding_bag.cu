// embedding_bag: ragged gather + bag reduce (sum or mean), for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas
//   (body _embedding_bag_kernel), which takes one bag per grid step and
//   double-buffers one table row at a time by DMA into VMEM.
//
// What it computes: for bag b and column c,
//   sum:  out[b, c] = sum over j with ids[b, j] >= 0 of table[row_j, c]
//   mean: that sum / max(count, 1), count = #{j : ids[b, j] >= 0}
// with row_j = min(ids[b, j], V - 1).  So an id >= V reads row V - 1 and
// counts as valid, as on the TPU.  An id < 0 is skipped without reading its
// row (the TPU kernel loads row 0 and masks it out: the same result, fewer
// bytes).  The rows are added in the order of the bag, in fp32.
//
// What bounds it on an H100: bytes.  Each valid id costs one random row of
// D floats (1 KB at D = 256) and D adds; nothing is reused.  Row offsets
// are 64-bit: the two-tower user table (4,194,304 x 256 floats) is 2^30
// elements, 4.29 GB.
//
// Design: one warp per bag.  With D % 4 == 0 and 16-byte aligned rows each
// lane holds up to two float4 columns (one pass covers 256 columns, all of
// D = 256); otherwise up to eight scalar columns.  Wider rows take more
// passes.  The next id's row is loaded into registers while the current
// one is added, so two row reads are in flight per warp.  No allocation,
// no synchronisation; launched on the caller's stream.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

struct Vec4 {
  using T = float4;
  static constexpr int kWidth = 4;  // floats per element
  static constexpr int kPer = 2;    // elements per lane per pass
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  __device__ static T scale(T a, float div) {
    a.x /= div; a.y /= div; a.z /= div; a.w /= div;
    return a;
  }
};

struct Scalar {
  using T = float;
  static constexpr int kWidth = 1;
  static constexpr int kPer = 8;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, const T& b) { a += b; }
  __device__ static T scale(T a, float div) { return a / div; }
};

// one warp per bag; cols = D / kWidth elements of type V::T per row
template <class V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_kernel(const int* __restrict__ ids,
                     const typename V::T* __restrict__ table,
                     typename V::T* __restrict__ out, int b, int l, int v,
                     int cols, bool mean) {
  using T = typename V::T;
  const long long bag =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bag >= b) return;  // whole warp leaves together
  const int* bag_ids = ids + bag * l;
  int cnt = 0;
  for (int j = 0; j < l; ++j) cnt += __ldg(bag_ids + j) >= 0;
  const float div = static_cast<float>(max(cnt, 1));

  for (int c0 = 0; c0 < cols; c0 += 32 * V::kPer) {
    T acc[V::kPer], cur[V::kPer], nxt[V::kPer];
#pragma unroll
    for (int k = 0; k < V::kPer; ++k) {
      acc[k] = V::zero();
      nxt[k] = V::zero();
    }
    // row j's columns c0 + lane + 32 k of this pass, or zeros for id < 0
    auto load = [&](int j, T* dst) {
      const int id = __ldg(bag_ids + j);
      if (id < 0) {
#pragma unroll
        for (int k = 0; k < V::kPer; ++k) dst[k] = V::zero();
        return;
      }
      const T* row = table + static_cast<long long>(min(id, v - 1)) * cols;
#pragma unroll
      for (int k = 0; k < V::kPer; ++k) {
        const int c = c0 + lane + 32 * k;
        dst[k] = c < cols ? __ldg(row + c) : V::zero();
      }
    };
    if (l > 0) load(0, nxt);
    for (int j = 0; j < l; ++j) {
#pragma unroll
      for (int k = 0; k < V::kPer; ++k) cur[k] = nxt[k];
      if (j + 1 < l) load(j + 1, nxt);
#pragma unroll
      for (int k = 0; k < V::kPer; ++k) V::add(acc[k], cur[k]);
    }
    T* o = out + bag * cols;
#pragma unroll
    for (int k = 0; k < V::kPer; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < cols) o[c] = mean ? V::scale(acc[k], div) : acc[k];
    }
  }
}

template <class V>
void launch(const int* ids, const void* table, void* out, int b, int l,
            int v, int d, bool mean, cudaStream_t stream) {
  const int threads = kWarpsPerBlock * 32;
  const long long blocks = (static_cast<long long>(b) + kWarpsPerBlock - 1) /
                           kWarpsPerBlock;
  embedding_bag_kernel<V><<<static_cast<unsigned>(blocks), threads, 0,
                            stream>>>(
      ids, static_cast<const typename V::T*>(table),
      static_cast<typename V::T*>(out), b, l, v, d / V::kWidth, mean);
}

}  // namespace

// C entry point.  ids (b, l) int32, table (v, d) f32, out (b, d) f32, all
// contiguous on the current device, v >= 1; mode_mean 0 = sum, 1 = mean.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_embedding_bag(const void* ids, const void* table,
                                   void* out, int b, int l, int v, int d,
                                   int mode_mean, void* stream) {
  if (b == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (d % 4) == 0 &&
                    (reinterpret_cast<unsigned long long>(table) % 16) == 0 &&
                    (reinterpret_cast<unsigned long long>(out) % 16) == 0;
  if (vec4) {
    launch<Vec4>(static_cast<const int*>(ids), table, out, b, l, v, d,
                 mode_mean != 0, s);
  } else {
    launch<Scalar>(static_cast<const int*>(ids), table, out, b, l, v, d,
                   mode_mean != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
