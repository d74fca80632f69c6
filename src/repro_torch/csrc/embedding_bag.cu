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
//
// 16-bit tables (bf16, fp16): the rows are read as stored, half the bytes
// of fp32 (16-byte loads of 8 elements when D % 8 == 0 and the table and
// output are 16 B aligned, one element a load otherwise), widened to fp32
// in registers and added in fp32; mean divides in fp32, and the output is
// rounded once (to nearest even) to the table's dtype, which is the
// reference's output dtype.  An fp32 table keeps its float4 (or scalar)
// loads and adds them in the order of the bag.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// A lane's piece of a row: a stored element of type T (kWidth columns),
// added into an accumulator of type A, written back as T.
struct Vec4 {
  using T = float4;
  using A = float4;
  static constexpr int kWidth = 4;  // columns per element
  static constexpr int kPer = 2;    // elements per lane per pass
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static A acc0() { return zero(); }
  __device__ static void add(A& a, const T& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  __device__ static T out(A a, bool mean, float div) {
    if (mean) {
      a.x /= div; a.y /= div; a.z /= div; a.w /= div;
    }
    return a;
  }
};

struct Scalar {
  using T = float;
  using A = float;
  static constexpr int kWidth = 1;
  static constexpr int kPer = 8;
  __device__ static T zero() { return 0.f; }
  __device__ static A acc0() { return 0.f; }
  __device__ static void add(A& a, const T& b) { a += b; }
  __device__ static T out(A a, bool mean, float div) {
    return mean ? a / div : a;
  }
};

// 16-bit storage: bits -> fp32, and fp32 -> bits rounded to nearest even
struct BF16 {
  __device__ static float widen(uint32_t h) {
    return __uint_as_float(h << 16);
  }
  __device__ static uint32_t narrow(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
struct F16 {
  __device__ static float widen(uint32_t h) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
  }
  __device__ static uint32_t narrow(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};

struct Acc8 {
  float v[8];
};

// 8 16-bit columns per 16-byte element
template <class H>
struct Vec8 {
  using T = uint4;
  using A = Acc8;
  static constexpr int kWidth = 8;
  static constexpr int kPer = 1;
  __device__ static T zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static A acc0() { return A{}; }
  __device__ static void add(A& a, const T& b) {
    const uint32_t w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // the lower address first
      a.v[2 * j] += H::widen(w[j] & 0xFFFFu);
      a.v[2 * j + 1] += H::widen(w[j] >> 16);
    }
  }
  __device__ static T out(A a, bool mean, float div) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = mean ? a.v[2 * j] / div : a.v[2 * j];
      const float hi = mean ? a.v[2 * j + 1] / div : a.v[2 * j + 1];
      w[j] = H::narrow(lo) | (H::narrow(hi) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// one 16-bit column per element
template <class H>
struct Half1 {
  using T = unsigned short;
  using A = float;
  static constexpr int kWidth = 1;
  static constexpr int kPer = 8;
  __device__ static T zero() { return 0; }
  __device__ static A acc0() { return 0.f; }
  __device__ static void add(A& a, const T& b) { a += H::widen(b); }
  __device__ static T out(A a, bool mean, float div) {
    return static_cast<T>(H::narrow(mean ? a / div : a));
  }
};

// one warp per bag; cols = D / kWidth elements of type V::T per row
template <class V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_kernel(const int* __restrict__ ids,
                     const typename V::T* __restrict__ table,
                     typename V::T* __restrict__ out, int b, int l, int v,
                     int cols, bool mean) {
  using T = typename V::T;
  using A = typename V::A;
  const long long bag =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bag >= b) return;  // whole warp leaves together
  const int* bag_ids = ids + bag * l;
  int cnt = 0;
  for (int j = 0; j < l; ++j) cnt += __ldg(bag_ids + j) >= 0;
  const float div = static_cast<float>(max(cnt, 1));

  for (int c0 = 0; c0 < cols; c0 += 32 * V::kPer) {
    A acc[V::kPer];
    T cur[V::kPer], nxt[V::kPer];
#pragma unroll
    for (int k = 0; k < V::kPer; ++k) {
      acc[k] = V::acc0();
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
      if (c < cols) o[c] = V::out(acc[k], mean, div);
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

// C entry point.  ids (b, l) int32, table (v, d) and out (b, d) of
// table_type (0 = fp32, 1 = bf16, 2 = fp16), all contiguous on the current
// device, v >= 1; mode_mean 0 = sum, 1 = mean.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int repro_embedding_bag(const void* ids, const void* table,
                                   void* out, int b, int l, int v, int d,
                                   int mode_mean, int table_type,
                                   void* stream) {
  if (b == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (table_type < 0 || table_type > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto id = static_cast<const int*>(ids);
  const bool mean = mode_mean != 0;
  const bool aligned =
      (reinterpret_cast<unsigned long long>(table) % 16) == 0 &&
      (reinterpret_cast<unsigned long long>(out) % 16) == 0;
  if (table_type == 0) {
    if (aligned && (d % 4) == 0) {
      launch<Vec4>(id, table, out, b, l, v, d, mean, s);
    } else {
      launch<Scalar>(id, table, out, b, l, v, d, mean, s);
    }
  } else if (aligned && (d % 8) == 0) {
    if (table_type == 1) {
      launch<Vec8<BF16>>(id, table, out, b, l, v, d, mean, s);
    } else {
      launch<Vec8<F16>>(id, table, out, b, l, v, d, mean, s);
    }
  } else if (table_type == 1) {
    launch<Half1<BF16>>(id, table, out, b, l, v, d, mean, s);
  } else {
    launch<Half1<F16>>(id, table, out, b, l, v, d, mean, s);
  }
  return static_cast<int>(cudaGetLastError());
}
