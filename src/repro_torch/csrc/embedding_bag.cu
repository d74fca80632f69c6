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
// bytes).  The rows are added in the order of the bag, in fp32, into an
// accumulator that starts at +0.0 (so skipping an id < 0 gives the bits of
// adding a zero row).
//
// What bounds it on an H100: bytes, and at few bags the launch and two
// dependent trips to device memory (the ids, then the rows they name).
// Each valid id costs one random row of D elements (1 KB at D = 256 in
// fp32) and D adds; nothing is reused.  Row offsets are 64-bit: the
// two-tower user table (4,194,304 x 256 floats) is 2^30 elements, 4.29 GB.
//
// Design (redesigned for Hopper; the first version read a bag's ids one by
// one, twice, and kept two rows in flight per warp):
//  - Ids once, coalesced: lane j holds id j of a chunk of 32; a ballot
//    gives the chunk's valid ids, __popc their count, and each valid id
//    reaches the warp by __shfl_sync, lowest lane first (the bag's order).
//  - All rows of a short bag in flight before the first add: the loads of
//    up to kRows = 4 valid rows are issued, then added in bag order.  Rows
//    are read with the streaming hint (__ldcs) and the output written with
//    __stcs: nothing is read twice.
//  - Width split: a bag's columns go to 1-4 warps, each a slice of whole
//    16-byte elements (slice_cols columns, a multiple of 8), so that at
//    few bags the grid still covers the SMs.  Each column is summed by one
//    lane in the same order, so the split leaves the bits alone.  The
//    launcher picks the split and the block size
//    (kernels/embedding_bag/kernel.py::launch_shape).
// What is left: at many bags the loads keep the memory busy, and a call
// that starts with dirty lines in the L2 (as after the timing's overwrite,
// or a step that wrote its output) also pays for writing them back, which
// the bytes bound does not count; at few bags the launch and the two trips.
//
// Tried and not kept (tests/bag_tma_variant.cu, timed by
// tests/bag_variants_probe.py): a persistent kernel whose producer lane
// copies each valid row into a ring in shared memory with cp.async.bulk
// (Hopper's form of the TPU kernel's DMA double buffer), consumer warps
// adding from there.  A 512 B or 1 KB row is too small a copy for it: an SM
// completed 5-10 rows a microsecond at 2-8 blocks, 1.5-3x slower than these
// loads.
//
// Element types: an fp32 table with D % 4 == 0 and 16-byte aligned table
// and output is read as float4, otherwise one float at a time.  16-bit
// tables (bf16, fp16) are read as stored, half the bytes of fp32 (16-byte
// loads of 8 elements when D % 8 == 0 and aligned, one element a load
// otherwise), widened to fp32 in registers and added in fp32; mean divides
// in fp32, and the output is rounded once (to nearest even) to the table's
// dtype, which is the reference's output dtype.  No allocation, no
// synchronisation; launched on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxWarpsPerBag = 4;
constexpr int kSliceQuantum = 8;  // columns: one 16-byte element at 16 bits
constexpr int kRows = 4;          // rows of a bag loaded before their adds
constexpr unsigned kAll = 0xFFFFFFFFu;

// A lane's piece of a row: kPer stored elements of type T (kWidth columns
// each) per pass, added into accumulators of type A, written back as T.
struct Vec4 {
  using T = float4;
  using A = float4;
  static constexpr int kWidth = 4;
  static constexpr int kPer = 1;
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
  static constexpr int kPer = 4;
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
  static constexpr int kPer = 4;
  __device__ static T zero() { return 0; }
  __device__ static A acc0() { return 0.f; }
  __device__ static void add(A& a, const T& b) { a += H::widen(b); }
  __device__ static T out(A a, bool mean, float div) {
    return static_cast<T>(H::narrow(mean ? a / div : a));
  }
};

// Warp w of the grid takes part w % warps_per_bag of bag w / warps_per_bag:
// elements [part * slice, min(cols, (part + 1) * slice)) of its rows, in
// passes of 32 * kPer elements (lane i holds elements c0 + i + 32 k).
template <class V>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
embedding_bag_kernel(const int* __restrict__ ids,
                     const typename V::T* __restrict__ table,
                     typename V::T* __restrict__ out, int b, int l, int v,
                     int cols, int slice, int warps_per_bag, bool mean) {
  using T = typename V::T;
  using A = typename V::A;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long bag = warp / warps_per_bag;
  if (bag >= b) return;  // whole warp leaves together
  const int lo = static_cast<int>(warp - bag * warps_per_bag) * slice;
  const int hi = min(cols, lo + slice);
  const int* bag_ids = ids + bag * l;
  T* o = out + bag * cols;

  for (int c0 = lo; c0 < hi; c0 += 32 * V::kPer) {
    A acc[V::kPer];
#pragma unroll
    for (int k = 0; k < V::kPer; ++k) acc[k] = V::acc0();
    int cnt = 0;
    for (int j0 = 0; j0 < l; j0 += 32) {
      const int id = j0 + lane < l ? __ldg(bag_ids + j0 + lane) : -1;
      unsigned valid = __ballot_sync(kAll, id >= 0);  // the same in every lane
      cnt += __popc(valid);
      while (valid != 0u) {
        // issue the loads of up to kRows valid rows, then add them in order
        T buf[kRows][V::kPer];
        int n = 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (valid != 0u) {
            const int src = __ffs(valid) - 1;
            valid &= valid - 1u;
            const int row_id = min(__shfl_sync(kAll, id, src), v - 1);
            const T* row = table + static_cast<long long>(row_id) * cols;
#pragma unroll
            for (int k = 0; k < V::kPer; ++k) {
              const int c = c0 + lane + 32 * k;
              buf[r][k] = c < hi ? __ldcs(row + c) : V::zero();
            }
            n = r + 1;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < n) {
#pragma unroll
            for (int k = 0; k < V::kPer; ++k) V::add(acc[k], buf[r][k]);
          }
        }
      }
    }
    const float div = static_cast<float>(max(cnt, 1));
#pragma unroll
    for (int k = 0; k < V::kPer; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < hi) __stcs(o + c, V::out(acc[k], mean, div));
    }
  }
}

template <class V>
void launch(const int* ids, const void* table, void* out, int b, int l,
            int v, int d, bool mean, int warps_per_bag, int slice_cols,
            int warps_per_block, int blocks, cudaStream_t stream) {
  embedding_bag_kernel<V><<<static_cast<unsigned>(blocks),
                            warps_per_block * 32, 0, stream>>>(
      ids, static_cast<const typename V::T*>(table),
      static_cast<typename V::T*>(out), b, l, v, d / V::kWidth,
      slice_cols / V::kWidth, warps_per_bag, mean);
}

}  // namespace

// C entry point with the launch shape given: a bag's columns in
// warps_per_bag slices of slice_cols columns (a multiple of 8; the last
// may be ragged, none empty), warps_per_block warps a block (1-8), blocks
// blocks (covering b * warps_per_bag warps).  Other arguments as
// repro_embedding_bag's.  Returns cudaErrorInvalidValue for a shape that
// does not tile the output, else cudaGetLastError() after the launch.
extern "C" int repro_embedding_bag_shaped(
    const void* ids, const void* table, void* out, int b, int l, int v,
    int d, int mode_mean, int table_type, int warps_per_bag, int slice_cols,
    int warps_per_block, int blocks, void* stream) {
  if (b == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (table_type < 0 || table_type > 2 || warps_per_bag < 1 ||
      warps_per_bag > kMaxWarpsPerBag || slice_cols < 1 ||
      slice_cols % kSliceQuantum != 0 ||
      static_cast<long long>(warps_per_bag) * slice_cols < d ||
      static_cast<long long>(warps_per_bag - 1) * slice_cols >= d ||
      warps_per_block < 1 || warps_per_block > kMaxWarpsPerBlock ||
      blocks < 1 ||
      static_cast<long long>(blocks) * warps_per_block <
          static_cast<long long>(b) * warps_per_bag) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto id = static_cast<const int*>(ids);
  const bool mean = mode_mean != 0;
  const bool aligned =
      (reinterpret_cast<unsigned long long>(table) % 16) == 0 &&
      (reinterpret_cast<unsigned long long>(out) % 16) == 0;
  const int w = warps_per_bag, sc = slice_cols, wb = warps_per_block;
  if (table_type == 0) {
    if (aligned && (d % 4) == 0) {
      launch<Vec4>(id, table, out, b, l, v, d, mean, w, sc, wb, blocks, s);
    } else {
      launch<Scalar>(id, table, out, b, l, v, d, mean, w, sc, wb, blocks, s);
    }
  } else if (aligned && (d % 8) == 0) {
    if (table_type == 1) {
      launch<Vec8<BF16>>(id, table, out, b, l, v, d, mean, w, sc, wb, blocks,
                         s);
    } else {
      launch<Vec8<F16>>(id, table, out, b, l, v, d, mean, w, sc, wb, blocks,
                        s);
    }
  } else if (table_type == 1) {
    launch<Half1<BF16>>(id, table, out, b, l, v, d, mean, w, sc, wb, blocks,
                        s);
  } else {
    launch<Half1<F16>>(id, table, out, b, l, v, d, mean, w, sc, wb, blocks,
                       s);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry point.  ids (b, l) int32, table (v, d) and out (b, d) of
// table_type (0 = fp32, 1 = bf16, 2 = fp16), all contiguous on the current
// device, v >= 1; mode_mean 0 = sum, 1 = mean.  One warp a bag, 8 warps a
// block (the launcher passes a shape of its own to
// repro_embedding_bag_shaped; the bits are the same).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_embedding_bag(const void* ids, const void* table,
                                   void* out, int b, int l, int v, int d,
                                   int mode_mean, int table_type,
                                   void* stream) {
  const int slice = (d + kSliceQuantum - 1) / kSliceQuantum * kSliceQuantum;
  const long long blocks =
      (static_cast<long long>(b) + kMaxWarpsPerBlock - 1) / kMaxWarpsPerBlock;
  return repro_embedding_bag_shaped(ids, table, out, b, l, v, d, mode_mean,
                                    table_type, 1, slice, kMaxWarpsPerBlock,
                                    static_cast<int>(blocks), stream);
}
