// A persistent variant of csrc/embedding_bag.cu, kept for timing against
// it (tests/bag_variants_probe.py); the port does not build or call it.
//
// Hopper's form of the Pallas kernel's DMA double buffer
// (src/repro/kernels/embedding_bag/kernel.py:25-47): a few blocks an SM,
// each over a contiguous range of bags.  One lane of a producer warp walks
// the range's ids in order and, for each valid id, copies its row
// (min(id, V - 1)) into the next stage of a ring in shared memory with
// cp.async.bulk, completed on the stage's mbarrier; four consumer warps
// walk the same ids, add each arrived row into fp32 accumulators (thread t
// holds columns t, t + 128, ...), in bag order from +0.0, free the stage,
// and write each bag's sum (or mean) as it ends, rounded once to the
// table's dtype.  The same arithmetic in the same order as the port's
// kernel, so the same bits.  Takes rows of a multiple of 16 bytes from a
// 16-byte aligned table and D <= 1,024.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxPer = 8;             // columns a consumer thread holds
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr long long kSpinLimit = 1LL << 22;  // then trap, never hang

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0u;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0; !mbar_try_wait(bar, parity); ++spin) {
    if (spin > kSpinLimit) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct F32 {
  using T = float;
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float x) { return x; }
};
struct BF16 {
  using T = unsigned short;
  __device__ static float widen(unsigned short h) {
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
  __device__ static unsigned short narrow(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
struct F16 {
  using T = unsigned short;
  __device__ static float widen(unsigned short h) {
    return __half2float(__ushort_as_half(h));
  }
  __device__ static unsigned short narrow(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};

template <class E>
__global__ void __launch_bounds__(kThreads)
bag_tma_kernel(const int* __restrict__ ids, const typename E::T* table,
               typename E::T* __restrict__ out, int b, int l, int v, int d,
               int stages, bool mean) {
  using T = typename E::T;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  unsigned char* ring = smem + ((16 * stages + 127) / 128) * 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // this block's bags [lo, hi) and their ids [lo * l, hi * l)
  const long long lo = static_cast<long long>(b) * blockIdx.x / gridDim.x;
  const long long hi = static_cast<long long>(b) * (blockIdx.x + 1) / gridDim.x;
  const long long p_end = hi * l;
  int s = 0;
  unsigned phase = 0;
  if (warp == kConsumerWarps) {  // producer
    int id = lo * l + lane < p_end ? __ldg(ids + lo * l + lane) : -1;
    for (long long p0 = lo * l; p0 < p_end; p0 += 32) {
      const int next = p0 + 32 + lane < p_end ? __ldg(ids + p0 + 32 + lane)
                                              : -1;
      unsigned valid = __ballot_sync(kAll, id >= 0);
      while (valid != 0u) {
        const int src = __ffs(valid) - 1;
        valid &= valid - 1u;
        const int row = min(__shfl_sync(kAll, id, src), v - 1);
        if (lane == 0) {
          mbar_wait(&empty[s], phase ^ 1u);
          mbar_expect_tx(&full[s], row_bytes);
          bulk_copy(ring + static_cast<long long>(s) * row_bytes,
                    table + static_cast<long long>(row) * d, row_bytes,
                    &full[s]);
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
      }
      id = next;
    }
    return;
  }
  // consumers
  const int t = threadIdx.x;
  const int per = (d + kConsumers - 1) / kConsumers;
  float acc[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) acc[k] = 0.f;
  int cnt = 0, left = l;
  long long bag = lo;
  if (l == 0) {  // every bag is empty
    for (; bag < hi; ++bag) {
      for (int k = 0; k < per; ++k) {
        const int c = t + kConsumers * k;
        if (c < d) out[bag * d + c] = E::narrow(0.f);
      }
    }
    return;
  }
  int id = lo * l + lane < p_end ? __ldg(ids + lo * l + lane) : -1;
  for (long long p0 = lo * l; p0 < p_end; p0 += 32) {
    const int next = p0 + 32 + lane < p_end ? __ldg(ids + p0 + 32 + lane)
                                            : -1;
    const int n = static_cast<int>(min(32LL, p_end - p0));
    for (int j = 0; j < n; ++j) {
      if (__shfl_sync(kAll, id, j) >= 0) {
        mbar_wait(&full[s], phase);
        const T* row = reinterpret_cast<const T*>(
            ring + static_cast<long long>(s) * row_bytes);
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          const int c = t + kConsumers * k;
          if (k < per && c < d) acc[k] += E::widen(row[c]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
        ++cnt;
      }
      if (--left == 0) {  // the bag ends: write it, start the next
        const float div = static_cast<float>(max(cnt, 1));
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          const int c = t + kConsumers * k;
          if (k < per && c < d) {
            __stcs(out + bag * d + c,
                   E::narrow(mean ? acc[k] / div : acc[k]));
          }
          acc[k] = 0.f;
        }
        cnt = 0;
        left = l;
        ++bag;
      }
    }
    id = next;
  }
}

template <class E>
int launch(const void* ids, const void* table, void* out, int b, int l,
           int v, int d, bool mean, int blocks, int stages,
           cudaStream_t stream) {
  const int smem = ((16 * stages + 127) / 128) * 128 +
                   stages * d * static_cast<int>(sizeof(typename E::T));
  cudaError_t e = cudaFuncSetAttribute(
      bag_tma_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bag_tma_kernel<E><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int*>(ids),
      static_cast<const typename E::T*>(table),
      static_cast<typename E::T*>(out), b, l, v, d, stages, mean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids (b, l) int32, table (v, d) and out (b, d) of table_type (0 fp32,
// 1 bf16, 2 fp16); blocks persistent blocks, stages rows of ring each.
extern "C" int repro_embedding_bag_tma(const void* ids, const void* table,
                                       void* out, int b, int l, int v, int d,
                                       int mode_mean, int table_type,
                                       int blocks, int stages, void* stream) {
  const int elem = table_type == 0 ? 4 : 2;
  if (b == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (table_type < 0 || table_type > 2 || (d * elem) % 16 != 0 ||
      d > kConsumers * kMaxPer || stages < 1 || blocks < 1 ||
      reinterpret_cast<unsigned long long>(table) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const bool mean = mode_mean != 0;
  if (table_type == 0) {
    return launch<F32>(ids, table, out, b, l, v, d, mean, blocks, stages, s);
  }
  if (table_type == 1) {
    return launch<BF16>(ids, table, out, b, l, v, d, mean, blocks, stages, s);
  }
  return launch<F16>(ids, table, out, b, l, v, d, mean, blocks, stages, s);
}
