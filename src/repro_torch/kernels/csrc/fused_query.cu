// One-launch SSB query kernel for Hopper (sm_90a): fused_query.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_query.py:fused_query
// (_fused_query_kernel).  Per fact row and joined dimension (up to four):
// probe the dimension's bucket row, decode the attribute plane, optionally
// override with the delta's bucket row, AND the predicate bits and sum the
// strided group keys; then add the masked measure into an int32 histogram
// over the composite group key.  Like the bucket probes it gathers bucket
// rows itself from the (B, W) planes; the TPU version took (m, W) planes
// gathered by XLA (two per dimension: ~15 GB for Q4.x at SF10).
//
// What bounds it: bytes.  Per row it reads one key and bucket id per
// dimension (coalesced), one random key sector per dimension, the attribute
// sector on a hit, and the measure for rows that pass.  The design: one
// thread per row in a grid-stride loop; a row stops probing at the first
// dimension that rejects it (the mask can only fall, and a rejected row adds
// nothing), so selective predicates skip the later dimensions' sectors.
//
// The TPU kernel carried its histogram in VMEM across a sequential grid;
// Hopper's blocks run in parallel, so the sum is taken with int32 atomics,
// which wrap mod 2^32 and do not depend on order: the result is
// bit-identical to the plain version.  Three regimes, chosen from
// num_segments: one segment (Q1.x) keeps a register sum per thread, reduces
// it over the warp and adds once per warp; up to kMaxSharedSegments, each
// block privatises a shared-memory histogram and flushes its non-zero bins;
// beyond that (Q3.2-Q3.4: 437,500 segments, Q4.3: 1,750,000) rows add
// straight into the global histogram.  Segment ids outside [0, num_segments)
// are dropped, as jax.ops.segment_sum drops them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kMaxDims = 4;
constexpr int kMaxSharedSegments = 12288;  // 48 KB of int32 bins per block

struct DimArgs {
  const int32_t* pk;     // (m,) dictionary codes
  const int32_t* bids;   // (m,) bucket ids
  const int32_t* tk;     // (B, w) key plane
  const int32_t* ta;     // (B, w) attribute plane
  const int32_t* dpk;    // delta operands, null when the dimension has none
  const int32_t* dbids;
  const int32_t* dtk;
  const int32_t* dta;
  int32_t w, dw;
};

struct QueryArgs {
  DimArgs dim[kMaxDims];
  int32_t n_dims;
};

// Sum of the matching lanes' words of row `bid`; returns whether k matched.
__device__ __forceinline__ bool probe_row(const int32_t* __restrict__ tk,
                                          const int32_t* __restrict__ tv,
                                          int32_t bid, int w, int32_t k,
                                          int32_t* word) {
  const int64_t row = static_cast<int64_t>(bid) * w;
  const int4* rk = reinterpret_cast<const int4*>(tk + row);
  const int4* rv = reinterpret_cast<const int4*>(tv + row);
  bool any = false;
  uint32_t sum = 0;
  for (int j = 0; j < w / 4; ++j) {
    const int4 kk = __ldg(rk + j);
    const bool m0 = kk.x == k, m1 = kk.y == k, m2 = kk.z == k, m3 = kk.w == k;
    if (m0 | m1 | m2 | m3) {
      any = true;
      const int4 vv = __ldg(rv + j);
      sum += (m0 ? static_cast<uint32_t>(vv.x) : 0u) +
             (m1 ? static_cast<uint32_t>(vv.y) : 0u) +
             (m2 ? static_cast<uint32_t>(vv.z) : 0u) +
             (m3 ? static_cast<uint32_t>(vv.w) : 0u);
    }
  }
  *word = static_cast<int32_t>(sum);
  return any && k != kEmpty;
}

enum Agg { kScalar, kShared, kGlobal };

template <int kAgg>
__global__ void __launch_bounds__(kThreads)
fused_query_kernel(const QueryArgs args, const int32_t* __restrict__ fm,
                   int64_t m, int32_t* __restrict__ groups,
                   int32_t num_segments) {
  extern __shared__ int32_t hist[];
  if (kAgg == kShared) {
    for (int s = threadIdx.x; s < num_segments; s += kThreads) hist[s] = 0;
    __syncthreads();
  }
  uint32_t acc = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < m; i += stride) {
    bool keep = true;
    uint32_t gk = 0;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d >= args.n_dims) break;
      const DimArgs& a = args.dim[d];
      int32_t word;
      int32_t attr = probe_row(a.tk, a.ta, a.bids[i], a.w, a.pk[i], &word)
                         ? word : -1;
      if (a.dtk != nullptr &&
          probe_row(a.dtk, a.dta, a.dbids[i], a.dw, a.dpk[i], &word)) {
        attr = word;
      }
      if (attr < 0 || (attr & 1) == 0) {
        keep = false;
        break;
      }
      gk += static_cast<uint32_t>(attr >> 1);
    }
    if (!keep) continue;
    const int32_t seg = static_cast<int32_t>(gk);
    const int32_t v = fm[i];
    if (seg < 0 || seg >= num_segments || v == 0) continue;
    if (kAgg == kScalar) {
      acc += static_cast<uint32_t>(v);
    } else if (kAgg == kShared) {
      atomicAdd(&hist[seg], v);
    } else {
      atomicAdd(&groups[seg], v);
    }
  }
  if (kAgg == kScalar) {
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if ((threadIdx.x & 31) == 0 && acc != 0) {
      atomicAdd(&groups[0], static_cast<int32_t>(acc));
    }
  } else if (kAgg == kShared) {
    __syncthreads();
    for (int s = threadIdx.x; s < num_segments; s += kThreads) {
      if (hist[s] != 0) atomicAdd(&groups[s], hist[s]);
    }
  }
}

}  // namespace

// dim_ptrs: host array of 8 device pointers per dimension, in DimArgs order
// (delta pointers 0 when absent); widths: host array of (w, dw) per
// dimension.  groups must be zeroed by the caller.
extern "C" int fused_query_launch(const void* dim_ptrs, const void* widths,
                                  int32_t n_dims, const void* fmeasure,
                                  int64_t m, void* groups,
                                  int32_t num_segments, int32_t grid,
                                  void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || num_segments < 1 || grid < 1) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  QueryArgs args{};
  args.n_dims = n_dims;
  const auto* p = static_cast<const int32_t* const*>(dim_ptrs);
  const auto* w = static_cast<const int32_t*>(widths);
  for (int d = 0; d < n_dims; ++d) {
    DimArgs& a = args.dim[d];
    a.pk = p[8 * d + 0];
    a.bids = p[8 * d + 1];
    a.tk = p[8 * d + 2];
    a.ta = p[8 * d + 3];
    a.dpk = p[8 * d + 4];
    a.dbids = p[8 * d + 5];
    a.dtk = p[8 * d + 6];
    a.dta = p[8 * d + 7];
    a.w = w[2 * d];
    a.dw = w[2 * d + 1];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const int32_t*>(fmeasure);
  auto* g = static_cast<int32_t*>(groups);
  if (num_segments == 1) {
    fused_query_kernel<kScalar><<<grid, kThreads, 0, s>>>(args, f, m, g, 1);
  } else if (num_segments <= kMaxSharedSegments) {
    const size_t smem = sizeof(int32_t) * static_cast<size_t>(num_segments);
    fused_query_kernel<kShared><<<grid, kThreads, smem, s>>>(
        args, f, m, g, num_segments);
  } else {
    fused_query_kernel<kGlobal><<<grid, kThreads, 0, s>>>(
        args, f, m, g, num_segments);
  }
  return cudaGetLastError();
}
