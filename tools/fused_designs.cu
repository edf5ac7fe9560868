// Designs of fused_query timed side by side on the card by
// tools/kernel_designs.py.  The design the port ships is in
// src/repro_torch/kernels/csrc/fused_query.cu, included here so that its
// kernel runs as it ships and with parts of it switched off:
//
//   ids     the first design (below, in namespace ids): per-row bucket
//           ids read from vectors (two per dimension with a delta), every
//           dimension probed in the given (alphabetical) order, 4 blocks
//           of 256 threads per SM;
//   hash    the shipped kernel without the screen (kScreen false): the
//           keys hashed in the kernel, every key row read, and the
//           attributes of a match;
//   screen  the screen (bucket bits, fingerprints, passing rows), the
//           dimensions in the given order, every bit set read through L1
//           (no shared memory);
//   order   screen + the dimensions sorted by their pack counts;
//   smem    order + the bit sets in shared memory, and the fingerprints
//           where they fit there: the shipped kernel;
//   nofp    smem without the fingerprints;
//   mfirst  smem with the measure read first, a zero measure ending the
//           row (kMeasureFirst, for Q1.x).
#include "../src/repro_torch/kernels/csrc/fused_query.cu"

namespace ids {

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


int ids_launch(const void* dim_ptrs, const void* widths,
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

}  // namespace ids

// design: 1 hash, 2 screen, 3 order, 4 smem, 5 mfirst, 6 nofp; the tables
// and the stats are fused_query_launch's (the bit sets packed beforehand).
extern "C" int fused_design_launch(int32_t design, const void* dim_ptrs,
                                   const void* dim_ints, int32_t n_dims,
                                   const void* stats, const void* fmeasure,
                                   int64_t m, void* groups,
                                   int32_t num_segments, void* stream) {
  const QueryArgs q = query_args(dim_ptrs, dim_ints, n_dims, stats);
  const auto* f = static_cast<const int32_t*>(fmeasure);
  auto* g = static_cast<int32_t*>(groups);
  const auto s = static_cast<cudaStream_t>(stream);
  QueryOptions l1;
  l1.smem_budget = 0;
  QueryOptions given = l1;
  given.sort = false;
  switch (design) {
    case 1:
      return launch_query_as<false, false>(q, f, m, g, num_segments, given, s);
    case 2:
      return launch_query_as<true, false>(q, f, m, g, num_segments, given, s);
    case 3:
      return launch_query_as<true, false>(q, f, m, g, num_segments, l1, s);
    case 4:
      return launch_query_as<true, false>(q, f, m, g, num_segments,
                                          QueryOptions{}, s);
    case 5:
      return launch_query_as<true, true>(q, f, m, g, num_segments,
                                         QueryOptions{}, s);
    case 6: {
      QueryOptions nofp;
      nofp.fingers = false;
      return launch_query_as<true, false>(q, f, m, g, num_segments, nofp, s);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// The first design's launcher: 8 pointers per dimension (pk, bids, tk, ta,
// dpk, dbids, dtk, dta), widths (w, dw) per dimension, a grid of 4 blocks
// per SM.
extern "C" int ids_launch(const void* dim_ptrs, const void* widths,
                           int32_t n_dims, const void* fmeasure, int64_t m,
                           void* groups, int32_t num_segments, int32_t grid,
                           void* stream) {
  return ids::ids_launch(dim_ptrs, widths, n_dims, fmeasure, m, groups,
                           num_segments, grid, stream);
}
