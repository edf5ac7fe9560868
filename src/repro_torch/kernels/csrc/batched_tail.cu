// Batched SSB query tail for Hopper (sm_90a): batched_tail.
//
// Replaces no Pallas kernel.  The JAX package answers a dispatch of B
// requests of one query (repro/serving/batch.py) by vmapping the shared
// filter -> mask -> measure -> segment-sum tail inside one compiled
// program, and XLA fuses that chain; this kernel is the port's
// counterpart of that fusion.  For every request of a dispatch (up to 32)
// it evaluates, in one streaming pass over the fact rows, exactly what
// repro_torch/serving/batch.py's plain tail computes:
//
//   a row joins dimension d iff found_d[row]; it then reads d's planes at
//   clamp(dim_row_d[row], 0, n_d - 1).  Request i keeps the row iff every
//   joined dimension joins, bit i of every filtered dimension's predicate
//   word is set, and bit i of the fact filter's word is set (where the
//   query has one).  A kept row adds its measure (int32, wrapping) to
//   request i's total and to segment i * size + g of the groups, where g
//   is the sum of the grouped dimensions' planes (remainder(col, card) *
//   stride, strides the suffix products of the cardinalities).
//
// The operands are built per dispatch by the wrapper (kernels/
// batched_tail.py) from the query's own predicate callables, evaluated on
// the dimension tables and the fact rows with one parameter column per
// request; nothing of SSB's predicates or constants lives here.  The measure is a column, or
// two columns combined by *, - or + (traced from the query's measure
// callable), computed in uint32 so it wraps as torch's int32 does.
//
// What bounds it: bytes.  A fact row costs each joined dimension's cached
// (found, dim_row), 5 bytes, and the fact filter's word and the measure's
// columns only where some request still keeps the row: 17-28 bytes a row,
// about 3.7 GB over 180M rows, 1.1 ms at HBM's rate.  The kernel writes
// nothing of size rows or B x rows: the masks, the measure, the group
// keys and the per-request contributions live in registers.
//
// Layout.  A thread takes 4 consecutive rows a step in a grid-stride
// loop over persistent blocks: one 16-byte evict-first load of each
// joined dimension's dim_row and one 4-byte load of its found bytes, all
// issued before the first gather.  The dimensions come smallest first, so
// the cheap gathers reject rows before the large planes are touched: the
// planes of the dimensions that fit kPlaneSmemBytes (date's 2,556 rows)
// are copied into shared memory by each block, the others (supplier's
// 60,000 rows, customer's 900,000, part's 1,000,000) are gathered through
// L1 and L2, where they stay.  A row whose bits AND to 0 gathers nothing
// more, and a step whose four rows are all rejected loads nothing more.
//
// Aggregation: sums wrap mod 2^32, so any order gives torch's bits.  Each
// thread keeps the B totals in registers (NB, the request count rounded
// up to 4, 8, 16 or 32, fixes the array), reduced by warp shuffles, then
// in shared memory, then one atomic a block and request.  Groups go to a
// block histogram in shared memory where B x size words fit beside the
// planes, flushed with one global atomic per non-zero entry; larger
// spaces (Q3.2-Q3.4, Q4.3) add straight into the zeroed output with
// global atomics, where few rows pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 4;
constexpr int kThreads = 512;
constexpr int kRows = 4;                       // rows a thread takes a step
constexpr int kPlaneSmemBytes = 32 << 10;      // planes copied per block
constexpr int kMaxRequests = 32;

struct TailDim {
  const uint8_t* found;   // (n,) bool
  const int32_t* row;     // (n,) dim_row, -1 on a miss
  const uint32_t* pred;   // (n_dim,) request bits, or nullptr
  const int32_t* group;   // (n_dim,) group part, or nullptr
  int32_t n_dim;
  int32_t smem;           // word offset of its planes in shared memory, -1
};

struct TailArgs {
  TailDim dim[kMaxDims];
  const uint32_t* fword;  // (n,) the fact filter's request bits, or nullptr
  const int32_t* ma;      // (n,) measure column a
  const int32_t* mb;      // (n,) measure column b, or nullptr
  uint32_t* totals;       // (nb,)
  uint32_t* groups;       // (nb, size), or nullptr when size == 1
  int64_t n;
  int32_t n_dims;
  int32_t mop;            // 0: a, 1: a * b, 2: a - b, 3: a + b
  int32_t nb;
  int32_t size;
  int32_t plane_words;    // shared words of the planes
  int32_t hist_words;     // > 0: the groups' block histogram in shared memory
  int32_t vec;            // every streamed operand aligned for vector loads
};

__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ int4 load4(const int32_t* p, int64_t r0, int64_t n,
                                      bool whole) {
  if (whole) return __ldcs(reinterpret_cast<const int4*>(p + r0));
  int4 v = make_int4(0, 0, 0, 0);
  if (r0 < n) v.x = __ldcs(p + r0);
  if (r0 + 1 < n) v.y = __ldcs(p + r0 + 1);
  if (r0 + 2 < n) v.z = __ldcs(p + r0 + 2);
  if (r0 + 3 < n) v.w = __ldcs(p + r0 + 3);
  return v;
}

// the four found bytes of rows r0 .. r0 + 3 as one word, byte j for row j
__device__ __forceinline__ uint32_t load_found(const uint8_t* p, int64_t r0,
                                               int64_t n, bool whole) {
  if (whole) return __ldcs(reinterpret_cast<const unsigned int*>(p + r0));
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (r0 + j < n) v |= static_cast<uint32_t>(__ldcs(p + r0 + j)) << (8 * j);
  }
  return v;
}

__device__ __forceinline__ int clamp_row(int r, int n_dim) {
  return r < 0 ? 0 : (r >= n_dim ? n_dim - 1 : r);
}

__device__ __forceinline__ uint32_t measure(int op, uint32_t a, uint32_t b) {
  return op == 0 ? a : op == 1 ? a * b : op == 2 ? a - b : a + b;
}

// Up to 8 requests two blocks share an SM (at most 64 registers a thread);
// the 16 and 32 totals of the wider variants take one.
template <int NB>
__global__ void __launch_bounds__(kThreads, NB <= 8 ? 2 : 1)
    batched_tail_kernel(const TailArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t block_totals[NB];
  const uint32_t* pred[kMaxDims];
  const int32_t* grp[kMaxDims];
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    pred[d] = nullptr;
    grp[d] = nullptr;
    if (d >= a.n_dims) continue;
    const TailDim& dm = a.dim[d];
    pred[d] = dm.pred;
    grp[d] = dm.group;
    if (dm.smem < 0) continue;
    uint32_t* s = smem + dm.smem;
    if (dm.pred != nullptr) {
      for (int i = threadIdx.x; i < dm.n_dim; i += blockDim.x) s[i] = dm.pred[i];
      pred[d] = s;
      s += dm.n_dim;
    }
    if (dm.group != nullptr) {
      for (int i = threadIdx.x; i < dm.n_dim; i += blockDim.x) {
        s[i] = static_cast<uint32_t>(dm.group[i]);
      }
      grp[d] = reinterpret_cast<const int32_t*>(s);
    }
  }
  uint32_t* hist = smem + a.plane_words;
  for (int i = threadIdx.x; i < a.hist_words; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x < NB) block_totals[threadIdx.x] = 0;
  __syncthreads();

  const uint32_t all = a.nb >= 32 ? 0xffffffffu : (1u << a.nb) - 1u;
  uint32_t acc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i] = 0;
  const int64_t steps = (a.n + kRows - 1) / kRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < steps; s += stride) {
    const int64_t r0 = s * kRows;
    const bool whole = a.vec && r0 + kRows <= a.n;
    uint32_t found[kMaxDims];
    int4 row[kMaxDims];
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d < a.n_dims) {
        found[d] = load_found(a.dim[d].found, r0, a.n, whole);
        row[d] = load4(a.dim[d].row, r0, a.n, whole);
      }
    }
    uint32_t p[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) p[j] = r0 + j < a.n ? all : 0u;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d >= a.n_dims) continue;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (((found[d] >> (8 * j)) & 0xffu) == 0) p[j] = 0;
        if (p[j] != 0 && pred[d] != nullptr) {
          p[j] &= pred[d][clamp_row(lane_of(row[d], j), a.dim[d].n_dim)];
        }
      }
    }
    if ((p[0] | p[1] | p[2] | p[3]) == 0) continue;
    if (a.fword != nullptr) {
      const int4 w = load4(reinterpret_cast<const int32_t*>(a.fword), r0, a.n,
                           whole);
#pragma unroll
      for (int j = 0; j < kRows; ++j) p[j] &= static_cast<uint32_t>(lane_of(w, j));
      if ((p[0] | p[1] | p[2] | p[3]) == 0) continue;
    }
    const int4 va = load4(a.ma, r0, a.n, whole);
    const int4 vb = a.mb != nullptr ? load4(a.mb, r0, a.n, whole)
                                    : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (p[j] == 0) continue;
      const uint32_t m = measure(a.mop, static_cast<uint32_t>(lane_of(va, j)),
                                 static_cast<uint32_t>(lane_of(vb, j)));
#pragma unroll
      for (int i = 0; i < NB; ++i) acc[i] += ((p[j] >> i) & 1u) ? m : 0u;
      if (a.size == 1) continue;
      int32_t g = 0;
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) {
        if (d < a.n_dims && grp[d] != nullptr) {
          g += grp[d][clamp_row(lane_of(row[d], j), a.dim[d].n_dim)];
        }
      }
      // an id outside the space is dropped, as segment_sum drops it
      uint32_t bits = g >= 0 && g < a.size ? p[j] : 0u;
      while (bits != 0) {
        const int i = __ffs(bits) - 1;
        bits &= bits - 1;
        const int64_t k = static_cast<int64_t>(i) * a.size + g;
        if (a.hist_words > 0) {
          atomicAdd(hist + k, m);
        } else {
          atomicAdd(a.groups + k, m);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NB; ++i) {
    uint32_t v = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(block_totals + i, v);
  }
  __syncthreads();
  if (threadIdx.x < a.nb && block_totals[threadIdx.x] != 0) {
    atomicAdd(a.totals + threadIdx.x, block_totals[threadIdx.x]);
  }
  for (int i = threadIdx.x; i < a.hist_words; i += blockDim.x) {
    if (hist[i] != 0) atomicAdd(a.groups + i, hist[i]);
  }
}

struct Device {
  int sms = 0;
  int smem_optin = 0;
};

Device device_info() {
  static Device info[16];
  int dev = 0;
  cudaGetDevice(&dev);
  Device& d = info[dev & 15];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.smem_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return d;
}

template <int NB>
int launch_as(const TailArgs& a, const Device& dev, cudaStream_t stream) {
  const auto kernel = batched_tail_kernel<NB>;
  const size_t smem =
      static_cast<size_t>(a.plane_words + a.hist_words) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t steps = (a.n + kRows - 1) / kRows;
  int64_t blocks = (steps + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(per_sm) * dev.sms;
  blocks = blocks < resident ? blocks : resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dim_ptrs: host array of 4 device pointers per dimension (found, dim_row,
// predicate words or 0, group plane or 0); dim_ints: host array of one
// int64 per dimension, its row count.  The dimensions come in the order
// the kernel gathers them.  fword and mb may be 0.  totals (nb) and, when
// size > 1, groups (nb x size) must be zeroed by the caller.
extern "C" int batched_tail_launch(const void* dim_ptrs, const void* dim_ints,
                                   int32_t n_dims, const void* fword,
                                   const void* ma, const void* mb,
                                   int32_t mop, int64_t n, int32_t nb,
                                   int32_t size, void* totals, void* groups,
                                   void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || nb < 1 || nb > kMaxRequests ||
      size < 1 || mop < 0 || mop > 3 || (size > 1 && groups == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const auto* ptrs = static_cast<const void* const*>(dim_ptrs);
  const auto* ints = static_cast<const int64_t*>(dim_ints);
  TailArgs a{};
  a.n = n;
  a.n_dims = n_dims;
  a.fword = static_cast<const uint32_t*>(fword);
  a.ma = static_cast<const int32_t*>(ma);
  a.mb = static_cast<const int32_t*>(mb);
  a.mop = mop;
  a.nb = nb;
  a.size = size;
  a.totals = static_cast<uint32_t*>(totals);
  a.groups = static_cast<uint32_t*>(groups);
  bool aligned = reinterpret_cast<uintptr_t>(ma) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(mb) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(fword) % 16 == 0;
  int words = 0;
  for (int d = 0; d < n_dims; ++d) {
    TailDim& t = a.dim[d];
    t.found = static_cast<const uint8_t*>(ptrs[4 * d]);
    t.row = static_cast<const int32_t*>(ptrs[4 * d + 1]);
    t.pred = static_cast<const uint32_t*>(ptrs[4 * d + 2]);
    t.group = static_cast<const int32_t*>(ptrs[4 * d + 3]);
    if (ints[d] < 1 || ints[d] > INT32_MAX) return cudaErrorInvalidValue;
    t.n_dim = static_cast<int32_t>(ints[d]);
    aligned = aligned && reinterpret_cast<uintptr_t>(t.found) % 4 == 0 &&
              reinterpret_cast<uintptr_t>(t.row) % 16 == 0;
    const int64_t need = static_cast<int64_t>(t.n_dim) *
                         ((t.pred != nullptr) + (t.group != nullptr));
    t.smem = -1;
    if (need > 0 && (words + need) * 4 <= kPlaneSmemBytes) {
      t.smem = words;
      words += static_cast<int>(need);
    }
  }
  a.vec = aligned;
  a.plane_words = words;
  const Device dev = device_info();
  const int64_t budget =
      dev.smem_optin - static_cast<int64_t>(kMaxRequests) * 4 - words * 4;
  const int64_t hist = static_cast<int64_t>(nb) * size;
  a.hist_words = size > 1 && hist * 4 <= budget ? static_cast<int32_t>(hist)
                                                : 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (nb <= 4) return launch_as<4>(a, dev, st);
  if (nb <= 8) return launch_as<8>(a, dev, st);
  if (nb <= 16) return launch_as<16>(a, dev, st);
  return launch_as<32>(a, dev, st);
}
