// One-launch SSB query kernel for Hopper (sm_90a): fused_query.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_query.py:fused_query
// (_fused_query_kernel).  Per fact row and joined dimension (up to four):
// probe the dimension's bucket row, decode the attribute plane, optionally
// override with the delta's bucket row, AND the predicate bits and sum the
// strided group keys; then add the masked measure into an int32 histogram
// over the composite group key.  The TPU version took (m, W) planes gathered
// by XLA (two per dimension: ~15 GB for Q4.x at SF10); this one hashes each
// probe key itself (the table's bucket count and hash mode travel as
// scalars, no bucket-id vector is read) and reads bucket rows from the
// (B, W) planes.
//
// What bounds it: the random reads, not the streamed bytes.  A row reads
// its code (coalesced) for each dimension it reaches, and the measure only
// if it passes every dimension, so the bytes it must move are the first
// dimension's codes whole and the later ones' (and the measure's) sectors
// that hold a row reaching them.  This kernel's first design read a key
// sector per dimension for every row, in alphabetical dimension order (Q2.x
// probed part's 2 x 16 MiB planes for every row, to reject 24 of 25).  This
// one:
//
// - screens: a pack kernel (one launch per query, one thread per bucket of
//   every plane) works out which keys of each bucket pass: a key passes
//   where the wrapping sum of the attributes of its bucket's lanes holding
//   it (what a probe of that key sums) is >= 0 and odd, so the screen is
//   exact on any plane, duplicates included.  It writes a pass bit per
//   bucket, a byte of fingerprints per bucket (bit finger_of(key) of each
//   passing key: three hash bits beside the bucket's, which tell SSB's
//   dense codes of one bucket apart) and a passing table: per bucket its
//   passing keys, each once, beside their group part (attr >> 1), packed
//   to the front.  A row whose bucket bit or fingerprint bit is unset is
//   rejected there; the rest read one sector of their bucket's passing row
//   (four pairs; more only if all four are taken) in place of the key row,
//   the attribute row and a pass bit.  The key and attribute planes are
//   read only by the pack;
// - orders: the pack kernel also counts each plane's passing and occupied
//   slots, and every block sorts the dimensions by that share, the most
//   selective first (a row stops at the first dimension that rejects it;
//   the mask is an AND and the group key a wrapping sum, so the order
//   changes no result);
// - keeps the bits in shared memory: persistent blocks of 1024 threads, two
//   per SM (64 warps; the first design ran 32), copy every bucket bit set
//   that fits the budget once, the smallest first, then the fingerprints
//   that still fit, then walk the rows with a grid stride.  What does not
//   fit is read through L1.
//
// The delta overlay: a delta hit overrides the main attribute, even for a
// row the main table rejects (an upsert can make a row pass), so the delta
// is probed first, its key row read only where a hit could matter: where
// the row's main bucket and fingerprint bits are set, where the delta
// bucket is occupied (a hit there overrides; a tombstone, -1, rejects);
// elsewhere the row can pass only through a passing delta slot, so only
// where the delta bucket's pass bit is set.
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
//
// Measured against this design (tools/kernel_designs.py, PERF.md): the
// first design (bucket ids read from vectors), the hash alone (kScreen
// false: the key row and the attributes of every probe), the screen in the
// given order with the bits through L1, no fingerprints, and the measure
// read first as a screen (kMeasureFirst, for Q1.x).
#include <cstdint>
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int kMaxDims = 4;
constexpr int kMaxSharedSegments = 12288;  // 48 KB of int32 bins per block
constexpr int kThreads = 1024;             // query kernel, two blocks per SM
constexpr int kPackThreads = 256;
// shared memory a query block may take for its histogram and bits, so that
// two fit on an SM (227 KB)
constexpr size_t kSmemBudget = 110 << 10;

// ---------------------------------------------------------------------------
// pack: pass bits and counts of every plane of one query
// ---------------------------------------------------------------------------

// One plane to pack: a key plane and its attribute plane.  Every output but
// the pass bits per bucket is optional (null): a main table wants the
// fingerprints, the passing table and the stats, a delta the occupancy
// bits.
struct PackPlane {
  const int32_t* keys;        // (B, w) key plane
  const int32_t* attr;        // (B, w) attribute plane
  uint32_t* bucket_bits;      // ceil(B / 32) words: some slot passes
  uint8_t* finger;            // B bytes: bit finger_of(key) of passing keys
  int2* passing;              // (B, w): passing (key, attr >> 1), then empty
  uint32_t* occ_bits;         // ceil(B / 32) words: some slot is occupied
  unsigned long long* stats;  // 2 zeroed counters: passing, occupied slots
  Hash h;
  int64_t num_buckets;
  int32_t w;
};

struct PackArgs {
  PackPlane p[2 * kMaxDims];
};

// Three hash bits beside the bucket's own: the bits just above the bucket
// bits (identity) or just below them in the Fibonacci product.  Keys of one
// bucket that differ in them are told apart without reading a row.
__device__ __forceinline__ uint32_t finger_of(int32_t k, const Hash h) {
  const uint32_t u = static_cast<uint32_t>(k);
  if (!h.fib) return (u >> (32 - h.shift)) & 7u;
  const uint32_t p = u * kFib;
  return (h.shift >= 3 ? p >> (h.shift - 3) : p) & 7u;
}

// One thread per bucket; blockIdx.y picks the plane.  Lane j passes where
// its key is not EMPTY_KEY and the wrapping sum of the attributes of the
// bucket's lanes holding that key (what a probe of that key sums) is >= 0
// and odd.  The passing row lists each passing key once, in lane order,
// with that sum >> 1, then (EMPTY_KEY, 0).  Every lane of a warp takes part
// in the ballots and reductions (no early return inside a plane).
template <int W>
__device__ __forceinline__ void pack_plane(const PackPlane& p) {
  const int w = W > 0 ? W : p.w;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kPackThreads +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool active = b < p.num_buckets;
  uint32_t occupied = 0, passing = 0, fp = 0;
  if (active) {
    const int32_t* rk = p.keys + b * w;
    const int32_t* ra = p.attr + b * w;
    int2* out = p.passing != nullptr ? p.passing + b * w : nullptr;
    int n_out = 0;
    for (int j = 0; j < w; ++j) {
      const int32_t k = rk[j];
      if (k == kEmpty) continue;
      ++occupied;
      uint32_t sum = 0;
      bool lead = true;  // the group's first lane
#pragma unroll
      for (int l = 0; l < w; ++l) {
        if (rk[l] == k) {
          sum += static_cast<uint32_t>(ra[l]);
          lead &= l >= j;
        }
      }
      const int32_t a = static_cast<int32_t>(sum);
      if (a < 0 || (a & 1) == 0) continue;
      ++passing;
      fp |= 1u << finger_of(k, p.h);
      if (out != nullptr && lead) out[n_out++] = make_int2(k, a >> 1);
    }
    for (; out != nullptr && n_out < w; ++n_out) {
      out[n_out] = make_int2(kEmpty, 0);
    }
    if (p.finger != nullptr) p.finger[b] = static_cast<uint8_t>(fp);
  }
  const uint32_t bucket_word = __ballot_sync(kFull, passing != 0);
  const uint32_t occ_word = __ballot_sync(kFull, occupied != 0);
  if (lane == 0 && active) {
    p.bucket_bits[b >> 5] = bucket_word;
    if (p.occ_bits != nullptr) p.occ_bits[b >> 5] = occ_word;
  }
  if (p.stats == nullptr) return;
  const uint32_t n_pass = __reduce_add_sync(kFull, passing);
  const uint32_t n_occ = __reduce_add_sync(kFull, occupied);
  if (lane == 0) {
    if (n_pass) atomicAdd(p.stats, static_cast<unsigned long long>(n_pass));
    if (n_occ) atomicAdd(p.stats + 1, static_cast<unsigned long long>(n_occ));
  }
}

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const PackArgs a) {
  const PackPlane& p = a.p[blockIdx.y];
  // a whole block past its plane's end leaves together
  if (static_cast<int64_t>(blockIdx.x) * kPackThreads >= p.num_buckets) {
    return;
  }
  switch (p.w) {
    case 4: pack_plane<4>(p); break;
    case 8: pack_plane<8>(p); break;
    case 16: pack_plane<16>(p); break;
    default: pack_plane<0>(p); break;
  }
}

// ---------------------------------------------------------------------------
// the query kernel
// ---------------------------------------------------------------------------

struct DimArgs {
  const int32_t* pk;            // (m,) dictionary codes
  const int32_t* tk;            // (B, w) key plane
  const int32_t* ta;            // (B, w) attribute plane
  const uint32_t* bucket_bits;  // pack: a pass bit per bucket
  const uint8_t* finger;        // pack: passing fingerprints per bucket
  const int2* passing;          // pack: (B, w) passing keys, group parts
  const int32_t* dpk;           // delta operands, null when none
  const int32_t* dtk;
  const int32_t* dta;
  const uint32_t* dpass;        // pack: the delta's pass bit per bucket
  const uint32_t* docc;         // pack: the delta's occupancy bit per bucket
  Hash h, dh;
  int32_t w, dw;
  // word offsets in shared memory (after the histogram), -1: global
  int32_t bits_smem, dpass_smem, docc_smem, finger_smem;
  int32_t nbw, dnbw;            // words of bucket bits, of delta bits
};

struct QueryArgs {
  DimArgs dim[kMaxDims];
  const unsigned long long* stats;  // pack: 2 counters per dimension
  int32_t n_dims;
  int32_t sort;                     // 0: keep the given order
};

// Whether k matched a lane of delta bucket db, and then the sum of the
// matched lanes' attributes in *attr.
__device__ __forceinline__ bool delta_attr(const DimArgs& a, int32_t k,
                                           uint32_t db, int32_t* attr) {
  const int64_t row = static_cast<int64_t>(db) * a.dw;
  const int4* rk = reinterpret_cast<const int4*>(a.dtk + row);
  bool hit = false;
  uint32_t s = 0;
  for (int j = 0; j < a.dw / 4; ++j) {
    for (uint32_t mm = match4(__ldg(rk + j), k); mm != 0; mm &= mm - 1) {
      hit = true;
      s += static_cast<uint32_t>(__ldg(a.dta + row + 4 * j + __ffs(mm) - 1));
    }
  }
  *attr = static_cast<int32_t>(s);
  return hit;
}

__device__ __forceinline__ bool bit(const uint32_t* bits, uint32_t i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// Whether row i passes dimension a; adds its group part to *gk.  With a
// delta, a hit there decides.  A row that the main bucket and fingerprint
// bits reject can pass only through a passing delta slot, so its delta row
// is read only where the delta bucket's pass bit is set; any other row
// reads it where the delta bucket is occupied.
template <bool kScreen>
__device__ __forceinline__ bool probe_dim(const DimArgs& a, int64_t i,
                                          uint32_t* gk) {
  const int32_t k = __ldcs(a.pk + i);
  const uint32_t b = bucket_of(k, a.h);
  // whether the main table may pass the row: its bucket bit, then its
  // fingerprint bit
  const bool main =
      !kScreen || (k != kEmpty && bit(a.bucket_bits, b) &&
                   (a.finger == nullptr ||
                    ((a.finger[b] >> finger_of(k, a.h)) & 1u)));
  if (a.dtk != nullptr) {
    const int32_t dk = __ldcs(a.dpk + i);
    const uint32_t db = bucket_of(dk, a.dh);
    int32_t attr;
    if (dk != kEmpty && (!kScreen || bit(main ? a.docc : a.dpass, db)) &&
        delta_attr(a, dk, db, &attr)) {
      if (attr < 0 || (attr & 1) == 0) return false;
      *gk += static_cast<uint32_t>(attr >> 1);
      return true;
    }
  }
  if (k == kEmpty || !main) return false;
  if (kScreen) {
    // the bucket's passing row, a sector (4 pairs) at a time, up to the
    // first empty pair
    const int4* row = reinterpret_cast<const int4*>(
        a.passing + static_cast<int64_t>(b) * a.w);
    for (int j = 0; j < a.w / 2; j += 2) {
      const int4 p0 = __ldg(row + j), p1 = __ldg(row + j + 1);
      const int32_t found = p0.x == k ? p0.y : p0.z == k ? p0.w
                            : p1.x == k ? p1.y : p1.z == k ? p1.w : -1;
      if (found >= 0) {
        *gk += static_cast<uint32_t>(found);
        return true;
      }
      if (p1.z == kEmpty) break;
    }
    return false;
  }
  // without the screen: the key row, and the attributes of its matches
  const int64_t slot = static_cast<int64_t>(b) * a.w;
  const int4* rk = reinterpret_cast<const int4*>(a.tk + slot);
  bool matched = false;
  uint32_t s = 0;
  for (int j = 0; j < a.w / 4; ++j) {
    for (uint32_t mm = match4(__ldg(rk + j), k); mm != 0; mm &= mm - 1) {
      matched = true;
      s += static_cast<uint32_t>(__ldg(a.ta + slot + 4 * j + __ffs(mm) - 1));
    }
  }
  const int32_t attr = static_cast<int32_t>(s);
  if (!matched || attr < 0 || (attr & 1) == 0) return false;
  *gk += static_cast<uint32_t>(attr >> 1);
  return true;
}

enum Agg { kScalar, kShared, kGlobal };

template <int kAgg, bool kScreen, bool kMeasureFirst>
__global__ void __launch_bounds__(kThreads, 2)
query_kernel(const QueryArgs q, const int32_t* __restrict__ fm, int64_t m,
             int32_t* __restrict__ groups, int32_t num_segments) {
  // [histogram (kShared)] [bit sets at the launcher's word offsets]
  extern __shared__ uint32_t smem[];
  __shared__ DimArgs sdim[kMaxDims];
  int32_t* hist = reinterpret_cast<int32_t*>(smem);
  const int n = q.n_dims;
  if (threadIdx.x == 0) {
    // the most selective dimension first: passing / occupied slots, compared
    // as cross products; ties keep the given order
    int order[kMaxDims] = {0, 1, 2, 3};
    if (kScreen && q.sort) {
      for (int s = 1; s < n; ++s) {
        for (int t = s; t > 0; --t) {
          const unsigned long long* x = q.stats + 2 * order[t];
          const unsigned long long* y = q.stats + 2 * order[t - 1];
          const unsigned long long xo = x[1] ? x[1] : 1, yo = y[1] ? y[1] : 1;
          if (x[0] * yo >= y[0] * xo) break;
          const int tmp = order[t];
          order[t] = order[t - 1];
          order[t - 1] = tmp;
        }
      }
    }
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) {
        if (order[s] != d) continue;
        DimArgs a = q.dim[d];
        if (kScreen) {
          if (a.bits_smem >= 0) a.bucket_bits = smem + a.bits_smem;
          if (a.dpass_smem >= 0) a.dpass = smem + a.dpass_smem;
          if (a.docc_smem >= 0) a.docc = smem + a.docc_smem;
          if (a.finger_smem >= 0) {
            a.finger = reinterpret_cast<const uint8_t*>(smem + a.finger_smem);
          }
        }
        sdim[s] = a;
      }
    }
  }
  if (kAgg == kShared) {
    for (int s = threadIdx.x; s < num_segments; s += kThreads) hist[s] = 0;
  }
  if (kScreen) {
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d >= n) break;
      const DimArgs& a = q.dim[d];
      if (a.bits_smem >= 0) {
        for (int w = threadIdx.x; w < a.nbw; w += kThreads) {
          smem[a.bits_smem + w] = __ldg(a.bucket_bits + w);
        }
      }
      if (a.dpass_smem >= 0) {
        for (int w = threadIdx.x; w < a.dnbw; w += kThreads) {
          smem[a.dpass_smem + w] = __ldg(a.dpass + w);
        }
      }
      if (a.docc_smem >= 0) {
        for (int w = threadIdx.x; w < a.dnbw; w += kThreads) {
          smem[a.docc_smem + w] = __ldg(a.docc + w);
        }
      }
      if (a.finger_smem >= 0) {
        auto* f = reinterpret_cast<uint8_t*>(smem + a.finger_smem);
        const int n_buckets = static_cast<int>(a.h.mask) + 1;
        for (int j = threadIdx.x; j < n_buckets; j += kThreads) {
          f[j] = __ldg(a.finger + j);
        }
      }
    }
  }
  __syncthreads();
  uint32_t acc = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < m; i += stride) {
    int32_t v = 0;
    if (kMeasureFirst) {
      v = __ldcs(fm + i);
      if (v == 0) continue;
    }
    bool keep = true;
    uint32_t gk = 0;
#pragma unroll 1
    for (int s = 0; s < n; ++s) {
      if (!probe_dim<kScreen>(sdim[s], i, &gk)) {
        keep = false;
        break;
      }
    }
    if (!keep) continue;
    if (!kMeasureFirst) v = __ldcs(fm + i);
    const int32_t seg = static_cast<int32_t>(gk);
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
    acc = __reduce_add_sync(kFull, acc);
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

// How a query launch is shaped: the shipped kernel sorts the dimensions,
// keeps bits in shared memory up to kSmemBudget and tests fingerprints;
// the design bench varies each.
struct QueryOptions {
  bool sort = true;
  size_t smem_budget = kSmemBudget;
  bool fingers = true;
};

template <bool kScreen, bool kMeasureFirst>
int launch_query_as(QueryArgs q, const int32_t* fm, int64_t m, int32_t* groups,
                    int32_t num_segments, const QueryOptions& opt,
                    cudaStream_t s) {
  q.sort = opt.sort;
  const int agg = num_segments == 1 ? kScalar
                  : num_segments <= kMaxSharedSegments ? kShared : kGlobal;
  size_t words = agg == kShared ? static_cast<size_t>(num_segments) : 0;
  // bit sets into shared memory, the smallest first, while they fit: per
  // dimension the bucket bits, and with a delta its pass and occupancy bits
  for (int d = 0; d < q.n_dims; ++d) {
    q.dim[d].bits_smem = q.dim[d].dpass_smem = q.dim[d].docc_smem = -1;
    q.dim[d].finger_smem = -1;
  }
  if (kScreen) {
    for (;;) {
      int32_t* best = nullptr;
      int best_words = 0;
      for (int d = 0; d < q.n_dims; ++d) {
        DimArgs& a = q.dim[d];
        int32_t* slots[3] = {&a.bits_smem, &a.dpass_smem, &a.docc_smem};
        for (int j = 0; j < (a.dtk != nullptr ? 3 : 1); ++j) {
          const int nw = j == 0 ? a.nbw : a.dnbw;
          if (*slots[j] < 0 && (best == nullptr || nw < best_words)) {
            best = slots[j];
            best_words = nw;
          }
        }
      }
      if (best == nullptr ||
          sizeof(uint32_t) * (words + best_words) > opt.smem_budget) {
        break;
      }
      *best = static_cast<int32_t>(words);
      words += best_words;
    }
    // then the fingerprints, the smallest first, while they fit (the
    // others are read through L1)
    for (int d = 0; d < q.n_dims && !opt.fingers; ++d) {
      q.dim[d].finger = nullptr;
    }
    while (opt.fingers) {
      int best = -1, best_words = 0;
      for (int d = 0; d < q.n_dims; ++d) {
        const int nw = static_cast<int>((int64_t{q.dim[d].h.mask} + 4) / 4);
        if (q.dim[d].finger_smem < 0 && (best < 0 || nw < best_words)) {
          best = d;
          best_words = nw;
        }
      }
      if (best < 0 ||
          sizeof(uint32_t) * (words + best_words) > opt.smem_budget) {
        break;
      }
      q.dim[best].finger_smem = static_cast<int32_t>(words);
      words += best_words;
    }
  }
  const size_t bytes = sizeof(uint32_t) * words;
  constexpr bool kM = kMeasureFirst;
  auto* kernel = agg == kScalar   ? &query_kernel<kScalar, kScreen, kM>
                 : agg == kShared ? &query_kernel<kShared, kScreen, kM>
                                  : &query_kernel<kGlobal, kScreen, kM>;
  int dev = 0, sms = 0, per_sm = 0;
  int status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (status == cudaSuccess) status = cudaGetDevice(&dev);
  if (status == cudaSuccess) {
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (status == cudaSuccess) {
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, bytes);
  }
  if (status != cudaSuccess) return status;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t need = (m + kThreads - 1) / kThreads;
  const int64_t full = int64_t{sms} * per_sm;
  const unsigned grid = static_cast<unsigned>(need < full ? need : full);
  kernel<<<grid, kThreads, bytes, s>>>(q, fm, m, groups, num_segments);
  return cudaGetLastError();
}

// The query's arguments from the wrapper's host tables: 11 pointers per
// dimension (pk, tk, ta, bucket_bits, finger, passing, dpk, dtk, dta, dpass,
// docc; the delta's null when absent) and 6 integers (B, w, fib, DB, dw,
// dfib).
QueryArgs query_args(const void* dim_ptrs, const void* dim_ints,
                     int32_t n_dims, const void* stats) {
  QueryArgs q{};
  q.n_dims = n_dims;
  q.stats = static_cast<const unsigned long long*>(stats);
  const auto* p = static_cast<void* const*>(dim_ptrs);
  const auto* v = static_cast<const int64_t*>(dim_ints);
  for (int d = 0; d < n_dims; ++d) {
    DimArgs& a = q.dim[d];
    void* const* pd = p + 11 * d;
    const int64_t* vd = v + 6 * d;
    a.pk = static_cast<const int32_t*>(pd[0]);
    a.tk = static_cast<const int32_t*>(pd[1]);
    a.ta = static_cast<const int32_t*>(pd[2]);
    a.bucket_bits = static_cast<const uint32_t*>(pd[3]);
    a.finger = static_cast<const uint8_t*>(pd[4]);
    a.passing = static_cast<const int2*>(pd[5]);
    a.dpk = static_cast<const int32_t*>(pd[6]);
    a.dtk = static_cast<const int32_t*>(pd[7]);
    a.dta = static_cast<const int32_t*>(pd[8]);
    a.dpass = static_cast<const uint32_t*>(pd[9]);
    a.docc = static_cast<const uint32_t*>(pd[10]);
    a.h = make_hash(vd[0], static_cast<int32_t>(vd[2]));
    a.w = static_cast<int32_t>(vd[1]);
    a.nbw = static_cast<int32_t>((vd[0] + 31) / 32);
    if (a.dtk != nullptr) {
      a.dh = make_hash(vd[3], static_cast<int32_t>(vd[5]));
      a.dw = static_cast<int32_t>(vd[4]);
      a.dnbw = static_cast<int32_t>((vd[3] + 31) / 32);
    }
  }
  return q;
}

bool valid_widths(const QueryArgs& q) {
  for (int d = 0; d < q.n_dims; ++d) {
    const DimArgs& a = q.dim[d];
    const int32_t ws[2] = {a.w, a.dtk != nullptr ? a.dw : 4};
    for (const int32_t w : ws) {
      if (w < 4 || w > 128 || (w & (w - 1)) != 0) return false;
    }
  }
  return true;
}

}  // namespace

// The bit sets, passing tables and stats of one query's planes (see
// fused_query_launch for the tables; stats: 2 zeroed counters per
// dimension).  One launch packs every plane.
extern "C" int fused_pack_launch(const void* dim_ptrs, const void* dim_ints,
                                 int32_t n_dims, void* stats, void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims) return cudaErrorInvalidValue;
  const QueryArgs q = query_args(dim_ptrs, dim_ints, n_dims, stats);
  if (!valid_widths(q)) return cudaErrorInvalidValue;
  const auto* v = static_cast<const int64_t*>(dim_ints);
  PackArgs pa{};
  int planes = 0;
  int64_t most = 1;
  for (int d = 0; d < n_dims; ++d) {
    const DimArgs& a = q.dim[d];
    auto* st = static_cast<unsigned long long*>(stats) + 2 * d;
    pa.p[planes++] = PackPlane{
        a.tk, a.ta, const_cast<uint32_t*>(a.bucket_bits),
        const_cast<uint8_t*>(a.finger), const_cast<int2*>(a.passing),
        nullptr, st, a.h, v[6 * d], a.w};
    most = v[6 * d] > most ? v[6 * d] : most;
    if (a.dtk != nullptr) {
      pa.p[planes++] = PackPlane{
          a.dtk, a.dta, const_cast<uint32_t*>(a.dpass), nullptr, nullptr,
          const_cast<uint32_t*>(a.docc), nullptr, a.dh, v[6 * d + 3], a.dw};
      most = v[6 * d + 3] > most ? v[6 * d + 3] : most;
    }
  }
  const dim3 grid(static_cast<unsigned>((most + kPackThreads - 1) /
                                        kPackThreads),
                  planes);
  pack_kernel<<<grid, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pa);
  return cudaGetLastError();
}

// dim_ptrs: host array of 11 device pointers per dimension, dim_ints: host
// array of 6 int64 per dimension (see query_args); the bit sets and stats
// are fused_pack_launch's.  groups must be zeroed by the caller.
extern "C" int fused_query_launch(const void* dim_ptrs, const void* dim_ints,
                                  int32_t n_dims, const void* stats,
                                  const void* fmeasure, int64_t m,
                                  void* groups, int32_t num_segments,
                                  void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || num_segments < 1) {
    return cudaErrorInvalidValue;
  }
  const QueryArgs q = query_args(dim_ptrs, dim_ints, n_dims, stats);
  if (!valid_widths(q)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  return launch_query_as<true, false>(
      q, static_cast<const int32_t*>(fmeasure), m,
      static_cast<int32_t*>(groups), num_segments, QueryOptions{},
      static_cast<cudaStream_t>(stream));
}
