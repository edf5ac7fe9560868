// Bucket probe kernels for Hopper (sm_90a): probe_rows, probe_filter_rows,
// probe_filter_rows_delta and bucket_probe_stream.
//
// Replaces the Pallas TPU kernels of repro/kernels/bucket_probe.py:
// probe_rows (_probe_rows_kernel), probe_filter_rows
// (_probe_filter_rows_kernel), probe_filter_rows_delta
// (_probe_filter_rows_delta_kernel) and bucket_probe_stream (_stream_kernel).
// The TPU versions of the first three take bucket rows that XLA gathered
// into (m, W) planes in HBM; these take the (B, W) table planes and gather
// the row themselves, so no (m, W) plane is ever written.
//
// What bounds them: the rate of random reads (32-byte sectors from L2, and
// the L1's line lookups), not the streaming rate.  Per probe a thread
// reads its key (coalesced), then rows of the table at a random bucket,
// and writes one word.  All four hash the key themselves (the table's
// bucket count and hash mode travel as scalars): no bucket-id vector is
// written or read.
//
// probe_rows: where both planes fit kTableSmemBudget (date at SF10: 2 x 32
// KiB), the stream's table kernel (below) at kTableProbes probes a thread
// a step (their key loads in flight together: one a thread left the key
// stream short of loads in flight) with the value read as one 4-byte lane
// (lane_word: fewer shared-memory wavefronts than an int4 group); date's
// 60M probes 0.43 to 0.27 ms.  Larger tables take rows_kernel, one probe a
// thread: the W-lane key row (W=8: one sector, two int4 loads issued back
// to back), then the value of the matching lane as one 4-byte load.  Two
// random sectors a hit, and their rate from L2 sets the time: two, four or
// eight probes a thread with every key row issued before the first compare,
// the next row prefetched in registers (persistent), the ring, loads
// through L2 only or L1 given the SM's whole memory all measured the same
// or slower (tools/stream_designs.cu, PERF.md).  Dropping the 240 MB
// bucket-id vector took the bytes from 754 to 514 MB at part.
//
// probe_filter_rows and probe_filter_rows_delta hash the key themselves
// (the table's bucket count and hash mode travel as scalars, no bucket-id
// vector is read) and never read the int32 predicate plane: the wrapper
// first packs it (pack_bits_launch, one thread per bucket) into two levels
// of bits, one per slot (part: 16 MiB of plane become 512 KiB) and one per
// bucket, set where some slot of the bucket passes (64 KiB).  A probe
// reads its bucket's bit first: unset means no slot passes, so the result
// is NULL_WORD whatever the keys hold, and nothing else of the table is
// read.  Only where it is set are the bucket's lane bits and key row read,
// together, and the value of the matching lane only where its lane bit is
// set.  A selective predicate (Q2.1 passes 1/25 of parts: 14% of part's
// buckets hold a passing slot) thus skips most key sectors and almost
// every value sector: the random reads go from three 16 MiB planes to a
// bit per bucket.
//
// Where the bucket bits (with the delta's, below) fit 96 KiB and W <= 16,
// persistent blocks of 1024 threads, two per SM, copy them into shared
// memory and walk the probes with a grid stride, so that the one random
// read every probe makes is a shared-memory access: a warp's random 4-byte
// reads through L1 touch up to 32 distinct lines, which L1 serves one
// after another.  Larger tables, and W >= 32, take one thread per probe
// and read the bits through L1.
//
// probe_filter_rows_delta adds the delta overlay of a live ingest buffer:
// the thread also reads its raw key (coalesced), hashes it into the
// delta's buckets, reads that bucket's occupancy bit (the key plane packed
// the same way, != EMPTY_KEY, held beside the table's bits) and only where
// it is set the delta key row (DW=8, the engine's width, is compiled as
// such: one sector), loaded before the main probe and compared after it so
// the two chains overlap, and the folded word only on a delta hit.  A
// delta hit overrides the main word unconditionally, even with NULL_WORD
// (a tombstone, or a delta row the predicate rejects).
//
// The streamed vectors (probe keys, raw keys, the output) are read and
// written with the evict-first hint (__ldcs/__stcs), so that 720 MB of them
// pass through L2 without pushing the table out.
//
// Designs measured against this one (tools/probe_designs.py, PERF.md):
// the bit per slot alone, read beside the key row or before it; two lanes
// per probe; two, four or eight probes per thread; the bucket bits read
// through L1 only.
//
// bucket_probe_stream is the stream schedule's probe: probe_rows' result,
// the key hashed in the kernel (no bucket-id vector), and the TPU kernel's
// row-activation pipeline (one bucket-row DMA per probe, double-buffered
// against the compare of the step before) rebuilt on Hopper's asynchronous
// copies.  Persistent blocks; each thread walks its probes with a grid
// stride (4 blocks of 256 threads per SM) and keeps a ring of kRingStages
// (2: double buffering) key rows in shared memory: it hashes the key of
// the probe kRingStages - 1 ahead and issues cp.async (16 B, .ca: cached
// in L1 as well) of that bucket's key row into the ring, one commit group
// per probe, then compares the row that has arrived.  The value word is
// read only from the int4 group that matched.  Each thread reads only the
// ring slots it filled, so no barrier is needed.  Where both planes fit
// kTableSmemBudget (date: 2 x 32 KiB), a block copies them whole into
// shared memory with cp.async and probes there.  What bounds the ring is
// what bounds probe_rows: the rate of random sectors from L2 (a deeper
// ring, .cg copies or the value loaded a probe later bought nothing), and
// its shared memory comes out of L1, so on tables that L1 partly holds
// (supplier's 256 KiB planes) it loses to one thread per probe.  This
// kernel's first design (W lanes of a warp per probe, a ballot and
// shuffles: instruction issue bound) is kept in tools/stream_designs.cu
// with the other designs tried.
//
// Semantics (bit-identical to the plain versions): found = any lane equals
// the key and the key is not EMPTY_KEY; the word is the int32 sum of the
// matching lanes' values (at most one match per bucket), NULL_WORD (-2) on
// a miss; the filter kernels also need a matched lane whose predicate is
// > 0, which on the 0/1 plane of ops.slot_predicate is the reference's
// "summed predicate lanes > 0".
#include <cstdint>
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int32_t kNull = -2;
constexpr int kThreads = 256;
// the filter kernels' persistent blocks: two of 1024 threads on each SM,
// each holding at most kSmemBudget bytes of bucket bits (part's 524288
// buckets and its delta's 65536: 73,728 bytes)
constexpr int kSmemThreads = 1024;
constexpr size_t kSmemBudget = 96 << 10;

__device__ __forceinline__ uint32_t lane_sum(const int4 v, bool m0, bool m1,
                                             bool m2, bool m3) {
  return (m0 ? static_cast<uint32_t>(v.x) : 0u) +
         (m1 ? static_cast<uint32_t>(v.y) : 0u) +
         (m2 ? static_cast<uint32_t>(v.z) : 0u) +
         (m3 ? static_cast<uint32_t>(v.w) : 0u);
}

// The delta operands of probe_filter_rows_delta (unused otherwise).
struct DeltaArgs {
  const int32_t* dtk;    // (DB, dw) delta key plane (raw keys)
  const int32_t* dtw;    // (DB, dw) predicate-folded delta words
  const uint32_t* occ;   // (ceil(DB / 32),) bucket bits: some slot occupied
  const int32_t* raw;    // (m,) raw probe keys
  Hash h;                // the delta's hash
  int32_t dw;
};

// The slot bits and bucket bits of a (B, W) plane, one thread per bucket:
// slot bit b W + j (bit (b W + j) % 32 of word (b W + j) / 32) is the test
// of plane[b][j] (kPositive: > 0, else != EMPTY_KEY), bucket bit b is "some
// slot bit of bucket b is set".  Below 32 lanes a slot word holds 32 / W
// buckets, put together by shuffles; every lane takes part in the ballot
// and the shuffles (no early return).
template <int W, bool kPositive>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ plane, int64_t num_buckets,
            uint32_t* __restrict__ slot_bits,
            uint32_t* __restrict__ bucket_bits) {
  constexpr int NW = W > 32 ? W / 32 : 1;  // slot words per bucket
  constexpr int LW = W < 32 ? W : 32;      // lanes per slot word
  constexpr int G = 32 / LW;               // buckets per slot word
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool active = b < num_buckets;
  const int4* row = reinterpret_cast<const int4*>(plane + b * W);
  constexpr int32_t kOff = kPositive ? 0 : kEmpty;  // tests false
  uint32_t bits[NW];
  uint32_t any = 0;
#pragma unroll
  for (int c = 0; c < NW; ++c) {
    bits[c] = 0;
#pragma unroll
    for (int j = 0; j < LW / 4; ++j) {
      const int4 v = active ? __ldcs(row + c * (LW / 4) + j)
                            : make_int4(kOff, kOff, kOff, kOff);
      const uint32_t t = kPositive
          ? static_cast<uint32_t>(v.x > 0) |
                static_cast<uint32_t>(v.y > 0) << 1 |
                static_cast<uint32_t>(v.z > 0) << 2 |
                static_cast<uint32_t>(v.w > 0) << 3
          : static_cast<uint32_t>(v.x != kEmpty) |
                static_cast<uint32_t>(v.y != kEmpty) << 1 |
                static_cast<uint32_t>(v.z != kEmpty) << 2 |
                static_cast<uint32_t>(v.w != kEmpty) << 3;
      bits[c] |= t << (4 * j);
    }
    any |= bits[c];
  }
  const uint32_t bucket_word = __ballot_sync(kFull, any != 0);
  if (lane == 0 && active) bucket_bits[b >> 5] = bucket_word;
  if (W >= 32) {
    if (active) {
#pragma unroll
      for (int c = 0; c < NW; ++c) slot_bits[b * NW + c] = bits[c];
    }
  } else {
    uint32_t word = bits[0] << (LW * (lane % G));
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      word |= __shfl_xor_sync(kFull, word, off);
    }
    if (lane % G == 0 && active) slot_bits[(b * W) >> 5] = word;
  }
}

// The operands of one filter launch.
struct FilterArgs {
  const int32_t* tk;    // (B, W) key plane
  const int32_t* tv;    // (B, W) value plane
  const uint32_t* pm;   // slot bits of the predicate plane
  const uint32_t* pb;   // bucket bits of the predicate plane
  const int32_t* keys;  // (m,) probe keys
  int32_t* out;         // (m,) words
  int64_t m;
  Hash h;               // the table's hash
  DeltaArgs d;          // with a delta only
};

template <bool kSmem>
__device__ __forceinline__ uint32_t bit_word(const uint32_t* bits, uint32_t w) {
  if constexpr (kSmem) {
    return bits[w];
  } else {
    return __ldg(bits + w);
  }
}

// The word of probe i.  DW: 0 no delta, 8 a delta 8 lanes wide (the
// engine's), -1 a delta of the runtime width d.dw.  pb and occ (the
// delta's bucket bits) point into shared memory when kSmem, else into
// global memory.
template <int W, int DW, bool kSmem>
__device__ __forceinline__ int32_t filter_probe(int64_t i, const FilterArgs& a,
                                                const uint32_t* pb,
                                                const uint32_t* occ) {
  constexpr int NW = W > 32 ? W / 32 : 1;       // mask words per bucket
  constexpr int LW = W < 32 ? W : 32;           // lanes per mask word
  constexpr uint32_t kLanes = LW == 32 ? kFull : (1u << LW) - 1u;
  constexpr bool kDelta = DW != 0;
  const DeltaArgs& d = a.d;
  const int dw = DW > 0 ? DW : d.dw;
  const int32_t k = __ldcs(a.keys + i);
  const uint32_t b = bucket_of(k, a.h);
  // the bucket bit first: a bucket with no passing slot gives NULL_WORD
  const bool live = k != kEmpty && ((bit_word<kSmem>(pb, b >> 5) >> (b & 31)) & 1u);
  // delta: its bucket's occupancy bit, then the key row, loaded here and
  // compared after the main probe, so the two chains overlap
  int32_t dk = kEmpty;
  bool dlive = false;
  int64_t drow = 0;
  int4 d0 = make_int4(0, 0, 0, 0), d1 = d0;
  if (kDelta) {
    dk = __ldcs(d.raw + i);
    const uint32_t db = bucket_of(dk, d.h);
    dlive = dk != kEmpty && ((bit_word<kSmem>(occ, db >> 5) >> (db & 31)) & 1u);
    drow = static_cast<int64_t>(db) * dw;
    if (dlive) {
      const int4* drk = reinterpret_cast<const int4*>(d.dtk + drow);
      d0 = __ldg(drk);
      if (dw >= 8) d1 = __ldg(drk + 1);
    }
  }
  int32_t result = kNull;
  if (live) {
    // the bucket's lane bits and key row together, the value only for a
    // matched lane whose bit is set
    const int64_t slot = static_cast<int64_t>(b) * W;
    const int4* rk = reinterpret_cast<const int4*>(a.tk + slot);
    uint32_t pass[NW], match[NW];
    uint32_t hit = 0;
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      const int64_t s = slot + 32 * c;
      pass[c] = (__ldg(a.pm + (s >> 5)) >> (s & 31)) & kLanes;
      match[c] = 0;
#pragma unroll
      for (int j = 0; j < LW / 4; ++j) {
        match[c] |= match4(__ldg(rk + c * (LW / 4) + j), k) << (4 * j);
      }
      hit |= match[c] & pass[c];
    }
    if (hit != 0) {
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        for (uint32_t mm = match[c]; mm != 0; mm &= mm - 1) {
          word += static_cast<uint32_t>(
              __ldg(a.tv + slot + 32 * c + (__ffs(mm) - 1)));
        }
      }
      result = static_cast<int32_t>(word);
    }
  }
  if (kDelta && dlive) {
    const int4* drk = reinterpret_cast<const int4*>(d.dtk + drow);
    const int4* drw = reinterpret_cast<const int4*>(d.dtw + drow);
    bool dany = false;
    uint32_t dword = 0;
#pragma unroll 2
    for (int j = 0; j < dw / 4; ++j) {
      const int4 kk = j == 0 ? d0 : j == 1 ? d1 : __ldg(drk + j);
      const bool m0 = kk.x == dk, m1 = kk.y == dk, m2 = kk.z == dk,
                 m3 = kk.w == dk;
      if (m0 | m1 | m2 | m3) {
        dany = true;
        dword += lane_sum(__ldg(drw + j), m0, m1, m2, m3);
      }
    }
    if (dany) result = static_cast<int32_t>(dword);
  }
  return result;
}

// One thread per probe, the bits read through L1: tables whose bucket bits
// do not fit the shared-memory budget, and W >= 32.
template <int W, int DW>
__global__ void __launch_bounds__(kThreads) filter_kernel(const FilterArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.m) return;
  __stcs(a.out + i, filter_probe<W, DW, false>(i, a, a.pb, a.d.occ));
}

// Persistent blocks, two per SM: each copies the bucket bits (and the
// delta's) into shared memory once, then walks the probes with a grid
// stride.  A random bit test is then a shared-memory access, not a
// 32-line gather through L1.
template <int W, int DW>
__global__ void __launch_bounds__(kSmemThreads, 2)
filter_smem_kernel(const FilterArgs a, int32_t nbw, int32_t dnbw) {
  extern __shared__ uint32_t sbits[];
  for (int w = threadIdx.x; w < nbw; w += kSmemThreads) {
    sbits[w] = __ldg(a.pb + w);
  }
  for (int w = threadIdx.x; w < dnbw; w += kSmemThreads) {
    sbits[nbw + w] = __ldg(a.d.occ + w);
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSmemThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kSmemThreads +
                   threadIdx.x;
       i < a.m; i += stride) {
    __stcs(a.out + i, filter_probe<W, DW, true>(i, a, sbits, sbits + nbw));
  }
}

unsigned grid_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <int W, int DW>
int launch_filter_w(const FilterArgs& a, int64_t num_buckets,
                    int64_t delta_buckets, cudaStream_t s) {
  if constexpr (W <= 16) {
    const int nbw = static_cast<int>((num_buckets + 31) / 32);
    const int dnbw = DW != 0 ? static_cast<int>((delta_buckets + 31) / 32) : 0;
    const size_t bytes = sizeof(uint32_t) * (nbw + dnbw);
    if (bytes <= kSmemBudget) {
      const auto kernel = filter_smem_kernel<W, DW>;
      int dev = 0, sms = 0, per_sm = 0;
      int status = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (status == cudaSuccess) status = cudaGetDevice(&dev);
      if (status == cudaSuccess) {
        status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev);
      }
      if (status == cudaSuccess) {
        status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kSmemThreads, bytes);
      }
      if (status != cudaSuccess) return status;
      if (per_sm > 0) {
        const int64_t need = (a.m + kSmemThreads - 1) / kSmemThreads;
        const int64_t grid = need < int64_t{sms} * per_sm
                                 ? need : int64_t{sms} * per_sm;
        kernel<<<static_cast<unsigned>(grid), kSmemThreads, bytes, s>>>(
            a, nbw, dnbw);
        return cudaGetLastError();
      }
    }
  }
  filter_kernel<W, DW><<<grid_for(a.m), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int DW>
int launch_filter(const FilterArgs& a, int64_t num_buckets,
                  int64_t delta_buckets, int32_t w, void* stream) {
  if (a.m == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 4: return launch_filter_w<4, DW>(a, num_buckets, delta_buckets, s);
    case 8: return launch_filter_w<8, DW>(a, num_buckets, delta_buckets, s);
    case 16: return launch_filter_w<16, DW>(a, num_buckets, delta_buckets, s);
    case 32: return launch_filter_w<32, DW>(a, num_buckets, delta_buckets, s);
    case 64: return launch_filter_w<64, DW>(a, num_buckets, delta_buckets, s);
    case 128: return launch_filter_w<128, DW>(a, num_buckets, delta_buckets, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPositive>
int launch_pack(const int32_t* p, int64_t nb, int32_t w, uint32_t* sb,
                uint32_t* bb, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (w) {
    case 4: pack_kernel<4, kPositive><<<g, kThreads, 0, s>>>(p, nb, sb, bb); break;
    case 8: pack_kernel<8, kPositive><<<g, kThreads, 0, s>>>(p, nb, sb, bb); break;
    case 16: pack_kernel<16, kPositive><<<g, kThreads, 0, s>>>(p, nb, sb, bb); break;
    case 32: pack_kernel<32, kPositive><<<g, kThreads, 0, s>>>(p, nb, sb, bb); break;
    case 64: pack_kernel<64, kPositive><<<g, kThreads, 0, s>>>(p, nb, sb, bb); break;
    case 128: pack_kernel<128, kPositive><<<g, kThreads, 0, s>>>(p, nb, sb, bb); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bucket_probe_stream
// ---------------------------------------------------------------------------

// key rows in flight per thread, plus the one being compared, whether their
// copies are cached in L1, and ring blocks per SM (of the 8 that fit at
// W = 8: fewer leave more of the SM's memory to L1)
constexpr int kRingStages = 2;
constexpr bool kRingL1 = true;
constexpr int kRingBlocksPerSM = 4;
// both planes of a table probed from shared memory, two blocks per SM
constexpr int kTableThreads = 1024;
constexpr size_t kTableSmemBudget = 96 << 10;
// probes a thread a step of the table kernel in probe_rows
constexpr int kTableProbes = 4;

// 16 bytes global -> shared, asynchronously: kL1 caches them in L1 (.ca),
// else only in L2 (.cg)
template <bool kL1 = false>
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (kL1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lane_sum4(const int4 v, uint32_t m4) {
  return lane_sum(v, m4 & 1u, m4 & 2u, m4 & 4u, m4 & 8u);
}

// The word of key k against the key row at `row` (G int4 groups, `step`
// int4 apart) and the value row at `rv`: the sum of the matched lanes'
// values, read only from the groups that matched.  Both rows may be in
// shared or global memory.
template <int G, int step>
__device__ __forceinline__ int32_t row_word(const int4* row, const int4* rv,
                                            int32_t k) {
  bool any = false;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const uint32_t mm = match4(row[j * step], k);
    if (mm != 0) {
      any = true;
      word += lane_sum4(rv[j], mm);
    }
  }
  return any && k != kEmpty ? static_cast<int32_t>(word) : kNull;
}

// The word of key k against a W-lane key row and its value row, both in
// global memory (kGlobal, read through L1) or in shared memory: the key
// row's matching lanes as bits, then one 4-byte value read for each (one
// unless the key repeats in the bucket).  An EMPTY_KEY probe matches the
// empty slots, but misses.
template <int W, bool kGlobal>
__device__ __forceinline__ int32_t lane_word(const int4* rk, const int32_t* rv,
                                             int32_t k) {
  constexpr int NW = W > 32 ? W / 32 : 1;  // match words
  constexpr int LW = W < 32 ? W : 32;      // lanes per match word
  uint32_t match[NW];
#pragma unroll
  for (int c = 0; c < NW; ++c) {
    match[c] = 0;
#pragma unroll
    for (int j = 0; j < LW / 4; ++j) {
      const int4* q = rk + c * (LW / 4) + j;
      match[c] |= match4(kGlobal ? __ldg(q) : *q, k) << (4 * j);
    }
  }
  uint32_t any = 0, word = 0;
#pragma unroll
  for (int c = 0; c < NW; ++c) {
    const uint32_t mc = k != kEmpty ? match[c] : 0u;
    any |= mc;
    for (uint32_t mm = mc; mm != 0; mm &= mm - 1) {
      const int32_t* q = rv + 32 * c + __ffs(mm) - 1;
      word += static_cast<uint32_t>(kGlobal ? __ldg(q) : *q);
    }
  }
  return any != 0 ? static_cast<int32_t>(word) : kNull;
}

// threads of a ring block: 256 up to W = 16, fewer above so that the ring
// of a block stays within S x 256 x 64 B
template <int W>
__host__ __device__ constexpr int ring_threads() {
  return W <= 16 ? 256 : 4096 / W;
}

// The ring: each thread's S slots of one key row (W / 4 int4, laid out
// [S][W / 4][T] so that a warp's reads of one int4 are contiguous) and one
// key ([S][T] int32, after the rows).
template <int W, int S, bool kL1>
__global__ void __launch_bounds__(W <= 16 ? 256 : 4096 / W, W <= 8 ? 8 : 1)
stream_ring_kernel(const int32_t* __restrict__ tk,
                   const int32_t* __restrict__ tv,
                   const int32_t* __restrict__ keys, int32_t* __restrict__ out,
                   int64_t m, const Hash h) {
  constexpr int T = ring_threads<W>();
  constexpr int G = W / 4;
  extern __shared__ int4 ring[];
  int32_t* skey = reinterpret_cast<int32_t*>(ring + S * T * G);
  const int tid = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * T;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * T + tid;
  // hash probe p's key and start the copy of its key row into slot st; one
  // commit group per probe, empty past the end, so the count stays exact
  auto issue = [&](int64_t p, int st) {
    if (p < m) {
      const int32_t k = __ldcs(keys + p);
      skey[st * T + tid] = k;
      const int4* src = reinterpret_cast<const int4*>(
          tk + static_cast<int64_t>(bucket_of(k, h)) * W);
      int4* dst = ring + st * G * T + tid;
#pragma unroll
      for (int j = 0; j < G; ++j) cp_async16<kL1>(dst + j * T, src + j);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) issue(first + st * stride, st);
  int st = 0;
  for (int64_t p = first; p < m; p += stride) {
    issue(p + (S - 1) * stride, st == 0 ? S - 1 : st - 1);
    cp_async_wait<S - 1>();  // probe p's row has arrived
    const int32_t k = skey[st * T + tid];
    const int4* rv = reinterpret_cast<const int4*>(
        tv + static_cast<int64_t>(bucket_of(k, h)) * W);
    __stcs(out + p, row_word<G, T>(ring + st * G * T + tid, rv, k));
    st = st + 1 == S ? 0 : st + 1;
  }
  cp_async_wait<0>();
}

// Both planes in shared memory ([B][W / 4] int4 keys, then values), copied
// once per block; then a grid stride over the probes, P probes a thread a
// step (probe i0 + p * kTableThreads, so each key load is coalesced across
// the warp), all P keys loaded before the first is compared: P streamed
// loads in flight a thread.  kLane: the value read as lane_word reads it
// (4 bytes of the matching lane, where row_word reads the matching int4
// group: fewer shared-memory wavefronts a warp).  bucket_probe_stream takes
// P = 1 and the group, probe_rows kTableProbes and the lane.
template <int W, int P, bool kLane>
__global__ void __launch_bounds__(kTableThreads, 2)
table_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
             const int32_t* __restrict__ keys, int32_t* __restrict__ out,
             int64_t m, const Hash h, int64_t num_buckets) {
  constexpr int G = W / 4;
  extern __shared__ int4 tab[];
  const int64_t n4 = num_buckets * G;
  const int4* gk = reinterpret_cast<const int4*>(tk);
  const int4* gv = reinterpret_cast<const int4*>(tv);
  for (int64_t j = threadIdx.x; j < n4; j += kTableThreads) {
    cp_async16(tab + j, gk + j);
    cp_async16(tab + n4 + j, gv + j);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTableThreads * P;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTableThreads * P +
                    threadIdx.x;
       i0 < m; i0 += stride) {
    int32_t k[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int64_t i = i0 + p * kTableThreads;
      k[p] = i < m ? __ldcs(keys + i) : kEmpty;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int64_t i = i0 + p * kTableThreads;
      if (i < m) {
        const int64_t row = static_cast<int64_t>(bucket_of(k[p], h)) * G;
        __stcs(out + i, kLane
            ? lane_word<W, false>(tab + row,
                                  reinterpret_cast<const int32_t*>(
                                      tab + n4 + row), k[p])
            : row_word<G, 1>(tab + row, tab + n4 + row, k[p]));
      }
    }
  }
}

// probe_rows on a table whose planes do not fit shared memory: one probe a
// thread.  Its key row (W / 4 int4 loads, issued back to back), then the
// value of the first lane that holds the key as one 4-byte load, and of any
// further one (a duplicate key) after it: two random sectors a hit, the
// least a probe of two planes can read.  Those sectors' rate from L2 bounds
// it: more probes a thread, a ring or the next row held in registers moved
// nothing (tools/stream_designs.cu).
template <int W>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
            const int32_t* __restrict__ keys, int32_t* __restrict__ out,
            int64_t m, const Hash h) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int32_t k = __ldcs(keys + i);
  const int64_t slot = static_cast<int64_t>(bucket_of(k, h)) * W;
  __stcs(out + i, lane_word<W, true>(reinterpret_cast<const int4*>(tk + slot),
                                     tv + slot, k));
}

// A persistent grid of `kernel`: as many blocks as fit on the card (at most
// max_per_sm on an SM, when > 0), and no more than one per `threads` probes.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, int64_t m,
                    unsigned* grid, int max_per_sm = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  int status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (status == cudaSuccess) status = cudaGetDevice(&dev);
  if (status == cudaSuccess) {
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (status == cudaSuccess) {
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           threads, smem);
  }
  if (status != cudaSuccess) return status;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (max_per_sm > 0 && per_sm > max_per_sm) per_sm = max_per_sm;
  const int64_t need = (m + threads - 1) / threads;
  const int64_t full = int64_t{sms} * per_sm;
  *grid = static_cast<unsigned>(need < full ? need : full);
  return cudaSuccess;
}

template <int W, int S, bool kL1>
int launch_ring(const int32_t* k, const int32_t* v, const int32_t* q,
                int32_t* o, int64_t m, const Hash h, cudaStream_t s,
                int max_per_sm = 0) {
  constexpr int T = ring_threads<W>();
  const size_t smem = S * T * (W * sizeof(int32_t) + sizeof(int32_t));
  const auto kernel = stream_ring_kernel<W, S, kL1>;
  unsigned grid = 0;
  const int status = persistent_grid(kernel, T, smem, m, &grid, max_per_sm);
  if (status != cudaSuccess) return status;
  kernel<<<grid, T, smem, s>>>(k, v, q, o, m, h);
  return cudaGetLastError();
}

template <int W, int P, bool kLane>
int launch_table(const int32_t* k, const int32_t* v, const int32_t* q,
                 int32_t* o, int64_t m, const Hash h, int64_t num_buckets,
                 cudaStream_t s) {
  const size_t smem = 2 * sizeof(int32_t) * W * num_buckets;
  const auto kernel = table_kernel<W, P, kLane>;
  unsigned grid = 0;
  const int status = persistent_grid(kernel, kTableThreads, smem,
                                     (m + P - 1) / P, &grid);
  if (status != cudaSuccess) return status;
  kernel<<<grid, kTableThreads, smem, s>>>(k, v, q, o, m, h, num_buckets);
  return cudaGetLastError();
}

template <int W>
int launch_stream(const int32_t* k, const int32_t* v, const int32_t* q,
                  int32_t* o, int64_t m, int64_t num_buckets, int32_t fib,
                  cudaStream_t s) {
  const Hash h = make_hash(num_buckets, fib);
  if (2 * sizeof(int32_t) * W * num_buckets <= kTableSmemBudget) {
    return launch_table<W, 1, false>(k, v, q, o, m, h, num_buckets, s);
  }
  return launch_ring<W, kRingStages, kRingL1>(k, v, q, o, m, h, s,
                                             kRingBlocksPerSM);
}

// probe_rows' dispatch: planes that fit kTableSmemBudget (date: 2 x 32 KiB)
// are probed from shared memory, larger ones by rows_kernel.
template <int W>
int launch_rows(const int32_t* k, const int32_t* v, const int32_t* q,
                int32_t* o, int64_t m, int64_t num_buckets, int32_t fib,
                cudaStream_t s) {
  const Hash h = make_hash(num_buckets, fib);
  if (2 * sizeof(int32_t) * W * num_buckets <= kTableSmemBudget) {
    return launch_table<W, kTableProbes, true>(k, v, q, o, m, h, num_buckets,
                                               s);
  }
  rows_kernel<W><<<grid_for(m), kThreads, 0, s>>>(k, v, q, o, m, h);
  return cudaGetLastError();
}

}  // namespace

// fib: the table's hash mode, 0 identity, 1 Fibonacci.
extern "C" int probe_rows_launch(const void* tk, const void* tv,
                                 const void* keys, void* out, int64_t m,
                                 int64_t num_buckets, int32_t w, int32_t fib,
                                 void* stream) {
  if (m == 0) return cudaSuccess;
  const auto* k = static_cast<const int32_t*>(tk);
  const auto* v = static_cast<const int32_t*>(tv);
  const auto* q = static_cast<const int32_t*>(keys);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 4: return launch_rows<4>(k, v, q, o, m, num_buckets, fib, s);
    case 8: return launch_rows<8>(k, v, q, o, m, num_buckets, fib, s);
    case 16: return launch_rows<16>(k, v, q, o, m, num_buckets, fib, s);
    case 32: return launch_rows<32>(k, v, q, o, m, num_buckets, fib, s);
    case 64: return launch_rows<64>(k, v, q, o, m, num_buckets, fib, s);
    case 128: return launch_rows<128>(k, v, q, o, m, num_buckets, fib, s);
    default: return cudaErrorInvalidValue;
  }
}

// A (B, W) int32 plane -> its slot bits (max(1, B W / 32) words) and its
// bucket bits (ceil(B / 32) words).  positive: 1 tests > 0 (a predicate
// plane), 0 tests != EMPTY_KEY (a key plane's occupied slots).
extern "C" int pack_bits_launch(const void* plane, int64_t num_buckets,
                                int32_t w, int32_t positive, void* slot_bits,
                                void* bucket_bits, void* stream) {
  if (num_buckets == 0) return cudaSuccess;
  const auto* p = static_cast<const int32_t*>(plane);
  auto* sb = static_cast<uint32_t*>(slot_bits);
  auto* bb = static_cast<uint32_t*>(bucket_bits);
  const auto s = static_cast<cudaStream_t>(stream);
  return positive ? launch_pack<true>(p, num_buckets, w, sb, bb, s)
                  : launch_pack<false>(p, num_buckets, w, sb, bb, s);
}

// slot_bits, bucket_bits: pack_bits_launch's words for the table's
// predicate plane.  fib: the table's hash mode, 0 identity, 1 Fibonacci.
extern "C" int probe_filter_rows_launch(const void* tk, const void* tv,
                                        const void* slot_bits,
                                        const void* bucket_bits,
                                        const void* keys, void* out, int64_t m,
                                        int64_t num_buckets, int32_t w,
                                        int32_t fib, void* stream) {
  const FilterArgs a{static_cast<const int32_t*>(tk),
                     static_cast<const int32_t*>(tv),
                     static_cast<const uint32_t*>(slot_bits),
                     static_cast<const uint32_t*>(bucket_bits),
                     static_cast<const int32_t*>(keys),
                     static_cast<int32_t*>(out), m,
                     make_hash(num_buckets, fib), DeltaArgs{}};
  return launch_filter<0>(a, num_buckets, 0, w, stream);
}

// delta_bits: pack_bits_launch's bucket words for the delta's key plane
// (positive = 0).
extern "C" int probe_filter_rows_delta_launch(
    const void* tk, const void* tv, const void* slot_bits,
    const void* bucket_bits, const void* keys, const void* dtk,
    const void* dtw, const void* delta_bits, const void* raw, void* out,
    int64_t m, int64_t num_buckets, int32_t w, int32_t fib,
    int64_t delta_buckets, int32_t dw, int32_t dfib, void* stream) {
  if (dw < 4 || dw > 128 || (dw & (dw - 1)) != 0) return cudaErrorInvalidValue;
  const DeltaArgs d{static_cast<const int32_t*>(dtk),
                    static_cast<const int32_t*>(dtw),
                    static_cast<const uint32_t*>(delta_bits),
                    static_cast<const int32_t*>(raw),
                    make_hash(delta_buckets, dfib), dw};
  const FilterArgs a{static_cast<const int32_t*>(tk),
                     static_cast<const int32_t*>(tv),
                     static_cast<const uint32_t*>(slot_bits),
                     static_cast<const uint32_t*>(bucket_bits),
                     static_cast<const int32_t*>(keys),
                     static_cast<int32_t*>(out), m,
                     make_hash(num_buckets, fib), d};
  return dw == 8 ? launch_filter<8>(a, num_buckets, delta_buckets, w, stream)
                 : launch_filter<-1>(a, num_buckets, delta_buckets, w, stream);
}


// fib: the table's hash mode, 0 identity, 1 Fibonacci.
extern "C" int bucket_probe_stream_launch(const void* tk, const void* tv,
                                          const void* keys, void* out,
                                          int64_t m, int64_t num_buckets,
                                          int32_t w, int32_t fib,
                                          void* stream) {
  if (m == 0) return cudaSuccess;
  const auto* k = static_cast<const int32_t*>(tk);
  const auto* v = static_cast<const int32_t*>(tv);
  const auto* q = static_cast<const int32_t*>(keys);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 4: return launch_stream<4>(k, v, q, o, m, num_buckets, fib, s);
    case 8: return launch_stream<8>(k, v, q, o, m, num_buckets, fib, s);
    case 16: return launch_stream<16>(k, v, q, o, m, num_buckets, fib, s);
    case 32: return launch_stream<32>(k, v, q, o, m, num_buckets, fib, s);
    case 64: return launch_stream<64>(k, v, q, o, m, num_buckets, fib, s);
    case 128: return launch_stream<128>(k, v, q, o, m, num_buckets, fib, s);
    default: return cudaErrorInvalidValue;
  }
}
