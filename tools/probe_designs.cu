// Designs of the filter probe (probe_filter_rows, probe_filter_rows_delta)
// at bucket width 8 and delta width 8, timed side by side on the card by
// tools/probe_designs.py.  The design the port ships is in
// src/repro_torch/kernels/csrc/bucket_probe.cu (filter_kernel); these are
// the others it was measured against:
//
//   pr13    the port's first design: per-probe bucket ids read from a
//           vector (and delta bucket ids from a second one), the value row
//           and the int32 predicate row read for the int4 group that
//           holds the match;
//   mask    the key hashed in the kernel, the bucket's 8 predicate bits
//           read from the packed mask beside the key row, the value only
//           where a matched lane's bit is set (kScreen = false);
//   screen  as mask, but the mask first: the key row only where one of
//           the bucket's bits is set (kScreen = true), with or without the
//           evict-first hint on the streamed vectors (kHints);
//   pair    screen + hints with two lanes per probe, each loading one int4
//           of the key row, so one load instruction covers a whole sector;
//   multiP  screen + hints with P = 2, 4 or 8 probes per thread, their
//           loads issued together phase by phase (keys, masks, key rows);
//   summary screen + hints on a bit per bucket first (B / 8 bytes), then
//           the bucket's lane bits and key row together (the delta's key
//           row read for every probe);
//   smem    summary with the bucket bits, and the delta's bucket occupancy
//           bits, in shared memory (persistent blocks, grid stride).
//
// Every design computes the same words as the plain versions.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -0x7FFFFFFF;
constexpr int32_t kNull = -2;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kFib = 2654435769u;

struct Hash {
  uint32_t mask;
  int32_t shift;
  int32_t fib;
};

__device__ __forceinline__ uint32_t bucket_of(int32_t k, const Hash h) {
  uint32_t u = static_cast<uint32_t>(k);
  if (h.fib) u = (u * kFib) >> h.shift;
  return u & h.mask;
}

Hash make_hash(int64_t num_buckets, int32_t fib) {
  int bits = 1;
  while ((int64_t{1} << bits) < num_buckets) ++bits;
  return Hash{static_cast<uint32_t>(num_buckets - 1), 32 - bits, fib};
}

__device__ __forceinline__ uint32_t match4(const int4 v, int32_t k) {
  return static_cast<uint32_t>(v.x == k) |
         static_cast<uint32_t>(v.y == k) << 1 |
         static_cast<uint32_t>(v.z == k) << 2 |
         static_cast<uint32_t>(v.w == k) << 3;
}

__device__ __forceinline__ uint32_t lane_sum(const int4 v, uint32_t m4) {
  return (m4 & 1 ? static_cast<uint32_t>(v.x) : 0u) +
         (m4 & 2 ? static_cast<uint32_t>(v.y) : 0u) +
         (m4 & 4 ? static_cast<uint32_t>(v.z) : 0u) +
         (m4 & 8 ? static_cast<uint32_t>(v.w) : 0u);
}

// the sum of the words of the lanes set in `match` (row of 8)
__device__ __forceinline__ uint32_t sum_lanes(const int32_t* row,
                                              uint32_t match) {
  uint32_t word = 0;
  for (uint32_t mm = match; mm != 0; mm &= mm - 1) {
    word += static_cast<uint32_t>(__ldg(row + (__ffs(mm) - 1)));
  }
  return word;
}

struct Delta {
  const int32_t* dtk;
  const int32_t* dtw;
  const int32_t* raw;    // raw probe keys
  const int32_t* dbids;  // pr13 only
  const uint32_t* occ;   // smem only: the delta's bucket occupancy bits
  Hash h;
};

template <bool kDelta>
__global__ void __launch_bounds__(kThreads)
pr13_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
            const int32_t* __restrict__ tp, const int32_t* __restrict__ keys,
            const int32_t* __restrict__ bids, int32_t* __restrict__ out,
            int64_t m, const Delta d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int32_t k = keys[i];
  const int64_t row = static_cast<int64_t>(bids[i]) * 8;
  const int4* rk = reinterpret_cast<const int4*>(tk + row);
  const int4* rv = reinterpret_cast<const int4*>(tv + row);
  const int4* rp = reinterpret_cast<const int4*>(tp + row);
  bool any = false;
  uint32_t word = 0, pred = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t m4 = match4(__ldg(rk + j), k);
    if (m4) {
      any = true;
      word += lane_sum(__ldg(rv + j), m4);
      pred += lane_sum(__ldg(rp + j), m4);
    }
  }
  int32_t result = any && k != kEmpty && static_cast<int32_t>(pred) > 0
                       ? static_cast<int32_t>(word) : kNull;
  if (kDelta) {
    const int32_t dk = d.raw[i];
    const int64_t drow = static_cast<int64_t>(d.dbids[i]) * 8;
    const int4* drk = reinterpret_cast<const int4*>(d.dtk + drow);
    const int4* drw = reinterpret_cast<const int4*>(d.dtw + drow);
    bool dany = false;
    uint32_t dword = 0;
    for (int j = 0; j < 2; ++j) {
      const uint32_t m4 = match4(__ldg(drk + j), dk);
      if (m4) {
        dany = true;
        dword += lane_sum(__ldg(drw + j), m4);
      }
    }
    if (dany && dk != kEmpty) result = static_cast<int32_t>(dword);
  }
  out[i] = result;
}

template <bool kDelta, bool kScreen, bool kHints>
__global__ void __launch_bounds__(kThreads)
mask_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
            const uint32_t* __restrict__ pm,
            const int32_t* __restrict__ keys, int32_t* __restrict__ out,
            int64_t m, const Hash h, const Delta d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int32_t k = kHints ? __ldcs(keys + i) : keys[i];
  int32_t dk = kEmpty;
  int64_t drow = 0;
  int4 d0 = make_int4(0, 0, 0, 0), d1 = d0;
  if (kDelta) {
    dk = kHints ? __ldcs(d.raw + i) : d.raw[i];
    drow = static_cast<int64_t>(bucket_of(dk, d.h)) * 8;
    d0 = __ldg(reinterpret_cast<const int4*>(d.dtk + drow));
    d1 = __ldg(reinterpret_cast<const int4*>(d.dtk + drow) + 1);
  }
  const int64_t slot = static_cast<int64_t>(bucket_of(k, h)) * 8;
  const uint32_t pass = (__ldg(pm + (slot >> 5)) >> (slot & 31)) & 0xffu;
  int32_t result = kNull;
  if (!kScreen || pass != 0) {
    const int4* rk = reinterpret_cast<const int4*>(tk + slot);
    const uint32_t match = match4(__ldg(rk), k) | match4(__ldg(rk + 1), k) << 4;
    if ((match & pass) != 0 && k != kEmpty) {
      result = static_cast<int32_t>(sum_lanes(tv + slot, match));
    }
  }
  if (kDelta && dk != kEmpty) {
    const uint32_t dm = match4(d0, dk) | match4(d1, dk) << 4;
    if (dm != 0) result = static_cast<int32_t>(sum_lanes(d.dtw + drow, dm));
  }
  if (kHints) {
    __stcs(out + i, result);
  } else {
    out[i] = result;
  }
}

template <bool kDelta>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
            const uint32_t* __restrict__ pm,
            const int32_t* __restrict__ keys, int32_t* __restrict__ out,
            int64_t m, const Hash h, const Delta d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = t >> 1;
  const int half = static_cast<int>(t & 1);
  // no early return: both lanes of every pair take part in the shuffles
  const bool active = i < m;
  int32_t k = kEmpty, dk = kEmpty;
  if (active) {
    k = __ldcs(keys + i);
    if (kDelta) dk = __ldcs(d.raw + i);
  }
  uint32_t dm = 0;
  int64_t drow = 0;
  if (kDelta && active) {
    drow = static_cast<int64_t>(bucket_of(dk, d.h)) * 8;
    dm = match4(__ldg(reinterpret_cast<const int4*>(d.dtk + drow) + half), dk)
         << (4 * half);
  }
  const int64_t slot = static_cast<int64_t>(bucket_of(k, h)) * 8;
  const uint32_t pass =
      active ? (__ldg(pm + (slot >> 5)) >> (slot & 31)) & 0xffu : 0u;
  uint32_t mm = 0;
  if (pass != 0) {
    mm = match4(__ldg(reinterpret_cast<const int4*>(tk + slot) + half), k)
         << (4 * half);
  }
  mm |= __shfl_xor_sync(kFull, mm, 1);
  if (kDelta) dm |= __shfl_xor_sync(kFull, dm, 1);
  if (!active || half) return;
  int32_t result = kNull;
  if ((mm & pass) != 0 && k != kEmpty) {
    result = static_cast<int32_t>(sum_lanes(tv + slot, mm));
  }
  if (kDelta && dm != 0 && dk != kEmpty) {
    result = static_cast<int32_t>(sum_lanes(d.dtw + drow, dm));
  }
  __stcs(out + i, result);
}

// screen + hints with P probes per thread: probe p of a thread is
// base + p * kThreads, so each of its P key loads is coalesced across the
// warp and the P loads (and then the P mask loads, key rows, values) are
// in flight together.
template <bool kDelta, int P>
__global__ void __launch_bounds__(kThreads)
multi_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
             const uint32_t* __restrict__ pm,
             const int32_t* __restrict__ keys, int32_t* __restrict__ out,
             int64_t m, const Hash h, const Delta d) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kThreads * P + threadIdx.x;
  int32_t k[P], dk[P];
  int64_t slot[P], drow[P];
  uint32_t pass[P], match[P], dm[P];
  int4 r0[P], r1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = base + p * kThreads;
    k[p] = i < m ? __ldcs(keys + i) : kEmpty;
    dk[p] = kDelta && i < m ? __ldcs(d.raw + i) : kEmpty;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (kDelta) {
      drow[p] = static_cast<int64_t>(bucket_of(dk[p], d.h)) * 8;
      r0[p] = __ldg(reinterpret_cast<const int4*>(d.dtk + drow[p]));
      r1[p] = __ldg(reinterpret_cast<const int4*>(d.dtk + drow[p]) + 1);
    }
    slot[p] = static_cast<int64_t>(bucket_of(k[p], h)) * 8;
    pass[p] = k[p] != kEmpty
                  ? (__ldg(pm + (slot[p] >> 5)) >> (slot[p] & 31)) & 0xffu
                  : 0u;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    dm[p] = kDelta && dk[p] != kEmpty
                ? match4(r0[p], dk[p]) | match4(r1[p], dk[p]) << 4 : 0u;
    if (pass[p] != 0) {
      r0[p] = __ldg(reinterpret_cast<const int4*>(tk + slot[p]));
      r1[p] = __ldg(reinterpret_cast<const int4*>(tk + slot[p]) + 1);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    match[p] = pass[p] != 0
                   ? match4(r0[p], k[p]) | match4(r1[p], k[p]) << 4 : 0u;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = base + p * kThreads;
    if (i >= m) break;
    int32_t result = kNull;
    if ((match[p] & pass[p]) != 0) {
      result = static_cast<int32_t>(sum_lanes(tv + slot[p], match[p]));
    }
    if (dm[p] != 0) {
      result = static_cast<int32_t>(sum_lanes(d.dtw + drow[p], dm[p]));
    }
    __stcs(out + i, result);
  }
}

// screen + hints with a second, smaller level: one bit per bucket ("some
// slot passes"), B / 8 bytes (64 KiB for part, small enough for L1).  The
// bucket's lane bits and its key row are read, together, only where that
// bit is set.
template <bool kDelta>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
               const uint32_t* __restrict__ pm,
               const uint32_t* __restrict__ ps,
               const int32_t* __restrict__ keys, int32_t* __restrict__ out,
               int64_t m, const Hash h, const Delta d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int32_t k = __ldcs(keys + i);
  int32_t dk = kEmpty;
  int64_t drow = 0;
  int4 d0 = make_int4(0, 0, 0, 0), d1 = d0;
  if (kDelta) {
    dk = __ldcs(d.raw + i);
    drow = static_cast<int64_t>(bucket_of(dk, d.h)) * 8;
    d0 = __ldg(reinterpret_cast<const int4*>(d.dtk + drow));
    d1 = __ldg(reinterpret_cast<const int4*>(d.dtk + drow) + 1);
  }
  const uint32_t b = bucket_of(k, h);
  int32_t result = kNull;
  if (((__ldg(ps + (b >> 5)) >> (b & 31)) & 1u) != 0 && k != kEmpty) {
    const int64_t slot = static_cast<int64_t>(b) * 8;
    const uint32_t pass = (__ldg(pm + (slot >> 5)) >> (slot & 31)) & 0xffu;
    const int4* rk = reinterpret_cast<const int4*>(tk + slot);
    const uint32_t match = match4(__ldg(rk), k) | match4(__ldg(rk + 1), k) << 4;
    if ((match & pass) != 0) {
      result = static_cast<int32_t>(sum_lanes(tv + slot, match));
    }
  }
  if (kDelta && dk != kEmpty) {
    const uint32_t dm = match4(d0, dk) | match4(d1, dk) << 4;
    if (dm != 0) result = static_cast<int32_t>(sum_lanes(d.dtw + drow, dm));
  }
  __stcs(out + i, result);
}

// summary with the bucket bits (and the delta's bucket occupancy bits) held
// in shared memory: persistent blocks of 1024 threads, two per SM, each
// copying the bits once and then walking the probes with a grid stride.
// A random bit test is then a shared-memory access, not an L1 gather.
constexpr int kSmemThreads = 1024;

template <bool kDelta>
__global__ void __launch_bounds__(kSmemThreads, 2)
smem_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
            const uint32_t* __restrict__ pm,
            const uint32_t* __restrict__ ps,
            const int32_t* __restrict__ keys, int32_t* __restrict__ out,
            int64_t m, const Hash h, const Delta d, int32_t nbw,
            int32_t dnbw) {
  extern __shared__ uint32_t sbits[];
  for (int w = threadIdx.x; w < nbw; w += kSmemThreads) sbits[w] = ps[w];
  if (kDelta) {
    for (int w = threadIdx.x; w < dnbw; w += kSmemThreads) {
      sbits[nbw + w] = d.occ[w];
    }
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSmemThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kSmemThreads +
                   threadIdx.x;
       i < m; i += stride) {
    const int32_t k = __ldcs(keys + i);
    const uint32_t b = bucket_of(k, h);
    const bool live = k != kEmpty && ((sbits[b >> 5] >> (b & 31)) & 1u);
    int32_t dk = kEmpty;
    bool dlive = false;
    int64_t drow = 0;
    int4 d0 = make_int4(0, 0, 0, 0), d1 = d0;
    if (kDelta) {
      dk = __ldcs(d.raw + i);
      const uint32_t db = bucket_of(dk, d.h);
      dlive = dk != kEmpty && ((sbits[nbw + (db >> 5)] >> (db & 31)) & 1u);
      drow = static_cast<int64_t>(db) * 8;
      if (dlive) {
        d0 = __ldg(reinterpret_cast<const int4*>(d.dtk + drow));
        d1 = __ldg(reinterpret_cast<const int4*>(d.dtk + drow) + 1);
      }
    }
    int32_t result = kNull;
    if (live) {
      const int64_t slot = static_cast<int64_t>(b) * 8;
      const uint32_t pass = (__ldg(pm + (slot >> 5)) >> (slot & 31)) & 0xffu;
      const int4* rk = reinterpret_cast<const int4*>(tk + slot);
      const uint32_t match =
          match4(__ldg(rk), k) | match4(__ldg(rk + 1), k) << 4;
      if ((match & pass) != 0) {
        result = static_cast<int32_t>(sum_lanes(tv + slot, match));
      }
    }
    if (kDelta && dlive) {
      const uint32_t dm = match4(d0, dk) | match4(d1, dk) << 4;
      if (dm != 0) result = static_cast<int32_t>(sum_lanes(d.dtw + drow, dm));
    }
    __stcs(out + i, result);
  }
}

template <bool kDelta>
int launch_smem(const int32_t* k, const int32_t* v, const uint32_t* pm,
                const uint32_t* ps, const int32_t* q, int32_t* o, int64_t m,
                const Hash h, const Delta& d, int64_t nb, int64_t dnb,
                cudaStream_t s) {
  const int nbw = static_cast<int>((nb + 31) / 32);
  const int dnbw = kDelta ? static_cast<int>((dnb + 31) / 32) : 0;
  const size_t bytes = sizeof(uint32_t) * (nbw + dnbw);
  cudaFuncSetAttribute(smem_kernel<kDelta>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, smem_kernel<kDelta>,
                                                kSmemThreads, bytes);
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  smem_kernel<kDelta><<<sms * per_sm, kSmemThreads, bytes, s>>>(
      k, v, pm, ps, q, o, m, h, d, nbw, dnbw);
  return cudaGetLastError();
}

unsigned grid_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// dtk == nullptr: no delta.
extern "C" int pr13_launch(const void* tk, const void* tv, const void* tp,
                           const void* keys, const void* bids, const void* dtk,
                           const void* dtw, const void* raw, const void* dbids,
                           void* out, int64_t m, void* stream) {
  const Delta d{static_cast<const int32_t*>(dtk),
                static_cast<const int32_t*>(dtw),
                static_cast<const int32_t*>(raw),
                static_cast<const int32_t*>(dbids), nullptr, Hash{}};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(tk);
  const auto* v = static_cast<const int32_t*>(tv);
  const auto* p = static_cast<const int32_t*>(tp);
  const auto* q = static_cast<const int32_t*>(keys);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* o = static_cast<int32_t*>(out);
  if (dtk) {
    pr13_kernel<true><<<grid_for(m), kThreads, 0, s>>>(k, v, p, q, b, o, m, d);
  } else {
    pr13_kernel<false><<<grid_for(m), kThreads, 0, s>>>(k, v, p, q, b, o, m, d);
  }
  return cudaGetLastError();
}

// design: 0 mask, 1 screen, 2 screen + hints, 3 pair (screen + hints),
// 4/5/6 screen + hints with 2/4/8 probes per thread, 7 summary, 8 smem
extern "C" int design_launch(int32_t design, const void* tk, const void* tv,
                             const void* mask_bits, const void* bucket_bits,
                             const void* keys,
                             const void* dtk, const void* dtw, const void* raw,
                             const void* delta_bits,
                             void* out, int64_t m, int64_t num_buckets,
                             int32_t fib, int64_t delta_buckets, int32_t dfib,
                             void* stream) {
  const Delta d{static_cast<const int32_t*>(dtk),
                static_cast<const int32_t*>(dtw),
                static_cast<const int32_t*>(raw), nullptr,
                static_cast<const uint32_t*>(delta_bits),
                dtk ? make_hash(delta_buckets, dfib) : Hash{}};
  const Hash h = make_hash(num_buckets, fib);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(tk);
  const auto* v = static_cast<const int32_t*>(tv);
  const auto* pm = static_cast<const uint32_t*>(mask_bits);
  const auto* ps = static_cast<const uint32_t*>(bucket_bits);
  const auto* q = static_cast<const int32_t*>(keys);
  auto* o = static_cast<int32_t*>(out);
  const unsigned g = grid_for(m);
  const bool delta = dtk != nullptr;
  switch (design) {
    case 0:
      if (delta) mask_kernel<true, false, false><<<g, kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      else mask_kernel<false, false, false><<<g, kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      break;
    case 1:
      if (delta) mask_kernel<true, true, false><<<g, kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      else mask_kernel<false, true, false><<<g, kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      break;
    case 2:
      if (delta) mask_kernel<true, true, true><<<g, kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      else mask_kernel<false, true, true><<<g, kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      break;
    case 3:
      if (delta) pair_kernel<true><<<grid_for(2 * m), kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      else pair_kernel<false><<<grid_for(2 * m), kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      break;
    case 4:
      if (delta) multi_kernel<true, 2><<<grid_for((m + 1) / 2), kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      else multi_kernel<false, 2><<<grid_for((m + 1) / 2), kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      break;
    case 5:
      if (delta) multi_kernel<true, 4><<<grid_for((m + 3) / 4), kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      else multi_kernel<false, 4><<<grid_for((m + 3) / 4), kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      break;
    case 6:
      if (delta) multi_kernel<true, 8><<<grid_for((m + 7) / 8), kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      else multi_kernel<false, 8><<<grid_for((m + 7) / 8), kThreads, 0, s>>>(k, v, pm, q, o, m, h, d);
      break;
    case 7:
      if (delta) summary_kernel<true><<<g, kThreads, 0, s>>>(k, v, pm, ps, q, o, m, h, d);
      else summary_kernel<false><<<g, kThreads, 0, s>>>(k, v, pm, ps, q, o, m, h, d);
      break;
    case 8:
      return delta ? launch_smem<true>(k, v, pm, ps, q, o, m, h, d, num_buckets, delta_buckets, s)
                   : launch_smem<false>(k, v, pm, ps, q, o, m, h, d, num_buckets, delta_buckets, s);
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
