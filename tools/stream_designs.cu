// Designs of bucket_probe_stream and probe_rows at bucket width 8, timed
// side by side on the card by tools/kernel_designs.py.  The designs the port
// ships are in src/repro_torch/kernels/csrc/bucket_probe.cu (included here,
// so that the ring, table and rows kernels run as they ship, at other
// depths too); these are the others they were measured against:
//
//   lanes   the first design: per-probe bucket ids read from a vector, W lanes
//           of a warp per probe, each loading one slot, then a ballot and
//           shuffles inside the group;
//   direct  one thread per probe, the key hashed in the kernel, the key row
//           and the value loaded straight into registers (probe_rows with
//           the hash moved in);
//   defer   the ring, with the value group loaded into registers when the
//           row is compared and used one probe later, so that its latency
//           overlaps the next row's wait;
//   ringS, ringSca  the ring at S stages and as many blocks as fit (8 of
//           256 threads per SM at S = 2), its copies through L2 only (.cg)
//           or cached in L1 too (.ca);
//   ring2caB  ring2ca at B blocks per SM (B = 4 ships);
//   ring2reg  ring2ca4 with the keys in registers and fewer instructions;
//   prefetch  no ring: each thread loads its next key row into registers
//           before it compares the current one (persistent blocks);
//   ids     probe_rows' first design: per-probe bucket ids read from a
//           vector that hash_bucket wrote, one thread per probe, the key
//           row, then the matched value group, loaded one after the other;
//   rowsP   P probes a thread, every key row loaded before the first compare
//           and every matched value group before the first sum, the loads
//           predicated (P = 1: direct so written);
//   tableP  the port's table kernel at P probes a thread a step (P = 1 is
//           the stream's);
//   directP direct's code at P probes a thread, every key row issued first;
//   firstP  P probes a thread, every key row issued first, then one 4-byte
//           value load of each probe's first matching lane (first1 ships,
//           as the port's rows_kernel: rows); firstcg the same through
//           L2 only (.cg), firstL1 with the SM's memory given to L1;
//   tableSP the table kernel at P probes a thread a step, its value read
//           as firstP reads it (tableS4 ships in probe_rows).
#include "../src/repro_torch/kernels/csrc/bucket_probe.cu"

namespace {

__global__ void __launch_bounds__(kThreads)
ids_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
           const int32_t* __restrict__ keys, const int32_t* __restrict__ bids,
           int32_t* __restrict__ out, int64_t m) {
  constexpr int W = 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int32_t k = keys[i];
  const int64_t row = static_cast<int64_t>(bids[i]) * W;
  const int4* rk = reinterpret_cast<const int4*>(tk + row);
  const int4* rv = reinterpret_cast<const int4*>(tv + row);
  bool any = false;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const int4 kk = __ldg(rk + j);
    const bool m0 = kk.x == k, m1 = kk.y == k, m2 = kk.z == k, m3 = kk.w == k;
    if (m0 | m1 | m2 | m3) {
      any = true;
      word += lane_sum(__ldg(rv + j), m0, m1, m2, m3);
    }
  }
  out[i] = any && k != kEmpty ? static_cast<int32_t>(word) : kNull;
}

__global__ void __launch_bounds__(kThreads)
lanes_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
             const int32_t* __restrict__ keys,
             const int32_t* __restrict__ bids, int32_t* __restrict__ out,
             int64_t m) {
  constexpr int W = 8, G = 8;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = t / G;
  const int sub = static_cast<int>(t % G);
  const int lane = threadIdx.x & 31;
  const unsigned group = ((1u << G) - 1u) << (lane - lane % G);
  const bool active = i < m;
  int32_t k = kEmpty;
  int64_t row = 0;
  if (active) {
    k = keys[i];
    row = static_cast<int64_t>(bids[i]) * W;
  }
  const bool match = active && __ldg(tk + row + sub) == k;
  uint32_t v = match ? static_cast<uint32_t>(__ldg(tv + row + sub)) : 0u;
  const bool any = (__ballot_sync(kFull, match) & group) != 0u;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off, G);
  }
  if (active && sub == 0) {
    out[i] = any && k != kEmpty ? static_cast<int32_t>(v) : kNull;
  }
}

__global__ void __launch_bounds__(kThreads)
direct_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
              const int32_t* __restrict__ keys, int32_t* __restrict__ out,
              int64_t m, const Hash h) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int32_t k = __ldcs(keys + i);
  const int64_t row = static_cast<int64_t>(bucket_of(k, h)) * 8;
  const int4* rk = reinterpret_cast<const int4*>(tk + row);
  const int4* rv = reinterpret_cast<const int4*>(tv + row);
  const int4 k0 = __ldg(rk), k1 = __ldg(rk + 1);
  const uint32_t m0 = match4(k0, k), m1 = match4(k1, k);
  uint32_t word = 0;
  if (m0) word += lane_sum4(__ldg(rv), m0);
  if (m1) word += lane_sum4(__ldg(rv + 1), m1);
  __stcs(out + i, (m0 | m1) && k != kEmpty ? static_cast<int32_t>(word)
                                           : kNull);
}

template <int S>
__global__ void __launch_bounds__(256, 8)
defer_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
             const int32_t* __restrict__ keys, int32_t* __restrict__ out,
             int64_t m, const Hash h) {
  constexpr int T = 256, G = 2;
  extern __shared__ int4 ring[];
  int32_t* skey = reinterpret_cast<int32_t*>(ring + S * T * G);
  const int tid = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * T;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * T + tid;
  auto issue = [&](int64_t p, int st) {
    if (p < m) {
      const int32_t k = __ldcs(keys + p);
      skey[st * T + tid] = k;
      const int4* src = reinterpret_cast<const int4*>(
          tk + static_cast<int64_t>(bucket_of(k, h)) * 8);
      int4* dst = ring + st * G * T + tid;
      cp_async16<false>(dst, src);
      cp_async16<false>(dst + T, src + 1);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) issue(first + st * stride, st);
  int st = 0;
  int64_t prev = -1;
  int4 pv = make_int4(0, 0, 0, 0);
  uint32_t pmask = 0;
  for (int64_t p = first; p < m; p += stride) {
    issue(p + (S - 1) * stride, st == 0 ? S - 1 : st - 1);
    cp_async_wait<S - 1>();
    const int32_t k = skey[st * T + tid];
    const uint32_t m0 = match4(ring[st * G * T + tid], k);
    const uint32_t m1 = match4(ring[(st * G + 1) * T + tid], k);
    const int4* rv = reinterpret_cast<const int4*>(
        tv + static_cast<int64_t>(bucket_of(k, h)) * 8);
    int4 v = make_int4(0, 0, 0, 0);
    uint32_t mask = k != kEmpty ? (m0 | m1) : 0u;
    if (mask != 0 && m0 != 0 && m1 != 0) {  // a key in both groups
      v.x = static_cast<int32_t>(lane_sum4(__ldg(rv), m0) +
                                 lane_sum4(__ldg(rv + 1), m1));
      mask = 1;
    } else if (mask != 0) {
      v = __ldg(rv + (m0 != 0 ? 0 : 1));
    }
    if (prev >= 0) {
      __stcs(out + prev, pmask ? static_cast<int32_t>(lane_sum4(pv, pmask))
                               : kNull);
    }
    prev = p;
    pv = v;
    pmask = mask;
    st = st + 1 == S ? 0 : st + 1;
  }
  if (prev >= 0) {
    __stcs(out + prev, pmask ? static_cast<int32_t>(lane_sum4(pv, pmask))
                             : kNull);
  }
  cp_async_wait<0>();
}

// The ring at 2 stages with the keys in registers (the loop unrolled by
// the stages) and the value read with __ldg: fewer instructions a probe.
__global__ void __launch_bounds__(256, 8)
ring_reg_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
                const int32_t* __restrict__ keys, int32_t* __restrict__ out,
                int64_t m, const Hash h) {
  constexpr int T = 256;
  extern __shared__ int4 ring[];  // [2 stages][2 int4][T]
  const int tid = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * T;
  auto issue = [&](int64_t q, int st) {
    int32_t k = kEmpty;
    if (q < m) {
      k = __ldcs(keys + q);
      const int4* src = reinterpret_cast<const int4*>(
          tk + static_cast<int64_t>(bucket_of(k, h)) * 8);
      int4* dst = ring + st * 2 * T + tid;
      cp_async16<true>(dst, src);
      cp_async16<true>(dst + T, src + 1);
    }
    cp_async_commit();
    return k;
  };
  auto finish = [&](int64_t q, int st, int32_t k) {
    cp_async_wait<1>();
    const uint32_t m0 = match4(ring[st * 2 * T + tid], k);
    const uint32_t m1 = match4(ring[(st * 2 + 1) * T + tid], k);
    const int4* rv = reinterpret_cast<const int4*>(
        tv + static_cast<int64_t>(bucket_of(k, h)) * 8);
    uint32_t word = 0;
    if (m0) word += lane_sum4(__ldg(rv), m0);
    if (m1) word += lane_sum4(__ldg(rv + 1), m1);
    __stcs(out + q, (m0 | m1) && k != kEmpty ? static_cast<int32_t>(word)
                                              : kNull);
  };
  int64_t p = static_cast<int64_t>(blockIdx.x) * T + tid;
  int32_t k0 = issue(p, 0);
  for (; p < m; p += 2 * stride) {
    const int32_t k1 = issue(p + stride, 1);
    finish(p, 0, k0);
    if (p + stride >= m) break;
    k0 = issue(p + 2 * stride, 0);
    finish(p + stride, 1, k1);
  }
  cp_async_wait<0>();
}

// One thread's next key row loaded into registers while it compares the
// current one: the double buffer without shared memory or cp.async.
__global__ void __launch_bounds__(256)
prefetch_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
                const int32_t* __restrict__ keys, int32_t* __restrict__ out,
                int64_t m, const Hash h) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * 256;
  int64_t p = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  auto load = [&](int64_t q, int32_t* k, int4* r0, int4* r1) {
    *k = kEmpty;
    *r0 = *r1 = make_int4(0, 0, 0, 0);
    if (q < m) {
      *k = __ldcs(keys + q);
      const int4* rk = reinterpret_cast<const int4*>(
          tk + static_cast<int64_t>(bucket_of(*k, h)) * 8);
      *r0 = __ldg(rk);
      *r1 = __ldg(rk + 1);
    }
  };
  int32_t k;
  int4 r0, r1;
  load(p, &k, &r0, &r1);
  for (; p < m; p += stride) {
    int32_t kn;
    int4 n0, n1;
    load(p + stride, &kn, &n0, &n1);
    const uint32_t m0 = match4(r0, k), m1 = match4(r1, k);
    const int4* rv = reinterpret_cast<const int4*>(
        tv + static_cast<int64_t>(bucket_of(k, h)) * 8);
    uint32_t word = 0;
    if (m0) word += lane_sum4(__ldg(rv), m0);
    if (m1) word += lane_sum4(__ldg(rv + 1), m1);
    __stcs(out + p, (m0 | m1) && k != kEmpty ? static_cast<int32_t>(word)
                                              : kNull);
    k = kn;
    r0 = n0;
    r1 = n1;
  }
}

// direct's code at P probes a thread: every key row issued first, then
// each probe compared and its value groups read under branches, as direct
// does.
template <int P>
__global__ void __launch_bounds__(kThreads)
directp_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
               const int32_t* __restrict__ keys, int32_t* __restrict__ out,
               int64_t m, const Hash h) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * P +
                       threadIdx.x;
  int32_t k[P];
  int64_t row[P];
  int4 k0[P], k1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = base + p * kThreads;
    k[p] = i < m ? __ldcs(keys + i) : kEmpty;
    row[p] = static_cast<int64_t>(bucket_of(k[p], h)) * 8;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int4* rk = reinterpret_cast<const int4*>(tk + row[p]);
    k0[p] = __ldg(rk);
    k1[p] = __ldg(rk + 1);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = base + p * kThreads;
    const int4* rv = reinterpret_cast<const int4*>(tv + row[p]);
    const uint32_t m0 = match4(k0[p], k[p]), m1 = match4(k1[p], k[p]);
    uint32_t word = 0;
    if (m0) word += lane_sum4(__ldg(rv), m0);
    if (m1) word += lane_sum4(__ldg(rv + 1), m1);
    if (i < m) {
      __stcs(out + i, (m0 | m1) && k[p] != kEmpty ? static_cast<int32_t>(word)
                                                  : kNull);
    }
  }
}

// P probes a thread, every key row issued first, then for each probe one
// 4-byte value load of its first matching lane, all issued before the
// first sum (a further matching lane, a duplicate key, is read after).
template <int P, int kMode = 0>
__global__ void __launch_bounds__(kThreads)
first_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
             const int32_t* __restrict__ keys, int32_t* __restrict__ out,
             int64_t m, const Hash h) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * P +
                       threadIdx.x;
  int32_t k[P];
  int64_t row[P];
  int4 k0[P], k1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = base + p * kThreads;
    k[p] = i < m ? __ldcs(keys + i) : kEmpty;
    row[p] = static_cast<int64_t>(bucket_of(k[p], h)) * 8;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int4* rk = reinterpret_cast<const int4*>(tk + row[p]);
    k0[p] = kMode == 1 ? __ldcg(rk) : __ldg(rk);
    k1[p] = kMode == 1 ? __ldcg(rk + 1) : __ldg(rk + 1);
  }
  uint32_t mask[P];
  int32_t v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    mask[p] = k[p] != kEmpty
        ? match4(k0[p], k[p]) | match4(k1[p], k[p]) << 4 : 0u;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    v[p] = 0;
    if (mask[p]) {
      const int32_t* pv = tv + row[p] + __ffs(mask[p]) - 1;
      v[p] = kMode == 1 ? __ldcg(pv) : __ldg(pv);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t i = base + p * kThreads;
    uint32_t word = static_cast<uint32_t>(v[p]);
    for (uint32_t rest = mask[p] & (mask[p] - 1); rest; rest &= rest - 1) {
      word += static_cast<uint32_t>(__ldg(tv + row[p] + __ffs(rest) - 1));
    }
    if (i < m) __stcs(out + i, mask[p] ? static_cast<int32_t>(word) : kNull);
  }
}

// The rowsP design: P probes a thread (probe base + p * kThreads), every
// key row loaded before the first compare (each load predicated on the key
// not being EMPTY_KEY), then the value group of every match before the
// first sum.
template <int W, int P>
__global__ void __launch_bounds__(kThreads)
rowsp_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
            const int32_t* __restrict__ keys, int32_t* __restrict__ out,
            int64_t m, const Hash h) {
  constexpr int G = W / 4;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kThreads * P) + threadIdx.x;
  const int4* gk = reinterpret_cast<const int4*>(tk);
  const int4* gv = reinterpret_cast<const int4*>(tv);
  if constexpr (W > 16) {
    static_assert(P == 1, "one probe a thread above W = 16");
    if (base < m) {
      const int32_t k = __ldcs(keys + base);
      const int64_t row = static_cast<int64_t>(bucket_of(k, h)) * G;
      __stcs(out + base, row_word<G, 1>(gk + row, gv + row, k));
    }
  } else {
    int32_t k[P];
    int64_t row[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int64_t i = base + p * kThreads;
      k[p] = i < m ? __ldcs(keys + i) : kEmpty;
      row[p] = static_cast<int64_t>(bucket_of(k[p], h)) * G;
    }
    // an EMPTY_KEY probe (and a lane past the end) reads no row: it misses
    int4 r[P][G];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        r[p][j] = k[p] != kEmpty ? __ldg(gk + row[p] + j)
                                 : make_int4(0, 0, 0, 0);
      }
    }
    uint32_t mm[P][G];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int j = 0; j < G; ++j) mm[p][j] = match4(r[p][j], k[p]);
    }
    // the value groups that matched, all issued before the first sum
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        r[p][j] = mm[p][j] != 0 ? __ldg(gv + row[p] + j)
                                : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int64_t i = base + p * kThreads;
      uint32_t word = 0, any = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        word += lane_sum4(r[p][j], mm[p][j]);
        any |= mm[p][j];
      }
      if (i < m) {
        __stcs(out + i, any != 0 && k[p] != kEmpty ? static_cast<int32_t>(word)
                                                   : kNull);
      }
    }
  }
}

}  // namespace

// design: 0 lanes, 1 direct, 2 defer (3 stages), 3-5 ring of 2-4 stages,
// 6 table (both planes in shared memory; fails where they do not fit), 7-8
// ring of 2-3 stages with the copies cached in L1, 9-10 ring of 2 stages
// cached in L1 at 4 or 6 blocks of 256 threads per SM (8 fit), 11 the
// ring with keys in registers, 12 the register double buffer, 13 ids,
// 14-17 rows at 1, 2, 4, 8 probes a thread, 18-19 table at 2 or 4 probes a
// thread a step (fail where the planes do not fit), 20-21 directP at 2 or 4
// probes a thread, 22-24 firstP at 1, 2 or 4, 25 firstcg, 26 firstL1, 27 the
// port's rows_kernel, 28 tableS4, 29 table8, 30 tableS2, 31 tableS8 (6,
// 18-19 and 28-31 fail where the planes do not fit).
// W = 8 only; bids are read by lanes and ids only.
extern "C" int stream_design_launch(int32_t design, const void* tk,
                                    const void* tv, const void* keys,
                                    const void* bids, void* out, int64_t m,
                                    int64_t num_buckets, int32_t fib,
                                    void* stream) {
  const auto* k = static_cast<const int32_t*>(tk);
  const auto* v = static_cast<const int32_t*>(tv);
  const auto* q = static_cast<const int32_t*>(keys);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const Hash h = make_hash(num_buckets, fib);
  switch (design) {
    case 0:
      lanes_kernel<<<grid_for(m * 8), kThreads, 0, s>>>(
          k, v, q, static_cast<const int32_t*>(bids), o, m);
      return cudaGetLastError();
    case 1:
      direct_kernel<<<grid_for(m), kThreads, 0, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    case 2: {
      const size_t smem = 3 * 256 * (8 * sizeof(int32_t) + sizeof(int32_t));
      unsigned grid = 0;
      const int st = persistent_grid(defer_kernel<3>, 256, smem, m, &grid);
      if (st != cudaSuccess) return st;
      defer_kernel<3><<<grid, 256, smem, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    }
    case 3: return launch_ring<8, 2, false>(k, v, q, o, m, h, s);
    case 4: return launch_ring<8, 3, false>(k, v, q, o, m, h, s);
    case 5: return launch_ring<8, 4, false>(k, v, q, o, m, h, s);
    case 7: return launch_ring<8, 2, true>(k, v, q, o, m, h, s);
    case 8: return launch_ring<8, 3, true>(k, v, q, o, m, h, s);
    case 9: return launch_ring<8, 2, true>(k, v, q, o, m, h, s, 4);
    case 10: return launch_ring<8, 2, true>(k, v, q, o, m, h, s, 6);
    case 11: {
      const size_t smem = 2 * 2 * 256 * sizeof(int4);
      unsigned grid = 0;
      const int st = persistent_grid(ring_reg_kernel, 256, smem, m, &grid, 4);
      if (st != cudaSuccess) return st;
      ring_reg_kernel<<<grid, 256, smem, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    }
    case 12: {
      unsigned grid = 0;
      const int st = persistent_grid(prefetch_kernel, 256, 0, m, &grid);
      if (st != cudaSuccess) return st;
      prefetch_kernel<<<grid, 256, 0, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    }
    case 13:
      ids_kernel<<<grid_for(m), kThreads, 0, s>>>(
          k, v, q, static_cast<const int32_t*>(bids), o, m);
      return cudaGetLastError();
    case 14:
      rowsp_kernel<8, 1><<<grid_for(m), kThreads, 0, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    case 15:
      rowsp_kernel<8, 2><<<grid_for((m + 1) / 2), kThreads, 0, s>>>(
          k, v, q, o, m, h);
      return cudaGetLastError();
    case 16:
      rowsp_kernel<8, 4><<<grid_for((m + 3) / 4), kThreads, 0, s>>>(
          k, v, q, o, m, h);
      return cudaGetLastError();
    case 17:
      rowsp_kernel<8, 8><<<grid_for((m + 7) / 8), kThreads, 0, s>>>(
          k, v, q, o, m, h);
      return cudaGetLastError();
    case 20:
      directp_kernel<2><<<grid_for((m + 1) / 2), kThreads, 0, s>>>(
          k, v, q, o, m, h);
      return cudaGetLastError();
    case 21:
      directp_kernel<4><<<grid_for((m + 3) / 4), kThreads, 0, s>>>(
          k, v, q, o, m, h);
      return cudaGetLastError();
    case 22:
      first_kernel<1><<<grid_for(m), kThreads, 0, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    case 23:
      first_kernel<2><<<grid_for((m + 1) / 2), kThreads, 0, s>>>(
          k, v, q, o, m, h);
      return cudaGetLastError();
    case 24:
      first_kernel<4><<<grid_for((m + 3) / 4), kThreads, 0, s>>>(
          k, v, q, o, m, h);
      return cudaGetLastError();
    case 25:
      first_kernel<1, 1><<<grid_for(m), kThreads, 0, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    case 26: {
      // as first1, with the SM's memory given to L1 (no shared memory)
      const int st = cudaFuncSetAttribute(
          first_kernel<1, 2>, cudaFuncAttributePreferredSharedMemoryCarveout,
          0);
      if (st != cudaSuccess) return st;
      first_kernel<1, 2><<<grid_for(m), kThreads, 0, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    }
    case 27:
      rows_kernel<8><<<grid_for(m), kThreads, 0, s>>>(k, v, q, o, m, h);
      return cudaGetLastError();
    case 6:
    case 18:
    case 19:
    case 28:
    case 29:
    case 30:
    case 31:
      if (2 * sizeof(int32_t) * 8 * num_buckets > kTableSmemBudget) {
        return cudaErrorInvalidValue;
      }
      switch (design) {
        case 6: return launch_table<8, 1, false>(k, v, q, o, m, h,
                                                 num_buckets, s);
        case 18: return launch_table<8, 2, false>(k, v, q, o, m, h,
                                                  num_buckets, s);
        case 19: return launch_table<8, 4, false>(k, v, q, o, m, h,
                                                  num_buckets, s);
        case 28: return launch_table<8, 4, true>(k, v, q, o, m, h,
                                                 num_buckets, s);
        case 29: return launch_table<8, 8, false>(k, v, q, o, m, h,
                                                  num_buckets, s);
        case 30: return launch_table<8, 2, true>(k, v, q, o, m, h,
                                                 num_buckets, s);
        default: return launch_table<8, 8, true>(k, v, q, o, m, h,
                                                 num_buckets, s);
      }
    default: return cudaErrorInvalidValue;
  }
}
