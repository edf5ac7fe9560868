// Designs of bucket_probe_stream at bucket width 8, timed side by side on
// the card by tools/kernel_designs.py.  The design the port ships is in
// src/repro_torch/kernels/csrc/bucket_probe.cu (included here, so that the
// ring and the table kernels run as they ship, at other depths too); these
// are the others it was measured against:
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
//           before it compares the current one.
#include "../src/repro_torch/kernels/csrc/bucket_probe.cu"

namespace {

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

}  // namespace

// design: 0 lanes, 1 direct, 2 defer (3 stages), 3-5 ring of 2-4 stages,
// 6 table (both planes in shared memory; fails where they do not fit), 7-8
// ring of 2-3 stages with the copies cached in L1, 9-10 ring of 2 stages
// cached in L1 at 4 or 6 blocks of 256 threads per SM (8 fit), 11 the
// ring with keys in registers, 12 the register double buffer.
// W = 8 only; bids are read by lanes only.
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
    case 6:
      if (2 * sizeof(int32_t) * 8 * num_buckets > kTableSmemBudget) {
        return cudaErrorInvalidValue;
      }
      return launch_table<8>(k, v, q, o, m, h, num_buckets, s);
    default: return cudaErrorInvalidValue;
  }
}
