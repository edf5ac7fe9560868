// Bucket probe kernels for Hopper (sm_90a): probe_rows, probe_filter_rows,
// probe_filter_rows_delta and bucket_probe_stream.
//
// Replaces the Pallas TPU kernels of repro/kernels/bucket_probe.py:
// probe_rows (_probe_rows_kernel), probe_filter_rows
// (_probe_filter_rows_kernel), probe_filter_rows_delta
// (_probe_filter_rows_delta_kernel) and bucket_probe_stream (_stream_kernel).
// The TPU versions of the first three take bucket rows that XLA gathered
// into (m, W) planes in HBM; these take the (B, W) table planes and the
// per-probe bucket ids and gather the row themselves, so no (m, W) plane is
// ever written.
//
// What bounds them: bytes.  Per probe a thread reads its key and bucket id
// (8 bytes, coalesced), one W-lane key row (W=8: one 32-byte sector, two
// int4 loads), and on a hit the value row (and predicate row); it writes one
// word.  The row reads are random, so the kernels live on the memory
// system's sector rate, not its streaming rate.  The design does the least
// it can about that in a first version: one thread per probe, vector loads
// of whole sectors, and value/predicate sectors loaded only for the int4
// group that holds a match (a miss costs the key sector alone).
//
// probe_filter_rows_delta adds the delta overlay of a live ingest buffer:
// after the main probe the thread reads its raw key and delta bucket id
// (coalesced) and that delta key row (DW=8: one sector; the buffer is small
// next to the table and meant to stay in L2), and only on a delta hit the
// folded word sector.  A delta hit overrides the main word unconditionally,
// even with NULL_WORD (a tombstone, or a delta row the predicate rejects).
//
// bucket_probe_stream is the other probe design, kept so the two can be
// compared on the card: the TPU kernel DMAs one bucket row per probe, and
// here G = min(W, 32) lanes of a warp share one probe, each lane loading
// one slot (a warp covers 32/G probes, one coalesced sector each at W=8),
// then a ballot and a butterfly of shuffles inside the group combine the
// lanes.  W > 32 loops over 32-lane chunks.
//
// Semantics (bit-identical to the plain versions): found = any lane equals
// the key and the key is not EMPTY_KEY; the word is the int32 sum of the
// matching lanes' values (at most one match per bucket), NULL_WORD (-2) on
// a miss; probe_filter_rows also needs the summed predicate lanes > 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -0x7FFFFFFF;
constexpr int32_t kNull = -2;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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
  const int32_t* dkeys;  // (m,) raw probe keys
  const int32_t* dbids;  // (m,) delta bucket ids
  int32_t dw;
};

template <int W, bool kFilter, bool kDelta>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
             const int32_t* __restrict__ tp, const int32_t* __restrict__ keys,
             const int32_t* __restrict__ bids, int32_t* __restrict__ out,
             int64_t m, const DeltaArgs d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int32_t k = keys[i];
  const int64_t row = static_cast<int64_t>(bids[i]) * W;
  const int4* rk = reinterpret_cast<const int4*>(tk + row);
  const int4* rv = reinterpret_cast<const int4*>(tv + row);
  bool any = false;
  uint32_t word = 0, pred = 0;
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const int4 kk = __ldg(rk + j);
    const bool m0 = kk.x == k, m1 = kk.y == k, m2 = kk.z == k, m3 = kk.w == k;
    if (m0 | m1 | m2 | m3) {
      any = true;
      word += lane_sum(__ldg(rv + j), m0, m1, m2, m3);
      if (kFilter) {
        const int4* rp = reinterpret_cast<const int4*>(tp + row);
        pred += lane_sum(__ldg(rp + j), m0, m1, m2, m3);
      }
    }
  }
  const bool hit = any && k != kEmpty &&
                   (!kFilter || static_cast<int32_t>(pred) > 0);
  int32_t result = hit ? static_cast<int32_t>(word) : kNull;
  if (kDelta) {
    const int32_t dk = d.dkeys[i];
    const int64_t drow = static_cast<int64_t>(d.dbids[i]) * d.dw;
    const int4* drk = reinterpret_cast<const int4*>(d.dtk + drow);
    const int4* drw = reinterpret_cast<const int4*>(d.dtw + drow);
    bool dany = false;
    uint32_t dword = 0;
    for (int j = 0; j < d.dw / 4; ++j) {
      const int4 kk = __ldg(drk + j);
      const bool m0 = kk.x == dk, m1 = kk.y == dk, m2 = kk.z == dk,
                 m3 = kk.w == dk;
      if (m0 | m1 | m2 | m3) {
        dany = true;
        dword += lane_sum(__ldg(drw + j), m0, m1, m2, m3);
      }
    }
    if (dany && dk != kEmpty) result = static_cast<int32_t>(dword);
  }
  out[i] = result;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
              const int32_t* __restrict__ keys,
              const int32_t* __restrict__ bids, int32_t* __restrict__ out,
              int64_t m) {
  constexpr int G = W < 32 ? W : 32;  // lanes per probe
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = t / G;            // this lane's probe
  const int sub = static_cast<int>(t % G);
  const int lane = threadIdx.x & 31;
  const unsigned group =
      G == 32 ? kFull : (((1u << G) - 1u) << (lane - lane % G));
  // no early return: every lane of the warp takes part in the shuffles
  const bool active = i < m;
  int32_t k = kEmpty;
  int64_t row = 0;
  if (active) {
    k = keys[i];
    row = static_cast<int64_t>(bids[i]) * W;
  }
  bool any = false;
  uint32_t word = 0;
#pragma unroll
  for (int c = 0; c < W; c += G) {
    const bool match = active && __ldg(tk + row + c + sub) == k;
    uint32_t v = match ? static_cast<uint32_t>(__ldg(tv + row + c + sub)) : 0u;
    any |= (__ballot_sync(kFull, match) & group) != 0u;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      v += __shfl_xor_sync(kFull, v, off, G);
    }
    word += v;
  }
  if (active && sub == 0) {
    out[i] = any && k != kEmpty ? static_cast<int32_t>(word) : kNull;
  }
}

template <bool kFilter, bool kDelta>
int launch(const void* tk, const void* tv, const void* tp, const void* keys,
           const void* bids, void* out, int64_t m, int32_t w,
           const DeltaArgs& d, void* stream) {
  if (m == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(tk);
  const auto* v = static_cast<const int32_t*>(tv);
  const auto* p = static_cast<const int32_t*>(tp);
  const auto* q = static_cast<const int32_t*>(keys);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* o = static_cast<int32_t*>(out);
  switch (w) {
    case 4: probe_kernel<4, kFilter, kDelta><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m, d); break;
    case 8: probe_kernel<8, kFilter, kDelta><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m, d); break;
    case 16: probe_kernel<16, kFilter, kDelta><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m, d); break;
    case 32: probe_kernel<32, kFilter, kDelta><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m, d); break;
    case 64: probe_kernel<64, kFilter, kDelta><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m, d); break;
    case 128: probe_kernel<128, kFilter, kDelta><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m, d); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int W>
int launch_stream(const int32_t* k, const int32_t* v, const int32_t* q,
                  const int32_t* b, int32_t* o, int64_t m, cudaStream_t s) {
  constexpr int G = W < 32 ? W : 32;
  const int64_t threads = m * G;
  const unsigned grid =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  stream_kernel<W><<<grid, kThreads, 0, s>>>(k, v, q, b, o, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" int probe_rows_launch(const void* tk, const void* tv,
                                 const void* keys, const void* bids, void* out,
                                 int64_t m, int32_t w, void* stream) {
  return launch<false, false>(tk, tv, nullptr, keys, bids, out, m, w,
                              DeltaArgs{}, stream);
}

extern "C" int probe_filter_rows_launch(const void* tk, const void* tv,
                                        const void* tp, const void* keys,
                                        const void* bids, void* out, int64_t m,
                                        int32_t w, void* stream) {
  return launch<true, false>(tk, tv, tp, keys, bids, out, m, w, DeltaArgs{},
                             stream);
}

extern "C" int probe_filter_rows_delta_launch(
    const void* tk, const void* tv, const void* tp, const void* keys,
    const void* bids, const void* dtk, const void* dtw, const void* dkeys,
    const void* dbids, void* out, int64_t m, int32_t w, int32_t dw,
    void* stream) {
  if (dw < 4 || dw > 128 || (dw & (dw - 1)) != 0) return cudaErrorInvalidValue;
  const DeltaArgs d{static_cast<const int32_t*>(dtk),
                    static_cast<const int32_t*>(dtw),
                    static_cast<const int32_t*>(dkeys),
                    static_cast<const int32_t*>(dbids), dw};
  return launch<true, true>(tk, tv, tp, keys, bids, out, m, w, d, stream);
}

extern "C" int bucket_probe_stream_launch(const void* tk, const void* tv,
                                          const void* keys, const void* bids,
                                          void* out, int64_t m, int32_t w,
                                          void* stream) {
  if (m == 0) return cudaSuccess;
  const auto* k = static_cast<const int32_t*>(tk);
  const auto* v = static_cast<const int32_t*>(tv);
  const auto* q = static_cast<const int32_t*>(keys);
  const auto* b = static_cast<const int32_t*>(bids);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 4: return launch_stream<4>(k, v, q, b, o, m, s);
    case 8: return launch_stream<8>(k, v, q, b, o, m, s);
    case 16: return launch_stream<16>(k, v, q, b, o, m, s);
    case 32: return launch_stream<32>(k, v, q, b, o, m, s);
    case 64: return launch_stream<64>(k, v, q, b, o, m, s);
    case 128: return launch_stream<128>(k, v, q, b, o, m, s);
    default: return cudaErrorInvalidValue;
  }
}
