// Bucket probe kernels for Hopper (sm_90a): probe_rows and probe_filter_rows.
//
// Replaces the Pallas TPU kernels repro/kernels/bucket_probe.py:probe_rows
// (_probe_rows_kernel) and probe_filter_rows (_probe_filter_rows_kernel).
// The TPU versions take bucket rows that XLA gathered into (m, W) planes in
// HBM; these take the (B, W) table planes and the per-probe bucket ids and
// gather the row themselves, so no (m, W) plane is ever written.
//
// What bounds them: bytes.  Per probe a thread reads its key and bucket id
// (8 bytes, coalesced), one W-lane key row (W=8: one 32-byte sector, two
// int4 loads), and on a hit the value row (and predicate row); it writes one
// word.  The row reads are random, so the kernel lives on the memory
// system's sector rate, not its streaming rate.  The design does the least
// it can about that in a first version: one thread per probe, vector loads
// of whole sectors, and value/predicate sectors loaded only for the int4
// group that holds a match (a miss costs the key sector alone).
//
// Semantics (bit-identical to the plain version): found = any lane equals
// the key and the key is not EMPTY_KEY; the word is the int32 sum of the
// matching lanes' values (at most one match per bucket), NULL_WORD (-2) on
// a miss; probe_filter_rows also needs the summed predicate lanes > 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -0x7FFFFFFF;
constexpr int32_t kNull = -2;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t lane_sum(const int4 v, bool m0, bool m1,
                                             bool m2, bool m3) {
  return (m0 ? static_cast<uint32_t>(v.x) : 0u) +
         (m1 ? static_cast<uint32_t>(v.y) : 0u) +
         (m2 ? static_cast<uint32_t>(v.z) : 0u) +
         (m3 ? static_cast<uint32_t>(v.w) : 0u);
}

template <int W, bool kFilter>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
             const int32_t* __restrict__ tp, const int32_t* __restrict__ keys,
             const int32_t* __restrict__ bids, int32_t* __restrict__ out,
             int64_t m) {
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
  out[i] = hit ? static_cast<int32_t>(word) : kNull;
}

template <bool kFilter>
int launch(const void* tk, const void* tv, const void* tp, const void* keys,
           const void* bids, void* out, int64_t m, int32_t w, void* stream) {
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
    case 4: probe_kernel<4, kFilter><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m); break;
    case 8: probe_kernel<8, kFilter><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m); break;
    case 16: probe_kernel<16, kFilter><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m); break;
    case 32: probe_kernel<32, kFilter><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m); break;
    case 64: probe_kernel<64, kFilter><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m); break;
    case 128: probe_kernel<128, kFilter><<<grid, kThreads, 0, s>>>(k, v, p, q, b, o, m); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int probe_rows_launch(const void* tk, const void* tv,
                                 const void* keys, const void* bids, void* out,
                                 int64_t m, int32_t w, void* stream) {
  return launch<false>(tk, tv, nullptr, keys, bids, out, m, w, stream);
}

extern "C" int probe_filter_rows_launch(const void* tk, const void* tv,
                                        const void* tp, const void* keys,
                                        const void* bids, void* out, int64_t m,
                                        int32_t w, void* stream) {
  return launch<true>(tk, tv, tp, keys, bids, out, m, w, stream);
}
