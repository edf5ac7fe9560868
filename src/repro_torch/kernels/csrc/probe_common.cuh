// What the probe kernels share: the empty-slot key, the in-kernel hash
// (core/hash_table.py:hash_bucket on the card) and the lane compare.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kFib = 2654435769u;  // 2^32 / golden ratio

// The key's int32 bits as uint32, then either the low bits (identity) or
// the top `bits` bits of the wrapping product with kFib (Fibonacci), masked
// to the bucket count.
struct Hash {
  uint32_t mask;   // num_buckets - 1
  int32_t shift;   // 32 - max(1, bit_length(num_buckets - 1))
  int32_t fib;     // 0: identity, 1: Fibonacci
};

__device__ __forceinline__ uint32_t bucket_of(int32_t k, const Hash h) {
  uint32_t u = static_cast<uint32_t>(k);
  if (h.fib) u = (u * kFib) >> h.shift;
  return u & h.mask;
}

inline Hash make_hash(int64_t num_buckets, int32_t fib) {
  int bits = 1;
  while ((int64_t{1} << bits) < num_buckets) ++bits;
  return Hash{static_cast<uint32_t>(num_buckets - 1), 32 - bits, fib};
}

// The matching lanes of one int4 group as 4 bits.
__device__ __forceinline__ uint32_t match4(const int4 v, int32_t k) {
  return static_cast<uint32_t>(v.x == k) |
         static_cast<uint32_t>(v.y == k) << 1 |
         static_cast<uint32_t>(v.z == k) << 2 |
         static_cast<uint32_t>(v.w == k) << 3;
}

}  // namespace
