// Shared pieces of the port's Hopper kernels: (value, id) order, the
// distance key, load-time conversion to f32 and the cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace knn {

constexpr int kIntMax = 2147483647;   // id of a +inf sentinel slot

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Lexicographic (value, id) order, the reference's tie order: equal values
// go to the smaller id (lax.top_k on the negated input).
__device__ __forceinline__ bool key_lt(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// A distance (value, id) as one key of the distance kernels: the value's
// bits above the id.  Distances are >= +0, so the key order is key_lt's.
// INF_KEY is (+inf, 2^31 - 1), the key of an empty slot; the wrappers'
// INF_KEY (kernels/distance_topk.py) equals it.  local_topk.cu keys signed
// values, with an order-preserving map of the bits: another format.
using Key = unsigned long long;
constexpr Key INF_KEY = 0x7F8000007FFFFFFFull;

__device__ __forceinline__ Key key_of(float v, int i) {
  return (static_cast<Key>(__float_as_uint(v)) << 32) |
         static_cast<unsigned>(i);
}
__device__ __forceinline__ Key kmin(Key a, Key b) { return a < b ? a : b; }

// 16-byte cp.async copies into shared memory, one commit group each call
// of cp_async_commit: with a source size (bytes < 16 zero-fill the rest),
// or whole.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Width of the sorted running top-l region: a power of two >= max(l, 32).
inline int run_width(int l) { return next_pow2(l < 32 ? 32 : l); }

}  // namespace knn
