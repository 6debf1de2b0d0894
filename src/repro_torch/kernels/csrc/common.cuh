// Shared pieces of the port's Hopper kernels: composite (value, id) keys,
// load-time conversion to f32, and a bitonic sort of (value, id) pairs in
// shared memory for a cooperating group of threads (a block or a warp).
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

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct WarpSync {
  __device__ __forceinline__ void operator()() const { __syncwarp(); }
};

// Sorts the first n (a power of two) pairs of (v, ix) ascending by key.
// Threads tid in [0, nthreads) cooperate; every one of them must call it,
// and the caller synchronises before the call.  Ends with a sync.
template <typename Sync>
__device__ void bitonic_sort(float* v, int* ix, int n, int tid, int nthreads,
                             Sync sync) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < (n >> 1); t += nthreads) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i + j;
        const bool up = (i & k) == 0;
        const float vi = v[i], vp = v[p];
        const int ii = ix[i], ip = ix[p];
        const bool swap = up ? key_lt(vp, ip, vi, ii) : key_lt(vi, ii, vp, ip);
        if (swap) {
          v[i] = vp; v[p] = vi;
          ix[i] = ip; ix[p] = ii;
        }
      }
      sync();
    }
  }
}

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Width of the sorted running top-l region: a power of two >= max(l, 32).
inline int run_width(int l) { return next_pow2(l < 32 ? 32 : l); }

}  // namespace knn
