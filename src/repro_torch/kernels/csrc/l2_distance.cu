// Squared-L2 distance matrix for all k shards in one launch.
//
// Replaces: src/repro/kernels/l2_distance.py::l2_distance (Pallas _kernel).
//
// Computes out[s, b, j] = max(|q_b|^2 - 2 q_b.p_sj + |p_sj|^2, 0) for the
// (B, d) queries against the (k, m, d) points, which are contiguous, so
// the point axis is one (k*m, d) matrix and each element is written to its
// shard's (B, m) slab.  Both norms are summed in the same d-loop as the
// product, as the TPU kernel does, so each operand is read once.
//
// What bounds it on an H100: at the service shapes (B <= 32, d = 64) the
// arithmetic intensity is about B/2 FLOP per byte of points plus a
// 4*B*k*m-byte output, far below the f32 SIMT ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte for the product alone) once the output is
// counted: it is bound by the bytes it must move, mostly the output.
// Design: 32 x 128 output tiles, 256 threads with a 4 x 4 register tile
// each, d staged through shared memory in steps of 32 with coalesced
// 128-byte row loads and padded transposed tiles (no bank conflicts);
// ragged B, k*m and d edges are masked in the kernel, so no padded copies
// are made.  f32 FMAs only: TF32 is excluded by the port's numerics.
#include "common.cuh"

namespace {

constexpr int TB = 32;    // queries per tile
constexpr int TN = 128;   // points per tile
constexpr int BK = 32;    // feature dims per shared-memory step
constexpr int NT = 256;   // threads per block

template <typename T>
__global__ void __launch_bounds__(NT)
l2_distance_kernel(const T* __restrict__ q, const T* __restrict__ p,
                   float* __restrict__ out, int B, int k, int m, int d) {
  __shared__ float qs[BK][TB + 1];
  __shared__ float ps[BK][TN + 1];
  const long long N = (long long)k * m;
  const int tid = threadIdx.x;
  const int tx = tid % 32;   // point columns tx + 32 * j
  const int ty = tid / 32;   // query rows ty * 4 + i
  const long long n0 = (long long)blockIdx.x * TN;
  const int b0 = blockIdx.y * TB;

  float acc[4][4], qn[4], pn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qn[i] = 0.f;
    pn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < TB * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int b = b0 + r, kk = k0 + c;
      qs[c][r] = (b < B && kk < d) ? knn::to_f32(q[(long long)b * d + kk])
                                   : 0.f;
    }
    for (int e = tid; e < TN * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const long long n = n0 + r;
      const int kk = k0 + c;
      ps[c][r] = (n < N && kk < d) ? knn::to_f32(p[n * d + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[c][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ps[c][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qn[i] = fmaf(a[i], a[i], qn[i]);
        pn[i] = fmaf(w[i], w[i], pn[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx + 32 * j;
      if (n >= N) continue;
      const long long s = n / m, jj = n % m;
      out[(s * B + b) * m + jj] = fmaxf(qn[i] - 2.f * acc[i][j] + pn[j], 0.f);
    }
  }
}

}  // namespace

// q: (B, d), p: (k, m, d), both f32 or both bf16; out: (k, B, m) f32.
extern "C" int knn_l2_distance(const void* q, const void* p, float* out,
                               int B, int k, int m, int d, int dtype,
                               void* stream) {
  const long long N = (long long)k * m;
  dim3 grid((unsigned)((N + TN - 1) / TN), (unsigned)((B + TB - 1) / TB));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == knn::kBF16) {
    l2_distance_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(p), out, B, k, m, d);
  } else {
    l2_distance_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(p), out, B,
        k, m, d);
  }
  return (int)cudaGetLastError();
}
