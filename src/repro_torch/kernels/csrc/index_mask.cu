// Per-row bucket keep of the approx search tier, gated by the routing rows.
//
// Replaces: src/repro/kernels/routing.py::index_mask (Pallas _index_kernel
// over _index_rows).
//
// For query row b with rank l[b] and routing keep rows[b, :], bucket
// column c (shard c / bsz, bucket c % bsz) is gated in when its shard is
// kept and it holds live points; its squared bounds are
// lb = max(|q - center| - radius, 0)^2 and ub = (|q - center| + radius)^2
// (+inf when gated out).  T is the smallest ub_c whose cumulative live
// count sum_j live_j [ub_j <= ub_c] reaches max(l, ceil(oversample * l)),
// and the bucket is kept when gated in, lb <= T and l > 0.  The shard gate
// is a direct lookup of rows[b, c / bsz]; the reference expanded it with a
// 0/1 matrix product only for the TPU's vector layout.
//
// Parity with the plain version (kernels/routing.py index_mask_plain), bit
// for bit: the distance is summed over the coordinates in order with every
// product and sum rounded on its own (no FMA), the square root is IEEE, and
// the live-count sums add integers below 2^24.
//
// What bounds it on an H100: launch latency.  At B = 32, dim = 64 and
// k*b = 64 it reads about 17 KB; the byte bound is a few nanoseconds.
// Design: one block per query row, one thread per bucket column; the row,
// the bucket uppers, lowers and live counts sit in shared memory, and each
// thread counts over the k*b columns for its candidate, then takes the min
// over the candidates itself.  Ragged B: the grid has exactly B blocks.
#include "common.cuh"

namespace {

__global__ void index_mask_kernel(const float* __restrict__ q,
                                  const int* __restrict__ ls,
                                  const int* __restrict__ rows,
                                  const float* __restrict__ bcentsT,
                                  const float* __restrict__ bradii,
                                  const float* __restrict__ blive,
                                  int* __restrict__ out, int dim, int k,
                                  int kb, float oversample) {
  extern __shared__ float sm[];
  float* qs = sm;            // (dim)
  float* live = qs + dim;    // (kb)
  float* lb = live + kb;     // (kb)
  float* ub = lb + kb;       // (kb)
  float* cand = ub + kb;     // (kb)
  const int b = blockIdx.x;
  const int bsz = kb / k;
  const float inf = CUDART_INF_F;

  for (int d = threadIdx.x; d < dim; d += blockDim.x)
    qs[d] = q[(long long)b * dim + d];
  for (int c = threadIdx.x; c < kb; c += blockDim.x) live[c] = blive[c];
  __syncthreads();

  for (int c = threadIdx.x; c < kb; c += blockDim.x) {
    float acc = 0.f;
    for (int d = 0; d < dim; ++d) {
      const float diff = __fsub_rn(qs[d], bcentsT[(long long)d * kb + c]);
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    }
    const float dist = __fsqrt_rn(acc);
    const bool g = rows[(long long)b * k + c / bsz] != 0 && live[c] > 0.f;
    const float lbd = fmaxf(__fsub_rn(dist, bradii[c]), 0.f);
    const float ubd = __fadd_rn(dist, bradii[c]);
    lb[c] = g ? __fmul_rn(lbd, lbd) : inf;
    ub[c] = g ? __fmul_rn(ubd, ubd) : inf;
  }
  __syncthreads();

  const int l = ls[b];
  const float lf = (float)l;
  const float target = fmaxf(lf, ceilf(__fmul_rn(oversample, lf)));
  for (int c = threadIdx.x; c < kb; c += blockDim.x) {
    float cnt = 0.f;
    const float u = ub[c];
    for (int j = 0; j < kb; ++j)
      if (ub[j] <= u) cnt = __fadd_rn(cnt, live[j]);
    cand[c] = cnt >= target ? u : inf;
  }
  __syncthreads();

  float T = inf;
  for (int c = 0; c < kb; ++c) T = fminf(T, cand[c]);
  for (int c = threadIdx.x; c < kb; c += blockDim.x) {
    const bool g = rows[(long long)b * k + c / bsz] != 0 && live[c] > 0.f;
    out[(long long)b * kb + c] = (g && lb[c] <= T && l > 0) ? 1 : 0;
  }
}

}  // namespace

// q (B, dim) f32, ls (B,) int32, rows (B, k) int32, the 3 packed index
// operands (f32, kernels/routing.py pack_index), out (B, kb) int32.
extern "C" int knn_index_mask(const float* q, const int* ls, const int* rows,
                              const float* bcentsT, const float* bradii,
                              const float* blive, int* out, int B, int dim,
                              int k, int kb, float oversample, void* stream) {
  int threads = ((kb + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = sizeof(float) * (size_t)(dim + 4 * kb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        index_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  index_mask_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, ls, rows, bcentsT, bradii, blive, out, dim, k, kb, oversample);
  return (int)cudaGetLastError();
}
