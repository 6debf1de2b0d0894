// The l smallest (value, id) pairs of each row, ascending.
//
// Replaces: src/repro/kernels/local_topk.py::local_topk (Pallas _kernel,
// with the _merge_tile merge of src/repro/kernels/distance_topk.py).
//
// On the TPU the point axis was a sequential grid dimension carrying a
// running (bb, l) buffer in VMEM.  Here a row is split into chunks, one
// block per (row, chunk); each block keeps its running top-l in shared
// memory and writes it as a partial, and the wrapper merges the partials
// with a second launch of the same kernel over the (row, chunks * l)
// partials with their ids carried.  The same kernel with ids carried is
// the second pass of distance_topk.
//
// What bounds it on an H100: it reads each value once (4 bytes) and does
// O(1) work per value after warm-up, so it is bound by bytes.  Design:
// 256 threads read 1024 consecutive values per round (coalesced); a value
// becomes a candidate only if its key is below the running l-th key, and
// candidates are appended to a 2048-slot shared buffer through a shared
// atomic counter.  When the buffer could overflow, the running region and
// the candidates are bitonic-sorted together (lexicographic (value, id):
// ties to the smaller id, as the reference) and the l-th key becomes the
// new filter.  On random data the candidate rate falls as l / n, so the
// sorts are few and the skip of the TPU kernel's guarded merge becomes a
// per-value compare.
#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int ITEMS = 4;           // values per thread per round
constexpr int ROUND = NT * ITEMS;  // values per round
constexpr int S = 2048;            // shared (value, id) slots

__device__ void merge(float* bv, int* bi, int* cnt, float* thr_v, int* thr_i,
                      int L2, int l) {
  const int tid = threadIdx.x;
  const int n = *cnt + L2;
  int n_sort = L2;
  while (n_sort < n) n_sort <<= 1;
  knn::bitonic_sort(bv, bi, n_sort, tid, NT, knn::BlockSync());
  // slots past the running region held the larger keys: back to sentinels
  for (int t = L2 + tid; t < n_sort; t += NT) {
    bv[t] = CUDART_INF_F;
    bi[t] = knn::kIntMax;
  }
  __syncthreads();
  if (tid == 0) {
    *cnt = 0;
    *thr_v = bv[l - 1];
    *thr_i = bi[l - 1];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT)
local_topk_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                  float* __restrict__ out_v, int* __restrict__ out_i, int m,
                  int l, int L2, int chunk, int nchunks) {
  __shared__ float bv[S];
  __shared__ int bi[S];
  __shared__ int cnt;
  __shared__ float thr_v;
  __shared__ int thr_i;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x / nchunks;
  const int c = blockIdx.x % nchunks;
  const long long c0 = (long long)c * chunk;
  const long long c1 = min(c0 + chunk, (long long)m);

  for (int t = tid; t < S; t += NT) {
    bv[t] = CUDART_INF_F;
    bi[t] = knn::kIntMax;
  }
  if (tid == 0) {
    cnt = 0;
    thr_v = CUDART_INF_F;
    thr_i = knn::kIntMax;
  }
  __syncthreads();

  const T* xr = x + row * m;
  const int* ir = ids ? ids + row * m : nullptr;
  for (long long base = c0; base < c1; base += ROUND) {
    if (cnt > S - L2 - ROUND) merge(bv, bi, &cnt, &thr_v, &thr_i, L2, l);
    const float tv = thr_v;
    const int ti = thr_i;
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const long long col = base + t * NT + tid;
      if (col < c1) {
        const float v = knn::to_f32(xr[col]);
        const int id = ir ? ir[col] : (int)col;
        if (knn::key_lt(v, id, tv, ti)) {
          const int pos = atomicAdd(&cnt, 1);
          bv[L2 + pos] = v;
          bi[L2 + pos] = id;
        }
      }
    }
    __syncthreads();
  }
  merge(bv, bi, &cnt, &thr_v, &thr_i, L2, l);

  const long long o = (row * nchunks + c) * l;
  for (int t = tid; t < l; t += NT) {
    out_v[o + t] = bv[t];
    out_i[o + t] = bi[t];
  }
}

}  // namespace

// x: (rows, m) f32 or bf16; ids: (rows, m) int32 or null (ids = column);
// out: (rows, ceil(m / chunk), l) partials, ascending within each chunk.
// Slots a chunk cannot fill are (+inf, INT32_MAX).
extern "C" int knn_local_topk(const void* x, const int* ids, float* out_v,
                              int* out_i, int rows, int m, int l, int chunk,
                              int dtype, void* stream) {
  const int nchunks = (m + chunk - 1) / chunk;
  const int L2 = knn::run_width(l);
  dim3 grid((unsigned)((long long)rows * nchunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == knn::kBF16) {
    local_topk_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ids, out_v, out_i, m, l, L2,
        chunk, nchunks);
  } else {
    local_topk_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), ids, out_v, out_i, m, l, L2, chunk,
        nchunks);
  }
  return (int)cudaGetLastError();
}
