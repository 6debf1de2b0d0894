// Fused squared-L2 distance and per-row running top-l, without writing
// the (B, m) distance matrix.
//
// Replaces: src/repro/kernels/distance_topk.py::distance_topk (Pallas
// _kernel and _merge_tile).
//
// On the TPU one core walked the point axis as a sequential grid
// dimension and carried the running (bb, l) top buffer in VMEM.  On
// Hopper blocks run in parallel and in no order, so the walk becomes a
// loop inside a block over a chunk of one shard's points, and the carry
// across chunks becomes a second pass: one block per (query tile, point
// chunk, shard) writes its chunk's top-l as a partial (k, B, chunks, l),
// and the wrapper merges the partials with the local_topk kernel, ids
// carried.
//
// What bounds it on an H100: it reads the points once (4*k*m*d bytes)
// and does 2*B*k*m*d FLOPs; at B = 32, d = 64 that is 16 FLOP per byte,
// under the f32 SIMT ridge of about 20, so it is bound by bytes (the
// distance tiles never leave the chip).  Design: a 32-query x 64-point
// distance tile per step, d staged through shared memory (padded
// transposed tiles, coalesced 128-byte row loads, 256 threads each with a
// 2 x 4 register tile).  Each query row keeps a sorted running region of
// L2 = pow2 >= max(l, 32) slots and a candidate area in shared memory; a
// distance becomes a candidate only if its (value, id) key is below the
// row's l-th key, so after warm-up almost every value is dropped by one
// compare (the TPU kernel's guarded skip, per value instead of per
// tile).  When a row's candidates could overflow, one warp bitonic-sorts
// that row (lexicographic: ties to the smaller id) and refreshes its l-th
// key.  Points past m and, when given, points with valid == 0 never
// become candidates, which is the reference's +inf / id 2^31-1 rule: they
// can never win a slot, and unfilled slots report (+inf, 2^31-1).
#include "common.cuh"

namespace {

constexpr int TB = 32;    // queries per block
constexpr int TN = 64;    // points per tile
constexpr int BK = 32;    // feature dims per shared-memory step
constexpr int NT = 256;   // threads per block (8 warps)
constexpr int NW = NT / 32;

struct Smem {
  float* qs;      // [BK][TB + 1]
  float* ps;      // [BK][TN + 1]
  float* bv;      // [TB][S]
  int* bi;        // [TB][S]
  int* cnt;       // [TB]
  float* thr_v;   // [TB]
  int* thr_i;     // [TB]
};

inline size_t smem_bytes(int S) {
  return sizeof(float) * (BK * (TB + 1) + BK * (TN + 1)) +
         (sizeof(float) + sizeof(int)) * (size_t)TB * S +
         (2 * sizeof(int) + sizeof(float)) * TB;
}

__device__ inline Smem carve(char* base, int S) {
  Smem sm;
  sm.qs = reinterpret_cast<float*>(base);
  sm.ps = sm.qs + BK * (TB + 1);
  sm.bv = sm.ps + BK * (TN + 1);
  sm.bi = reinterpret_cast<int*>(sm.bv + (size_t)TB * S);
  sm.cnt = sm.bi + (size_t)TB * S;
  sm.thr_v = reinterpret_cast<float*>(sm.cnt + TB);
  sm.thr_i = reinterpret_cast<int*>(sm.thr_v + TB);
  return sm;
}

// One warp sorts row r's running region plus its candidates.
__device__ void merge_row(const Smem& sm, int r, int S, int L2, int l,
                          int lane) {
  float* v = sm.bv + (size_t)r * S;
  int* ix = sm.bi + (size_t)r * S;
  const int n = sm.cnt[r] + L2;
  int n_sort = L2;
  while (n_sort < n) n_sort <<= 1;
  knn::bitonic_sort(v, ix, n_sort, lane, 32, knn::WarpSync());
  for (int t = L2 + lane; t < n_sort; t += 32) {
    v[t] = CUDART_INF_F;
    ix[t] = knn::kIntMax;
  }
  __syncwarp();
  if (lane == 0) {
    sm.cnt[r] = 0;
    sm.thr_v[r] = v[l - 1];
    sm.thr_i[r] = ix[l - 1];
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(NT)
distance_topk_kernel(const T* __restrict__ q, const T* __restrict__ p,
                     const float* __restrict__ valid,
                     float* __restrict__ out_v, int* __restrict__ out_i,
                     int B, int m, int d, int l, int L2, int S, int chunk,
                     int nchunks) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem sm = carve(smem_raw, S);
  float(*qs)[TB + 1] = reinterpret_cast<float(*)[TB + 1]>(sm.qs);
  float(*ps)[TN + 1] = reinterpret_cast<float(*)[TN + 1]>(sm.ps);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16;   // point columns tx + 16 * j
  const int ty = tid / 16;   // query rows 2 * ty + i
  const int b0 = blockIdx.x * TB;
  const int c = blockIdx.y;
  const long long s = blockIdx.z;
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, m);
  const T* ps_base = p + s * (long long)m * d;
  const float* vs = valid ? valid + s * (long long)m : nullptr;

  for (int t = tid; t < TB * S; t += NT) {
    sm.bv[t] = CUDART_INF_F;
    sm.bi[t] = knn::kIntMax;
  }
  for (int r = tid; r < TB; r += NT) {
    sm.cnt[r] = 0;
    sm.thr_v[r] = CUDART_INF_F;
    sm.thr_i[r] = knn::kIntMax;
  }
  __syncthreads();

  for (int n0 = c0; n0 < c1; n0 += TN) {
    float acc[2][4], qn[2], pn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pn[j] = 0.f;
      acc[0][j] = 0.f;
      acc[1][j] = 0.f;
    }
    qn[0] = qn[1] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < TB * BK; e += NT) {
        const int r = e / BK, cc = e % BK;
        const int b = b0 + r, kk = k0 + cc;
        qs[cc][r] = (b < B && kk < d)
                        ? knn::to_f32(q[(long long)b * d + kk]) : 0.f;
      }
      for (int e = tid; e < TN * BK; e += NT) {
        const int r = e / BK, cc = e % BK;
        const int n = n0 + r, kk = k0 + cc;
        ps[cc][r] = (n < c1 && kk < d)
                        ? knn::to_f32(ps_base[(long long)n * d + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < BK; ++cc) {
        const float a0 = qs[cc][2 * ty], a1 = qs[cc][2 * ty + 1];
        qn[0] = fmaf(a0, a0, qn[0]);
        qn[1] = fmaf(a1, a1, qn[1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w = ps[cc][tx + 16 * j];
          pn[j] = fmaf(w, w, pn[j]);
          acc[0][j] = fmaf(a0, w, acc[0][j]);
          acc[1][j] = fmaf(a1, w, acc[1][j]);
        }
      }
      __syncthreads();
    }

    // candidates: keys below the row's running l-th key
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * ty + i;
      if (b0 + r >= B) continue;
      const float tv = sm.thr_v[r];
      const int ti = sm.thr_i[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= c1) continue;
        if (vs && !(vs[n] > 0.f)) continue;
        const float dist = fmaxf(qn[i] - 2.f * acc[i][j] + pn[j], 0.f);
        if (knn::key_lt(dist, n, tv, ti)) {
          const int pos = atomicAdd(&sm.cnt[r], 1);
          sm.bv[(size_t)r * S + L2 + pos] = dist;
          sm.bi[(size_t)r * S + L2 + pos] = n;
        }
      }
    }
    __syncthreads();
    // rows whose next tile could overflow their candidate area
    for (int r = warp; r < TB; r += NW) {
      if (sm.cnt[r] > S - L2 - TN) merge_row(sm, r, S, L2, l, lane);
    }
    __syncthreads();
  }

  for (int r = warp; r < TB; r += NW) {
    const int b = b0 + r;
    if (b >= B) continue;
    merge_row(sm, r, S, L2, l, lane);
    const long long o = ((s * B + b) * nchunks + c) * (long long)l;
    for (int t = lane; t < l; t += 32) {
      out_v[o + t] = sm.bv[(size_t)r * S + t];
      out_i[o + t] = sm.bi[(size_t)r * S + t];
    }
  }
}

template <typename T>
int launch(const T* q, const T* p, const float* valid, float* out_v,
           int* out_i, int B, int k, int m, int d, int l, int chunk,
           cudaStream_t stream) {
  const int L2 = knn::run_width(l);
  const int S = knn::next_pow2(L2 + 2 * TN);
  const int nchunks = (m + chunk - 1) / chunk;
  const size_t bytes = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      distance_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((B + TB - 1) / TB), (unsigned)nchunks, (unsigned)k);
  distance_topk_kernel<T><<<grid, NT, bytes, stream>>>(
      q, p, valid, out_v, out_i, B, m, d, l, L2, S, chunk, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, d), p: (k, m, d), both f32 or both bf16; valid: (k, m) f32 or
// null; out: (k, B, ceil(m / chunk), l) partials, local point indices in
// [0, m), ascending within each chunk.  chunk must be a multiple of 64.
extern "C" int knn_distance_topk(const void* q, const void* p,
                                 const float* valid, float* out_v,
                                 int* out_i, int B, int k, int m, int d,
                                 int l, int chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == knn::kBF16) {
    return launch(static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(p), valid, out_v, out_i,
                  B, k, m, d, l, chunk, s);
  }
  return launch(static_cast<const float*>(q), static_cast<const float*>(p),
                valid, out_v, out_i, B, k, m, d, l, chunk, s);
}
