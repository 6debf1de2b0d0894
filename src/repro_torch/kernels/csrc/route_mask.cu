// Per-row shard keep of pruned routing: the route_shards decision in f32.
//
// Replaces: src/repro/kernels/routing.py::route_mask (Pallas _kernel over
// _route_rows).
//
// For query row b with rank l[b], shard s is kept when it is alive, l > 0
// and lb[s] <= T*(1+slack) + err, where
//   lb, ub  squared bounds from the centroid ball, the pivot-ball union and
//           the projection-sketch gaps (lower bound only);
//   T       min over candidates c of ub_c whose cumulative live count
//           sum_j live_j [ub_j <= ub_c] reaches l, over the k shard uppers
//           and over the m*k pivot-ball uppers weighted by their credits;
//   err     16*(dim+1)*eps*(|q| + R)^2.
//
// Parity with the plain version (kernels/routing.py route_mask_plain), bit
// for bit: every sum over coordinates runs in order d = 0..dim-1; every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn,
// so nvcc contracts nothing into an FMA); square roots are IEEE
// (__fsqrt_rn); min and max are exact; the live-count sums add integers
// below 2^24, exact in any order.  No --use_fast_math.
//
// What bounds it on an H100: nothing but launch latency.  At B = 32,
// dim = 64, k = 8 it reads about 15 KB and does about 10^5 flops; the byte
// bound is a few nanoseconds.  Design: one block per query row; the row
// and every summary operand are staged in shared memory (about 5 KB at one
// pivot, 13 KB at four); one thread per sequential sum (k centroid
// distances, m*k pivot distances, r projection dots, |q|^2), then one
// thread per shard for the bounds and per candidate for the threshold
// counts; each thread takes the min over the candidates itself.  Ragged B
// needs no mask: the grid has exactly B blocks.
#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per block

struct RouteArgs {
  const float* q;       // (B, dim)
  const int* ls;        // (B,)
  const float* centsT;  // (dim, k)
  const float* radii;   // (1, k)
  const float* live;    // (1, k)
  const float* loT;     // (r, k)
  const float* hiT;     // (r, k)
  const float* pivT;    // (m*dim, k)
  const float* pivrT;   // (m, k)
  const float* occT;    // (m, k)
  const float* pliveT;  // (m, k)
  const float* rmax;    // (1, 1)
  const float* dirsT;   // (dim, r)
  int* out;             // (B, k)
  int dim, k, m, r;
  float slack1, errc;
};

// shared-memory layout, in floats
struct Layout {
  int qs, cents, piv, dirs, lo, hi, radii, live, pivr, occ, plive,
      sums, lb, ub, tub, cand, total;
  __host__ __device__ Layout(int dim, int k, int m, int r) {
    int o = 0;
    qs = o;    o += dim;
    cents = o; o += dim * k;
    piv = o;   o += m * dim * k;
    dirs = o;  o += dim * r;
    lo = o;    o += r * k;
    hi = o;    o += r * k;
    radii = o; o += k;
    live = o;  o += k;
    pivr = o;  o += m * k;
    occ = o;   o += m * k;
    plive = o; o += m * k;
    sums = o;  o += k + m * k + r + 1;   // dc, dp, qp, |q|^2
    lb = o;    o += k;
    ub = o;    o += k;
    tub = o;   o += m * k;
    cand = o;  o += k + m * k;
    total = o;
  }
};

__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// sum_d (a[d] - mat[d*stride + col])^2, in order
__device__ __forceinline__ float sq_dist(const float* a, const float* mat,
                                         int stride, int col, int dim) {
  float acc = 0.f;
  for (int d = 0; d < dim; ++d) {
    const float diff = __fsub_rn(a[d], mat[d * stride + col]);
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

__global__ void __launch_bounds__(NT) route_mask_kernel(RouteArgs a) {
  extern __shared__ float sm[];
  const int dim = a.dim, k = a.k, m = a.m, r = a.r;
  const Layout L(dim, k, m, r);
  const int b = blockIdx.x;
  const float inf = CUDART_INF_F;

  stage(sm + L.qs, a.q + (long long)b * dim, dim);
  stage(sm + L.cents, a.centsT, dim * k);
  stage(sm + L.piv, a.pivT, m * dim * k);
  stage(sm + L.dirs, a.dirsT, dim * r);
  stage(sm + L.lo, a.loT, r * k);
  stage(sm + L.hi, a.hiT, r * k);
  stage(sm + L.radii, a.radii, k);
  stage(sm + L.live, a.live, k);
  stage(sm + L.pivr, a.pivrT, m * k);
  stage(sm + L.occ, a.occT, m * k);
  stage(sm + L.plive, a.pliveT, m * k);
  __syncthreads();

  const float* qs = sm + L.qs;
  float* sums = sm + L.sums;
  float* dc = sums;             // (k) centroid distances
  float* dp = sums + k;         // (m*k) pivot distances, slot-major
  float* qp = dp + m * k;       // (r) projections of q
  float* q2 = qp + r;           // |q|^2

  // one thread per sequential sum over the coordinates
  const int tasks = k + m * k + r + 1;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    if (t < k) {
      dc[t] = __fsqrt_rn(sq_dist(qs, sm + L.cents, k, t, dim));
    } else if (t < k + m * k) {
      const int u = t - k, p = u / k, s = u % k;
      dp[u] = __fsqrt_rn(sq_dist(qs, sm + L.piv + p * dim * k, k, s, dim));
    } else if (t < k + m * k + r) {
      const int rr = t - k - m * k;
      float acc = 0.f;
      for (int d = 0; d < dim; ++d)
        acc = __fadd_rn(acc, __fmul_rn(qs[d], sm[L.dirs + d * r + rr]));
      qp[rr] = acc;
    } else {
      float acc = 0.f;
      for (int d = 0; d < dim; ++d)
        acc = __fadd_rn(acc, __fmul_rn(qs[d], qs[d]));
      *q2 = acc;
    }
  }
  __syncthreads();

  // bounds: one thread per shard, and the pivot balls' credited uppers
  const float* radii = sm + L.radii;
  const float* live = sm + L.live;
  const float* pivr = sm + L.pivr;
  const float* occ = sm + L.occ;
  const float* plive = sm + L.plive;
  float* lb = sm + L.lb;
  float* ub = sm + L.ub;
  float* tub = sm + L.tub;
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    float lbd = fmaxf(__fsub_rn(dc[s], radii[s]), 0.f);
    float ubd = __fadd_rn(dc[s], radii[s]);
    float plb = inf, pub = -inf;
    bool has = false;
    for (int p = 0; p < m; ++p) {
      const int u = p * k + s;
      if (occ[u] > 0.f) {
        plb = fminf(plb, fmaxf(__fsub_rn(dp[u], pivr[u]), 0.f));
        pub = fmaxf(pub, __fadd_rn(dp[u], pivr[u]));
        has = true;
      }
    }
    if (has) {
      lbd = fmaxf(lbd, plb);
      ubd = fminf(ubd, pub);
    }
    for (int rr = 0; rr < r; ++rr) {
      const float gap = fmaxf(fmaxf(__fsub_rn(sm[L.lo + rr * k + s], qp[rr]),
                                    __fsub_rn(qp[rr], sm[L.hi + rr * k + s])),
                              0.f);
      lbd = fmaxf(lbd, gap);
    }
    const bool alive = live[s] > 0.f;
    lb[s] = alive ? __fmul_rn(lbd, lbd) : inf;
    ub[s] = alive ? __fmul_rn(ubd, ubd) : inf;
  }
  for (int u = threadIdx.x; u < m * k; u += blockDim.x) {
    const bool credit = occ[u] > 0.f && plive[u] > 0.f;
    const float bub = __fadd_rn(dp[u], pivr[u]);
    tub[u] = credit ? __fmul_rn(bub, bub) : inf;
  }
  __syncthreads();

  // sort-free thresholds: candidate c counts the live at or below it
  const int l = a.ls[b];
  const float lf = (float)l;
  float* cand = sm + L.cand;
  for (int c = threadIdx.x; c < k + m * k; c += blockDim.x) {
    float cnt = 0.f, u;
    if (c < k) {
      u = ub[c];
      for (int j = 0; j < k; ++j)
        if (ub[j] <= u) cnt = __fadd_rn(cnt, live[j]);
    } else {
      u = tub[c - k];
      for (int j = 0; j < m * k; ++j)
        if (tub[j] <= u) cnt = __fadd_rn(cnt, plive[j]);
    }
    cand[c] = cnt >= lf ? u : inf;
  }
  __syncthreads();

  float T = inf;
  for (int c = 0; c < k + m * k; ++c) T = fminf(T, cand[c]);
  const float sq = __fadd_rn(__fsqrt_rn(*q2), a.rmax[0]);
  const float t_eff =
      __fadd_rn(__fmul_rn(T, a.slack1), __fmul_rn(a.errc, __fmul_rn(sq, sq)));
  for (int s = threadIdx.x; s < k; s += blockDim.x)
    a.out[(long long)b * k + s] =
        (live[s] > 0.f && lb[s] <= t_eff && l > 0) ? 1 : 0;
}

}  // namespace

// q (B, dim) f32, ls (B,) int32, the 11 packed summary operands (f32,
// kernels/routing.py pack_summaries), out (B, k) int32.
extern "C" int knn_route_mask(const float* q, const int* ls,
                              const float* centsT, const float* radii,
                              const float* live, const float* loT,
                              const float* hiT, const float* pivT,
                              const float* pivrT, const float* occT,
                              const float* pliveT, const float* rmax,
                              const float* dirsT, int* out, int B, int dim,
                              int k, int m, int r, float slack1, float errc,
                              void* stream) {
  const RouteArgs args{q, ls, centsT, radii, live, loT, hiT,
                       pivT, pivrT, occT, pliveT, rmax, dirsT, out,
                       dim, k, m, r, slack1, errc};
  const size_t smem = sizeof(float) * (size_t)Layout(dim, k, m, r).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        route_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  route_mask_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}
