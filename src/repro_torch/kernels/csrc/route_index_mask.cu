// Per-row shard keep of pruned routing, per-row bucket keep of the approx
// tier, and both batch unions, in one launch.
//
// Replaces: src/repro/kernels/routing.py::route_mask (Pallas _kernel over
// _route_rows) and ::index_mask (Pallas _index_kernel over _index_rows).
//
// Shard keep, query row b with rank l[b]: shard s is kept when it is alive,
// l > 0 and lb[s] <= T*(1+slack) + err, where
//   lb, ub  squared bounds from the centroid ball, the pivot-ball union and
//           the projection-sketch gaps (lower bound only);
//   T       min over candidates c of ub_c whose cumulative live count
//           sum_j live_j [ub_j <= ub_c] reaches l, over the k shard uppers
//           and over the m*k pivot-ball uppers weighted by their credits;
//   err     16*(dim+1)*eps*(|q| + R)^2.
// Bucket keep: column c (shard c / bsz, bucket c % bsz) is gated in when its
// shard is kept and it holds live points; lb = max(|q - center| - radius,
// 0)^2 and ub = (|q - center| + radius)^2 (+inf when gated out); T is the
// least ub_c whose live count reaches max(l, ceil(oversample * l)); the
// bucket is kept when gated in, lb <= T and l > 0.  The shard gate is a
// direct lookup; the reference expanded it with a 0/1 matrix product only
// for the TPU's vector layout.
//
// Modes: route (the shard rows), route + index (both; the buckets gated by
// the row's keep just computed, held in shared memory), index (bucket rows
// gated by rows the caller gives).  Every mode ORs the rows it has into the
// batch unions, one byte each: shards at [0, k), buckets at [k, k + kb).
//
// Parity with the plain versions (kernels/routing.py route_mask_plain and
// index_mask_plain), bit for bit: every sum over the coordinates runs in
// order d = 0..dim-1; every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts nothing into an
// FMA); square roots are IEEE (__fsqrt_rn); min and max are exact, so the
// shuffle min that gives T may take any order; the live-count sums add
// integers below 2^24, exact in any order.  No --use_fast_math.
//
// What bounds it on an H100: launch latency.  At B = 32, dim = 64, k = 8,
// one pivot, r = 8 and k*b = 64 it moves about 41 KB and does under a
// million flops: bytes over 3.35 TB/s or flops over 67 TFLOP/s are
// nanoseconds, while one launch costs microseconds, so neither bound says
// anything here.  What a launch costs beyond that is its longest chain of
// dependent steps.  The kernels it replaces ran one block per row and
// restaged every summary operand (~15 KB) in each, with loads that waited
// one by one, and took each min on one thread.  Design:
//  - one launch of one thread block cluster of CLUSTER blocks (Hopper),
//    each of up to MAX_WARPS warps, the rows dealt to the warps in turn;
//  - a block stages the operands, packed by the host into one buffer at
//    server construction, into shared memory once, 8 16-byte loads a
//    thread in flight;
//  - a row is one warp's: the lanes take the k + m*k + r + 1 (+ k*b)
//    in-order coordinate sums, up to TPL of them a lane side by side (a
//    template instance for each count, so no branch splits the unrolled
//    chains), which hide each other's latency, in one loop for distances
//    and dots alike (no divergence between the kinds); then the bounds one
//    lane a shard, the threshold counts up to CPL candidates a lane side by
//    side, T as a shuffle min; then the bucket columns, gated by the row's
//    keep without a trip to device memory;
//  - the unions: every block ORs its rows' into its shared memory, then
//    into the cluster's first block's (distributed shared memory), which
//    writes them out; the barrier that orders those ORs after the first
//    block's zeroing is split, its arrival at the start and its wait after
//    the rows, so it costs no wait; no atomics in device memory;
//  - each warp's first query row is loaded while the operands stage.
// PERF.md (PR 16) has the versions measured on the way: the whole batch in
// one block of 32 warps (bound by one SM's issue rate), blocks of 4 rows
// meeting through device-memory atomics and a ticket counter, and this
// design with always four chains a lane or with a branch in the unrolled
// chains.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;     // blocks, the portable cluster size
constexpr int MAX_WARPS = 8;   // warps of a block
constexpr int TPL = 4;         // coordinate sums a lane carries at once
constexpr int CPL = 4;         // threshold candidates a lane counts at once
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { kRoute = 0, kRouteIndex = 1, kIndex = 2 };

// The packed operand buffer, in floats, in the order of kernels/routing.py
// PackedRouting: the route part when the mode routes, the index part when
// it has the index; padded to whole float4s.
struct Ops {
  int cents, radii, live, lo, hi, piv, pivr, occ, plive, rmax, dirs, bcents,
      bradii, blive, total;
  __host__ __device__ Ops(int dim, int k, int m, int r, int kb, bool route) {
    const int rk = route ? 1 : 0;
    int o = 0;
    cents = o;  o += rk * dim * k;
    radii = o;  o += rk * k;
    live = o;   o += rk * k;
    lo = o;     o += rk * r * k;
    hi = o;     o += rk * r * k;
    piv = o;    o += rk * m * dim * k;
    pivr = o;   o += rk * m * k;
    occ = o;    o += rk * m * k;
    plive = o;  o += rk * m * k;
    rmax = o;   o += rk;
    dirs = o;   o += rk * dim * r;
    bcents = o; o += dim * kb;
    bradii = o; o += kb;
    blive = o;  o += kb;
    total = (o + 3) / 4 * 4;
  }
};

// One warp's scratch, in floats.
struct Scratch {
  int q, sums, lb, ub, tub, keep, blb, bub, total;
  __host__ __device__ Scratch(int dim, int k, int m, int r, int kb) {
    int o = 0;
    q = o;    o += dim;
    sums = o; o += k + m * k + r + 1 + kb;   // dc, dp, qp, |q|^2, buckets
    lb = o;   o += k;
    ub = o;   o += k;
    tub = o;  o += m * k;
    keep = o; o += k;
    blb = o;  o += kb;
    bub = o;  o += kb;
    total = o;
  }
};

struct Args {
  const float* q;         // (B, dim)
  const int* ls;          // (B,)
  const float* ops;       // the packed operands (Ops)
  const int* rows_in;     // (B, k), index mode
  int* rows_out;          // (B, k), route modes, or null: not written
  int* idx_out;           // (B, kb), index modes, or null: not written
  unsigned char* unions;  // (k + kb), kb = 0 in route mode
  int B, dim, k, m, r, kb, mode;
  float slack1, errc, over;
};

size_t smem_bytes(const Ops& o, const Scratch& s, int warps, int n_union) {
  return sizeof(float) * ((size_t)o.total + (size_t)warps * s.total + n_union);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// Slots t, t + 32, ..., N of them, of a row's coordinate sums (see row()),
// side by side: the N in-order chains are independent, so each hides the
// others' latency.  A slot past the end computes on q and is not written.
template <int N>
__device__ __forceinline__ void coord_sums(const Args& a, const Ops& O,
                                           const float* ops, const float* qs,
                                           float* sums, int t, int nsr,
                                           int kb) {
  const int dim = a.dim, k = a.k, m = a.m, r = a.r;
  const float* base[N];
  int stride[N];
  bool dist[N];
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int tj = t + j * 32;
    base[j] = qs;
    stride[j] = 0;
    dist[j] = true;
    acc[j] = 0.f;
    if (tj >= nsr + kb) {
    } else if (tj < k) {
      base[j] = ops + O.cents + tj;
      stride[j] = k;
    } else if (tj < k + m * k) {
      const int u = tj - k;
      base[j] = ops + O.piv + (u / k) * dim * k + u % k;
      stride[j] = k;
    } else if (tj < k + m * k + r) {
      base[j] = ops + O.dirs + (tj - k - m * k);
      stride[j] = r;
      dist[j] = false;
    } else if (tj < nsr) {
      stride[j] = 1;
      dist[j] = false;
    } else {
      base[j] = ops + O.bcents + (tj - nsr);
      stride[j] = kb;
    }
  }
  for (int d = 0; d < dim; ++d) {
    const float x = qs[d];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float y = base[j][d * stride[j]];
      const float diff = __fsub_rn(x, y);
      acc[j] = __fadd_rn(acc[j], dist[j] ? __fmul_rn(diff, diff)
                                         : __fmul_rn(x, y));
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (t + j * 32 < nsr + kb)
      sums[t + j * 32] = dist[j] ? __fsqrt_rn(acc[j]) : acc[j];
}

// The least ub[c] over candidates c = c0, c0 + 32, ..., N of them, whose
// live count sum_j live[j] [ub[j] <= ub[c]] over the n columns reaches
// target: N counts side by side over one read of each column.
template <int N>
__device__ __forceinline__ float threshold(const float* ub, const float* live,
                                           int n, int c0, float target,
                                           float T) {
  float u[N], cnt[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = c0 + i * 32;
    u[i] = c < n ? ub[c] : -CUDART_INF_F;
    cnt[i] = 0.f;
  }
  for (int j = 0; j < n; ++j) {
    const float uj = ub[j], lj = live[j];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (uj <= u[i]) cnt[i] = __fadd_rn(cnt[i], lj);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (c0 + i * 32 < n && cnt[i] >= target) T = fminf(T, u[i]);
  return T;
}

// Row b's query into the warp's scratch, and its rank.
__device__ __forceinline__ int load_row(const Args& a, const Scratch& S,
                                        float* w, int b, int lane) {
  for (int d = lane; d < a.dim; d += 32)
    w[S.q + d] = a.q[(long long)b * a.dim + d];
  return a.ls[b];
}

// Row b (query in the scratch, rank l), on one warp: its keep rows and its
// bits of the block's unions.
__device__ void row(const Args& a, const Ops& O, const Scratch& S,
                    const float* ops, float* w, int* uni, int b, int l,
                    int lane, bool route, int kb) {
  const int k = a.k, m = a.m, r = a.r;
  const float inf = CUDART_INF_F;
  float* qs = w + S.q;
  float* sums = w + S.sums;
  int* keep = reinterpret_cast<int*>(w + S.keep);
  const float lf = (float)l;
  __syncwarp();

  // one lane a sequential sum over the coordinates, slot t of sums: k
  // centroid distances, m*k pivot distances (slot-major), r projections,
  // |q|^2, then kb bucket distances; up to TPL slots a lane at once, as
  // many as the slots left need (the same on every lane)
  const int nsr = k + m * k + r + 1;
  for (int t0 = route ? 0 : nsr; t0 < nsr + kb; t0 += 32 * TPL) {
    switch (min(TPL, (nsr + kb - t0 + 31) / 32)) {
      case 1: coord_sums<1>(a, O, ops, qs, sums, t0 + lane, nsr, kb); break;
      case 2: coord_sums<2>(a, O, ops, qs, sums, t0 + lane, nsr, kb); break;
      case 3: coord_sums<3>(a, O, ops, qs, sums, t0 + lane, nsr, kb); break;
      default: coord_sums<TPL>(a, O, ops, qs, sums, t0 + lane, nsr, kb);
    }
  }
  __syncwarp();

  if (route) {
    const float* dc = sums;
    const float* dp = sums + k;
    const float* qp = dp + m * k;
    const float* radii = ops + O.radii;
    const float* live = ops + O.live;
    const float* pivr = ops + O.pivr;
    const float* occ = ops + O.occ;
    const float* plive = ops + O.plive;
    float* lb = w + S.lb;
    float* ub = w + S.ub;
    float* tub = w + S.tub;
    // bounds: one lane a shard, and the pivot balls' credited uppers
    for (int s = lane; s < k; s += 32) {
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
        const float gap =
            fmaxf(fmaxf(__fsub_rn(ops[O.lo + rr * k + s], qp[rr]),
                        __fsub_rn(qp[rr], ops[O.hi + rr * k + s])),
                  0.f);
        lbd = fmaxf(lbd, gap);
      }
      const bool alive = live[s] > 0.f;
      lb[s] = alive ? __fmul_rn(lbd, lbd) : inf;
      ub[s] = alive ? __fmul_rn(ubd, ubd) : inf;
    }
    for (int u = lane; u < m * k; u += 32) {
      const bool credit = occ[u] > 0.f && plive[u] > 0.f;
      const float bub = __fadd_rn(dp[u], pivr[u]);
      tub[u] = credit ? __fmul_rn(bub, bub) : inf;
    }
    __syncwarp();
    // sort-free thresholds: candidate c counts the live at or below it,
    // over the shard uppers, then over the credited pivot-ball uppers
    float T = inf;
    for (int c0 = 0; c0 < k; c0 += 32)
      T = threshold<1>(ub, live, k, c0 + lane, lf, T);
    for (int c0 = 0; c0 < m * k; c0 += 32)
      T = threshold<1>(tub, plive, m * k, c0 + lane, lf, T);
    T = warp_min(T);
    const float sq = __fadd_rn(__fsqrt_rn(sums[nsr - 1]), ops[O.rmax]);
    const float t_eff = __fadd_rn(__fmul_rn(T, a.slack1),
                                  __fmul_rn(a.errc, __fmul_rn(sq, sq)));
    for (int s = lane; s < k; s += 32) {
      const int kp = (live[s] > 0.f && lb[s] <= t_eff && l > 0) ? 1 : 0;
      keep[s] = kp;
      if (a.rows_out) a.rows_out[(long long)b * k + s] = kp;
      if (kp) uni[s] = 1;
    }
  } else {
    for (int s = lane; s < k; s += 32) {
      const int kp = a.rows_in[(long long)b * k + s] != 0 ? 1 : 0;
      keep[s] = kp;
      if (kp) uni[s] = 1;
    }
  }
  __syncwarp();

  if (kb) {
    const int bsz = kb / k;
    const float* bd = sums + nsr;
    const float* bradii = ops + O.bradii;
    const float* blive = ops + O.blive;
    float* blb = w + S.blb;
    float* bub = w + S.bub;
    for (int c = lane; c < kb; c += 32) {
      const bool g = keep[c / bsz] != 0 && blive[c] > 0.f;
      const float lbd = fmaxf(__fsub_rn(bd[c], bradii[c]), 0.f);
      const float ubd = __fadd_rn(bd[c], bradii[c]);
      blb[c] = g ? __fmul_rn(lbd, lbd) : inf;
      bub[c] = g ? __fmul_rn(ubd, ubd) : inf;
    }
    __syncwarp();
    const float target = fmaxf(lf, ceilf(__fmul_rn(a.over, lf)));
    float T = inf;
    for (int c0 = 0; c0 < kb; c0 += 32 * CPL) {   // up to CPL a lane
      switch (min(CPL, (kb - c0 + 31) / 32)) {
        case 1: T = threshold<1>(bub, blive, kb, c0 + lane, target, T); break;
        case 2: T = threshold<2>(bub, blive, kb, c0 + lane, target, T); break;
        case 3: T = threshold<3>(bub, blive, kb, c0 + lane, target, T); break;
        default: T = threshold<CPL>(bub, blive, kb, c0 + lane, target, T);
      }
    }
    T = warp_min(T);
    for (int c = lane; c < kb; c += 32) {
      const bool g = keep[c / bsz] != 0 && blive[c] > 0.f;
      const int kp = (g && blb[c] <= T && l > 0) ? 1 : 0;
      if (a.idx_out) a.idx_out[(long long)b * kb + c] = kp;
      if (kp) uni[k + c] = 1;
    }
  }
  __syncwarp();   // the scratch is the next row's
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(MAX_WARPS * 32) route_index_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const bool route = a.mode != kIndex;
  const int kb = a.mode == kRoute ? 0 : a.kb;
  const int nu = a.k + kb;
  const Ops O(a.dim, a.k, a.m, a.r, kb, route);
  const Scratch S(a.dim, a.k, a.m, a.r, kb);
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* uni = reinterpret_cast<int*>(sm + O.total + nw * S.total);
  float* w = sm + O.total + warp * S.total;

  // zero this block's unions, then arrive at the cluster barrier whose
  // wait, after the rows, lets every block OR into the first block's
  for (int i = threadIdx.x; i < nu; i += blockDim.x) uni[i] = 0;
  cluster_arrive();
  // the warp's first row's query and rank, in flight with the staging
  const int b0 = blockIdx.x * nw + warp;
  const int l0 = b0 < a.B ? load_row(a, S, w, b0, lane) : 0;

  // stage the operands: 8 16-byte loads a thread in flight, then stores
  const float4* __restrict__ src = reinterpret_cast<const float4*>(a.ops);
  const int n4 = O.total / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n4) v[j] = __ldg(src + i);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n4) smem4[i] = v[j];
    }
  }
  __syncthreads();

  // the rows, dealt to the cluster's warps in turn
  for (int b = b0; b < a.B; b += CLUSTER * nw) {
    const int l = b == b0 ? l0 : load_row(a, S, w, b, lane);
    row(a, O, S, sm, w, uni, b, l, lane, route, kb);
  }
  __syncthreads();
  cluster_wait();   // the first block's unions are zeroed
  if (cluster.block_rank() != 0) {
    int* uni0 = cluster.map_shared_rank(uni, 0);
    for (int i = threadIdx.x; i < nu; i += blockDim.x)
      if (uni[i]) uni0[i] = 1;
  }
  cluster.sync();
  if (cluster.block_rank() == 0)
    for (int i = threadIdx.x; i < nu; i += blockDim.x)
      a.unions[i] = uni[i] ? 1 : 0;
}

}  // namespace

// q (B, dim) f32, ls (B,) int32, ops: the packed operands (16-byte aligned,
// kernels/routing.py PackedRouting), rows_in (B, k) int32 (mode 2),
// rows_out (B, k) int32 (modes 0, 1) and idx_out (B, kb) int32 (modes 1,
// 2), either null where the caller needs only the unions; unions (k + kb)
// bytes, kb counted in modes 1 and 2 only.  Mode 0:
// route, 1: route + index, 2: index.  One cluster of CLUSTER blocks of
// min(ceil(B / CLUSTER), MAX_WARPS) warps, fewer where their scratch would
// not fit in shared memory.
extern "C" int knn_route_index_mask(const float* q, const int* ls,
                                    const float* ops, const int* rows_in,
                                    int* rows_out, int* idx_out,
                                    unsigned char* unions, int B, int dim,
                                    int k, int m, int r, int kb, int mode,
                                    float slack1, float errc, float over,
                                    void* stream) {
  if (mode < kRoute || mode > kIndex || B < 1 || k < 1 ||
      (mode != kRoute && (kb < k || kb % k != 0)))
    return (int)cudaErrorInvalidValue;
  const int kbi = mode == kRoute ? 0 : kb;
  const Ops O(dim, k, m, r, kbi, mode != kIndex);
  const Scratch S(dim, k, m, r, kbi);
  int warps = (B + CLUSTER - 1) / CLUSTER;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  while (warps > 1 && smem_bytes(O, S, warps, k + kbi) > SMEM_MAX) --warps;
  const size_t smem = smem_bytes(O, S, warps, k + kbi);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static size_t opted_in = SMEM_DEFAULT;   // the largest size allowed so far
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        route_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const Args args{q, ls, ops, rows_in, rows_out, idx_out, unions,
                  B, dim, k, m, r, kbi, mode, slack1, errc, over};
  route_index_kernel<<<CLUSTER, warps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
