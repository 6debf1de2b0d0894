// The whole-bucket path of distance_topk, for buckets of more than 32
// query rows: one block scores a tile of RT query rows (64 or 128) against
// tiles of 128 points with 8 x 8 register tiles and keeps each row's
// running top-l, without writing the (B, m) distance matrix.
//
// What bounds it on an H100: at deep1b's step (B = 128, k = 8, m =
// 15,625,000, d = 96, l = 100, f32) it does 2 * 128 * 96 FLOP for the
// 96 * 4 bytes of each point, 64 FLOP per byte, three times the f32 SIMT
// ridge (67 TFLOP/s over 3.35 TB/s): it is bound by the f32 FMAs (3.07
// TFLOP, 45.85 ms).  The 32-row kernel (distance_topk.cu) ran it at ~24%
// of that peak: 4 x 4 register tiles (8 FMAs a 16-byte shared load), two
// 4-warp blocks an SM (each row's 256 slots of running top-l, 64 KB for 32
// rows, beside the loop), and every point copied into shared memory by
// four blocks, one a query tile.
//
// What this design does about it (~96 ms at that step on an H100, ~48%
// of the peak; the loop alone ~64%):
// - One block an SM (RT = 128: 8 warps, up to 255 registers a thread; RT
//   = 64: two 4-warp blocks) walks its chunk of points in all k shards, so
//   each point passes through shared memory once a launch.  Each thread
//   holds 8 rows x 8 points (rows r0 + {0..3} and the same + RT / 2,
//   points p0 + {0..3} and the same + 64), so every 16-byte shared load
//   feeds 16 or more FMAs, with l2_distance_wide.cuh's role, quads and
//   conflict-free chunk swizzle, two quads a step.
// - The bucket's queries stay resident in shared memory, in slabs of
//   128-byte rows (32 f32 or 64 bf16 dims; 48 KB at RT = 128, d = 96).
//   Point tiles stream through a ring of slabs of 128 points x 128 bytes
//   (cp.async, one commit group and one barrier a group): two whole tiles
//   where they fit beside enough candidate keys (ng = 2 groups, one
//   barrier a tile: 96 KB at d = 96), else three slabs (ng = 3, one
//   barrier a slab).  |q|^2 is summed once; each slab's |p|^2 partial
//   by one thread a point (the lower half of the block on even slabs, the
//   upper on odd ones), the partials added in order in the epilogue.
// - Each row's running top-l is not in shared memory.  Its sorted run of
//   up to l keys lives in the block's own slot of the (k B, chunks, l)
//   output, which the block writes anyway and which stays in L2 between
//   merges; shared memory holds a threshold key, counts and an area of C
//   candidate keys a row (C <= 128 from what the block's budget leaves: 77
//   at RT = 128, d = 96, f32).  A distance becomes a candidate only if its
//   (value, id) key is below the row's threshold, the lower of the row's
//   own l-th key and the per-(shard, row) key in device memory that every
//   block lowers with atomicMin, as in distance_topk.cu.  The epilogue
//   first tests a tile's 64 distances a thread against the thresholds'
//   values without a branch; only the pairs at or below them take the
//   exact key test and claim slots, one atomicAdd a row and thread.
// - A row is merged only when its area is full: a candidate that finds no
//   slot stays pending in its thread's registers (a bit a (row, point) of
//   its tile), the block votes, every row whose area is at least half full
//   is merged in that round (so the warps share the work), and the pending
//   ones are tested again against the lowered thresholds.  A merge is one
//   warp on one row, in registers: the candidates sorted (a bitonic network
//   over 32 lanes, shuffles across lanes), folded into the run read from
//   the output (the elementwise min of the run and the reversed
//   candidates is bitonic and holds the l smallest), one bitonic merge,
//   and the run written back.  Row r is always merged by warp r % NW, and
//   each lane reads back only the keys it wrote.  Every shared-memory
//   address is taken from the kernel's dynamic shared array where it is
//   used, and the merges are inlined: held in a struct or called, they
//   turned the loop's loads generic or sent its registers to the stack.
// - At the end of a shard the block merges every row's remaining
//   candidates, so each partial is the chunk's l smallest keys, ascending,
//   (+inf, 2^31-1) past the chunk's points: with one chunk, the answer.
// - Dead tiles: where a valid mask is given, the block votes on the flags
//   of the next NT / 8 tiles before a tile's first slab is copied; a tile
//   with no valid point is neither copied nor scored.
//
// Every distance is bit-equal to distance_tile.cuh's: each (row, point)
// product is one fmaf chain from +0 over the dims in ascending order (the
// zero padding past d adds exact zeros), |q|^2 is one chain, |p|^2 the sum
// in ascending order of each 128-byte slab's chain from 0, and dist_of
// clamps.  Keys order as (value, id), ties to the smaller id, so the l
// smallest of a (shard, row) are those of the 32-row kernel.  f32 FMAs on
// the SIMT pipes only: no TF32, no tensor cores.
#pragma once

#include "distance_tile.cuh"
#include "l2_distance_wide.cuh"

namespace knn {
namespace topw {

using tile::Dims;
using tile::ROW_BYTES;
using wide::Quad;
using wide::Role;

constexpr unsigned FULL = 0xffffffffu;

constexpr int PT = 128;          // points per tile
constexpr int SLAB = PT * ROW_BYTES;
constexpr int MAX_CAND = 128;    // candidate keys a row, at most

template <int RT>
struct Shape {
  static constexpr int NT = 2 * RT;            // threads a block
  static constexpr int NW = NT / 32;           // warps a block
  // one 8-warp block an SM at RT = 128, two 4-warp blocks at RT = 64
  static constexpr int MIN_BLOCKS = RT == 128 ? 1 : 2;
};

// Slabs in the ring: ng groups of G slabs, one barrier a group.  ng = 2:
// a group is a whole point tile (G = nk), so a tile costs one barrier;
// ng = 3: a group is one slab, for widths whose two tiles do not fit.
__host__ __device__ inline int ring_slabs(int ng, int nk) {
  return ng == 2 ? 2 * nk : 3;
}

// Dynamic shared memory of the kernel.  Every address below is taken from
// this symbol where it is used, so each access compiles to a shared-memory
// instruction (LDS, STS, ATOMS), never a generic one.
extern __shared__ __align__(128) char smem[];

// The block's shared memory: resident queries [nk][RT][128 B], the ring
// [ring_slabs][PT][128 B], the candidate keys [RT][C], thresholds [RT],
// the |p|^2 partials [2][nk][PT], |q|^2 [RT], counts and runs [RT], the
// group tiles [ng] and the vote's ballots.
template <int RT>
struct Smem {
  int nk;       // 128-byte slabs a row
  int ng;       // groups in the ring
  int C;        // candidate keys a row

  __host__ __device__ static size_t bytes(int nk, int ng, int C) {
    return (size_t)nk * RT * ROW_BYTES + (size_t)ring_slabs(ng, nk) * SLAB +
           sizeof(Key) * ((size_t)RT * C + RT) +
           sizeof(float) * (2 * nk * PT + RT) +
           sizeof(int) * (2 * RT + ng) + sizeof(unsigned) * Shape<RT>::NW;
  }
  __device__ char* q() const { return smem; }
  __device__ char* ring() const { return smem + nk * RT * ROW_BYTES; }
  __device__ Key* cand() const {
    return reinterpret_cast<Key*>(ring() + ring_slabs(ng, nk) * SLAB);
  }
  __device__ Key* thr() const { return cand() + RT * C; }
  __device__ float* pnp() const {
    return reinterpret_cast<float*>(thr() + RT);
  }
  __device__ float* qn() const { return pnp() + 2 * nk * PT; }
  __device__ int* cnt() const { return reinterpret_cast<int*>(qn() + RT); }
  __device__ int* run() const { return cnt() + RT; }
  __device__ int* group_tile() const { return run() + RT; }
  __device__ unsigned* vote() const {
    return reinterpret_cast<unsigned*>(group_tile() + ng);
  }
};

__device__ __forceinline__ Key kmax(Key a, Key b) { return a < b ? b : a; }

// One stage (k, j) of a bitonic network over the N = 32 E keys of a warp,
// key t in lane t / E, register t % E: pairs (t, t ^ j) ascending where
// (t & k) == 0, descending elsewhere.  Stages across lanes (j >= E) take
// k and j at run time; those inside a lane are instantiated for each j, so
// the networks are loops (a few hundred instructions each, not thousands:
// the kernel's build time).
template <int E, int J>
__device__ __forceinline__ void stage_in_lane(Key (&x)[E], int lane,
                                              int k) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e & J) continue;
    const bool up = ((lane * E + e) & k) == 0;
    const Key lo = kmin(x[e], x[e | J]), hi = kmax(x[e], x[e | J]);
    x[e] = up ? lo : hi;
    x[e | J] = up ? hi : lo;
  }
}

template <int E>
__device__ __forceinline__ void bitonic_stage(Key (&x)[E], int lane, int k,
                                              int j) {
  if (j >= E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = lane * E + e;
      const Key o = __shfl_xor_sync(FULL, x[e], j / E);
      const bool keep_min = ((t & k) == 0) == ((t & j) == 0);
      x[e] = keep_min ? kmin(x[e], o) : kmax(x[e], o);
    }
  } else if (j == 1) {
    stage_in_lane<E, 1>(x, lane, k);
  } else if (E > 2 && j == 2) {
    stage_in_lane<E, (E > 2 ? 2 : 1)>(x, lane, k);
  } else if (E > 4) {
    stage_in_lane<E, (E > 4 ? 4 : 1)>(x, lane, k);
  }
}

template <int E>
__device__ __forceinline__ void bitonic_sort(Key (&x)[E], int lane) {
#pragma unroll 1
  for (int k = 2; k <= 32 * E; k <<= 1)
#pragma unroll 1
    for (int j = k >> 1; j > 0; j >>= 1) bitonic_stage<E>(x, lane, k, j);
}

// A bitonic sequence of 32 E keys, ascending.
template <int E>
__device__ __forceinline__ void bitonic_merge(Key (&x)[E], int lane) {
#pragma unroll 1
  for (int j = 16 * E; j > 0; j >>= 1) bitonic_stage<E>(x, lane, 32 * E, j);
}

// acc[i][j] += q[row i] . p[point j] over one slab: the resident query slab
// qs and the point slab ps, both of 128-byte rows, U quads a step.
template <typename T, int RT>
__device__ __forceinline__ void score_slab(const char* qs, const char* ps,
                                           const Role& ro,
                                           float (&acc)[8][8]) {
  constexpr int W = Quad<T>::W, N = Quad<T>::N, U = 2;
  const char* qb = qs + ro.r0 * ROW_BYTES;
  const char* pb = ps + ro.p0 * ROW_BYTES;
#pragma unroll 1
  for (int x0 = 0; x0 < N; x0 += U)
#pragma unroll
  for (int x = x0; x < x0 + U; ++x) {
    const char* pq = pb + Quad<T>::off(x, ro.psw16);
    const char* qq = qb + Quad<T>::off(x, ro.qsw16);
    float w[8][W];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Quad<T>::load(pq + ((j & 3) + 64 * (j >> 2)) * ROW_BYTES, w[j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float a[W];
      Quad<T>::load(qq + ((i & 3) + RT / 2 * (i >> 2)) * ROW_BYTES, a);
#pragma unroll
      for (int e = 0; e < W; ++e)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(a[e], w[j][e], acc[i][j]);
    }
  }
}

// Where a block's rows keep their runs, and the shared keys they lower.
struct Rows {
  Key* gthr;       // (k, B) threshold keys
  float* out_v;    // (k B, nchunks, l): run of (shard s, row b0 + r)
  int* out_i;
  int B, b0, l, nchunks;

  __device__ long long slot(int s, int r) const {
    return (((long long)s * B + b0 + r) * nchunks + blockIdx.x) * l;
  }
};

// One warp folds row r's candidates into its run in the output (shard s),
// keeps the l smallest and lowers the row's threshold and shard s's shared
// one.  full: also write (+inf, 2^31-1) up to l slots.
template <int E, int RT>
__device__ __forceinline__ void merge_row(const Rows& rw, const Smem<RT>& sm,
                                          int r, int s, bool full,
                                          int lane) {
  const int C = sm.C, l = rw.l;
  const int c = min(sm.cnt()[r], C), nr = sm.run()[r];
  const long long o = rw.slot(s, r);
  Key a[E], b[E];
  const Key* cand = sm.cand() + r * C;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = lane * E + e;
    a[e] = t < nr ? key_of(__ldcg(rw.out_v + o + t),
                           __ldcg(rw.out_i + o + t))
                  : INF_KEY;
    b[e] = t < c ? cand[t] : INF_KEY;
  }
  bitonic_sort<E>(b, lane);
#pragma unroll
  for (int e = 0; e < E; ++e)
    a[e] = kmin(a[e], __shfl_sync(FULL, b[E - 1 - e], 31 - lane));
  bitonic_merge<E>(a, lane);
  const int n = min(l, nr + c), upto = full ? l : n;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = lane * E + e;
    if (t < upto) {
      rw.out_v[o + t] = __uint_as_float(static_cast<unsigned>(a[e] >> 32));
      rw.out_i[o + t] = static_cast<int>(static_cast<unsigned>(a[e]));
    }
  }
  Key kl = 0;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e == (l - 1) % E) kl = __shfl_sync(FULL, a[e], (l - 1) / E);
  if (lane == 0) {
    sm.run()[r] = n;
    sm.cnt()[r] = 0;
    if (n == l) {
      sm.thr()[r] = kmin(sm.thr()[r], kl);
      atomicMin(rw.gthr + (long long)s * rw.B + rw.b0 + r, kl);
    }
  }
  __syncwarp();
}

// Every row of the block with at least `least` candidates (shard s),
// merged by warp r % NW; full: every row's partial written whole, l slots.
// Inlined: as a call, the registers live across it (the tile's 64 sums)
// went to the stack and the kernel took 1.8x as long at deep1b's step.
template <int RT>
__device__ __forceinline__ void merge_rows(Rows rw, Smem<RT> sm, int s,
                                        int least, bool full) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < RT; r += Shape<RT>::NW) {
    if (rw.b0 + r >= rw.B) continue;
    const int c = sm.cnt()[r];
    if (c > 0 && c >= least) {
      if (rw.l <= 32 * 4)
        merge_row<4, RT>(rw, sm, r, s, full, lane);
      else
        merge_row<8, RT>(rw, sm, r, s, full, lane);
    } else if (full && lane == 0) {
      // no candidate left: the run is the row's partial; pad it
      const long long o = rw.slot(s, r);
      for (int t = sm.run()[r]; t < rw.l; ++t) {
        rw.out_v[o + t] = CUDART_INF_F;
        rw.out_i[o + t] = kIntMax;
      }
    }
  }
}

// The tiles a block walks: its chunk [c0, c1) of every shard, shard
// (chunk + i) % k at step i, in tiles of PT points; tile g is step g / tpc.
template <int RT>
struct Walk {
  const unsigned char* valid;
  Rows rw;
  int k, m, c0, c1, tpc;
  Role ro;
  Smem<RT> sm;
  int cur;                       // step whose rows are held

  __device__ int shard(int i) const { return ((int)blockIdx.x + i) % k; }
  __device__ int first() const { return tpc > 0 ? 0 : -1; }
  __device__ int step(int g, int i) const {
    return g + i < k * tpc ? g + i : -1;
  }
  __device__ int next(int g) const { return step(g, 1); }
  __device__ long long start(int g) const {
    return (long long)shard(g / tpc) * m + c0 + (g % tpc) * PT;
  }
  __device__ long long end(int g) const {
    return (long long)shard(g / tpc) * m + c1;
  }
  __device__ void dead(int) const {}
  __device__ int row(int i) const {
    return ro.r0 + (i & 3) + RT / 2 * (i >> 2);
  }
  __device__ int point(int j) const { return ro.p0 + (j & 3) + 64 * (j >> 2); }

  // Empty rows for step i; ends with a barrier.
  __device__ void reset(int i) {
    const int t = threadIdx.x;
    if (t < RT) {
      sm.cnt()[t] = 0;
      sm.run()[t] = 0;
      sm.thr()[t] =
          rw.b0 + t < rw.B
              ? __ldcg(rw.gthr + (long long)shard(i) * rw.B + rw.b0 + t)
              : 0ULL;
    }
    __syncthreads();
  }

  // Write the partials of the steps before i and take step i's rows.
  __device__ void advance_to(int i) {
    while (cur < i) {
      __syncthreads();
      merge_rows<RT>(rw, sm, shard(cur), 1, true);
      __syncthreads();
      if (++cur < k) reset(cur);
    }
  }

  // The pairs of the tile whose distance is at or below its row's
  // threshold value: bit 8 i + j for (row i, point j), valid points only,
  // tested without a branch.
  __device__ unsigned long long maybe(const float (&acc)[8][8],
                                      const float (&pn)[8],
                                      unsigned okm) const {
    unsigned long long bits = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row(i);
      const float thv =
          __uint_as_float(static_cast<unsigned>(sm.thr()[r] >> 32));
      const float q2 = sm.qn()[r];
      // dist_of's clamp left out: thv >= +0, so max(v, +0) <= thv exactly
      // where !(v > thv) (a NaN v, which dist_of makes +0, passes too)
      unsigned rb = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rb |= static_cast<unsigned>(
                  !(q2 - 2.f * acc[i][j] + pn[j] > thv)) << j;
      if (rw.b0 + r < rw.B)
        bits |= static_cast<unsigned long long>(rb & okm) << (8 * i);
    }
    return bits;
  }

  // Test the pairs of `bits` against their rows' threshold keys and claim
  // a slot for each candidate, one atomicAdd a row; returns those that
  // found none.
  __device__ unsigned long long insert(const float (&acc)[8][8],
                                       const float (&pn)[8], int n0,
                                       unsigned long long bits) {
    unsigned long long pend = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned rb = static_cast<unsigned>(bits >> (8 * i)) & 0xffu;
      if (rb == 0) continue;
      const int r = row(i);
      const Key th = sm.thr()[r];
      const float q2 = sm.qn()[r];
      Key key[8];
      unsigned cand = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        key[j] = key_of(tile::dist_of(q2, acc[i][j], pn[j]), n0 + point(j));
        if ((rb >> j) & 1 && key[j] < th) cand |= 1u << j;
      }
      if (cand == 0) continue;
      int pos = atomicAdd(&sm.cnt()[r], __popc(cand));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!((cand >> j) & 1)) continue;
        if (pos < sm.C)
          sm.cand()[r * sm.C + pos] = key[j];
        else
          pend |= 1ULL << (8 * i + j);
        ++pos;
      }
    }
    return pend;
  }

  // Tile g's distances into the rows' candidates.  pnp: the tile's |p|^2
  // partials [nk][PT].  All threads; ends with a barrier.
  __device__ void epilogue(int g, const float (&acc)[8][8],
                           const float* pnp) {
    const int i = g / tpc, t = g % tpc;
    advance_to(i);
    const int s = shard(i);
    const int tid = threadIdx.x;
    // now and then, take the other blocks' thresholds: loaded here, stored
    // after this thread's tests
    const bool refresh = (t & 7) == 0 && tid < RT && rw.b0 + tid < rw.B;
    const Key gk =
        refresh ? __ldcg(rw.gthr + (long long)s * rw.B + rw.b0 + tid) : 0;
    const int n0 = c0 + t * PT;               // local point index
    const long long base = (long long)s * m;
    unsigned okm = 0;
    float pn[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + point(j);
      okm |= static_cast<unsigned>(
                 n < c1 && (valid == nullptr || valid[base + n] != 0)) << j;
      pn[j] = 0.f;
    }
    // |p|^2: the slabs' partials added in ascending order, loaded four
    // slabs at a time so the loads do not wait on each other
    for (int k0 = 0; k0 < sm.nk; k0 += 4) {
      float x[4][8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          x[kk][j] = k0 + kk < sm.nk ? pnp[(k0 + kk) * PT + point(j)] : 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k0 + kk < sm.nk) pn[j] += x[kk][j];
    }
    const unsigned long long bits = maybe(acc, pn, okm);
    unsigned long long pend = bits ? insert(acc, pn, n0, bits) : 0;
    if (refresh) sm.thr()[tid] = kmin(sm.thr()[tid], gk);
    // a full area: merge it and every row at least half full, then test
    // the pending pairs again
    while (__syncthreads_or(pend != 0)) {
      merge_rows<RT>(rw, sm, s, (sm.C + 1) / 2, false);
      __syncthreads();
      pend = insert(acc, pn, n0, pend);
    }
  }
};

template <typename T, int RT>
__global__ void __launch_bounds__(Shape<RT>::NT, Shape<RT>::MIN_BLOCKS)
distance_topk_wide_kernel(const T* __restrict__ q, const T* __restrict__ p,
                          const unsigned char* __restrict__ valid,
                          Key* __restrict__ gthr, float* __restrict__ out_v,
                          int* __restrict__ out_i, int B, int k, int m,
                          int d, int l, int ng, int C, int chunk,
                          int nchunks) {
  using S = Shape<RT>;
  constexpr int BK = Dims<T>::BK;
  const int nk = tile::slabs(d, BK);
  const int G = ng == 2 ? nk : 1;             // slabs a group
  const int tid = threadIdx.x;
  Walk<RT> w;
  w.valid = valid;
  w.rw = Rows{gthr, out_v, out_i, B, (int)blockIdx.y * RT, l, nchunks};
  w.k = k;
  w.m = m;
  w.c0 = blockIdx.x * chunk;
  w.c1 = min(w.c0 + chunk, m);
  w.tpc = (w.c1 - w.c0 + PT - 1) / PT;
  w.ro = wide::role_of(tid);
  w.sm = Smem<RT>{nk, ng, C};
  w.cur = 0;
  const Smem<RT> sm = w.sm;
  const int b0 = w.rw.b0;

  // the bucket's queries, resident; |q|^2 one chain a row
  const bool aq = tile::rows_aligned(q, d), ap = tile::rows_aligned(p, d);
  for (int kk = 0; kk < nk; ++kk)
    wide::copy_rows<T, RT, S::NT, ROW_BYTES>(sm.q() + kk * RT * ROW_BYTES, q,
                                             b0, B, kk * BK, d, aq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid < RT) {
    const int nq = wide::norm_index(tid);
    float v = 0.f;
    for (int kk = 0; kk < nk; ++kk)
      v = wide::norm_part<T>(sm.q() + (kk * RT + nq) * ROW_BYTES, nq, v);
    sm.qn()[nq] = v;
  }
  w.reset(0);

  // one group of G slabs into ring group `slot`, one commit group; a
  // tile's point range is found once, at its first slab
  int ptile = w.first(), pk = 0, issued = 0;
  long long pstart = 0, pend_row = 0;
  auto produce = [&](int slot) {
    bool any = false;
#pragma unroll 1
    for (int gs = 0; gs < G; ++gs) {
      if (pk == 0 && valid != nullptr && ptile >= 0)
        ptile = tile::skip_dead<S::NT, 8>(sm.vote(), valid, w, ptile);
      if (ptile < 0) break;
      if (pk == 0) {
        pstart = w.start(ptile);
        pend_row = w.end(ptile);
      }
      wide::copy_rows<T, PT, S::NT, ROW_BYTES>(
          sm.ring() + (slot * G + gs) * SLAB, p, pstart, pend_row, pk * BK,
          d, ap);
      if (gs == 0 && tid == 0) sm.group_tile()[slot] = ptile;
      any = true;
      if (++pk == nk) {
        pk = 0;
        ptile = w.next(ptile);
      }
    }
    issued += any;
    cp_async_commit();
  };

  for (int s = 0; s < ng - 1; ++s) produce(s);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // the |p|^2 partial of slab kk: one thread a point, the lower half of
  // the threads on even slabs and the upper half on odd ones
  const bool norms_even = S::NT == PT || tid < PT;
  const bool norms_odd = S::NT == PT || tid >= PT;
  const int np = wide::norm_index(tid & (PT - 1));
  int ck = 0, buf = 0, pend = -1;
  for (int u = 0; u < issued; ++u) {
    // the group u in: ng - 2 groups may stay in flight
    if (ng == 2)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();
    const int slot = u % ng;
    const int g = sm.group_tile()[slot];
    if (pend >= 0) {
      w.epilogue(pend, acc, sm.pnp() + (buf ^ 1) * nk * PT);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      pend = -1;
    }
    produce((u + ng - 1) % ng);
#pragma unroll 1
    for (int gs = 0; gs < G; ++gs) {
      const char* slab = sm.ring() + (slot * G + gs) * SLAB;
      score_slab<T, RT>(sm.q() + ck * RT * ROW_BYTES, slab, w.ro, acc);
      if (ck & 1 ? norms_odd : norms_even)
        sm.pnp()[(buf * nk + ck) * PT + np] =
            wide::norm_part<T>(slab + np * ROW_BYTES, np, 0.f);
      if (++ck == nk) {
        ck = 0;
        pend = g;
        buf ^= 1;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pend >= 0) w.epilogue(pend, acc, sm.pnp() + (buf ^ 1) * nk * PT);
  w.advance_to(k);
}

template <typename T, int RT>
int launch(const T* q, const T* p, const unsigned char* valid, Key* gthr,
           float* out_v, int* out_i, int B, int k, int m, int d, int l,
           int ng, int C, int chunk, cudaStream_t stream) {
  if (C < 1 || C > MAX_CAND || l < 1 || l > 256 || chunk % PT != 0 ||
      (ng != 2 && ng != 3))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = Smem<RT>::bytes(tile::slabs(d, Dims<T>::BK), ng, C);
  cudaError_t err = cudaFuncSetAttribute(
      distance_topk_wide_kernel<T, RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (m + chunk - 1) / chunk;
  dim3 grid((unsigned)nchunks, (unsigned)((B + RT - 1) / RT));
  distance_topk_wide_kernel<T, RT><<<grid, Shape<RT>::NT, bytes, stream>>>(
      q, p, valid, gthr, out_v, out_i, B, k, m, d, l, ng, C, chunk, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace topw
}  // namespace knn
