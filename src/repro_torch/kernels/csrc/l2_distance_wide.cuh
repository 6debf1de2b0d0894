// The whole-bucket main loop of l2_distance, for buckets of more than 32
// query rows: one block scores a tile of RT query rows (64 or 128) by 128
// points, both operands streamed through a ring in shared memory along d.
//
// What it does about the card (H100, sm_90a), at the service's large
// buckets (B = 128, d = 1,024: 64 FLOP per byte of points, compute-bound):
// - Shared memory does not grow with d.  A ring of STAGES = 3 stages, each
//   one d-slab of the RT query rows and of the 128 points (256 bytes of a
//   row at RT = 128: 64 f32 or 128 bf16 dims, 194 KB a block; 128 bytes
//   at RT = 64, 74 KB), filled by cp.async 16-byte copies, one commit
//   group a stage.  Each 128-byte part of a slab row keeps
//   distance_tile.cuh's layout (16-byte chunk c of row r at chunk
//   c ^ ((r >> 2) & 7)).
// - Register tile: each of the 2 RT threads holds 8 rows x 8 points
//   (rows 4 ty + {0..3} and the same + RT / 2, points 4 tx + {0..3} and
//   the same + 64): for every 4 dims it loads the 8 points' 4 values
//   (32 registers), then streams the 8 rows' 4 values, so each 16-byte
//   shared load (8 bytes in bf16) feeds 32 FMAs.  A warp is 4 row groups
//   x 8 point groups: its 8 point loads and 4 row loads of one quad fall
//   in distinct 16-byte chunk columns (no bank conflicts).  The register
//   file bounds the rest (Shape): at RT = 128 one 8-warp block an SM at up
//   to 255 registers, two quads a step; at RT = 64 three 4-warp blocks.
//   At B = 128, d = 1,024 that ran at ~58% of the f32 peak on an H100;
//   without the copies and the norms, ~64%.
// - Points are read from device memory once a launch.  A persistent grid
//   of the resident blocks walks items (point tile, row tile) with the
//   row tile fastest, so the blocks in flight cover a contiguous run of
//   point tiles and a bucket above 128 rows re-reads a point tile from
//   L2; the query block (512 KB at B = 128, d = 1,024) stays in L2.
// - |q|^2 and |p|^2 are summed as their slabs pass, by one thread a row
//   or a point, into the item's buffers in shared memory (double-buffered
//   by item parity), so no register holds them across the slabs; an
//   item's epilogue runs one slab late, right after the next barrier.
// - Dead tiles: where a valid mask is given, the block votes on the next
//   NT / 8 items' point tiles before an item's first slab is copied, and a
//   point tile with no valid point writes +inf without being read.
//
// Every distance is bit-equal to the 32-row loop's (distance_tile.cuh):
// each (row, point) product is one fmaf chain from +0 over the dims in
// ascending order (the zero padding past d adds exact zeros), |q|^2 is one
// chain, |p|^2 the sum in ascending order of each 128-byte chunk's chain
// from 0, and dist_of clamps.  f32 FMAs only: no TF32, no tensor cores.
#pragma once

#include <climits>

#include "distance_tile.cuh"

namespace knn {
namespace wide {

using tile::CHUNKS;
using tile::Dims;
using tile::ROW_BYTES;

constexpr int PT = 128;           // points per tile
constexpr int STAGES = 3;         // stages in the ring

template <int RT>
struct Shape {
  static constexpr int NT = 2 * RT;                  // threads a block
  // 128-byte parts of a slab row: two at RT = 128 (a barrier every 64 f32
  // dims; its one block an SM has the shared memory: 3% faster at d =
  // 1,024, 17% slower at d = 96, where a third of the slab is padding),
  // one at RT = 64
  static constexpr int PARTS = RT == 128 ? 2 : 1;
  static constexpr int ROW = PARTS * ROW_BYTES;      // bytes a slab row
  static constexpr int Q_BYTES = RT * ROW;           // query slab
  static constexpr int STAGE_BYTES = Q_BYTES + PT * ROW;
  static constexpr int WIN = NT / 8;                 // items a vote
  // Blocks an SM, and quads a step of the quad loop.  At RT = 128 one
  // block of 8 warps with up to 255 registers a thread, two quads a step
  // (the next quad's loads issued under the current one's FMAs), was
  // faster than two blocks at 128 registers; at RT = 64, three blocks at
  // up to 168, one quad a step (two spill).
  static constexpr int MIN_BLOCKS = RT == 128 ? 1 : 3;
  static constexpr int UNROLL = RT == 128 ? 2 : 1;
};

// Shared memory of a block: the ring, |p|^2 [2][PT], |q|^2 [2][RT], the
// item of each stage and the vote's ballots.
template <int RT>
inline size_t smem_bytes() {
  using S = Shape<RT>;
  return (size_t)STAGES * S::STAGE_BYTES +
         sizeof(float) * 2 * (PT + RT) + sizeof(int) * (STAGES + S::NT / 32);
}

// The row or point whose norm thread t (< 128) sums: conflict-free under
// the chunk swizzle, as distance_tile.cuh's |p|^2 pass.
__device__ __forceinline__ int norm_index(int t) {
  return 4 * (t & 7) + ((t >> 3) & 3) + 32 * (t >> 5);
}

// W consecutive dims ("a quad") of a slab row, widened to f32: 16 bytes
// in f32, 8 in bf16.  sw16 is the row's swizzle times 16.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  static constexpr int W = 4;   // dims a quad
  static constexpr int N = 8;   // quads a 128-byte row
  __device__ __forceinline__ static int off(int x, int sw16) {
    return (x << 4) ^ sw16;
  }
  __device__ __forceinline__ static void load(const char* a,
                                              float (&o)[W]) {
    const float4 v = *reinterpret_cast<const float4*>(a);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  static constexpr int W = 4;
  static constexpr int N = 16;
  __device__ __forceinline__ static int off(int x, int sw16) {
    return (((x >> 1) << 4) ^ sw16) + ((x & 1) << 3);
  }
  __device__ __forceinline__ static void load(const char* a,
                                              float (&o)[W]) {
    const uint2 v = *reinterpret_cast<const uint2*>(a);
    __nv_bfloat162 b0, b1;
    *reinterpret_cast<unsigned*>(&b0) = v.x;
    *reinterpret_cast<unsigned*>(&b1) = v.y;
    const float2 f0 = __bfloat1622float2(b0), f1 = __bfloat1622float2(b1);
    o[0] = f0.x; o[1] = f0.y; o[2] = f1.x; o[3] = f1.y;
  }
};

// Which outputs a thread owns: rows r0 + (i & 3) + RT / 2 * (i >> 2) and
// points p0 + (j & 3) + 64 * (j >> 2), i, j < 8.
struct Role {
  int r0, p0;        // first row, first point (multiples of 4)
  int qsw16, psw16;  // the swizzle of its rows and of its points, x 16
};

__device__ __forceinline__ Role role_of(int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 +
                                                     (lane & 7);
  return Role{4 * ty, 4 * tx, (ty & 7) << 4, (tx & 7) << 4};
}

// Copy dims [k0, k0 + BK) of rows [r0, r0 + ROWS) of the row-major
// (rows, d) matrix src (zero past r_end or d) into one slab of ROW-byte
// rows, each part of 128 bytes laid out as distance_tile.cuh's slab rows.
// Thread t copies chunk t % CH of rows t / CH + i NT / CH: its addresses
// are one base and constant strides.
template <typename T, int ROWS, int NT, int ROW>
__device__ __forceinline__ void copy_rows(char* slab,
                                          const T* __restrict__ src,
                                          long long r0, long long r_end,
                                          int k0, int d, bool async) {
  constexpr int PER = Dims<T>::PER, CH = ROW / 16, STEP = NT / CH;
  const int c = threadIdx.x % CH, row0 = threadIdx.x / CH;
  const int kk = k0 + c * PER;
  const long long n0 = r0 + row0;
  const T* s0 = src + n0 * d + kk;
  char* d0 = slab + row0 * ROW + c / CHUNKS * ROW_BYTES;
  if (async) {
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) {
      const bool in = n0 + i * STEP < r_end && kk < d;
      cp_async16(
          d0 + i * STEP * ROW + (tile::swz(row0 + i * STEP, c % CHUNKS) << 4),
          in ? s0 + (long long)i * STEP * d : src, in ? 16 : 0);
    }
    return;
  }
  for (int i = 0; i < ROWS / STEP; ++i) {
    const bool in = n0 + i * STEP < r_end;
    const T* sr = s0 + (long long)i * STEP * d;
    unsigned w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      w[h] = 0u;
#pragma unroll
      for (int x = h * PER / 4; x < (h + 1) * PER / 4; ++x) {
        const T v = (in && kk + x < d) ? sr[x] : tile::zero_of<T>();
        w[h] |= tile::bits_of(v) << (32 / (PER / 4) * (x - h * PER / 4));
      }
    }
    *reinterpret_cast<uint4*>(d0 + i * STEP * ROW +
                              (tile::swz(row0 + i * STEP, c % CHUNKS) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// acc[i][j] += q[row i] . p[point j] over one stage's slab (queries at qs,
// points at ps), Shape<RT>::UNROLL quads a step.
template <typename T, int RT>
__device__ __forceinline__ void compute_slab(const char* qs, const char* ps,
                                             const Role& ro,
                                             float (&acc)[8][8]) {
  using S = Shape<RT>;
  constexpr int W = Quad<T>::W, N = Quad<T>::N, U = S::UNROLL;
  const char* qb = qs + ro.r0 * S::ROW;
  const char* pb = ps + ro.p0 * S::ROW;
#pragma unroll 1
  for (int x0 = 0; x0 < N * S::PARTS; x0 += U)
#pragma unroll
  for (int x = x0; x < x0 + U; ++x) {
    const int part = x / N * ROW_BYTES;
    const char* pq = pb + part + Quad<T>::off(x % N, ro.psw16);
    const char* qq = qb + part + Quad<T>::off(x % N, ro.qsw16);
    float w[8][W];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Quad<T>::load(pq + ((j & 3) + 64 * (j >> 2)) * S::ROW, w[j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float a[W];
      Quad<T>::load(qq + ((i & 3) + RT / 2 * (i >> 2)) * S::ROW, a);
#pragma unroll
      for (int e = 0; e < W; ++e)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(a[e], w[j][e], acc[i][j]);
    }
  }
}

// A norm chain continued from s over one 128-byte part of slab row r.
template <typename T>
__device__ __forceinline__ float norm_part(const char* part, int r,
                                           float s) {
  constexpr int PER = Dims<T>::PER;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    float v[PER];
    tile::load_chunk(part + (tile::swz(r, c) << 4), v);
#pragma unroll
    for (int x = 0; x < PER; ++x) s = fmaf(v[x], v[x], s);
  }
  return s;
}

// The items a block walks: item g is point tile g / nrt, row tile g % nrt.
template <int RT>
struct Walk {
  const unsigned char* valid;
  float* out;
  int B, m, nrt, items;
  long long N;
  Role ro;

  __device__ int first() const {
    return (int)blockIdx.x < items ? (int)blockIdx.x : -1;
  }
  __device__ int step(int g, int i) const {
    const long long n = (long long)g + (long long)i * gridDim.x;
    return n < items ? (int)n : -1;
  }
  __device__ int next(int g) const { return step(g, 1); }
  __device__ int ptile(int g) const { return nrt == 1 ? g : g / nrt; }
  __device__ int rtile(int g) const {
    return nrt == 1 ? 0 : g - (g / nrt) * nrt;
  }
  __device__ long long pstart(int g) const {
    return (long long)ptile(g) * PT;
  }

  // Rows rt * RT + r of the 4 points n0 .. n0 + 3 (one thread's group).
  __device__ void store(long long n0, int b0, const float (&v)[8][4]) const {
    if (n0 >= N) return;
    long long s, j;
    if (N < (1LL << 31)) {
      const unsigned n = (unsigned)n0, mu = (unsigned)m;
      const unsigned su = n / mu;
      s = su;
      j = n - su * mu;
    } else {
      s = n0 / m;
      j = n0 - s * m;
    }
    const bool vec = (m & 3) == 0 && j + 3 < m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = b0 + ro.r0 + (i & 3) + RT / 2 * (i >> 2);
      if (b >= B) continue;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(out + (s * B + b) * m + j),
               make_float4(v[i][0], v[i][1], v[i][2], v[i][3]));
        continue;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (n0 + t >= N) break;
        long long jx = j + t, sx = s;
        while (jx >= m) {
          jx -= m;
          ++sx;
        }
        out[(sx * B + b) * m + jx] = v[i][t];
      }
    }
  }

  __device__ void dead(int g) const {
    float v[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) v[i][t] = CUDART_INF_F;
    const int b0 = rtile(g) * RT;
#pragma unroll
    for (int h = 0; h < 2; ++h) store(pstart(g) + ro.p0 + 64 * h, b0, v);
  }

  __device__ void epilogue(int g, const float (&acc)[8][8], const float* qn,
                           const float* pn) const {
    const int b0 = rtile(g) * RT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pl = ro.p0 + 64 * h;
      const long long n0 = pstart(g) + pl;
      bool ok[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        ok[t] = n0 + t < N && (valid == nullptr || valid[n0 + t] != 0);
      float v[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = qn[ro.r0 + (i & 3) + RT / 2 * (i >> 2)];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[i][t] = ok[t] ? tile::dist_of(a, acc[i][4 * h + t], pn[pl + t])
                          : CUDART_INF_F;
      }
      store(n0, b0, v);
    }
  }
};

// The first item from g0 on (in the walk's order) whose point tile has a
// valid point, or -1; dead() runs for each item skipped.  One vote covers
// WIN items: eight threads an item, each testing 16 flags.  All threads
// call it.  distance_tile.cuh's skip_dead in this loop's own terms: the
// shared template gave two of its instances more registers (bf16 x 128
// rows 173 -> 176, f32 x 64 rows 162 -> 164).
template <int RT>
__device__ int skip_dead(unsigned* vote,
                         const unsigned char* __restrict__ valid,
                         const Walk<RT>& w, int g0) {
  constexpr int NT = Shape<RT>::NT, WIN = Shape<RT>::WIN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  while (g0 >= 0) {
    const int g = w.step(g0, tid >> 3);
    int live = 0;
    if (g >= 0) {
      const long long n = w.pstart(g) + (tid & 7) * 16;
      const unsigned char* f = valid + n;
      if (n + 16 <= w.N && (reinterpret_cast<size_t>(f) & 15) == 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(f);
        live = (v.x | v.y | v.z | v.w) != 0;
      } else {
        for (int x = 0; x < 16 && n + x < w.N; ++x) live |= f[x] != 0;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) vote[warp] = bal;
    __syncthreads();
    int first = WIN;
    for (int v = 0; v < NT / 32; ++v) {
      const unsigned b = vote[v];
      if (b != 0) {
        first = v * 4 + ((__ffs(b) - 1) >> 3);
        break;
      }
    }
    __syncthreads();
    for (int i = 0; i < first; ++i) {
      const int dg = w.step(g0, i);
      if (dg < 0) break;
      w.dead(dg);
    }
    g0 = w.step(g0, first);
    if (first < WIN) break;
  }
  return g0;
}

template <typename T, int RT>
__global__ void __launch_bounds__(Shape<RT>::NT, Shape<RT>::MIN_BLOCKS)
l2_distance_wide_kernel(const T* __restrict__ q, const T* __restrict__ p,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ out, int B, int k, int m, int d,
                        int items) {
  using S = Shape<RT>;
  constexpr int BK = Dims<T>::BK * S::PARTS;
  extern __shared__ __align__(128) char smem[];
  float* pn_s = reinterpret_cast<float*>(smem + STAGES * S::STAGE_BYTES);
  float* qn_s = pn_s + 2 * PT;
  int* slab_item = reinterpret_cast<int*>(qn_s + 2 * RT);
  unsigned* vote = reinterpret_cast<unsigned*>(slab_item + STAGES);

  const int tid = threadIdx.x;
  const long long N = (long long)k * m;
  const Walk<RT> w{valid, out, B, m, (B + RT - 1) / RT, items, N,
                   role_of(tid)};
  const int nk = tile::slabs(d, BK);
  const bool aq = tile::rows_aligned(q, d), ap = tile::rows_aligned(p, d);
  int item = w.first(), pk = 0, issued = 0;

  auto produce = [&](int stage) {
    if (pk == 0 && valid != nullptr && item >= 0)
      item = skip_dead<RT>(vote, valid, w, item);
    if (item >= 0) {
      char* st = smem + stage * S::STAGE_BYTES;
      copy_rows<T, RT, S::NT, S::ROW>(st, q, (long long)w.rtile(item) * RT,
                                      B, pk * BK, d, aq);
      copy_rows<T, PT, S::NT, S::ROW>(st + S::Q_BYTES, p, w.pstart(item), N,
                                      pk * BK, d, ap);
      if (tid == 0) slab_item[stage] = item;
      ++issued;
      if (++pk == nk) {
        pk = 0;
        item = w.next(item);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) produce(s);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int ck = 0, buf = 0, pend = -1;
  for (int u = 0; u < issued; ++u) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int stage = u % STAGES;
    const int g = slab_item[stage];
    if (pend >= 0) {
      w.epilogue(pend, acc, qn_s + (buf ^ 1) * RT, pn_s + (buf ^ 1) * PT);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      pend = -1;
    }
    produce((u + STAGES - 1) % STAGES);
    const char* st = smem + stage * S::STAGE_BYTES;
    compute_slab<T, RT>(st, st + S::Q_BYTES, w.ro, acc);
    // the norms, summed into the item's buffers in shared memory, so no
    // register holds them across the slabs: |p|^2's partial of a point
    // (tid < PT) added in ascending order, |q|^2's chain of a row
    // (qt >= 0) continued; conflict-free under the chunk swizzle
    if (tid < PT) {
      const int np = norm_index(tid);
      const char* row = st + S::Q_BYTES + np * S::ROW;
      float* pp = pn_s + buf * PT + np;
      float v = ck == 0 ? 0.f : *pp;
#pragma unroll
      for (int h = 0; h < S::PARTS; ++h)
        v += norm_part<T>(row + h * ROW_BYTES, np, 0.f);
      *pp = v;
    }
    const int qt = tid - (S::NT - RT);
    if (qt >= 0) {
      const int nq = norm_index(qt);
      const char* row = st + nq * S::ROW;
      float* qp = qn_s + buf * RT + nq;
      float v = ck == 0 ? 0.f : *qp;
#pragma unroll
      for (int h = 0; h < S::PARTS; ++h)
        v = norm_part<T>(row + h * ROW_BYTES, nq, v);
      *qp = v;
    }
    if (++ck == nk) {
      ck = 0;
      pend = g;
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pend >= 0) w.epilogue(pend, acc, qn_s + (buf ^ 1) * RT,
                            pn_s + (buf ^ 1) * PT);
}

// One launch over the resident blocks (the occupancy API's count times the
// SMs), at most one a work item.
template <typename T, int RT>
int launch(const T* q, const T* p, const unsigned char* valid, float* out,
           int B, int k, int m, int d, cudaStream_t stream) {
  const size_t bytes = smem_bytes<RT>();
  cudaError_t err = cudaFuncSetAttribute(
      l2_distance_wide_kernel<T, RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, l2_distance_wide_kernel<T, RT>, Shape<RT>::NT, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long items =
      (((long long)k * m + PT - 1) / PT) * ((B + RT - 1) / RT);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long blocks = items < resident ? items : resident;
  l2_distance_wide_kernel<T, RT><<<(unsigned)blocks, Shape<RT>::NT, bytes,
                                   stream>>>(
      q, p, valid, out, B, k, m, d, (int)items);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace knn
