// The l smallest (value, id) pairs of each row, ascending.
//
// Replaces: src/repro/kernels/local_topk.py::local_topk (Pallas _kernel,
// with the _merge_tile merge of src/repro/kernels/distance_topk.py).
//
// On the TPU the point axis was a sequential grid dimension carrying a
// running (bb, l) buffer in VMEM.  Here the rows' values, taken as one
// flattened run of rows * m, are cut into items of `per` values; a block
// takes items in turn (a persistent grid the wrapper sizes to the card's
// resident blocks) and writes one partial of l slots for every row segment
// of its item, at (row, item - the row's first item).  With per == m an
// item is a row and its partial is the answer; otherwise the wrapper runs
// the same kernel again over the (row, parts * l) partials with their ids
// carried.  The same pass merges distance_topk's unmerged row slots.
//
// What bounds it on an H100: it reads each value once (carried ids only
// where their value passes the filter) and does O(1) work per value after
// warm-up, so it is bound by bytes.  Design:
//  - loads are 16-byte cp.async copies (4 f32 or 8 bf16 a thread) into a
//    warp-private ring in shared memory, STAGES - 1 rounds of 8 values a
//    thread ahead; a lane reads back only what it copied, so the ring
//    needs no barrier.  A row's unaligned head and ragged tail go to warp
//    0 as scalars;
//  - a round costs one compare per value against the threshold's value
//    and one warp vote; only a round where some value is at or below it
//    appends candidates (one ballot per value slot, at the warp-private
//    count plus the set lanes below), reading each such value's carried
//    id from device memory.  While that value is +inf (a row of +inf, as
//    a masked shard's), a value equal to it must also have its whole key
//    below the threshold, so such a row does not pass whole;
//  - each warp keeps a private sorted run of run_width(l) keys and its
//    candidate buffer in shared memory, and the block one 64-bit threshold
//    key lowered with atomicMin.  A warp merges alone (__syncwarp only)
//    once it holds ABSORB_AT candidates or could overflow: it drops those
//    no longer below the threshold, sorts the rest (bitonic), folds them
//    into its run (the elementwise min of the run and the reversed
//    candidates is bitonic and holds the run's new keys) and sorts that
//    with one bitonic merge pass;
//  - the threshold is the least of any warp's l-th key and the largest
//    q-th key, q = ceil(l / NW), that the warps publish: each bounds the
//    block's l-th key from above (l keys lie at or below it), and the
//    second falls about NW times faster.  The main loop has no block
//    barrier;
//  - at a segment's end the warps' runs are folded pairwise (log2 of the
//    warp count barriers) and the block writes l slots.
// An optional exclusive floor per row (the key of (floor_v[r], floor_i[r]))
// serves l above one pass's slots: a value whose whole key is at or below
// its row's floor never becomes a candidate, so pass p, floored at the last
// key of pass p - 1, writes the next l keys of the row (kernels/local_topk.py
// passes).  The floor costs one more compare per value; a value equal to
// the floor's has its whole key (carried id read) compared, as at a +inf
// threshold.  It is a template parameter, so a launch without one runs the
// one-pass code unchanged.
// Keys order exactly as knn::key_lt: the float's bits under the
// order-preserving map (all bits flipped when the sign is set, else the
// sign bit) above the id, with -0.0 folded to +0.0 first, so equal values
// tie to the smaller id.  A key decodes to +0.0 for either zero.  (The
// distance kernels' keys, common.cuh's key_of, take values >= +0 and keep
// their bits as they are: another format.)
#include <stdint.h>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int NW = 8;                 // warps per block
constexpr int NT = NW * 32;           // threads per block
constexpr int E = 8;                  // values per thread per round
constexpr int CAND = 256;             // candidate slots per warp
constexpr int STAGES = 4;             // rounds a warp's copy ring holds
constexpr int ABSORB_AT = 64;         // candidates that trigger a merge
constexpr u64 INF_KEY = 0xFF8000007FFFFFFFull;   // (+inf, INT32_MAX)
constexpr unsigned FULL = 0xffffffffu;
static_assert(CAND >= 32 * E, "a round's candidates must fit an empty buffer");

__device__ __forceinline__ u64 make_key(float v, int id) {
  unsigned b = __float_as_uint(v);
  if ((b << 1) == 0) b = 0;                      // -0.0 -> +0.0
  b = (b & 0x80000000u) ? ~b : (b ^ 0x80000000u);
  return ((u64)b << 32) | (unsigned)id;
}
__device__ __forceinline__ float key_value(u64 k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}
__device__ __forceinline__ int key_id(u64 k) { return (int)(unsigned)k; }

// Sorts a[0, n) ascending (n a power of two); the warp cooperates.
__device__ void warp_sort(u64* a, int n, int lane) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < (n >> 1); t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i + j;
        const u64 x = a[i], y = a[p];
        if ((x > y) == ((i & k) == 0)) {
          a[i] = y;
          a[p] = x;
        }
      }
      __syncwarp();
    }
  }
}

// run[0, R) sorted <- the R smallest of run and the sorted c[0, n).
__device__ void fold(u64* run, const u64* c, int n, int R, int lane) {
  for (int i = lane; i < R; i += 32) {
    const int j = R - 1 - i;
    const u64 x = j < n ? c[j] : INF_KEY;
    if (x < run[i]) run[i] = x;
  }
  __syncwarp();
  for (int j = R >> 1; j > 0; j >>= 1) {        // one bitonic merge pass
    for (int t = lane; t < (R >> 1); t += 32) {
      const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      const int p = i + j;
      const u64 x = run[i], y = run[p];
      if (x > y) {
        run[i] = y;
        run[p] = x;
      }
    }
    __syncwarp();
  }
}

struct Warp {
  u64* run;
  u64* cand;
  u64* thr;     // the block's threshold key
  u64* pub;     // each warp's run[q - 1], q = ceil(l / NW)
  int cnt;      // keys in cand
  int R, l, q, warp, lane;
};

// Drops the candidates no longer below the block's threshold, sorts the
// rest, folds them into the warp's run and lowers the threshold to the
// least of the run's l-th key and the largest q-th key any warp's run
// publishes (every run holds q keys at or below it: NW * q >= l).
__device__ __forceinline__ void absorb(Warp& w) {
  const u64 t = *(volatile u64*)w.thr;
  u64 k[CAND / 32];
#pragma unroll
  for (int i = 0; i < CAND / 32; ++i) {
    const int idx = i * 32 + w.lane;
    k[i] = idx < w.cnt ? w.cand[idx] : INF_KEY;
  }
  __syncwarp();
  int n = 0;
  const unsigned lt = (1u << w.lane) - 1;
#pragma unroll
  for (int i = 0; i < CAND / 32; ++i) {
    const bool keep = k[i] < t;
    const unsigned bal = __ballot_sync(FULL, keep);
    if (keep) w.cand[n + __popc(bal & lt)] = k[i];
    n += __popc(bal);
  }
  w.cnt = 0;
  if (n == 0) return;
  int n2 = 32;
  while (n2 < n) n2 <<= 1;
  for (int i = n + w.lane; i < n2; i += 32) w.cand[i] = INF_KEY;
  __syncwarp();
  warp_sort(w.cand, n2, w.lane);
  fold(w.run, w.cand, n2, w.R, w.lane);
  if (w.lane == 0) {
    w.pub[w.warp] = w.run[w.q - 1];
    u64 most = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const u64 x = ((volatile u64*)w.pub)[i];
      most = x > most ? x : most;
    }
    const u64 own = w.run[w.l - 1];
    atomicMin(w.thr, own < most ? own : most);
  }
  __syncwarp();
}

// Offers each lane's N values (bit e of ok: value e is at or below the
// threshold's value) with their columns to the warp's candidates (merging
// first if they could overflow, and after, from ABSORB_AT on): one ballot
// per value slot, keys at the warp's count plus the set lanes below;
// carried ids are read here, for these values alone.  Warp-collective.
template <int N>
__device__ __forceinline__ void offer(const float (&v)[N], const int (&col)[N],
                                      unsigned ok, const int* ids, Warp& w) {
  if (w.cnt + __reduce_add_sync(FULL, __popc(ok)) > CAND) absorb(w);
  const unsigned lt = (1u << w.lane) - 1;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const bool mine = (ok >> e) & 1;
    const unsigned bal = __ballot_sync(FULL, mine);
    if (bal == 0) continue;
    if (mine)
      w.cand[w.cnt + __popc(bal & lt)] =
          make_key(v[e], ids ? __ldg(ids + col[e]) : col[e]);
    w.cnt += __popc(bal);
  }
  if (w.cnt >= ABSORB_AT) absorb(w);
}

__device__ __forceinline__ unsigned word(const uint4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}
// element e of a 16-byte vector of T, as f32
template <typename T>
__device__ __forceinline__ float element(const uint4& q, int e);
template <>
__device__ __forceinline__ float element<float>(const uint4& q, int e) {
  return __uint_as_float(word(q, e));
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const uint4& q,
                                                        int e) {
  const unsigned w = word(q, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// One row segment [c0, c1) of row r: every warp offers its rounds, then
// the warps' runs are folded and the block writes partial slot j.
template <typename T, bool IDS, bool FLOOR>
__device__ void segment(const T* __restrict__ x, const int* __restrict__ ids,
                        const float* __restrict__ floor_v,
                        const int* __restrict__ floor_i,
                        float* __restrict__ out_v, int* __restrict__ out_i,
                        long long r, long long c0, long long c1, long long j,
                        int m, long long per, int nparts, u64* sm,
                        uint4* ring, Warp& w) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = E / VEC;                     // vectors per thread
  const int warp = threadIdx.x >> 5;
  const int R = w.R, l = w.l, lane = w.lane;

  __syncthreads();                  // the previous segment's slots are out
  for (int i = lane; i < R; i += 32) w.run[i] = INF_KEY;
  if (lane == 0) w.pub[warp] = INF_KEY;
  if (threadIdx.x == 0) *w.thr = INF_KEY;
  w.cnt = 0;
  __syncthreads();

  const T* xr = x + r * m;
  const int* ir = IDS ? ids + r * m : nullptr;
  // the row's exclusive floor: value fv, whole key fk (FLOOR only)
  const float fv = FLOOR ? floor_v[r] : -CUDART_INF_F;
  const u64 fk = FLOOR ? make_key(fv, floor_i[r]) : 0;
  // columns fit an int (m does); the aligned body is [a, b)
  int head = (int)(((16 - ((uintptr_t)(xr + c0) & 15)) & 15) / sizeof(T));
  if (head > c1 - c0) head = (int)(c1 - c0);
  const int a = (int)c0 + head;
  const int nv = ((int)c1 - a) / VEC;
  const int b = a + nv * VEC;

  if (warp == 0) {                  // unaligned head and ragged tail
    const int ns = head + (int)c1 - b;
    const int col = lane < head ? (int)c0 + lane : b + lane - head;
    bool ok = lane < ns;
    const float v[1] = {ok ? knn::to_f32(xr[col]) : 0.f};
    if (FLOOR && ok) ok = make_key(v[0], IDS ? __ldg(ir + col) : col) > fk;
    const int c[1] = {col};
    offer<1>(v, c, ok ? 1u : 0u, ir, w);
  }

  // the body: STAGES - 1 rounds of copies in flight; a lane reads back
  // only what it copied, so the ring needs no barrier
  const uint4* xv = reinterpret_cast<const uint4*>(xr + a);
  const int rounds = (nv + 32 * U - 1) / (32 * U);
  auto copy_round = [&](int rd, int st) {
    if (rd < rounds) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int vi = rd * 32 * U + u * 32 + lane;
        if (vi < nv)
          knn::cp_async16(ring + (st * U + u) * 32 + lane, xv + vi);
      }
    }
    knn::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) copy_round(warp + st * NW, st);
  const volatile unsigned* thr_hi =
      reinterpret_cast<const volatile unsigned*>(w.thr) + 1;
  int st = 0;
  for (int rd = warp; rd < rounds; rd += NW) {
    knn::cp_async_wait<STAGES - 2>();
    uint4 cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = ring[(st * U + u) * 32 + lane];
    copy_round(rd + (STAGES - 1) * NW, st == 0 ? STAGES - 1 : st - 1);
    st = st == STAGES - 1 ? 0 : st + 1;
    const unsigned hi = *thr_hi;
    const float tv =
        __uint_as_float((hi & 0x80000000u) ? (hi ^ 0x80000000u) : ~hi);
    const int v0 = rd * 32 * U + lane;
    unsigned ok = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xe = element<T>(cur[u], e);
        if (v0 + u * 32 < nv && xe <= tv && (!FLOOR || xe >= fv))
          ok |= 1u << (u * VEC + e);
      }
    if (!__any_sync(FULL, ok)) continue;
    float v[E];
    int col[E];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[u * VEC + e] = element<T>(cur[u], e);
        col[u * VEC + e] = a + (v0 + u * 32) * VEC + e;
      }
    if (FLOOR) {
      // a value equal to the floor's passes only if its whole key is
      // above the floor
      bool tie = false;
#pragma unroll
      for (int i = 0; i < E; ++i) tie |= ((ok >> i) & 1) && v[i] == fv;
      if (__any_sync(FULL, tie)) {
#pragma unroll
        for (int i = 0; i < E; ++i)
          if (((ok >> i) & 1) && v[i] == fv &&
              make_key(v[i], IDS ? __ldg(ir + col[i]) : col[i]) <= fk)
            ok &= ~(1u << i);
        if (!__any_sync(FULL, ok)) continue;
      }
    }
    if (__any_sync(FULL, tv == CUDART_INF_F)) {
      // a row of +inf (a masked shard's): a value equal to the
      // threshold's passes only if its whole key is below the threshold
      // (any key at or above the threshold may be dropped)
      const u64 tk = *(const volatile u64*)w.thr;
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (((ok >> i) & 1) && v[i] == tv &&
            make_key(v[i], IDS ? __ldg(ir + col[i]) : col[i]) >= tk)
          ok &= ~(1u << i);
      if (!__any_sync(FULL, ok)) continue;
    }
    offer<E>(v, col, ok, ir, w);
  }
  knn::cp_async_wait<0>();
  if (w.cnt) absorb(w);
  __syncthreads();
  const int stride = R + CAND;
  for (int s = 1; s < NW; s <<= 1) {
    if ((warp & (2 * s - 1)) == 0) fold(w.run, w.run + s * stride, R, R, lane);
    __syncthreads();
  }

  const long long o = (r * nparts + j) * l;
  for (int t = threadIdx.x; t < l; t += NT) {
    out_v[o + t] = key_value(sm[t]);
    out_i[o + t] = key_id(sm[t]);
  }
  if (c0 == 0) {     // the row's first segment fills the slots none fills
    const long long items =
        (r * m + m - 1) / per - (r * m) / per + 1;
    const long long f = (r * nparts + items) * l;
    for (long long t = threadIdx.x; t < (nparts - items) * l; t += NT) {
      out_v[f + t] = CUDART_INF_F;
      out_i[f + t] = knn::kIntMax;
    }
  }
}

template <typename T, bool IDS, bool FLOOR>
__global__ void __launch_bounds__(NT)
local_topk_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                  const float* __restrict__ floor_v,
                  const int* __restrict__ floor_i,
                  float* __restrict__ out_v, int* __restrict__ out_i, int m,
                  int l, int R, long long per, int nparts, long long total) {
  static_assert(!IDS || sizeof(T) == 4, "ids ride with f32 values only");
  static_assert(!(IDS && FLOOR), "a floored pass reads column ids");
  constexpr int U = E / (16 / sizeof(T));
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  uint4* ring = smem + warp * STAGES * U * 32;
  u64* sm = reinterpret_cast<u64*>(smem + NW * STAGES * U * 32);
  Warp w;
  w.run = sm + warp * (R + CAND);
  w.cand = w.run + R;
  w.thr = sm + NW * (R + CAND);
  w.pub = w.thr + 1;
  w.cnt = 0;
  w.R = R;
  w.l = l;
  w.q = (l + NW - 1) / NW;
  w.warp = warp;
  w.lane = threadIdx.x & 31;
  const long long items = (total + per - 1) / per;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long ie = min(item * per + per, total);
    for (long long s = item * per; s < ie;) {
      const long long r = s / m;
      const long long c0 = s - r * m;
      const long long c1 = min((long long)m, c0 + (ie - s));
      segment<T, IDS, FLOOR>(x, ids, floor_v, floor_i, out_v, out_i, r, c0,
                             c1, item - (r * m) / per, m, per, nparts, sm,
                             ring, w);
      s += c1 - c0;
    }
  }
}

// dynamic shared memory: the warps' copy rings, then their runs and
// candidates, the threshold key and the warps' published keys
size_t smem_bytes(int R, int elem_bytes) {
  return (size_t)NW * STAGES * 32 * E * elem_bytes +
         sizeof(u64) * ((size_t)NW * (R + CAND + 1) + 1);
}

template <typename T, bool IDS, bool FLOOR>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(local_topk_kernel<T, IDS, FLOOR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Launches the variant, or (occ != null) reports its resident blocks per
// SM from the occupancy API instead.
template <typename T, bool IDS, bool FLOOR>
cudaError_t run(const void* x, const int* ids, const float* floor_v,
                const int* floor_i, float* out_v, int* out_i, int m, int l,
                int R, long long per, int nparts, long long total, int grid,
                size_t smem, cudaStream_t s, int* occ) {
  cudaError_t e = prepare<T, IDS, FLOOR>(smem);
  if (e != cudaSuccess) return e;
  if (occ != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, local_topk_kernel<T, IDS, FLOOR>, NT, smem);
  local_topk_kernel<T, IDS, FLOOR><<<grid, NT, smem, s>>>(
      static_cast<const T*>(x), ids, floor_v, floor_i, out_v, out_i, m, l, R,
      per, nparts, total);
  return cudaGetLastError();
}

// The variant for dtype, carried ids and a floor (ids need f32 values; a
// floor takes no ids).
cudaError_t dispatch(const void* x, const int* ids, const float* floor_v,
                     const int* floor_i, float* out_v, int* out_i, int rows,
                     int m, int l, long long per, int nparts, int grid,
                     int dtype, bool with_ids, bool with_floor,
                     cudaStream_t s, int* occ) {
  const int R = knn::run_width(l);
  const size_t smem = smem_bytes(R, dtype == knn::kBF16 ? 2 : 4);
  const long long total = (long long)rows * m;
  if (with_ids && (dtype != knn::kF32 || with_floor))
    return cudaErrorInvalidValue;
  if (with_ids)
    return run<float, true, false>(x, ids, nullptr, nullptr, out_v, out_i, m,
                                   l, R, per, nparts, total, grid, smem, s,
                                   occ);
  if (dtype == knn::kBF16)
    return with_floor
               ? run<__nv_bfloat16, false, true>(x, nullptr, floor_v, floor_i,
                                                 out_v, out_i, m, l, R, per,
                                                 nparts, total, grid, smem, s,
                                                 occ)
               : run<__nv_bfloat16, false, false>(x, nullptr, nullptr,
                                                  nullptr, out_v, out_i, m, l,
                                                  R, per, nparts, total, grid,
                                                  smem, s, occ);
  return with_floor
             ? run<float, false, true>(x, nullptr, floor_v, floor_i, out_v,
                                       out_i, m, l, R, per, nparts, total,
                                       grid, smem, s, occ)
             : run<float, false, false>(x, nullptr, nullptr, nullptr, out_v,
                                        out_i, m, l, R, per, nparts, total,
                                        grid, smem, s, occ);
}

}  // namespace

// x: (rows, m) f32 or bf16; ids: (rows, m) int32 or null (ids = column;
// carried ids need f32 values); floor_v / floor_i: (rows,) f32 / int32, or
// both null for no floor (a floor takes no carried ids).  The rows,
// flattened, are cut into items of `per` values that `grid` blocks take in
// turn; out: (rows, nparts, l), one ascending partial per (row, item the
// row meets), slot j = item - (row * m) / per.  nparts must be at least the
// most items a row meets; slots no item fills are (+inf, INT32_MAX).
extern "C" int knn_local_topk(const void* x, const int* ids,
                              const float* floor_v, const int* floor_i,
                              float* out_v, int* out_i, int rows, int m,
                              int l, long long per, int nparts, int grid,
                              int dtype, void* stream) {
  if ((floor_v == nullptr) != (floor_i == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(x, ids, floor_v, floor_i, out_v, out_i, rows, m, l,
                       per, nparts, grid, dtype, ids != nullptr,
                       floor_v != nullptr, static_cast<cudaStream_t>(stream),
                       nullptr);
}

// Resident blocks per SM of the variant knn_local_topk launches for l,
// dtype, ids and a floor, from the occupancy API (registers and shared
// memory).
extern "C" int knn_local_topk_blocks_per_sm(int l, int dtype, int with_ids,
                                            int with_floor, int* out) {
  return (int)dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       0, 1, l, 1, 1, 1, dtype, with_ids != 0,
                       with_floor != 0, nullptr, out);
}
