// Fused squared-L2 distance and per-row running top-l, without writing
// the (B, m) distance matrix.
//
// Replaces: src/repro/kernels/distance_topk.py::distance_topk (Pallas
// _kernel and _merge_tile).
//
// On the TPU one core walked the point axis as a sequential grid
// dimension and carried the running (bb, l) top buffer in VMEM.  On
// Hopper blocks run in parallel and in no order, so the carry across
// blocks becomes a second pass: the points of every shard are cut into
// the same chunks, a persistent block per (chunk, query tile) walks its
// chunk in each of the k shards in turn (shard (chunk + i) % k at step
// i), writes each chunk's top-l as a partial (k, B, chunks, W), and the
// wrapper merges the partials with the local_topk kernel, ids carried.
// Because every block visits every shard, a valid mask that leaves one
// shard of k alive leaves every block 1/k of its work: routed-away
// shards cost a vote on their flags, not a walk.
//
// What bounds it on an H100: it reads the points once (4*k*m*d bytes)
// and does 2*B*k*m*d FLOPs, B/2 FLOP per byte of points.  At B = 32, d =
// 64 that is 16 FLOP per byte, under the f32 SIMT ridge of about 20, so
// it is bound by bytes (the distance tiles never leave the chip), with
// the FMAs close behind.  At deep1b's step (B = 128, d = 96, l = 100:
// 2 * 128 * 96 / (96 * 4) = 64 FLOP per byte) it is bound by the f32
// FMAs.
//
// Two paths; kernels/plan.py says which a bucket takes:
// - this file's kernel, a 32-row query tile;
// - distance_topk_wide.cuh (knn_distance_topk_wide), one block's
//   tile spanning the bucket (64 or 128 rows) with 8 x 8 register tiles,
//   one 8-warp block an SM, each point read into shared memory once a
//   launch, and each row's sorted run kept in its partial in device
//   memory (L2) beside a small candidate area in shared memory.
// Both give the same (value, id) lists, bit for bit.
//
// Design of the 32-row kernel: the distance main loop of
// distance_tile.cuh (queries resident, a 4-slab cp.async ring of 64-point
// tiles, 4 x 4 register tiles, |p|^2 once per point, dead tiles skipped
// by a block vote).  Each query row keeps a sorted running region of up
// to l entries and a candidate area in shared memory (S = pow2 >= l + 64
// slots); a distance becomes a candidate only if its (value, id) key is
// below the row's threshold key, the lower of the row's own l-th key and
// a per-(shard, row) key in device memory that every block lowers with
// atomicMin: a block's l-th key of a shard bounds the shard's l-th key
// from above, so points above it can win no slot anywhere.  When a row's
// candidates could overflow, one warp sorts them into its entries
// (bitonic, lexicographic: ties to the smaller id; once the sorted run
// fills half the sort, only the candidates are sorted and one merge pass
// follows) and refreshes its threshold.  Such a warp merge costs tens of
// thousands of cycles on the card, so a chunk's partial is not merged
// at its end: the block writes the row's S slots as they stand, and the
// local_topk pass picks the l smallest of all chunks' slots.  (With one
// chunk the partial is the answer: merged, the l smallest, ascending.)
// Points past m and points with valid == 0 never become candidates,
// which is the reference's +inf / id 2^31-1 rule: unfilled slots report
// (+inf, 2^31-1).
#include "distance_tile.cuh"
#include "distance_topk_wide.cuh"

namespace {

using namespace knn::tile;
constexpr int NW = NT / 32;

using knn::Key;
using knn::key_of;
using knn::kmin;

inline int slots(int l) { return knn::next_pow2(l + TN); }

inline size_t topk_bytes(size_t loop, int S) {
  return loop + sizeof(Key) * TB +
         (sizeof(float) + sizeof(int)) * (size_t)TB * S +
         2 * sizeof(int) * TB;
}

// Compare-exchange stages j = j0, j0 / 2, ..., 1 of a bitonic network of
// one warp over n (value, id) pairs in shared memory: pair (i, i + j)
// goes up where (i & k) == 0, and every direction flips when desc.
__device__ void bitonic_stages(float* v, int* ix, int n, int k, int j0,
                               bool desc, int lane) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int t = lane; t < (n >> 1); t += 32) {
      const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      const int p = i + j;
      const bool up = ((i & k) == 0) != desc;
      const float vi = v[i], vp = v[p];
      const int ii = ix[i], ip = ix[p];
      if (up ? knn::key_lt(vp, ip, vi, ii) : knn::key_lt(vi, ii, vp, ip)) {
        v[i] = vp;
        v[p] = vi;
        ix[i] = ip;
        ix[p] = ii;
      }
    }
    __syncwarp();
  }
}

__device__ void warp_sort(float* v, int* ix, int n, bool desc, int lane) {
  for (int k = 2; k <= n; k <<= 1)
    bitonic_stages(v, ix, n, k, k >> 1, desc, lane);
}

struct TopkWalk {
  const unsigned char* valid;
  Key* gthr;                     // (k, B) threshold keys
  float* out_v;
  int* out_i;
  int B, k, m, l, S, W, c0, c1, tpc, nchunks, b0;
  Lane ln;
  Key* thr;                      // [TB]
  float* bv;                     // [TB][S]
  int* bi;                       // [TB][S]
  int* run;                      // [TB] sorted entries at the row's front
  int* cnt;                      // [TB] candidates after them
  int cur;                       // item whose rows are held

  __device__ int shard(int i) const { return ((int)blockIdx.x + i) % k; }
  __device__ int first() const { return tpc > 0 ? 0 : -1; }
  __device__ int next(int g) const { return g + 1 < k * tpc ? g + 1 : -1; }
  __device__ int step(int g, int i) const {
    return g + i < k * tpc ? g + i : -1;
  }
  __device__ long long start(int g) const {
    return (long long)shard(g / tpc) * m + c0 + (g % tpc) * TN;
  }
  __device__ long long end(int g) const {
    return (long long)shard(g / tpc) * m + c1;
  }
  __device__ void dead(int) const {}

  // Empty rows for item i; ends with a barrier.
  __device__ void reset(int i) {
    const int tid = threadIdx.x;
    for (int e = tid; e < TB * S; e += NT) {
      bv[e] = CUDART_INF_F;
      bi[e] = knn::kIntMax;
    }
    if (tid < TB) {
      run[tid] = 0;
      cnt[tid] = 0;
      const int b = b0 + tid;
      thr[tid] = b < B ? __ldcg(gthr + (long long)shard(i) * B + b) : 0ULL;
    }
    __syncthreads();
  }

  // One warp folds row r's candidates into its sorted entries, keeps the
  // l smallest and lowers the row's threshold and shard s's shared one.
  __device__ void merge_row(int r, int s, int lane) {
    const int c = cnt[r];
    if (c == 0) return;
    float* v = bv + (size_t)r * S;
    int* ix = bi + (size_t)r * S;
    const int r0 = run[r], n = r0 + c;
    int n_sort = 1;
    while (n_sort < n) n_sort <<= 1;
    if (2 * r0 == n_sort) {
      // the sorted run fills the lower half: sort only the candidates,
      // descending, then one bitonic merge of the whole row
      warp_sort(v + r0, ix + r0, r0, true, lane);
      bitonic_stages(v, ix, n_sort, n_sort, n_sort >> 1, false, lane);
    } else {
      warp_sort(v, ix, n_sort, false, lane);
    }
    const int nr = n < l ? n : l;
    for (int t = nr + lane; t < n_sort; t += 32) {
      v[t] = CUDART_INF_F;
      ix[t] = knn::kIntMax;
    }
    __syncwarp();
    if (lane == 0) {
      run[r] = nr;
      cnt[r] = 0;
      if (nr == l) {
        const Key key = key_of(v[l - 1], ix[l - 1]);
        thr[r] = kmin(thr[r], key);
        atomicMin(gthr + (long long)s * B + b0 + r, key);
      }
    }
    __syncwarp();
  }

  // Write item i's partial; ends with a barrier.  With one chunk the
  // partial is the answer: the l smallest, ascending.  Otherwise it is
  // the row's W = S slots as they stand (sorted entries, candidates,
  // +inf), and the merge pass picks the l smallest of all chunks.
  __device__ void flush(int i) {
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s = shard(i);
    for (int r = warp; r < TB; r += NW) {
      const int b = b0 + r;
      if (b >= B) continue;
      if (W == l) merge_row(r, s, lane);
      const long long o = (((long long)s * B + b) * nchunks + blockIdx.x) * W;
      for (int t = lane; t < W; t += 32) {
        out_v[o + t] = bv[(size_t)r * S + t];
        out_i[o + t] = bi[(size_t)r * S + t];
      }
    }
    __syncthreads();
  }

  __device__ void advance_to(int i) {
    while (cur < i) {
      flush(cur);
      if (++cur < k) reset(cur);
    }
  }

  __device__ void epilogue(int g, const float (&acc)[4][4],
                           const float* qn, const float* pn) {
    const int i = g / tpc, t = g % tpc;
    advance_to(i);
    const int s = shard(i);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // rows whose next candidates could overflow; now and then, take the
    // other blocks' thresholds
    const bool refresh = (t & 7) == 0;
    for (int r = warp; r < TB; r += NW) {
      if (b0 + r >= B) continue;
      if (run[r] + cnt[r] > S - TN) {
        merge_row(r, s, lane);
      } else if (refresh && lane == 0) {
        thr[r] = kmin(thr[r], __ldcg(gthr + (long long)s * B + b0 + r));
      }
    }
    __syncthreads();
    const int nl0 = c0 + t * TN + ln.p0;      // local point index
    const long long base = (long long)s * m;
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ok[j] = nl0 + j < c1 &&
              (valid == nullptr || valid[base + nl0 + j] != 0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ln.r0 + 4 * a;
      if (b0 + r >= B) continue;
      const Key th = thr[r];
      const float q2 = qn[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!ok[j]) continue;
        const float dist = dist_of(q2, acc[a][j], pn[ln.p0 + j]);
        if (key_of(dist, nl0 + j) < th) {
          const int pos = run[r] + atomicAdd(&cnt[r], 1);
          bv[(size_t)r * S + pos] = dist;
          bi[(size_t)r * S + pos] = nl0 + j;
        }
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 2)
distance_topk_kernel(const T* __restrict__ q, const T* __restrict__ p,
                     const unsigned char* __restrict__ valid,
                     unsigned long long* __restrict__ gthr,
                     float* __restrict__ out_v, int* __restrict__ out_i,
                     int B, int k, int m, int d, int l, int S, int chunk,
                     int nchunks) {
  extern __shared__ __align__(128) char smem[];
  const Shared sm = carve<T>(smem, d);
  const int b0 = blockIdx.y * TB;
  TopkWalk w;
  w.valid = valid;
  w.gthr = gthr;
  w.out_v = out_v;
  w.out_i = out_i;
  w.B = B;
  w.k = k;
  w.m = m;
  w.l = l;
  w.S = S;
  w.W = nchunks == 1 ? l : S;
  w.c0 = blockIdx.x * chunk;
  w.c1 = min(w.c0 + chunk, m);
  w.tpc = (w.c1 - w.c0 + TN - 1) / TN;
  w.nchunks = nchunks;
  w.b0 = b0;
  w.ln = lane_of(threadIdx.x);
  w.thr = reinterpret_cast<Key*>(sm.tail);
  w.bv = reinterpret_cast<float*>(w.thr + TB);
  w.bi = reinterpret_cast<int*>(w.bv + (size_t)TB * S);
  w.run = w.bi + (size_t)TB * S;
  w.cnt = w.run + TB;
  w.cur = 0;
  load_queries<T>(sm, q, B, d, b0);
  w.reset(0);
  stream<T>(sm, p, d, valid, w);
  w.advance_to(k);
}

template <typename T>
int launch(const T* q, const T* p, const unsigned char* valid,
           unsigned long long* gthr, float* out_v, int* out_i, int B, int k,
           int m, int d, int l, int chunk, cudaStream_t stream) {
  const int S = slots(l);
  const int nchunks = (m + chunk - 1) / chunk;
  const size_t bytes = topk_bytes(loop_bytes<T>(d), S);
  cudaError_t err = cudaFuncSetAttribute(
      distance_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nchunks, (unsigned)((B + TB - 1) / TB));
  distance_topk_kernel<T><<<grid, NT, bytes, stream>>>(
      q, p, valid, gthr, out_v, out_i, B, k, m, d, l, S, chunk, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, d), p: (k, m, d), both f32 or both bf16; valid: (k, m) uint8 or
// null; gthr: (k, B) keys, +inf keys before the launch; out: (k, B,
// chunks, W) partials of local point indices in [0, m), chunks =
// ceil(m / chunk): with one chunk W = l, ascending; else W =
// pow2 >= l + 64 slots in no order.  chunk must be a multiple of 64.
extern "C" int knn_distance_topk(const void* q, const void* p,
                                 const unsigned char* valid, void* gthr,
                                 float* out_v, int* out_i, int B, int k,
                                 int m, int d, int l, int chunk, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<unsigned long long*>(gthr);
  if (dtype == knn::kBF16) {
    return launch(static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(p), valid, g, out_v,
                  out_i, B, k, m, d, l, chunk, s);
  }
  return launch(static_cast<const float*>(q), static_cast<const float*>(p),
                valid, g, out_v, out_i, B, k, m, d, l, chunk, s);
}

// The whole-bucket path (distance_topk_wide.cuh) for B > 32: row_tile 64
// or 128 query rows a block; groups 2 (a ring of two whole point tiles)
// or 3 (of three slabs); cand candidate keys a row in shared memory
// (<= 128); grid (chunks, ceil(B / row_tile)).  out: (k, B, chunks, l)
// partials, each the chunk's l smallest ascending, (+inf, 2^31-1) past
// its points.  chunk must be a multiple of 128.
extern "C" int knn_distance_topk_wide(const void* q, const void* p,
                                      const unsigned char* valid, void* gthr,
                                      float* out_v, int* out_i, int B, int k,
                                      int m, int d, int l, int chunk,
                                      int dtype, int row_tile, int groups,
                                      int cand, void* stream) {
  namespace tw = knn::topw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<unsigned long long*>(gthr);
  using BF = __nv_bfloat16;
  const BF *qb = static_cast<const BF*>(q), *pb = static_cast<const BF*>(p);
  const float *qf = static_cast<const float*>(q),
              *pf = static_cast<const float*>(p);
  const bool bf = dtype == knn::kBF16;
  if (row_tile == 64)
    return bf ? tw::launch<BF, 64>(qb, pb, valid, g, out_v, out_i, B, k, m,
                                   d, l, groups, cand, chunk, s)
              : tw::launch<float, 64>(qf, pf, valid, g, out_v, out_i, B, k,
                                      m, d, l, groups, cand, chunk, s);
  if (row_tile == 128)
    return bf ? tw::launch<BF, 128>(qb, pb, valid, g, out_v, out_i, B, k, m,
                                    d, l, groups, cand, chunk, s)
              : tw::launch<float, 128>(qf, pf, valid, g, out_v, out_i, B, k,
                                       m, d, l, groups, cand, chunk, s);
  return (int)cudaErrorInvalidValue;
}
