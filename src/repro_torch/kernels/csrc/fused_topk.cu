// Fused hybrid distance + top-k by id.
//
// Replaces repro/kernels/fused_topk.py::fused_topk_pallas: the fp32 form and
// the int8 (`has_scale`) form, bias on and off.
// For each query row b over candidate ids[b, 0..C): score = hybrid score +
// bias[b, c]; PAD ids (and ids outside [0, N)) are not read and score NEG.
// Returns the top k (descending) with their positions along C; ties go to the
// lowest position; slots with no live candidate hold (NEG, -1).
//
// Bound on the H100: bytes (each unique live row read once: Dd floats, or Dd
// int8 values + a 4-byte scale, plus its ELL slots). Two forms share the row
// arithmetic and the selection; the wrapper picks one by B x C
// (ORDERED_MIN_PAIRS in kernels/fused_topk.py):
//
// * one pass (small launches: serving and search rounds, descent inits,
//   refinement): one block per query row. The query's dense row goes to
//   shared memory and each of its ELL rows is sorted by one warp (a bitonic
//   sort over the lanes). Each warp scores a candidate: the row's ELL ids and
//   values and its dense words, 4 16-byte loads a lane at a time (two steps
//   at Dd 1024; 8 at once ran slower at the refinement shape, fewer warps
//   fitting an SM), are in flight before they are reduced. At B <= 264 the
//   block has a warp per candidate (up to 32), so at B = 32, C = 24 every
//   candidate of a row is in flight at once; above, 4 warps (small blocks,
//   many of them on an SM, ran the inits 4-10% faster than 8). Scores stay
//   in shared memory: the (B, C) score matrix never reaches device memory.
// * ordered (large launches: the NN-Descent chunk, B 2048 x C 1032): there
//   one block per query row reads each row once per pair (uniform ids over
//   2^20 rows give ~1.9 pairs per unique row; the real descent's two-hop ids
//   ~31, on hubs). So a counting sort (histogram, three-phase scan, scatter)
//   orders the live (id, b * C + c) pairs by id, and the scoring pass gives
//   each warp 16 consecutive pairs: the corpus row stays in the warp's
//   registers while its id repeats, so each unique row is read from HBM
//   about once, and each pair reads its query row (the chunk's ~9 MB of
//   query rows stay in L2) and the query's ELL ids, sorted once per launch,
//   one per lane (the intersection is a binary search over shuffles). The
//   scores go to an fp32 (B, C) scratch in device memory (8.5 MB at the
//   descent chunk, L2-resident) and a selection pass takes each row's top k.
//
// Selection has no barrier per rank: each warp keeps a running top-k of 32*M
// keys (M registers per lane, M = 1 for k <= 32, 2 for k <= 64), sorted
// (score desc, position asc) by a bitonic network over shuffles; a batch of
// 32*M new keys is sorted the same way and merged in (the better of L[i] and
// X[32M-1-i] is a bitonic sequence holding the top 32M of both, then a
// half-cleaner cascade sorts it). A batch none of whose keys beats the
// list's k-th is skipped. The block then merges its warps' lists once. The
// key is a strict total order, so this gives lax.top_k's order exactly. k > 64
// takes the general path: k rounds of a block-wide arg-max.
// The storage type enters only through the row scorer (CorpusView /
// CorpusViewQ8, common.cuh); int8 rows multiply the reduced dense dot by the
// row scale once (DESIGN.md §13).

#include "common.cuh"

namespace {

using rt::kFull;
using rt::kNoPos;  // with -inf: the key every candidate beats
using rt::kWarp;
using rt::QueryArgs;
constexpr int kMaxM = 2;            // keys per lane of the running top-k
// one pass: a block per query row, its warps taking the row's candidates
constexpr int kOnePassMaxWarps = 32;  // small launches: a warp per candidate
constexpr int kOnePassWarps = 4;      // launches of more than kSmallRows query rows
constexpr int kSmallRows = 264;       // two blocks per SM of the H100's 132
// ordered
constexpr int kPrepWarps = 8;         // query ELL rows sorted, a warp each
constexpr int kCountThreads = 256;    // histogram and scatter, grid-stride over B x C
constexpr int kScanThreads = 1024;    // exclusive scan of the N counters,
constexpr int kScanTile = 4 * kScanThreads;  // kScanTile of them a block
constexpr int kScoreWarps = 8;        // scoring: a warp per kPairsPerWarp sorted pairs
constexpr int kPairsPerWarp = 16;
constexpr int kSelectWarps = 4;       // selection: one block per query row
constexpr int kMaxSlots = 32;         // the ordered form's ELL widths (a lane per slot)
constexpr int kMaxVec = 8;            // its dense rows: <= 8 16-byte loads a lane (Dd <= 1024 fp32)

// (v, p) beats (w, q) when v > w, or v == w and p < q.
__device__ __forceinline__ bool beats(float v, int p, float w, int q) {
  return v > w || (v == w && p < q);
}

// ---- a warp's sorted list of 32*M keys ---------------------------------------
// Element e = 32 j + lane lives in register j of lane `lane`; rank 0 is the best.
template <int M>
struct Keys {
  float v[M];
  int p[M];
};

// One compare-exchange step of a bitonic network at distance d: element e
// and e ^ d; the lower one keeps the better key where (e & dir) == 0.
template <int M>
__device__ __forceinline__ void cx(Keys<M>& x, int d, int dir, int lane) {
  if (d >= kWarp) {  // both elements in this lane
    const int dj = d / kWarp;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int jj = j ^ dj;
      if (jj <= j) continue;
      const bool best_low = ((j * kWarp + lane) & dir) == 0;
      if (best_low == beats(x.v[jj], x.p[jj], x.v[j], x.p[j])) {
        const float tv = x.v[j];
        const int tp = x.p[j];
        x.v[j] = x.v[jj];
        x.p[j] = x.p[jj];
        x.v[jj] = tv;
        x.p[jj] = tp;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float ov = __shfl_xor_sync(kFull, x.v[j], d);
      const int op = __shfl_xor_sync(kFull, x.p[j], d);
      const bool best_low = ((j * kWarp + lane) & dir) == 0;
      const bool want_better = ((lane & d) == 0) == best_low;
      if (want_better == beats(ov, op, x.v[j], x.p[j])) {
        x.v[j] = ov;
        x.p[j] = op;
      }
    }
  }
}

template <int M>
__device__ __forceinline__ void sort_keys(Keys<M>& x, int lane) {
#pragma unroll
  for (int size = 2; size <= kWarp * M; size <<= 1)
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) cx(x, d, size, lane);
}

// L <- the top 32M of L and X, both sorted.
template <int M>
__device__ __forceinline__ void merge_keys(Keys<M>& l, const Keys<M>& x, int lane) {
#pragma unroll
  for (int j = 0; j < M; ++j) {  // X reversed: element 32M-1-e
    const float xv = __shfl_xor_sync(kFull, x.v[M - 1 - j], kWarp - 1);
    const int xp = __shfl_xor_sync(kFull, x.p[M - 1 - j], kWarp - 1);
    if (beats(xv, xp, l.v[j], l.p[j])) {
      l.v[j] = xv;
      l.p[j] = xp;
    }
  }
#pragma unroll
  for (int d = kWarp * M / 2; d > 0; d >>= 1) cx(l, d, 2 * kWarp * M, lane);
}

// The running top-k of one warp over row[c] for the batches of 32*M
// positions first, first + step, ...; positions past C hold (-inf, kNoPos).
template <int M>
__device__ __forceinline__ Keys<M> warp_topk(const float* row, int C, int first, int step, int k,
                                             int lane) {
  Keys<M> l;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    l.v[j] = -INFINITY;
    l.p[j] = kNoPos;
  }
  const int tj = (k - 1) / kWarp, tl = (k - 1) % kWarp;
  for (int base = first * kWarp * M; base < C; base += step * kWarp * M) {
    Keys<M> x;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int c = base + j * kWarp + lane;
      x.v[j] = c < C ? row[c] : -INFINITY;
      x.p[j] = c < C ? c : kNoPos;
    }
    float tv = l.v[0];
    int tp = l.p[0];
#pragma unroll
    for (int j = 1; j < M; ++j)
      if (j == tj) { tv = l.v[j]; tp = l.p[j]; }
    tv = __shfl_sync(kFull, tv, tl);
    tp = __shfl_sync(kFull, tp, tl);
    bool any = false;
#pragma unroll
    for (int j = 0; j < M; ++j) any |= beats(x.v[j], x.p[j], tv, tp);
    if (!__any_sync(kFull, any)) continue;
    sort_keys(x, lane);
    merge_keys(l, x, lane);
  }
  return l;
}

// Top k (k <= 32 M) of row[0..C) by the block's warps, merged once by warp 0,
// written to os/oi. `lists` holds 32 M (value, position) pairs per warp.
template <int M>
__device__ __forceinline__ void block_topk(const float* row, int C, int k, float* os, int* oi,
                                           float* lists) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int batches = (C + kWarp * M - 1) / (kWarp * M);
  const int nl = min(nwarps, batches);
  float* lv = lists;
  int* lp = reinterpret_cast<int*>(lists + nwarps * kWarp * M);
  Keys<M> l;
  if (warp < nl) l = warp_topk<M>(row, C, warp, nwarps, k, lane);
  if (nl > 1) {
    if (warp < nl) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        lv[(warp * M + j) * kWarp + lane] = l.v[j];
        lp[(warp * M + j) * kWarp + lane] = l.p[j];
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int w = 1; w < nl; ++w) {
        Keys<M> x;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          x.v[j] = lv[(w * M + j) * kWarp + lane];
          x.p[j] = lp[(w * M + j) * kWarp + lane];
        }
        merge_keys(l, x, lane);
      }
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int e = j * kWarp + lane;
      if (e < k) {
        const bool live = l.v[j] > rt::kNeg;
        os[e] = live ? l.v[j] : rt::kNeg;
        oi[e] = live ? l.p[j] : -1;
      }
    }
  }
}

// The general path (k > 32 kMaxM): k rounds of a block-wide arg-max over a
// writable row; a round that finds no score above NEG fills the rest.
__device__ void block_topk_rounds(float* row, int C, int k, float* os, int* oi, float* red) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  float* red_v = red;
  int* red_p = reinterpret_cast<int*>(red + kWarp);
  int* done = red_p + kWarp;
  if (threadIdx.x == 0) *done = 0;
  __syncthreads();
  for (int t = 0; t < k; ++t) {
    if (*done) {  // block-uniform: read after the barrier that ended round t-1
      for (int u = t + threadIdx.x; u < k; u += blockDim.x) {
        os[u] = rt::kNeg;
        oi[u] = -1;
      }
      break;
    }
    float bv = -INFINITY;
    int bp = kNoPos;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      if (beats(row[c], c, bv, bp)) { bv = row[c]; bp = c; }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int op = __shfl_xor_sync(kFull, bp, off);
      if (beats(ov, op, bv, bp)) { bv = ov; bp = op; }
    }
    if (lane == 0) { red_v[warp] = bv; red_p[warp] = bp; }
    __syncthreads();
    if (threadIdx.x == 0) {
      bv = red_v[0];
      bp = red_p[0];
      for (int w = 1; w < nwarps; ++w)
        if (beats(red_v[w], red_p[w], bv, bp)) { bv = red_v[w]; bp = red_p[w]; }
      if (bv > rt::kNeg) {
        os[t] = bv;
        oi[t] = bp;
        row[bp] = -INFINITY;  // retire the winner
      } else {
        os[t] = rt::kNeg;
        oi[t] = -1;
        *done = 1;
      }
    }
    __syncthreads();
  }
}

// Top k of a writable row by whichever path k takes. `lists`: select_smem_bytes.
__device__ __forceinline__ void select_row(float* row, int C, int k, float* os, int* oi,
                                           float* lists) {
  if (k <= kWarp) block_topk<1>(row, C, k, os, oi, lists);
  else if (k <= kWarp * kMaxM) block_topk<kMaxM>(row, C, k, os, oi, lists);
  else block_topk_rounds(row, C, k, os, oi, lists);
}

__host__ __device__ constexpr size_t select_smem_bytes(int warps) {
  return size_t(warps) * kWarp * kMaxM * 8 + 16;
}

// ---- one pass: one block per query row ---------------------------------------

template <typename View>
__global__ void __launch_bounds__(kOnePassMaxWarps * kWarp) fused_topk_kernel(
    QueryArgs qa, View corpus, const int* __restrict__ ids, const float* __restrict__ bias,
    int C, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  rt::QueryCache q = rt::carve_query_cache(smem, qa.dd, qa.psq, qa.pfq);
  float* scores = reinterpret_cast<float*>(smem + rt::query_cache_bytes(qa.dd, qa.psq, qa.pfq));
  float* lists = scores + ((C + 3) & ~3);

  rt::stage_query(q, qa, b);

  const int* idrow = ids + size_t(b) * C;
  const float* brow = bias == nullptr ? nullptr : bias + size_t(b) * C;
  for (int c = warp; c < C; c += nwarps) {
    const int id = idrow[c];
    float v = rt::kNeg;
    if (id >= 0 && id < corpus.n) {
      v = rt::score_row(corpus, q, id, lane);
      if (brow != nullptr) v += brow[c];
    }
    if (lane == 0) scores[c] = v;
  }
  __syncthreads();
  select_row(scores, C, k, out_s + size_t(b) * k, out_i + size_t(b) * k, lists);
}

// ---- ordered: query prep, counting sort by id, scoring, selection -----------
//
// Workspace (the caller's, fused_topk_workspace_bytes): the (B, C) fp32
// scores; the live pairs sorted by id as (id, b * C + c); per id a counter
// and the exclusive prefix of the counts (N + 1); the scan's tile sums; each
// query row's ELL ids and values sorted (B x 32 each) and their live counts.

struct Workspace {
  float* scores;
  int2* sorted;
  int* count;
  int* start;
  int* tiles;
  int* qsid;
  float* qsval;
  int* qfid;
  float* qfval;
  int* qn;
};

inline size_t ws_align(size_t x) { return (x + 255) & ~size_t(255); }

inline size_t carve_workspace(char* base, int B, int C, long long n, Workspace* w) {
  const size_t pairs = size_t(B) * C, tiles = size_t((n + kScanTile - 1) / kScanTile);
  const size_t q = size_t(B) * kMaxSlots;
  size_t off = 0;
  auto take = [&](size_t bytes) { char* p = base + off; off += ws_align(bytes); return p; };
  char* scores = take(pairs * 4);
  char* sorted = take(pairs * 8);
  char* count = take(size_t(n) * 4);
  char* start = take(size_t(n + 1) * 4);
  char* tsum = take(tiles * 4);
  char* qsid = take(q * 4);
  char* qsval = take(q * 4);
  char* qfid = take(q * 4);
  char* qfval = take(q * 4);
  char* qn = take(size_t(B) * 8);
  if (w != nullptr)
    *w = Workspace{reinterpret_cast<float*>(scores), reinterpret_cast<int2*>(sorted),
                   reinterpret_cast<int*>(count),   reinterpret_cast<int*>(start),
                   reinterpret_cast<int*>(tsum),    reinterpret_cast<int*>(qsid),
                   reinterpret_cast<float*>(qsval), reinterpret_cast<int*>(qfid),
                   reinterpret_cast<float*>(qfval), reinterpret_cast<int*>(qn)};
  return off;
}

// Each query row's two ELL rows sorted once, a warp per row (widths <= 32).
__global__ void __launch_bounds__(kPrepWarps * kWarp) fused_topk_prep_kernel(QueryArgs qa, int B,
                                                                           Workspace w) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int b = blockIdx.x * kPrepWarps + threadIdx.x / kWarp;
  if (b >= B) return;
  const size_t o = size_t(b) * kMaxSlots;
  const int ns = rt::warp_sort_ell(qa.si + size_t(b) * qa.psq, qa.sv + size_t(b) * qa.psq, qa.psq,
                               w.qsid + o, w.qsval + o, lane);
  const int nf = rt::warp_sort_ell(qa.fi + size_t(b) * qa.pfq, qa.fv + size_t(b) * qa.pfq, qa.pfq,
                               w.qfid + o, w.qfval + o, lane);
  if (lane == 0) { w.qn[2 * b] = ns; w.qn[2 * b + 1] = nf; }
}

// Histogram of the live ids (count zeroed by the launcher); dead positions
// are scored NEG here.
__global__ void __launch_bounds__(kCountThreads) fused_topk_hist_kernel(
    const int* __restrict__ ids, long long pairs, long long n, Workspace w) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * blockDim.x) {
    const int id = ids[i];
    if (id >= 0 && id < n) atomicAdd(w.count + id, 1);
    else w.scores[i] = rt::kNeg;
  }
}

// Exclusive scan of v[0..kScanThreads) held one per thread; returns the total.
__device__ int block_scan(int v, int* part, int& total) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  int incl = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == kWarp - 1) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = part[lane];  // kScanThreads / kWarp == 32 warps
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    part[lane] = x;
  }
  __syncthreads();
  total = part[kWarp - 1];
  const int excl = incl - v + (warp > 0 ? part[warp - 1] : 0);
  __syncthreads();  // part is reused by the caller's next scan
  return excl;
}

// Scan, phase 1: each tile's sum.
__global__ void __launch_bounds__(kScanThreads) fused_topk_tile_sum_kernel(long long n, Workspace w) {
  __shared__ int part[kWarp];
  const long long base = (long long)blockIdx.x * kScanTile + threadIdx.x * 4;
  int v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) v += base + e < n ? w.count[base + e] : 0;
  int total;
  block_scan(v, part, total);
  if (threadIdx.x == 0) w.tiles[blockIdx.x] = total;
}

// Scan, phase 2: the tile sums, in one block; start[n] = the live pairs.
__global__ void __launch_bounds__(kScanThreads) fused_topk_tile_scan_kernel(int tiles, long long n,
                                                                          Workspace w) {
  __shared__ int part[kWarp];
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    const int v = t < tiles ? w.tiles[t] : 0;
    int total;
    const int excl = block_scan(v, part, total);
    if (t < tiles) w.tiles[t] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) w.start[n] = carry;
}

// Scan, phase 3: start[i] = the tile's prefix + the prefix within the tile;
// the counters are zeroed again for the scatter.
__global__ void __launch_bounds__(kScanThreads) fused_topk_tile_apply_kernel(long long n, Workspace w) {
  __shared__ int part[kWarp];
  const long long base = (long long)blockIdx.x * kScanTile + threadIdx.x * 4;
  int c[4], v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c[e] = base + e < n ? w.count[base + e] : 0;
    v += c[e];
  }
  int total;
  int run = w.tiles[blockIdx.x] + block_scan(v, part, total);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (base + e < n) {
      w.start[base + e] = run;
      w.count[base + e] = 0;
      run += c[e];
    }
}

// Scatter: the live pairs by id.
__global__ void __launch_bounds__(kCountThreads) fused_topk_scatter_kernel(
    const int* __restrict__ ids, long long pairs, long long n, Workspace w) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * blockDim.x) {
    const int id = ids[i];
    if (id >= 0 && id < n) w.sorted[w.start[id] + atomicAdd(w.count + id, 1)] = make_int2(id, int(i));
  }
}

// One corpus row held in a warp's registers: its dense values (lane l holds
// 16-byte words l, l + 32, ...), its ELL slots (lane p holds slot p) and, for
// int8 storage, its scale. The dense words are loaded evict-first (__ldcs):
// a row is used by one warp's run of pairs, and the chunk's query rows,
// read once per pair, should keep their place in L2 (1.82 -> 1.63 ms at the
// uniform descent chunk on an H100, examples/torch_fused_topk_ablation.py).
template <typename View>
struct HeldRow;

template <>
struct HeldRow<rt::CorpusView> {
  float4 d[kMaxVec];
  int si, fi;
  float sv, fv, scale;
  __device__ __forceinline__ void load(const rt::CorpusView& c, long long row, int lane) {
    const float4* c4 = reinterpret_cast<const float4*>(c.dense + size_t(row) * c.dd);
    const int n4 = c.dd >> 2;
#pragma unroll
    for (int u = 0; u < kMaxVec; ++u) {
      const int i = u * kWarp + lane;
      d[u] = i < n4 ? __ldcs(c4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    si = lane < c.ps ? __ldg(c.si + size_t(row) * c.ps + lane) : -1;
    sv = lane < c.ps ? __ldg(c.sv + size_t(row) * c.ps + lane) : 0.f;
    fi = lane < c.pf ? __ldg(c.fi + size_t(row) * c.pf + lane) : -1;
    fv = lane < c.pf ? __ldg(c.fv + size_t(row) * c.pf + lane) : 0.f;
    scale = 1.f;
  }
  // lane-partial dot with fp32 query row q (16-byte aligned)
  __device__ __forceinline__ float dot(const float* q, int dd, int lane) const {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int n4 = dd >> 2;
    float4 b[kMaxVec];
#pragma unroll
    for (int u = 0; u < kMaxVec; ++u) {
      const int i = u * kWarp + lane;
      b[u] = i < n4 ? __ldg(q4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxVec; ++u)
      acc += d[u].x * b[u].x + d[u].y * b[u].y + d[u].z * b[u].z + d[u].w * b[u].w;
    return acc;
  }
};

template <>
struct HeldRow<rt::CorpusViewQ8> {
  static constexpr int kWords = kMaxVec / 4;  // 16 int8 values a word: Dd <= 1024
  int4 d[kWords];
  int si, fi;
  float sv, fv, scale;
  __device__ __forceinline__ void load(const rt::CorpusViewQ8& c, long long row, int lane) {
    const int4* c16 = reinterpret_cast<const int4*>(c.dense + size_t(row) * c.dd);
    const int n16 = c.dd >> 4;
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int i = u * kWarp + lane;
      d[u] = i < n16 ? __ldcs(c16 + i) : make_int4(0, 0, 0, 0);
    }
    si = lane < c.ps ? __ldg(c.si + size_t(row) * c.ps + lane) : -1;
    sv = lane < c.ps ? rt::ell_val(c.sv + size_t(row) * c.ps + lane) : 0.f;
    fi = lane < c.pf ? __ldg(c.fi + size_t(row) * c.pf + lane) : -1;
    fv = lane < c.pf ? rt::ell_val(c.fv + size_t(row) * c.pf + lane) : 0.f;
    scale = __ldg(c.scale + row);
  }
  __device__ __forceinline__ float dot(const float* q, int dd, int lane) const {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int n16 = dd >> 4;
    float4 b[4 * kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int i = u * kWarp + lane;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b[4 * u + e] = i < n16 ? __ldg(q4 + 4 * i + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kWords; ++u)
      acc += rt::dot4_i8(d[u].x, b[4 * u]) + rt::dot4_i8(d[u].y, b[4 * u + 1]) +
             rt::dot4_i8(d[u].z, b[4 * u + 2]) + rt::dot4_i8(d[u].w, b[4 * u + 3]);
    return acc;
  }
};

// Scoring: warp w takes sorted pairs [w P, (w + 1) P); the row stays in its
// registers while the id repeats, and each pair's query row comes from L2.
template <typename View>
__global__ void __launch_bounds__(kScoreWarps * kWarp) fused_topk_score_kernel(
    QueryArgs qa, View corpus, int C, const float* __restrict__ bias, Workspace w) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long j0 = ((long long)blockIdx.x * kScoreWarps + threadIdx.x / kWarp) * kPairsPerWarp;
  const int total = w.start[corpus.n];
  if (j0 >= total) return;
  const long long j1 = min(j0 + kPairsPerWarp, (long long)total);
  HeldRow<View> row;
  int cur = -1;
  for (long long j = j0; j < j1; ++j) {
    const int2 pr = w.sorted[j];
    if (pr.x != cur) {
      row.load(corpus, pr.x, lane);
      cur = pr.x;
    }
    const int b = pr.y / C;
    const size_t qo = size_t(b) * kMaxSlots + lane;
    const int ns = w.qn[2 * b], nf = w.qn[2 * b + 1];
    const int qs = lane < ns ? w.qsid[qo] : kNoPos;
    const float qsv = lane < ns ? w.qsval[qo] : 0.f;
    const int qf = lane < nf ? w.qfid[qo] : kNoPos;
    const float qfv = lane < nf ? w.qfval[qo] : 0.f;
    float d = row.dot(qa.dense + size_t(b) * qa.dd, qa.dd, lane);
    float s = rt::lane_match(row.si, row.sv, qs, qsv, ns);
    float f = rt::lane_match(row.fi, row.fv, qf, qfv, nf);
    d = rt::finish(corpus, rt::warp_sum(d), row.scale);
    s = rt::warp_sum(s);
    f = rt::warp_sum(f);
    const float out = (d + s) + f;
    if (lane == 0) w.scores[pr.y] = out + (bias ? bias[pr.y] : 0.f);
  }
}

// Selection pass: one block per query row of the scores.
__global__ void __launch_bounds__(kSelectWarps * kWarp) fused_topk_select_kernel(
    Workspace w, int C, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float lists[select_smem_bytes(kSelectWarps) / 4];
  const int b = blockIdx.x;
  select_row(w.scores + size_t(b) * C, C, k, out_s + size_t(b) * k, out_i + size_t(b) * k, lists);
}

// ---- launch ---------------------------------------------------------------------

int one_pass_warps(int B, int C) {
  const int cap = B <= kSmallRows ? kOnePassMaxWarps : kOnePassWarps;
  return C < 1 ? 1 : (C > cap ? cap : C);
}

size_t one_pass_smem(int B, int dd, int psq, int pfq, int C) {
  return rt::query_cache_bytes(dd, psq, pfq) + size_t((C + 3) & ~3) * 4 +
         select_smem_bytes(one_pass_warps(B, C));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

unsigned grid_for(long long work, int per_block) {
  const long long g = (work + per_block - 1) / per_block;
  return unsigned(g < 1 ? 1 : (g > 132 * 32 ? 132 * 32 : g));
}

template <typename View>
int launch(const QueryArgs& qa, int B, const View& corpus, const int* ids, const float* bias,
           int C, int k, float* out_s, int* out_i, void* workspace, int device, void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (workspace == nullptr) {
    const size_t smem = one_pass_smem(B, qa.dd, qa.psq, qa.pfq, C);
    if (cudaError_t e = allow_smem(fused_topk_kernel<View>, smem); e != cudaSuccess) return int(e);
    fused_topk_kernel<View><<<B, one_pass_warps(B, C) * kWarp, smem, st>>>(
        qa, corpus, ids, bias, C, k, out_s, out_i);
    return int(cudaGetLastError());
  }
  Workspace w;
  carve_workspace(static_cast<char*>(workspace), B, C, corpus.n, &w);
  const long long pairs = (long long)B * C, n = corpus.n;
  const int tiles = int((n + kScanTile - 1) / kScanTile);
  if (cudaError_t e = cudaMemsetAsync(w.count, 0, size_t(n) * 4, st); e != cudaSuccess) return int(e);
  fused_topk_prep_kernel<<<(B + kPrepWarps - 1) / kPrepWarps, kPrepWarps * kWarp, 0, st>>>(qa, B, w);
  fused_topk_hist_kernel<<<grid_for(pairs, kCountThreads), kCountThreads, 0, st>>>(ids, pairs, n, w);
  fused_topk_tile_sum_kernel<<<tiles, kScanThreads, 0, st>>>(n, w);
  fused_topk_tile_scan_kernel<<<1, kScanThreads, 0, st>>>(tiles, n, w);
  fused_topk_tile_apply_kernel<<<tiles, kScanThreads, 0, st>>>(n, w);
  fused_topk_scatter_kernel<<<grid_for(pairs, kCountThreads), kCountThreads, 0, st>>>(ids, pairs, n, w);
  const long long warps = (pairs + kPairsPerWarp - 1) / kPairsPerWarp;
  fused_topk_score_kernel<View><<<unsigned((warps + kScoreWarps - 1) / kScoreWarps),
                                  kScoreWarps * kWarp, 0, st>>>(qa, corpus, C, bias, w);
  fused_topk_select_kernel<<<B, kSelectWarps * kWarp, 0, st>>>(w, C, k, out_s, out_i);
  return int(cudaGetLastError());
}

}  // namespace

// Shared memory of the one-pass form (bytes per block): the wrapper checks it.
extern "C" size_t fused_topk_smem_bytes(int B, int dd, int psq, int pfq, int C) {
  return one_pass_smem(B, dd, psq, pfq, C);
}

// Workspace of the ordered form (bytes); it takes ELL widths <= 32 and dense
// rows of <= 8 16-byte words a lane, 16-byte aligned (the wrapper checks).
extern "C" size_t fused_topk_workspace_bytes(int B, int C, long long n) {
  return carve_workspace(nullptr, B, C, n, nullptr);
}

extern "C" int fused_topk_ordered_max_dd() { return kMaxVec * kWarp * 4; }

// workspace == NULL: the one-pass form; else the ordered form in the
// caller's fused_topk_workspace_bytes(B, C, n) bytes (256-byte aligned).
extern "C" int fused_topk_launch(const float* qd, const int* qsi, const float* qsv,
                                 const int* qfi, const float* qfv, int B, int dd, int psq,
                                 int pfq, const float* cd, const int* csi, const float* csv,
                                 const int* cfi, const float* cfv, long long n, int psc,
                                 int pfc, int vec, const int* ids, const float* bias, int C,
                                 int k, float* out_s, int* out_i, void* workspace, int device,
                                 void* stream) {
  const QueryArgs qa{qd, qsi, qsv, qfi, qfv, dd, psq, pfq};
  const rt::CorpusView corpus{cd, csi, csv, cfi, cfv, n, dd, psc, pfc, vec};
  return launch(qa, B, corpus, ids, bias, C, k, out_s, out_i, workspace, device, stream);
}

// int8 storage: cd int8 (N, Dd), cscale float32 (N,), csv/cfv float16.
extern "C" int fused_topk_q8_launch(const float* qd, const int* qsi, const float* qsv,
                                    const int* qfi, const float* qfv, int B, int dd, int psq,
                                    int pfq, const int8_t* cd, const float* cscale,
                                    const int* csi, const __half* csv, const int* cfi,
                                    const __half* cfv, long long n, int psc, int pfc, int vec,
                                    const int* ids, const float* bias, int C, int k,
                                    float* out_s, int* out_i, void* workspace, int device,
                                    void* stream) {
  const QueryArgs qa{qd, qsi, qsv, qfi, qfv, dd, psq, pfq};
  const rt::CorpusViewQ8 corpus{cd, cscale, csi, csv, cfi, cfv, n, dd, psc, pfc, vec};
  return launch(qa, B, corpus, ids, bias, C, k, out_s, out_i, workspace, device, stream);
}
