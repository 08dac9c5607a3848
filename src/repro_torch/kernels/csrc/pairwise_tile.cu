// Candidate-pairwise hybrid scores by id: for each node c, the (K, K) matrix
// out[c, i, j] = (dense + learned) + lexical score of rows ids[c, i] and
// ids[c, j].
//
// Replaces repro/kernels/pairwise_tile.py::pairwise_tile_pallas. The caller
// passes ids already in [0, N) (repro gathers PAD ids as row 0 and masks the
// columns itself); ids outside that range are clamped here for memory safety.
// No masking inside the kernel.
//
// Bound on the H100: at K = 32 and Dd = 1024 a node reads 128 KB of rows and
// does 2 K^2 Dd = 2 Mflop, ~16 flop per byte: on uniform ids bytes bound it
// (0.044 ms a 1,024-node chunk), but a real prune chunk's kNN lists share
// hub rows (11,611 unique rows of 32,768 slots), so its rows take 0.017 ms
// and its fp32 FMAs 0.032 ms. Design, one node's K x K tile as a small GEMM
// fed by asynchronous copies:
//
// * persistent blocks of 4 warps, as many as fit the SMs, each walking its
//   nodes; the K rows come over Dd in a ring of kStages shared-memory stages
//   of kBK floats a row (16-byte cp.async), and the ring runs on across a
//   block's nodes, so the next node's rows load under this node's epilogue;
// * the Gram X X^T on the tensor cores: mma.sync m16n8k8 in TF32 with each
//   operand split hi + lo and three products (lo hi, hi lo, hi hi) into an
//   fp32 partial per stage (3xTF32: ~2^-21 of each product lost; one TF32
//   product keeps ~3 digits, too few for TOL = 1e-4 and the RNG-IP detour
//   tests);
//   operands by ldmatrix from the fp32 stage (mma.cuh); a warp owns one
//   16-row block and up to 8 of the 8-column blocks;
// * each ELL row is sorted once per node by a warp (a bitonic sort over the
//   lanes), live ids first and dead slots padded with kNoPos to a power of
//   two, so a lookup is a fixed-step binary search;
// * a thread per pair i <= j (the sparse part is symmetric) intersects the
//   two sorted rows: row i's live entries in order, each looked up in row j
//   by a fixed-step binary search, kLookups of them in flight, summed in
//   that order, so identical rows give identical outputs and repeated
//   launches the same bits (no float atomics). The pairs go in rounds of a
//   thread each, spread over the node's tiles after the first, so the
//   lookups run under the MMAs and the copies instead of after them. (A
//   warp per pair, every lane searching one row and the warp summing by
//   shuffles, ran the chunk 1.55x slower on an H100;
//   examples/torch_pairwise_tile_ablation.py);
// * the node's (K, K) scores are assembled in shared memory and written out
//   in full rows.

#include "common.cuh"
#include "mma.cuh"

namespace {

using rt::kFull;
using rt::kNoPos;
using rt::kWarp;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxK = 64;
constexpr int kBK = 64;        // floats of each row a ring stage holds
constexpr int kLd = kBK + 4;   // a stage row's stride: 272 bytes, an odd multiple of 16
constexpr int kStages = 3;

struct Params {
  const float* cd;
  const int* csi;
  const float* csv;
  const int* cfi;
  const float* cfv;
  long long n;
  int dd, ps, pf;
  int vec;  // dense rows 16-byte aligned and dd % 4 == 0: 16-byte copies
  const int* ids;
  int nodes, K;
  float* out;
};

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// A block's shared memory: the ring (kStages x Kp rows of kLd floats), the
// sorted ELL rows of the node being scored (psp / pfp slots at a stride of
// one more, so searches in different rows fall in different banks), the (K,
// K) scores (stride K + 1) and the pair table. Small, so that many blocks
// share an SM: each phase of a node (copies, MMAs, sorting, lookups) waits
// on latency, and other blocks' phases fill those waits.
struct Layout {
  int kp, tiles, psp, pfp;
  size_t sorted, gram, sums, pairs, bytes;
};

__host__ __device__ inline Layout layout(int K, int dd, int ps, int pf) {
  Layout l;
  l.kp = (K + 15) / 16 * 16;
  l.tiles = dd > 0 ? (dd + kBK - 1) / kBK : 1;
  l.psp = pow2_at_least(ps);
  l.pfp = pow2_at_least(pf);
  l.sorted = rt::align16(size_t(kStages) * l.kp * kLd * 4);
  l.gram = l.sorted + rt::align16(size_t(K) * (l.psp + l.pfp + 2) * 8);
  l.sums = l.gram + rt::align16(size_t(K) * (K + 1) * 4);
  l.pairs = l.sums + rt::align16(size_t(K) * (K + 1) * 4);
  l.bytes = l.pairs + rt::align16(size_t(K) * (K + 1) / 2 * 2);
  return l;
}

struct Smem {
  float* ring;
  int* sid;
  float* sval;
  int* fid;
  float* fval;
  float* gram;
  float* sums;  // per pair: the learned and the lexical product
  unsigned short* pairs;
};

__device__ __forceinline__ Smem carve(char* base, const Layout& l, int K) {
  Smem s;
  s.ring = reinterpret_cast<float*>(base);
  s.sid = reinterpret_cast<int*>(base + l.sorted);
  s.sval = reinterpret_cast<float*>(s.sid + K * (l.psp + 1));
  s.fid = reinterpret_cast<int*>(s.sval + K * (l.psp + 1));
  s.fval = reinterpret_cast<float*>(s.fid + K * (l.pfp + 1));
  s.gram = reinterpret_cast<float*>(base + l.gram);
  s.sums = reinterpret_cast<float*>(base + l.sums);
  s.pairs = reinterpret_cast<unsigned short*>(base + l.pairs);
  return s;
}

__device__ __forceinline__ long long row_of(const int* nid, int r, long long n) {
  long long row = __ldg(nid + r);
  return row < 0 ? 0 : (row >= n ? n - 1 : row);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Issue the copies of ring tile gt (a block's tiles in order: node by node,
// kBK floats of Dd a tile) into stage gt % kStages; with a node's first tile
// its ELL rows are prefetched into L2, to be sorted from there.
__device__ __forceinline__ void issue(const Params& p, const Layout& l, const Smem& s,
                                      long long gt) {
  const int it = int(gt / l.tiles), t = int(gt % l.tiles);
  const long long node = blockIdx.x + (long long)it * gridDim.x;
  const int* nid = p.ids + node * p.K;
  float* stage = s.ring + size_t(gt % kStages) * l.kp * kLd;
  const int d0 = t * kBK;
  if (p.vec) {
    constexpr int kChunks = kBK / 4;
    for (int c = threadIdx.x; c < l.kp * kChunks; c += kThreads) {
      const int r = c / kChunks, x = (c % kChunks) * 4;
      const bool fill = r < p.K && d0 + x < p.dd;
      const float* src = fill ? p.cd + size_t(row_of(nid, r, p.n)) * p.dd + d0 + x : p.cd;
      mma::cp_async<16>(stage + r * kLd + x, src, fill);
    }
  } else {
    for (int c = threadIdx.x; c < l.kp * kBK; c += kThreads) {
      const int r = c / kBK, x = c % kBK;
      const bool fill = r < p.K && d0 + x < p.dd;
      const float* src = fill ? p.cd + size_t(row_of(nid, r, p.n)) * p.dd + d0 + x : p.cd;
      mma::cp_async<4>(stage + r * kLd + x, src, fill);
    }
  }
  if (t != 0) return;
  for (int r = threadIdx.x; r < p.K; r += kThreads) {
    const long long row = row_of(nid, r, p.n);
    prefetch_l2(p.csi + row * p.ps);
    prefetch_l2(p.csv + row * p.ps);
    prefetch_l2(p.cfi + row * p.pf);
    prefetch_l2(p.cfv + row * p.pf);
  }
}

// ---- sorting ---------------------------------------------------------------------

constexpr int kSortRows = 4;  // rows a warp loads before it sorts them

// The warp's (key, v) of one ELL row, a slot a lane, sorted into pp <= 32
// slots: live ids ascending, then kNoPos (value 0).
__device__ __forceinline__ void sort_slots(int key, float v, int* sid, float* sval, int pp,
                                           int lane) {
  if (key < 0) {
    key = kNoPos;
    v = 0.f;
  }
  rt::warp_bitonic(key, v, lane);
  if (lane < pp) {
    sid[lane] = key;
    sval[lane] = v;
  }
}

// ELL rows wider than 32 slots: rank-sorted by the warp, then padded.
__device__ __forceinline__ void sort_wide(const int* idx, const float* val, int P, int* sid,
                                          float* sval, int pp, int lane) {
  const int n = rt::warp_sort_ell(idx, val, P, sid, sval, lane);
  for (int q = n + lane; q < pp; q += kWarp) {
    sid[q] = kNoPos;
    sval[q] = 0.f;
  }
}

// The node's 2K ELL rows sorted into shared memory, a warp per row, straight
// from global memory (prefetched into L2 with the node's first tile): each
// warp loads kSortRows rows of both paths before it sorts any.
__device__ __forceinline__ void sort_node_ell(const Params& p, const Smem& sm, const int* nid,
                                              int psp, int pfp) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int K = p.K, ps = p.ps, pf = p.pf;
  if (ps > kWarp || pf > kWarp) {
    for (int r = warp; r < K; r += kWarps) {
      const long long row = row_of(nid, r, p.n);
      sort_wide(p.csi + row * ps, p.csv + row * ps, ps, sm.sid + r * (psp + 1),
                sm.sval + r * (psp + 1), psp, lane);
      sort_wide(p.cfi + row * pf, p.cfv + row * pf, pf, sm.fid + r * (pfp + 1),
                sm.fval + r * (pfp + 1), pfp, lane);
    }
    return;
  }
  for (int r0 = warp; r0 < K; r0 += kWarps * kSortRows) {
    int sk[kSortRows], fk[kSortRows];
    float sv[kSortRows], fv[kSortRows];
#pragma unroll
    for (int m = 0; m < kSortRows; ++m) {
      const int r = r0 + m * kWarps;
      const long long row = r < K ? row_of(nid, r, p.n) : 0;
      const bool s_in = r < K && lane < ps, f_in = r < K && lane < pf;
      sk[m] = s_in ? __ldg(p.csi + row * ps + lane) : -1;
      sv[m] = s_in ? __ldg(p.csv + row * ps + lane) : 0.f;
      fk[m] = f_in ? __ldg(p.cfi + row * pf + lane) : -1;
      fv[m] = f_in ? __ldg(p.cfv + row * pf + lane) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kSortRows; ++m) {
      const int r = r0 + m * kWarps;
      if (r < K) {
        sort_slots(sk[m], sv[m], sm.sid + r * (psp + 1), sm.sval + r * (psp + 1), psp, lane);
        sort_slots(fk[m], fv[m], sm.fid + r * (pfp + 1), sm.fval + r * (pfp + 1), pfp, lane);
      }
    }
  }
}

// ---- the Gram ------------------------------------------------------------------------

// A warp's output blocks: 16-row block mt, 8-column blocks nt0 + u nstep for
// u < ntiles. Kp <= 16: warps 0-1 take one column block each; Kp = 32: a row
// block and two column blocks each; Kp > 32: warp w row block w, every column
// block.
struct Tiles {
  int mt, nt0, nstep, ntiles;
};

__device__ __forceinline__ Tiles warp_tiles(int kp, int warp) {
  const int rows = kp / 16, cols = kp / 8;
  const int groups = rows <= 2 ? rows : kWarps;
  Tiles w;
  w.mt = warp % groups;
  w.nstep = kWarps / groups;
  w.nt0 = warp / groups;
  w.ntiles = w.mt < rows && w.nt0 < cols ? (cols - w.nt0 + w.nstep - 1) / w.nstep : 0;
  return w;
}

// acc += the stage's kBK columns of X X^T over the warp's blocks (3xTF32).
// The tensor cores round each fp32 sum toward zero; summed into one
// accumulator over all of Dd (384 MMAs at Dd 1024) that bias reaches ~1e-5
// of the result, so each stage sums into a fresh partial that is added to
// acc once, rounded to nearest.
template <int T>
__device__ __forceinline__ void gram_step(const float* tile, const Tiles& w, float (&acc)[T][4],
                                          int lane) {
  if (w.ntiles == 0) return;
  const float* arow = tile + (w.mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                      (lane >> 4) * 4;
  float part[T][4];
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[u][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kBK; k0 += 8) {
    uint32_t a[4], ahi[4], alo[4];
    mma::ldmatrix_x4(a, arow + k0);
#pragma unroll
    for (int e = 0; e < 4; ++e) mma::split_tf32(a[e], ahi[e], alo[e]);
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (u < w.ntiles) {
        const float* brow = tile + ((w.nt0 + u * w.nstep) * 8 + (lane & 7)) * kLd +
                            ((lane >> 3) & 1) * 4;
        uint32_t b[2], bhi[2], blo[2];
        mma::ldmatrix_x2(b, brow + k0);
        mma::split_tf32(b[0], bhi[0], blo[0]);
        mma::split_tf32(b[1], bhi[1], blo[1]);
        mma::mma_tf32(part[u], alo, bhi[0], bhi[1]);
        mma::mma_tf32(part[u], ahi, blo[0], blo[1]);
        mma::mma_tf32(part[u], ahi, bhi[0], bhi[1]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] += part[u][e];
}

// The warp's blocks into gram (stride K + 1); acc zeroed for the next node.
template <int T>
__device__ __forceinline__ void gram_store(float* gram, int K, const Tiles& w, float (&acc)[T][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if (u < w.ntiles) {
      const int i0 = w.mt * 16 + g, j0 = (w.nt0 + u * w.nstep) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1), j = j0 + (e & 1);
        if (i < K && j < K) gram[i * (K + 1) + j] = acc[u][e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  }
}

// ---- the sparse pairs --------------------------------------------------------------------

// Position of the first id >= key in a sorted row of pp slots (a power of
// two, kNoPos-padded), or pp - 1; fixed steps.
__device__ __forceinline__ int lower_pos(const int* row, int pp, int key) {
  int pos = 0;
  for (int step = pp >> 1; step >= kWarp; step >>= 1)
    if (row[pos + step - 1] < key) pos += step;
#pragma unroll
  for (int step = kWarp / 2; step > 0; step >>= 1)
    if (step < pp && row[pos + step - 1] < key) pos += step;
  return pos;
}

// One path's sparse product of sorted rows i and j (pp slots, row stride ld):
// row i's live entries in order, each looked up in row j, kLookups at a time
// in flight, summed in that order.
constexpr int kLookups = 4;
__device__ __forceinline__ float pair_path(const int* sid, const float* sval, int pp, int ld,
                                           int i, int j) {
  const int* ri = sid + i * ld;
  const int* rj = sid + j * ld;
  const float* vi = sval + i * ld;
  const float* vj = sval + j * ld;
  float s = 0.f;
  for (int t0 = 0; t0 < pp && ri[t0] != kNoPos; t0 += kLookups) {
    float m[kLookups];
#pragma unroll
    for (int u = 0; u < kLookups; ++u) {
      const int t = t0 + u;
      const int key = t < pp ? ri[t] : kNoPos;
      const int pos = lower_pos(rj, pp, key);
      m[u] = key != kNoPos && rj[pos] == key ? vi[t] * vj[pos] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLookups; ++u) s += m[u];
  }
  return s;
}

// The sparse products of the node's pairs in round r (pairs r kThreads +
// tid, a thread each) into sums[2 p] (learned) and sums[2 p + 1] (lexical).
__device__ __forceinline__ void sparse_round(const Smem& sm, int K, int psp, int pfp, int r) {
  const int p = r * kThreads + threadIdx.x;
  if (p >= K * (K + 1) / 2) return;
  const int i = sm.pairs[p] >> 8, j = sm.pairs[p] & 0xff;
  sm.sums[2 * p] = pair_path(sm.sid, sm.sval, psp, psp + 1, i, j);
  sm.sums[2 * p + 1] = pair_path(sm.fid, sm.fval, pfp, pfp + 1, i, j);
}

// The upper triangle's pairs (i <= j) of K rows, row by row, as (i << 8) | j:
// filled once per block.
__device__ __forceinline__ void fill_pairs(unsigned short* pairs, int K) {
  for (int p = threadIdx.x; p < K * (K + 1) / 2; p += kThreads) {
    int i = 0, q = p;
    while (q >= K - i) {
      q -= K - i;
      ++i;
    }
    pairs[p] = (unsigned short)((i << 8) | (i + q));
  }
}

// gram[i][j] and gram[j][i] = (dense + learned) + lexical, a thread per pair
// i <= j (each entry of gram is one thread's).
__device__ __forceinline__ void add_sparse(const Smem& sm, int K) {
  for (int p = threadIdx.x; p < K * (K + 1) / 2; p += kThreads) {
    const int i = sm.pairs[p] >> 8, j = sm.pairs[p] & 0xff;
    const float s = sm.sums[2 * p], f = sm.sums[2 * p + 1];
    float* a = sm.gram + i * (K + 1) + j;
    *a = (*a + s) + f;
    if (j > i) {
      float* b = sm.gram + j * (K + 1) + i;
      *b = (*b + s) + f;
    }
  }
}

// ---- the kernel -------------------------------------------------------------------------

// T: 8-column blocks a warp owns at most (2 for K <= 32, 8 for K <= 64).
// A node's tiles each run one stage of the Gram and, from the second on, an
// even share of its rounds of sparse pairs (the sort at the first), so the
// lookups fill the time the MMAs and the ring's copies leave.
template <int T>
__global__ void __launch_bounds__(kThreads, T <= 2 ? 4 : 2) pairwise_tile_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  const int K = p.K;
  const Layout l = layout(K, p.dd, p.ps, p.pf);
  const int psp = l.psp, pfp = l.pfp;
  const int rounds = (K * (K + 1) / 2 + kThreads - 1) / kThreads;
  const Smem sm = carve(smem, l, K);
  const int lane = threadIdx.x & (kWarp - 1);
  const Tiles w = warp_tiles(l.kp, threadIdx.x / kWarp);
  float acc[T][4];
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

  fill_pairs(sm.pairs, K);  // read after the first barrier below
  const int mine = (p.nodes - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const long long total = (long long)mine * l.tiles;
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < total) issue(p, l, sm, g);
    mma::cp_async_commit();
  }
  long long gt = 0;
  for (int it = 0; it < mine; ++it) {
    const long long node = blockIdx.x + (long long)it * gridDim.x;
    for (int t = 0; t < l.tiles; ++t, ++gt) {
      mma::cp_async_wait<kStages - 2>();
      __syncthreads();  // tile gt landed, gt - 1's stage free; at t >= 1 the rows sorted
      if (gt + kStages - 1 < total) issue(p, l, sm, gt + kStages - 1);
      mma::cp_async_commit();
      if (t == 0) sort_node_ell(p, sm, p.ids + node * K, psp, pfp);
      gram_step<T>(sm.ring + size_t(gt % kStages) * l.kp * kLd, w, acc, lane);
      if (t > 0) {  // rounds [ceil((t - 1) R / (tiles - 1)), ceil(t R / (tiles - 1)))
        const int r1 = (t * rounds + l.tiles - 2) / (l.tiles - 1);
        for (int r = ((t - 1) * rounds + l.tiles - 2) / (l.tiles - 1); r < r1; ++r)
          sparse_round(sm, K, psp, pfp, r);
      }
    }
    if (l.tiles == 1) {
      __syncthreads();
      for (int r = 0; r < rounds; ++r) sparse_round(sm, K, psp, pfp, r);
    }
    gram_store<T>(sm.gram, K, w, acc, lane);
    __syncthreads();  // the Gram and the sparse sums complete
    add_sparse(sm, K);
    __syncthreads();
    float* o = p.out + node * K * K;
    for (int e = threadIdx.x; e < K * K; e += kThreads) {
      const int i = e / K;
      __stcs(o + e, sm.gram[i * (K + 1) + e - i * K]);
    }
  }
}

// The kernel for K, its dynamic shared memory allowed and the whole SM's
// shared memory preferred (the carveout), and how many of its blocks an SM
// holds.
cudaError_t prepare(int K, int dd, int ps, int pf, void (**kernel)(Params), size_t* smem,
                    int* per_sm) {
  *kernel = K <= 32 ? pairwise_tile_kernel<2> : pairwise_tile_kernel<8>;
  *smem = layout(K, dd, ps, pf).bytes;
  cudaError_t e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(*smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, *kernel, kThreads, *smem);
  return e;
}

}  // namespace

extern "C" int pairwise_tile_max_k() { return kMaxK; }

extern "C" size_t pairwise_tile_smem_bytes(int K, int dd, int ps, int pf) {
  return layout(K, dd, ps, pf).bytes;
}

// Blocks an SM holds at these sizes (the persistent grid is that many per
// SM), or -1 on an error.
extern "C" int pairwise_tile_blocks_per_sm(int K, int dd, int ps, int pf, int device) {
  if (cudaSetDevice(device) != cudaSuccess || K < 1 || K > kMaxK) return -1;
  void (*kernel)(Params);
  size_t smem;
  int per_sm = 0;
  return prepare(K, dd, ps, pf, &kernel, &smem, &per_sm) == cudaSuccess ? per_sm : -1;
}

extern "C" int pairwise_tile_launch(const float* cd, const int* csi, const float* csv,
                                    const int* cfi, const float* cfv, long long n, int dd,
                                    int ps, int pf, int vec, const int* ids, int nodes, int K,
                                    float* out, int device, void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  if (K < 1 || K > kMaxK || nodes < 1) return int(cudaErrorInvalidValue);
  const Params p{cd, csi, csv, cfi, cfv, n, dd, ps, pf, vec, ids, nodes, K, out};
  void (*kernel)(Params);
  size_t smem;
  int per_sm = 0, sms = 0;
  if (cudaError_t e = prepare(K, dd, ps, pf, &kernel, &smem, &per_sm); e != cudaSuccess)
    return int(e);
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      e != cudaSuccess)
    return int(e);
  const long long fit = (long long)(per_sm < 1 ? 1 : per_sm) * sms;
  kernel<<<unsigned(nodes < fit ? nodes : fit), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}
