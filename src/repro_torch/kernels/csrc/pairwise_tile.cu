// Candidate-pairwise hybrid scores by id: for each node c, the (K, K) matrix
// out[c, i, j] = score(row ids[c, i], row ids[c, j]).
//
// Replaces repro/kernels/pairwise_tile.py::pairwise_tile_pallas. The caller
// passes ids already in [0, N) (repro gathers PAD ids as row 0 and masks the
// columns itself); ids outside that range are clamped here for memory safety.
// No masking inside the kernel.
//
// Bound on the H100: at K = 32 and Dd = 1024 a node reads 128 KB of rows and
// does 2 K^2 Dd = 2 Mflop, about 16 flop per byte, below the fp32 ridge
// (~20 flop/byte), so bytes bound it, with shared-memory traffic close
// behind. Design: one block per node; the K rows are loaded once, tiled over
// Dd through shared memory (coalesced row segments), and each thread keeps up
// to 16 (i, j) dense accumulators in registers across the tiles. Each row's
// ELL ids are rank-sorted once into shared memory; a pair's intersection
// walks row i's live ids and binary-searches row j's.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr int kMaxPairsPerThread = kMaxK * kMaxK / kThreads;  // 16
constexpr int kTileD = 128;
constexpr int kRowStride = kTileD + 1;  // +1 float: no bank conflicts across rows

struct PairSmem {
  float* tile;   // K x kRowStride
  int* sid;      // K x ps
  float* sval;   // K x ps
  int* fid;      // K x pf
  float* fval;   // K x pf
  int* ns;       // K
  int* nf;       // K
  long long* rows;  // K
};

__host__ __device__ inline size_t pair_smem_bytes(int K, int ps, int pf) {
  return rt::align16(size_t(K) * kRowStride * 4) + 2 * rt::align16(size_t(K) * ps * 4) +
         2 * rt::align16(size_t(K) * pf * 4) + 2 * rt::align16(size_t(K) * 4) +
         rt::align16(size_t(K) * 8);
}

__device__ inline PairSmem carve(char* base, int K, int ps, int pf) {
  PairSmem s;
  size_t off = 0;
  s.tile = reinterpret_cast<float*>(base + off); off += rt::align16(size_t(K) * kRowStride * 4);
  s.sid = reinterpret_cast<int*>(base + off);    off += rt::align16(size_t(K) * ps * 4);
  s.sval = reinterpret_cast<float*>(base + off); off += rt::align16(size_t(K) * ps * 4);
  s.fid = reinterpret_cast<int*>(base + off);    off += rt::align16(size_t(K) * pf * 4);
  s.fval = reinterpret_cast<float*>(base + off); off += rt::align16(size_t(K) * pf * 4);
  s.ns = reinterpret_cast<int*>(base + off);     off += rt::align16(size_t(K) * 4);
  s.nf = reinterpret_cast<int*>(base + off);     off += rt::align16(size_t(K) * 4);
  s.rows = reinterpret_cast<long long*>(base + off);
  return s;
}

// Sparse inner product of sorted rows i and j: walk i, binary-search j.
__device__ inline float pair_sparse(const int* sid, const float* sval, const int* cnt, int P,
                                    int i, int j) {
  const int* ai = sid + i * P;
  const float* av = sval + i * P;
  const int* bi = sid + j * P;
  const float* bv = sval + j * P;
  const int nb = cnt[j];
  float s = 0.f;
  for (int p = 0; p < cnt[i]; ++p) {
    const int h = rt::find_sorted(bi, nb, ai[p]);
    if (h >= 0) s += bv[h] * av[p];
  }
  return s;
}

__global__ void __launch_bounds__(kThreads) pairwise_tile_kernel(
    const float* __restrict__ cd, const int* __restrict__ csi, const float* __restrict__ csv,
    const int* __restrict__ cfi, const float* __restrict__ cfv, long long n, int dd, int ps,
    int pf, const int* __restrict__ ids, int K, float* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  PairSmem s = carve(smem, K, ps, pf);
  const int node = blockIdx.x;
  const int* nid = ids + size_t(node) * K;

  for (int r = threadIdx.x; r < K; r += kThreads) {
    long long row = nid[r];
    row = row < 0 ? 0 : (row >= n ? n - 1 : row);
    s.rows[r] = row;
  }
  __syncthreads();

  // sort each row's ELL ids once (one thread per entry: start t, stride P
  // visits entry t only); count live ids per row
  for (int e = threadIdx.x; e < K * ps; e += kThreads) {
    const int r = e / ps, t = e - r * ps;
    const int* ri = csi + size_t(s.rows[r]) * ps;
    const float* rv = csv + size_t(s.rows[r]) * ps;
    rt::rank_sort_row(ri, rv, ps, s.sid + r * ps, s.sval + r * ps, t, ps);
  }
  for (int e = threadIdx.x; e < K * pf; e += kThreads) {
    const int r = e / pf, t = e - r * pf;
    const int* ri = cfi + size_t(s.rows[r]) * pf;
    const float* rv = cfv + size_t(s.rows[r]) * pf;
    rt::rank_sort_row(ri, rv, pf, s.fid + r * pf, s.fval + r * pf, t, pf);
  }
  for (int r = threadIdx.x; r < K; r += kThreads) {
    s.ns[r] = rt::count_live(csi + size_t(s.rows[r]) * ps, ps);
    s.nf[r] = rt::count_live(cfi + size_t(s.rows[r]) * pf, pf);
  }

  const int kk = K * K;
  float acc[kMaxPairsPerThread];
#pragma unroll
  for (int m = 0; m < kMaxPairsPerThread; ++m) acc[m] = 0.f;

  for (int d0 = 0; d0 < dd; d0 += kTileD) {
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < K * kTileD; e += kThreads) {
      const int r = e / kTileD, x = e - r * kTileD;
      const int d = d0 + x;
      s.tile[r * kRowStride + x] = d < dd ? __ldg(cd + size_t(s.rows[r]) * dd + d) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kMaxPairsPerThread; ++m) {
      const int p = threadIdx.x + m * kThreads;
      if (p < kk) {
        const int i = p / K, j = p - (p / K) * K;
        const float* a = s.tile + i * kRowStride;
        const float* bb = s.tile + j * kRowStride;
        float t = 0.f;
#pragma unroll 8
        for (int x = 0; x < kTileD; ++x) t += a[x] * bb[x];
        acc[m] += t;
      }
    }
  }
  __syncthreads();  // sorted ELL rows visible (also when dd == 0)

#pragma unroll
  for (int m = 0; m < kMaxPairsPerThread; ++m) {
    const int p = threadIdx.x + m * kThreads;
    if (p < kk) {
      const int i = p / K, j = p - (p / K) * K;
      const float sp = pair_sparse(s.sid, s.sval, s.ns, ps, i, j);
      const float fp = pair_sparse(s.fid, s.fval, s.nf, pf, i, j);
      out[size_t(node) * kk + p] = (acc[m] + sp) + fp;
    }
  }
}

}  // namespace

extern "C" int pairwise_tile_max_k() { return kMaxK; }

extern "C" size_t pairwise_tile_smem_bytes(int K, int ps, int pf) {
  return pair_smem_bytes(K, ps, pf);
}

extern "C" int pairwise_tile_launch(const float* cd, const int* csi, const float* csv,
                                    const int* cfi, const float* cfv, long long n, int dd,
                                    int ps, int pf, const int* ids, int nodes, int K,
                                    float* out, int device, void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  if (K > kMaxK) return int(cudaErrorInvalidValue);
  const size_t smem = pair_smem_bytes(K, ps, pf);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pairwise_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  pairwise_tile_kernel<<<nodes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cd, csi, csv, cfi, cfv, n, dd, ps, pf, ids, K, out);
  return int(cudaGetLastError());
}
