// Hybrid distance by id: out[b, c] = score(query b, corpus row ids[b, c]).
//
// Replaces repro/kernels/hybrid_distance.py::hybrid_distance_pallas (fp32).
// The TPU kernel scored a gathered (B, C, Dd) copy of the candidate rows; here
// a block gathers its own rows by id, so no gathered copy exists. PAD ids
// (and any id outside [0, N)) are not read and score -inf, the masking of
// repro's ops.hybrid_scores_vs_ids.
//
// Bound on the H100: bytes. Each live candidate costs one Dd-float row read
// (4 KB at Dd = 1024) against ~2 Dd flops. Design: one warp per candidate,
// coalesced float4 loads of the row, the query row cached once per block in
// shared memory (dense values plus sorted ELL ids for the binary-search
// intersection), one warp-shuffle reduction per path.
//
// Grid: x = query row b (no 65535 limit, so B may be the whole corpus for the
// self-score pass), y = tile of up to 4 * warps candidates.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) hybrid_distance_kernel(
    const float* __restrict__ qd, const int* __restrict__ qsi, const float* __restrict__ qsv,
    const int* __restrict__ qfi, const float* __restrict__ qfv, int psq, int pfq,
    rt::CorpusView corpus, const int* __restrict__ ids, int C, int cand_per_block,
    float* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x;
  rt::QueryCache q = rt::carve_query_cache(smem, corpus.dd, psq, pfq);
  rt::load_query(q, b, qd, qsi, qsv, qfi, qfv, corpus.dd, psq, pfq);

  const int lane = threadIdx.x & (rt::kWarp - 1);
  const int warp = threadIdx.x / rt::kWarp;
  const int nwarps = blockDim.x / rt::kWarp;
  const int c0 = blockIdx.y * cand_per_block;
  const int c1 = min(C, c0 + cand_per_block);
  for (int c = c0 + warp; c < c1; c += nwarps) {
    const size_t o = size_t(b) * C + c;
    const int id = ids[o];
    float v;
    if (id < 0 || id >= corpus.n) {
      v = -INFINITY;
    } else {
      v = rt::warp_score(q, corpus, id, lane);
    }
    if (lane == 0) out[o] = v;
  }
}

}  // namespace

extern "C" int hybrid_distance_launch(const float* qd, const int* qsi, const float* qsv,
                                      const int* qfi, const float* qfv, int B, int dd,
                                      int psq, int pfq, const float* cd, const int* csi,
                                      const float* csv, const int* cfi, const float* cfv,
                                      long long n, int psc, int pfc, int vec4,
                                      const int* ids, int C, float* out,
                                      int device, void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  int warps = C < 8 ? C : 8;
  if (warps < 1) warps = 1;
  const int cand_per_block = warps * 4;
  dim3 grid(B, (C + cand_per_block - 1) / cand_per_block);
  const size_t smem = rt::query_cache_bytes(dd, psq, pfq);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hybrid_distance_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
    if (e != cudaSuccess) return int(e);
  }
  rt::CorpusView corpus{cd, csi, csv, cfi, cfv, n, dd, psc, pfc, vec4};
  hybrid_distance_kernel<<<grid, warps * rt::kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      qd, qsi, qsv, qfi, qfv, psq, pfq, corpus, ids, C, cand_per_block, out);
  return int(cudaGetLastError());
}
