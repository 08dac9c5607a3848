// Hybrid distance by id: out[b, c] = score(query b, corpus row ids[b, c]).
//
// Replaces repro/kernels/hybrid_distance.py::hybrid_distance_pallas, both its
// fp32 form and its int8 (`has_scale`) form. The TPU kernel scored a gathered
// (B, C, Dd) copy of the candidate rows; here a block gathers its own rows by
// id, so no gathered copy exists. PAD ids (and any id outside [0, N)) are not
// read and score -inf, the masking of repro's ops.hybrid_scores_vs_ids.
//
// Bound on the H100: bytes. Each live candidate costs one dense row read
// (4 KB in fp32, 1 KB in int8 at Dd = 1024) plus its ELL slots, against
// ~2 Dd flops. Design: one warp per candidate, coalesced 16-byte loads of the
// row, the query row cached once per block in shared memory (dense values
// plus sorted ELL ids for the binary-search intersection), one warp-shuffle
// reduction per path. The int8 form multiplies the reduced dense sum by the
// row scale once and widens fp16 ELL values in registers.
//
// Grid: x = query row b (no 65535 limit, so B may be the whole corpus for the
// self-score pass), y = tile of up to 4 * warps candidates.

#include "common.cuh"

namespace {

template <typename View>
__global__ void __launch_bounds__(256) hybrid_distance_kernel(
    const float* __restrict__ qd, const int* __restrict__ qsi, const float* __restrict__ qsv,
    const int* __restrict__ qfi, const float* __restrict__ qfv, int psq, int pfq,
    View corpus, const int* __restrict__ ids, int C, int cand_per_block,
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

template <typename View>
int launch(const float* qd, const int* qsi, const float* qsv, const int* qfi, const float* qfv,
           int B, int dd, int psq, int pfq, const View& corpus, const int* ids, int C,
           float* out, int device, void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  int warps = C < 8 ? C : 8;
  if (warps < 1) warps = 1;
  const int cand_per_block = warps * 4;
  dim3 grid(B, (C + cand_per_block - 1) / cand_per_block);
  const size_t smem = rt::query_cache_bytes(dd, psq, pfq);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hybrid_distance_kernel<View>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
    if (e != cudaSuccess) return int(e);
  }
  hybrid_distance_kernel<View><<<grid, warps * rt::kWarp, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      qd, qsi, qsv, qfi, qfv, psq, pfq, corpus, ids, C, cand_per_block, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int hybrid_distance_launch(const float* qd, const int* qsi, const float* qsv,
                                      const int* qfi, const float* qfv, int B, int dd,
                                      int psq, int pfq, const float* cd, const int* csi,
                                      const float* csv, const int* cfi, const float* cfv,
                                      long long n, int psc, int pfc, int vec,
                                      const int* ids, int C, float* out,
                                      int device, void* stream) {
  rt::CorpusView corpus{cd, csi, csv, cfi, cfv, n, dd, psc, pfc, vec};
  return launch(qd, qsi, qsv, qfi, qfv, B, dd, psq, pfq, corpus, ids, C, out, device, stream);
}

// int8 storage: cd int8 (N, Dd), cscale float32 (N,), csv/cfv float16.
extern "C" int hybrid_distance_q8_launch(const float* qd, const int* qsi, const float* qsv,
                                         const int* qfi, const float* qfv, int B, int dd,
                                         int psq, int pfq, const int8_t* cd, const float* cscale,
                                         const int* csi, const __half* csv, const int* cfi,
                                         const __half* cfv, long long n, int psc, int pfc,
                                         int vec, const int* ids, int C, float* out,
                                         int device, void* stream) {
  rt::CorpusViewQ8 corpus{cd, cscale, csi, csv, cfi, cfv, n, dd, psc, pfc, vec};
  return launch(qd, qsi, qsv, qfi, qfv, B, dd, psq, pfq, corpus, ids, C, out, device, stream);
}
