// Hybrid distance by id: out[b, c] = score(query b, corpus row ids[b, c]).
//
// Replaces repro/kernels/hybrid_distance.py::hybrid_distance_pallas, both its
// fp32 form and its int8 (`has_scale`) form. The TPU kernel scored a gathered
// (B, C, Dd) copy of the candidate rows; here each warp gathers its rows by
// id, so no gathered copy exists. PAD ids (and any id outside [0, N)) are not
// read and score -inf, the masking of repro's ops.hybrid_scores_vs_ids.
//
// Bound on the H100: bytes. Each live candidate costs one dense row read
// (4 KB in fp32, 1 KB in int8 at Dd = 1024) plus its ELL slots, against
// ~2 Dd flops. Both forms score a row with the shared row scorer
// (rt::score_row, common.cuh; fused_topk.cu scores with it too), which puts
// every load of the row in flight before any lookup. The wrapper picks the
// form by C (SMALL_C_MAX in kernels/hybrid_distance.py):
//
// * warp form (C up to SMALL_C_MAX: the build's self scores and per-path
//   norms at C = 1, entry scoring at C = 16, the final re-score at C = 80):
//   a warp owns one query row, holds its dense
//   words in registers (32 floats a lane at Dd = 1024) and its ELL rows
//   sorted across its lanes (rt::WarpQuery), and scores the row's candidates
//   c = part, part + split, ...; no shared memory and no block barrier. (A
//   block staging the query took two thirds of the self scores' time: 4.42
//   ms, 1.47 without the staging, on an H100,
//   examples/torch_pairwise_tile_ablation.py.) Where B query rows are too
//   few warps to fill the card, `split` warps share a query row's
//   candidates (each re-reads the query, from L2).
// * block form (large C, such as 2,048 x 1,032 ids): a block per query row
//   stages it once in shared memory (rt::stage_query: its ELL rows sorted by
//   a warp each) and its warps take the candidates, 4 a warp per block of up
//   to 32.
//
// The int8 form multiplies the reduced dense sum by the row scale once and
// widens fp16 ELL values in registers; the storage type enters only through
// the view (rt::CorpusView / rt::CorpusViewQ8). Each score is one warp's
// fixed-order sum: repeated launches give the same bits.

#include "common.cuh"

namespace {

using rt::kWarp;
using rt::QueryArgs;

constexpr int kWarpFormWarps = 8;   // warp form: query rows (or parts of one) a block
constexpr int kWarpsPerSm = 16;     // warp form: warps a launch aims at an SM (else rows split)
constexpr int kBlockWarps = 8;      // block form: warps a block at most

template <typename View>
__global__ void __launch_bounds__(kWarpFormWarps * kWarp) hybrid_distance_warp_kernel(
    QueryArgs qa, View corpus, const int* __restrict__ ids, int B, int C, int split,
    float* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long w = (long long)blockIdx.x * kWarpFormWarps + threadIdx.x / kWarp;
  if (w >= (long long)B * split) return;
  const int b = int(w / split), part = int(w % split);
  rt::WarpQuery<View> q;
  q.load(qa, b, lane);
  for (int c = part; c < C; c += split) {
    const size_t o = size_t(b) * C + c;
    const int id = ids[o];
    const float v = (id < 0 || id >= corpus.n) ? -INFINITY : rt::score_row(corpus, q, id, lane);
    if (lane == 0) out[o] = v;
  }
}

template <typename View>
__global__ void __launch_bounds__(kBlockWarps * kWarp) hybrid_distance_kernel(
    QueryArgs qa, View corpus, const int* __restrict__ ids, int C, int cand_per_block,
    float* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x;
  const rt::QueryCache q = rt::carve_query_cache(smem, qa.dd, qa.psq, qa.pfq);
  rt::stage_query(q, qa, b);

  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int c0 = blockIdx.y * cand_per_block;
  const int c1 = min(C, c0 + cand_per_block);
  for (int c = c0 + warp; c < c1; c += nwarps) {
    const size_t o = size_t(b) * C + c;
    const int id = ids[o];
    const float v = (id < 0 || id >= corpus.n) ? -INFINITY : rt::score_row(corpus, q, id, lane);
    if (lane == 0) out[o] = v;
  }
}

// Warps sharing one query row's candidates in the warp form: enough warps
// for kWarpsPerSm a SM, at most one a candidate.
int warp_split(int B, int C, int device) {
  static int sms_of[64];  // per device, read once
  int& sms = sms_of[device & 63];
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms = 132;
  const long long want = (long long)sms * kWarpsPerSm;
  const long long s = (want + B - 1) / B;
  return int(s < 1 ? 1 : (s > C ? C : s));
}

template <typename View>
int launch(const QueryArgs& qa, int B, const View& corpus, const int* ids, int C, int warp_form,
           float* out, int device, void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp_form) {
    const int split = warp_split(B, C, device);
    const long long warps = (long long)B * split;
    hybrid_distance_warp_kernel<View>
        <<<unsigned((warps + kWarpFormWarps - 1) / kWarpFormWarps), kWarpFormWarps * kWarp, 0,
           st>>>(qa, corpus, ids, B, C, split, out);
    return int(cudaGetLastError());
  }
  int warps = C < kBlockWarps ? C : kBlockWarps;
  if (warps < 1) warps = 1;
  const int cand_per_block = warps * 4;
  dim3 grid(B, (C + cand_per_block - 1) / cand_per_block);
  const size_t smem = rt::query_cache_bytes(qa.dd, qa.psq, qa.pfq);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hybrid_distance_kernel<View>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
    if (e != cudaSuccess) return int(e);
  }
  hybrid_distance_kernel<View><<<grid, warps * kWarp, smem, st>>>(qa, corpus, ids, C,
                                                                   cand_per_block, out);
  return int(cudaGetLastError());
}

}  // namespace

// warp_form != 0: a warp per query row (the caller has checked that the
// operands fit it: 16-byte query and corpus rows, Dd <= 32 lanes x
// rt::kQueryWords x 4 floats, query ELL widths <= 32); else the block form.
extern "C" int hybrid_distance_launch(const float* qd, const int* qsi, const float* qsv,
                                      const int* qfi, const float* qfv, int B, int dd,
                                      int psq, int pfq, const float* cd, const int* csi,
                                      const float* csv, const int* cfi, const float* cfv,
                                      long long n, int psc, int pfc, int vec,
                                      const int* ids, int C, int warp_form, float* out,
                                      int device, void* stream) {
  const QueryArgs qa{qd, qsi, qsv, qfi, qfv, dd, psq, pfq};
  const rt::CorpusView corpus{cd, csi, csv, cfi, cfv, n, dd, psc, pfc, vec};
  return launch(qa, B, corpus, ids, C, warp_form, out, device, stream);
}

// int8 storage: cd int8 (N, Dd), cscale float32 (N,), csv/cfv float16.
extern "C" int hybrid_distance_q8_launch(const float* qd, const int* qsi, const float* qsv,
                                         const int* qfi, const float* qfv, int B, int dd,
                                         int psq, int pfq, const int8_t* cd, const float* cscale,
                                         const int* csi, const __half* csv, const int* cfi,
                                         const __half* cfv, long long n, int psc, int pfc,
                                         int vec, const int* ids, int C, int warp_form,
                                         float* out, int device, void* stream) {
  const QueryArgs qa{qd, qsi, qsv, qfi, qfv, dd, psq, pfq};
  const rt::CorpusViewQ8 corpus{cd, cscale, csi, csv, cfi, cfv, n, dd, psc, pfc, vec};
  return launch(qa, B, corpus, ids, C, warp_form, out, device, stream);
}
