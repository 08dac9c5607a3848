// Fused hybrid distance + top-k by id.
//
// Replaces repro/kernels/fused_topk.py::fused_topk_pallas: the fp32 form and
// the int8 (`has_scale`) form, bias on and off.
// For each query row b over candidate ids[b, 0..C): score = hybrid score +
// bias[b, c]; PAD ids (and ids outside [0, N)) are not read and score NEG.
// Returns the top k (descending) with their positions along C; ties go to the
// lowest position; slots with no live candidate hold (NEG, -1).
//
// Bound on the H100: bytes, as the distance kernel (one dense row read per
// live candidate: Dd floats, or Dd int8 values + a 4-byte scale). Design: one block per query row; each warp scores
// candidates (coalesced float4 loads, query row cached in shared memory,
// binary-search ELL intersection) into a shared-memory score row, so the
// (B, C) score matrix never reaches device memory. Selection is k rounds of a
// block arg-max keyed on (score desc, position asc), which gives exactly the
// lax.top_k tie order; a round that finds no score above NEG fills the rest
// with sentinels. No TPU lane padding: the output is (B, k). The storage type
// enters only through the row scorer (common.cuh, CorpusView / CorpusViewQ8).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / rt::kWarp;

// (v, p) beats (w, q) when v > w, or v == w and p < q.
__device__ __forceinline__ bool beats(float v, int p, float w, int q) {
  return v > w || (v == w && p < q);
}

template <typename View>
__global__ void __launch_bounds__(kThreads) fused_topk_kernel(
    const float* __restrict__ qd, const int* __restrict__ qsi, const float* __restrict__ qsv,
    const int* __restrict__ qfi, const float* __restrict__ qfv, int psq, int pfq,
    View corpus, const int* __restrict__ ids, const float* __restrict__ bias, int C,
    int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_p[kWarps];
  __shared__ int done;

  const int b = blockIdx.x;
  rt::QueryCache q = rt::carve_query_cache(smem, corpus.dd, psq, pfq);
  float* scores = reinterpret_cast<float*>(smem + rt::query_cache_bytes(corpus.dd, psq, pfq));
  rt::load_query(q, b, qd, qsi, qsv, qfi, qfv, corpus.dd, psq, pfq);

  const int lane = threadIdx.x & (rt::kWarp - 1);
  const int warp = threadIdx.x / rt::kWarp;
  for (int c = warp; c < C; c += kWarps) {
    const size_t o = size_t(b) * C + c;
    const int id = ids[o];
    float v;
    if (id < 0 || id >= corpus.n) {
      v = rt::kNeg;
    } else {
      v = rt::warp_score(q, corpus, id, lane);
      if (bias != nullptr) v += bias[o];
    }
    if (lane == 0) scores[c] = v;
  }
  if (threadIdx.x == 0) done = 0;
  __syncthreads();

  float* os = out_s + size_t(b) * k;
  int* oi = out_i + size_t(b) * k;
  for (int t = 0; t < k; ++t) {
    if (done) {  // block-uniform: read after the barrier that ended round t-1
      for (int u = t + threadIdx.x; u < k; u += kThreads) {
        os[u] = rt::kNeg;
        oi[u] = -1;
      }
      break;
    }
    float bv = -INFINITY;
    int bp = 0x7fffffff;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float v = scores[c];
      if (beats(v, c, bv, bp)) { bv = v; bp = c; }
    }
#pragma unroll
    for (int off = rt::kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (beats(ov, op, bv, bp)) { bv = ov; bp = op; }
    }
    if (lane == 0) { red_v[warp] = bv; red_p[warp] = bp; }
    __syncthreads();
    if (threadIdx.x == 0) {
      bv = red_v[0];
      bp = red_p[0];
      for (int w = 1; w < kWarps; ++w)
        if (beats(red_v[w], red_p[w], bv, bp)) { bv = red_v[w]; bp = red_p[w]; }
      if (bv > rt::kNeg) {
        os[t] = bv;
        oi[t] = bp;
        scores[bp] = -INFINITY;  // retire the winner
      } else {
        os[t] = rt::kNeg;
        oi[t] = -1;
        done = 1;
      }
    }
    __syncthreads();
  }
}

template <typename View>
int launch(const float* qd, const int* qsi, const float* qsv, const int* qfi, const float* qfv,
           int B, int dd, int psq, int pfq, const View& corpus, const int* ids,
           const float* bias, int C, int k, float* out_s, int* out_i, int device,
           void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  const size_t smem = rt::query_cache_bytes(dd, psq, pfq) + size_t(C) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_topk_kernel<View>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  fused_topk_kernel<View><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      qd, qsi, qsv, qfi, qfv, psq, pfq, corpus, ids, bias, C, k, out_s, out_i);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" size_t fused_topk_smem_bytes(int dd, int psq, int pfq, int C) {
  return rt::query_cache_bytes(dd, psq, pfq) + size_t(C) * 4;
}

extern "C" int fused_topk_launch(const float* qd, const int* qsi, const float* qsv,
                                 const int* qfi, const float* qfv, int B, int dd, int psq,
                                 int pfq, const float* cd, const int* csi, const float* csv,
                                 const int* cfi, const float* cfv, long long n, int psc,
                                 int pfc, int vec, const int* ids, const float* bias, int C,
                                 int k, float* out_s, int* out_i, int device, void* stream) {
  rt::CorpusView corpus{cd, csi, csv, cfi, cfv, n, dd, psc, pfc, vec};
  return launch(qd, qsi, qsv, qfi, qfv, B, dd, psq, pfq, corpus, ids, bias, C, k, out_s, out_i,
                device, stream);
}

// int8 storage: cd int8 (N, Dd), cscale float32 (N,), csv/cfv float16.
extern "C" int fused_topk_q8_launch(const float* qd, const int* qsi, const float* qsv,
                                    const int* qfi, const float* qfv, int B, int dd, int psq,
                                    int pfq, const int8_t* cd, const float* cscale,
                                    const int* csi, const __half* csv, const int* cfi,
                                    const __half* cfv, long long n, int psc, int pfc, int vec,
                                    const int* ids, const float* bias, int C, int k,
                                    float* out_s, int* out_i, int device, void* stream) {
  rt::CorpusViewQ8 corpus{cd, cscale, csi, csv, cfi, cfv, n, dd, psc, pfc, vec};
  return launch(qd, qsi, qsv, qfi, qfv, B, dd, psq, pfq, corpus, ids, bias, C, k, out_s, out_i,
                device, stream);
}
