// Flash-attention forward, fp32 route: O = softmax(scale * Q K^T [+ mask]) V and the
// row log-sum-exp, with GQA, an optional causal mask, and dk != dv.
//
// Replaces repro/kernels/flash_attention.py::_flash_fwd (_fwd_kernel). It
// computes what that kernel is meant to compute: fp32 accumulation and the
// online-softmax recurrence over key tiles, NEG_INF = -1e30, the causal mask
// row >= col (aligned top-left, as the Pallas kernel's), tiles wholly above
// the diagonal skipped, and l floored at 1e-30. Unlike the Pallas kernel it
// masks key columns >= S and ignores query rows >= L in a partial tile, so
// its result does not depend on the tile size (the Pallas kernel returns NaN
// there; ROADMAP Queue 3).
//
// Layout: q (B, H, L, dk), k (B, KV, S, dk), v (B, KV, S, dv), o (B, H, L, dv)
// given by element strides (the last dimension contiguous), so the model's
// (B, L, H, d) projections are read and written in place without a
// transposed copy; lse (B, H, L) float32, contiguous. Query head h reads kv
// head h / (H / KV).
//
// Route: the C entry point dispatches by dtype, a fixed rule and not a
// fallback. float32 runs this file's kernel on the CUDA cores (the fp32 gate
// of 1e-5 needs fp32 products); bfloat16 runs the tensor-core kernel of
// csrc/flash_attention_tc.cu (wgmma fed by TMA).
//
// Bound on the H100: operations. At the RAG prefill shape (B 64, H 32,
// L = S = 1088, d 64, causal) the work is ~3.1e11 flop over ~0.72 GB, about
// 430 flop per byte, above the bf16 ridge (~295); in fp32 on the CUDA cores
// (67 TFLOP/s) ~4.6 ms. Design: one block of 256 threads per
// (b, h, 64 query rows). The query tile and each 64-row K/V tile are staged
// in shared memory as float (rows padded to a float4 multiple). Each thread
// owns 4 query rows x 4 key columns of the score tile and 4 rows x 4 output
// columns per 64 of dv; the row max and sum live in registers and are reduced
// across the 16 threads of a row group by warp shuffles.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key/value rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows 4ty..4ty+3, tx columns
constexpr int kPad = 4;        // row padding: float4-aligned, spreads banks
constexpr int kMaxD = 256;     // dk, dv <= kMaxD (4 column groups of 64)
constexpr float kNegInf = -1e30f;

struct FlashParams {
  int B, H, KV, L, S, dk, dv;
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl;
  int causal;
  float scale;
};

inline __host__ __device__ size_t smem_floats(int dk, int dv) {
  return size_t(kBQ) * (dk + kPad) + size_t(kBK) * (dk + kPad) + size_t(kBK) * (dv + kPad) +
         size_t(kBQ) * (kBK + kPad);
}

// `rows` rows of width d starting at row0 of one head into shared memory
// (row stride ld); rows at or past `valid` are zero.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, long long sl, int row0,
                                          int valid, int d, float* dst, int ld, int rows) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = (row0 + r < valid) ? src[(long long)(row0 + r) * sl + c] : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// G: column groups of 64 output columns per thread (dv <= 64 G).
template <int G>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     FlashParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = p.dk + kPad, ldv = p.dv + kPad, ldp = kBK + kPad;
  float* sQ = smem;              // kBQ x ldk
  float* sK = sQ + kBQ * ldk;    // kBK x ldk
  float* sV = sK + kBK * ldk;    // kBK x ldv
  float* sP = sV + kBK * ldv;    // kBQ x ldp: this tile's exp(s - m)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const float* qh = q + b * p.q_sb + h * p.q_sh;
  const float* kh = k + b * p.k_sb + kvh * p.k_sh;
  const float* vh = v + b * p.v_sb + kvh * p.v_sh;

  load_tile(qh, p.q_sl, q0, p.L, p.dk, sQ, ldk, kBQ);

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }
  // causal: key tiles wholly above the diagonal (col > every row) are skipped
  const int last = p.causal ? min(p.S - 1, q0 + kBQ - 1) : p.S - 1;
  const int n_tiles = last / kBK + 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = t * kBK;
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    load_tile(kh, p.k_sl, s0, p.S, p.dk, sK, ldk, kBK);
    load_tile(vh, p.v_sl, s0, p.S, p.dv, sV, ldv, kBK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.dk; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * ldk + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * ldk + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qa[i], kb[j], s[i][j]);
    }

    // scale and mask; the tile's row max over the 16 threads of the row group
    unsigned valid = 0;
    float mt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      mt[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = s0 + tx + 16 * j;
        const bool ok = col < p.S && (!p.causal || row >= col);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        valid |= unsigned(ok) << (i * 4 + j);
        mt[i] = fmaxf(mt[i], s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], off));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], mt[i]);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ((valid >> (i * 4 + j)) & 1u) ? expf(s[i][j] - mn) : 0.f;
        rs += e;
        sP[(ty * 4 + i) * ldp + tx + 16 * j] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V over the whole tile: masked P entries and V rows past S are 0
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * ldp + kk);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c0 = g * 64 + tx * 4;
        if (c0 >= p.dv) continue;
        const float* vr = sV + kk * ldv + c0;
        const float4 v0 = *reinterpret_cast<const float4*>(vr);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + ldv);
        const float4 v2 = *reinterpret_cast<const float4*>(vr + 2 * ldv);
        const float4 v3 = *reinterpret_cast<const float4*>(vr + 3 * ldv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[i] + g * 4;
          a[0] = fmaf(pa[i].w, v3.x, fmaf(pa[i].z, v2.x, fmaf(pa[i].y, v1.x, fmaf(pa[i].x, v0.x, a[0]))));
          a[1] = fmaf(pa[i].w, v3.y, fmaf(pa[i].z, v2.y, fmaf(pa[i].y, v1.y, fmaf(pa[i].x, v0.y, a[1]))));
          a[2] = fmaf(pa[i].w, v3.z, fmaf(pa[i].z, v2.z, fmaf(pa[i].y, v1.z, fmaf(pa[i].x, v0.z, a[2]))));
          a[3] = fmaf(pa[i].w, v3.w, fmaf(pa[i].z, v2.w, fmaf(pa[i].y, v1.w, fmaf(pa[i].x, v0.w, a[3]))));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.L) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    float* orow = o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_sl;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c0 = g * 64 + tx * 4;
      if (c0 >= p.dv) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[c0 + e] = acc[i][g * 4 + e] / lf;
    }
    if (tx == 0) lse[((long long)b * p.H + h) * p.L + row] = m[i] + logf(lf);
  }
}

template <int G>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const FlashParams& p, void* stream) {
  const size_t smem = smem_floats(p.dk, p.dv) * sizeof(float);
  auto kern = flash_fwd_kernel<G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const dim3 grid((p.L + kBQ - 1) / kBQ, p.H, p.B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, p);
  return int(cudaGetLastError());
}

int launch_g(const void* q, const void* k, const void* v, void* o, float* lse,
             const FlashParams& p, void* stream) {
  switch ((p.dv + 63) / 64) {
    case 1: return launch<1>(q, k, v, o, lse, p, stream);
    case 2: return launch<2>(q, k, v, o, lse, p, stream);
    case 3: return launch<3>(q, k, v, o, lse, p, stream);
    case 4: return launch<4>(q, k, v, o, lse, p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// The tensor-core route (flash_attention_tc.cu).
size_t flash_fwd_tc_smem_bytes(int dk, int dv);
int flash_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                 int KV, int L, int S, int dk, int dv, long long q_sb, long long q_sh,
                 long long q_sl, long long k_sb, long long k_sh, long long k_sl, long long v_sb,
                 long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,
                 int causal, float scale, void* stream);

// dtype: 0 float32, 1 bfloat16.
extern "C" size_t flash_attention_smem_bytes(int dk, int dv, int dtype) {
  return dtype == 1 ? flash_fwd_tc_smem_bytes(dk, dv) : smem_floats(dk, dv) * sizeof(float);
}

extern "C" int flash_attention_max_d() { return kMaxD; }

// dtype: 0 float32, 1 bfloat16. dk and dv are multiples of 4, at most kMaxD;
// H is a multiple of KV. Strides are in elements; for bfloat16 the base
// pointers and every stride but the last are 16-byte aligned (TMA).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int KV,
    int L, int S, int dk, int dv, long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl, long long v_sb, long long v_sh,
    long long v_sl, long long o_sb, long long o_sh, long long o_sl, int causal, float scale,
    int dtype, int device, void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  if (dk % 4 || dv % 4 || dk > kMaxD || dv > kMaxD || KV <= 0 || H % KV) {
    return int(cudaErrorInvalidValue);
  }
  const FlashParams p{B, H, KV, L, S, dk, dv, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                      v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, causal, scale};
  if (dtype == 1) {
    return flash_fwd_tc(q, k, v, o, lse, B, H, KV, L, S, dk, dv, q_sb, q_sh, q_sl, k_sb, k_sh,
                        k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, causal, scale, stream);
  }
  if (dtype == 0) return launch_g(q, k, v, o, lse, p, stream);
  return int(cudaErrorInvalidValue);
}
