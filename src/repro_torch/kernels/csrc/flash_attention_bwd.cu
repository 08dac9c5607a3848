// Flash-attention backward: dQ, dK and dV of O = softmax(scale * Q K^T
// [+ mask]) V, with P recomputed from the forward's row log-sum-exp, GQA,
// an optional causal mask, and dk != dv. Two kernels:
//
//   flash_bwd_dq:  dQ = scale * sum_k dS K,  dS = P o (dO V^T - Delta)
//   flash_bwd_dkv: dV = sum P^T dO,  dK = scale * sum dS^T Q, summed over the
//                  g query heads of each kv head and over the query tiles
//
// Replaces repro/kernels/flash_attention.py::_flash_bwd (_bwd_dq_kernel and
// _bwd_dkv_kernel). It computes what those kernels are meant to compute:
// fp32 math, P = exp(S - LSE), the causal mask row >= col (aligned top-left,
// as the forward's), tiles wholly above the diagonal skipped. Unlike the
// Pallas kernels it masks key columns >= S and query rows >= L of a partial
// tile, so the result does not depend on the tile size (the Pallas kernels
// give NaN there). Delta = rowsum(dO o O) comes in from the caller (float32).
//
// Layout: as the forward's: q (B, H, L, dk), k (B, KV, S, dk), v (B, KV, S,
// dv), dout (B, H, L, dv) and the gradients given by element strides (the
// last dimension contiguous); lse and delta (B, H, L) float32, contiguous.
// Query head h reads kv head h / (H / KV). Inputs and outputs are float32 or
// bfloat16; every sum is float32 and each output is rounded once.
//
// Bound on the H100: operations. At the training shape (B 8, H 32, KV 8,
// L = S = 2048, d 64, causal, bf16) dQ is ~2.1e11 flop over ~0.3 GB and
// dK/dV ~2.7e11 flop, both far above the bf16 ridge. Design (simple first;
// no tensor cores, TMA or mma.sync yet): 256 threads per block, 64-row tiles
// staged in shared memory as float (rows padded to a float4 multiple); each
// thread owns a 4 x 4 patch of the (64, 64) score tile and 4 rows x 4
// columns per 64 of the accumulated gradient. No atomics: every block owns
// its output rows, so a step is deterministic run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key/value rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows 4ty..4ty+3, tx columns
constexpr int kPad = 4;        // row padding: float4-aligned, spreads banks
constexpr int kMaxD = 256;     // dk, dv <= kMaxD (4 column groups of 64)

struct BwdParams {
  int B, H, KV, L, S, dk, dv;
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, do_sb, do_sh, do_sl;
  long long a_sb, a_sh, a_sl;  // dq (dq kernel) or dk (dkv kernel)
  long long b_sb, b_sh, b_sl;  // dv (dkv kernel)
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>  // round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

inline __host__ __device__ size_t dq_smem_floats(int dk, int dv) {
  return size_t(kBQ) * (dk + kPad) + size_t(kBQ) * (dv + kPad) + size_t(kBK) * (dk + kPad) +
         size_t(kBK) * (dv + kPad) + size_t(kBQ) * (kBK + kPad);
}

inline __host__ __device__ size_t dkv_smem_floats(int dk, int dv) {
  return size_t(kBK) * (dk + kPad) + size_t(kBK) * (dv + kPad) + size_t(kBQ) * (dk + kPad) +
         size_t(kBQ) * (dv + kPad) + 2 * size_t(kBK) * (kBQ + kPad) + 2 * size_t(kBQ);
}

// `rows` rows of width d starting at row0 of one head into shared memory
// (row stride ld), as float; rows at or past `valid` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, long long sl, int row0,
                                          int valid, int d, float* dst, int ld, int rows) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = (row0 + r < valid) ? to_f(src[(long long)(row0 + r) * sl + c]) : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// s[i][j] += A[ra + i] . B[rb + 16 j] over d columns: A and B in shared
// memory with row stride ld; the 4 x 4 patch of one thread.
__device__ __forceinline__ void patch_dot(const float* A, const float* B, int ld, int ra, int rb,
                                          int d, float (&s)[4][4]) {
  for (int c = 0; c < d; c += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ra + i) * ld + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * ld + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], bb[j], s[i][j]);
  }
}

// acc[i][4g + e] += sum_kk W[r0 + i][kk] * X[kk][g * 64 + 4 tx + e] over the
// 64 columns kk of W (row stride ldw) and the rows of X (row stride ldx),
// for the column groups g below d.
template <int G>
__device__ __forceinline__ void patch_acc(const float* W, int ldw, int r0, const float* X,
                                          int ldx, int d, int tx, float (&acc)[4][4 * G]) {
  for (int kk = 0; kk < 64; kk += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const float4*>(W + (r0 + i) * ldw + kk);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c0 = g * 64 + tx * 4;
      if (c0 >= d) continue;
      const float* xr = X + kk * ldx + c0;
      const float4 x0 = *reinterpret_cast<const float4*>(xr);
      const float4 x1 = *reinterpret_cast<const float4*>(xr + ldx);
      const float4 x2 = *reinterpret_cast<const float4*>(xr + 2 * ldx);
      const float4 x3 = *reinterpret_cast<const float4*>(xr + 3 * ldx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* a = acc[i] + g * 4;
        a[0] = fmaf(w[i].w, x3.x, fmaf(w[i].z, x2.x, fmaf(w[i].y, x1.x, fmaf(w[i].x, x0.x, a[0]))));
        a[1] = fmaf(w[i].w, x3.y, fmaf(w[i].z, x2.y, fmaf(w[i].y, x1.y, fmaf(w[i].x, x0.y, a[1]))));
        a[2] = fmaf(w[i].w, x3.z, fmaf(w[i].z, x2.z, fmaf(w[i].y, x1.z, fmaf(w[i].x, x0.z, a[2]))));
        a[3] = fmaf(w[i].w, x3.w, fmaf(w[i].z, x2.w, fmaf(w[i].y, x1.w, fmaf(w[i].x, x0.w, a[3]))));
      }
    }
  }
}

// 4 rows x (4 columns per group) of a float accumulator to row `row0 + i` of
// a strided output; rows at or past `valid` are not written.
template <typename T, int G>
__device__ __forceinline__ void store_patch(T* out, long long sl, int row0, int valid, int d,
                                            int tx, const float (&acc)[4][4 * G]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (row >= valid) continue;
    T* orow = out + (long long)row * sl;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c0 = g * 64 + tx * 4;
      if (c0 >= d) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[c0 + e] = from_f<T>(acc[i][g * 4 + e]);
    }
  }
}

// One block per (b, h, 64 query rows): dQ for those rows, over the key tiles
// the mask reaches. G: column groups of 64 of dk.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = p.dk + kPad, ldv = p.dv + kPad, ldp = kBK + kPad;
  float* sQ = smem;              // kBQ x ldk
  float* sdO = sQ + kBQ * ldk;   // kBQ x ldv
  float* sK = sdO + kBQ * ldv;   // kBK x ldk
  float* sV = sK + kBK * ldk;    // kBK x ldv
  float* sdS = sV + kBK * ldv;   // kBQ x ldp: this tile's dS
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const T* kh = k + b * p.k_sb + kvh * p.k_sh;
  const T* vh = v + b * p.v_sb + kvh * p.v_sh;

  load_tile(q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.L, p.dk, sQ, ldk, kBQ);
  load_tile(dout + b * p.do_sb + h * p.do_sh, p.do_sl, q0, p.L, p.dv, sdO, ldv, kBQ);
  const long long stat0 = ((long long)b * p.H + h) * p.L;
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < p.L ? lse[stat0 + row] : 0.f;
    delta_r[i] = row < p.L ? delta[stat0 + row] : 0.f;
  }

  float acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  // causal: key tiles wholly above the diagonal (col > every row) are skipped
  const int last = p.causal ? min(p.S - 1, q0 + kBQ - 1) : p.S - 1;
  const int n_tiles = last / kBK + 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = t * kBK;
    __syncthreads();  // the previous tile's sK/sV/sdS reads are done
    load_tile(kh, p.k_sl, s0, p.S, p.dk, sK, ldk, kBK);
    load_tile(vh, p.v_sl, s0, p.S, p.dv, sV, ldv, kBK);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    patch_dot(sQ, sK, ldk, ty * 4, tx, p.dk, s);
    patch_dot(sdO, sV, ldv, ty * 4, tx, p.dv, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = s0 + tx + 16 * j;
        const bool ok = row < p.L && col < p.S && (!p.causal || row >= col);
        const float pij = ok ? expf(s[i][j] * p.scale - lse_r[i]) : 0.f;
        sdS[(ty * 4 + i) * ldp + tx + 16 * j] = pij * (dp[i][j] - delta_r[i]) * p.scale;
      }
    }
    __syncthreads();
    // acc += dS K over the whole tile: masked dS entries and K rows past S are 0
    patch_acc<G>(sdS, ldp, ty * 4, sK, ldk, p.dk, tx, acc);
  }
  store_patch<T, G>(dq + b * p.a_sb + h * p.a_sh, p.a_sl, q0 + ty * 4, p.L, p.dk, tx, acc);
}

// One block per (b, kv head, 64 key rows): dK and dV for those rows, over
// the g query heads that share the kv head and the query tiles the mask
// reaches. G: column groups of 64 of max(dk, dv).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = p.dk + kPad, ldv = p.dv + kPad, ldp = kBQ + kPad;
  float* sK = smem;              // kBK x ldk
  float* sV = sK + kBK * ldk;    // kBK x ldv
  float* sQ = sV + kBK * ldv;    // kBQ x ldk
  float* sdO = sQ + kBQ * ldk;   // kBQ x ldv
  float* sP = sdO + kBQ * ldv;   // kBK x ldp: P^T of this tile, [key][query]
  float* sdS = sP + kBK * ldp;   // kBK x ldp: dS^T
  float* sL = sdS + kBK * ldp;   // kBQ: LSE of the tile's query rows
  float* sD = sL + kBQ;          // kBQ: Delta
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x;  // key tile 0 meets the most query tiles: first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.KV;
  const int k0 = kt * kBK;

  load_tile(k + b * p.k_sb + kvh * p.k_sh, p.k_sl, k0, p.S, p.dk, sK, ldk, kBK);
  load_tile(v + b * p.v_sb + kvh * p.v_sh, p.v_sl, k0, p.S, p.dv, sV, ldv, kBK);

  float acc_k[4][4 * G], acc_v[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  // causal: query tiles wholly above this key tile (every row < k0) are skipped
  const int first = p.causal ? k0 / kBQ : 0;
  const int n_qt = (p.L + kBQ - 1) / kBQ;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const T* qh = q + b * p.q_sb + h * p.q_sh;
    const T* doh = dout + b * p.do_sb + h * p.do_sh;
    const long long stat0 = ((long long)b * p.H + h) * p.L;
    for (int qt = first; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's sQ/sdO/sP/sdS reads are done
      load_tile(qh, p.q_sl, q0, p.L, p.dk, sQ, ldk, kBQ);
      load_tile(doh, p.do_sl, q0, p.L, p.dv, sdO, ldv, kBQ);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < p.L ? lse[stat0 + row] : 0.f;
        sD[threadIdx.x] = row < p.L ? delta[stat0 + row] : 0.f;
      }
      __syncthreads();

      // transposed patch: key rows 4ty + i, query columns tx + 16 j
      float st[4][4] = {}, dpt[4][4] = {};
      patch_dot(sK, sQ, ldk, ty * 4, tx, p.dk, st);
      patch_dot(sV, sdO, ldv, ty * 4, tx, p.dv, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j, row = q0 + qc;
          const bool ok = key < p.S && row < p.L && (!p.causal || row >= key);
          const float pij = ok ? expf(st[i][j] * p.scale - sL[qc]) : 0.f;
          sP[(ty * 4 + i) * ldp + qc] = pij;
          sdS[(ty * 4 + i) * ldp + qc] = pij * (dpt[i][j] - sD[qc]) * p.scale;
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's query rows (masked entries 0)
      patch_acc<G>(sP, ldp, ty * 4, sdO, ldv, p.dv, tx, acc_v);
      patch_acc<G>(sdS, ldp, ty * 4, sQ, ldk, p.dk, tx, acc_k);
    }
  }
  store_patch<T, G>(dk + b * p.a_sb + kvh * p.a_sh, p.a_sl, k0 + ty * 4, p.S, p.dk, tx, acc_k);
  store_patch<T, G>(dv + b * p.b_sb + kvh * p.b_sh, p.b_sl, k0 + ty * 4, p.S, p.dv, tx, acc_v);
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <typename T, int G>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, const BwdParams& p, void* stream) {
  const size_t smem = dq_smem_floats(p.dk, p.dv) * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, G>;
  if (int e = set_smem(kern, smem)) return e;
  const dim3 grid((p.L + kBQ - 1) / kBQ, p.H, p.B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), p);
  return int(cudaGetLastError());
}

template <typename T, int G>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, const BwdParams& p, void* stream) {
  const size_t smem = dkv_smem_floats(p.dk, p.dv) * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, G>;
  if (int e = set_smem(kern, smem)) return e;
  const dim3 grid((p.S + kBK - 1) / kBK, p.KV, p.B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dq, const BwdParams& p, void* stream) {
  switch ((p.dk + 63) / 64) {
    case 1: return launch_dq<T, 1>(q, k, v, dout, lse, delta, dq, p, stream);
    case 2: return launch_dq<T, 2>(q, k, v, dout, lse, delta, dq, p, stream);
    case 3: return launch_dq<T, 3>(q, k, v, dout, lse, delta, dq, p, stream);
    case 4: return launch_dq<T, 4>(q, k, v, dout, lse, delta, dq, p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* dk, void* dv, const BwdParams& p, void* stream) {
  switch (((p.dk > p.dv ? p.dk : p.dv) + 63) / 64) {
    case 1: return launch_dkv<T, 1>(q, k, v, dout, lse, delta, dk, dv, p, stream);
    case 2: return launch_dkv<T, 2>(q, k, v, dout, lse, delta, dk, dv, p, stream);
    case 3: return launch_dkv<T, 3>(q, k, v, dout, lse, delta, dk, dv, p, stream);
    case 4: return launch_dkv<T, 4>(q, k, v, dout, lse, delta, dk, dv, p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

bool valid_shape(int H, int KV, int dk, int dv) {
  return !(dk % 4 || dv % 4 || dk > kMaxD || dv > kMaxD || KV <= 0 || H % KV);
}

}  // namespace

// The larger of the two kernels' dynamic shared memory, in bytes.
extern "C" size_t flash_attention_bwd_smem_bytes(int dk, int dv) {
  const size_t a = dq_smem_floats(dk, dv), b = dkv_smem_floats(dk, dv);
  return (a > b ? a : b) * sizeof(float);
}

// dtype: 0 float32, 1 bfloat16. dk and dv are multiples of 4, at most kMaxD;
// H is a multiple of KV. Strides are in elements; lse and delta contiguous.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq, int B, int H, int KV, int L, int S, int dk, int dv,
    long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
    long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long do_sb,
    long long do_sh, long long do_sl, long long dq_sb, long long dq_sh, long long dq_sl,
    int causal, float scale, int dtype, int device, void* stream) {
  // the caller's device: this library's runtime keeps its own current device
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  if (!valid_shape(H, KV, dk, dv)) return int(cudaErrorInvalidValue);
  const BwdParams p{B, H, KV, L, S, dk, dv, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                    v_sb, v_sh, v_sl, do_sb, do_sh, do_sl, dq_sb, dq_sh, dq_sl,
                    0, 0, 0, causal, scale};
  if (dtype == 1) return dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, p, stream);
  if (dtype == 0) return dispatch_dq<float>(q, k, v, dout, lse, delta, dq, p, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, int B, int H, int KV, int L, int S, int dk_,
    int dv_, long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
    long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long do_sb,
    long long do_sh, long long do_sl, long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl, int causal, float scale, int dtype,
    int device, void* stream) {
  if (cudaError_t e = cudaSetDevice(device); e != cudaSuccess) return int(e);
  if (!valid_shape(H, KV, dk_, dv_)) return int(cudaErrorInvalidValue);
  const BwdParams p{B, H, KV, L, S, dk_, dv_, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                    v_sb, v_sh, v_sl, do_sb, do_sh, do_sl, dk_sb, dk_sh, dk_sl,
                    dv_sb, dv_sh, dv_sl, causal, scale};
  if (dtype == 1) {
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, p, stream);
  }
  if (dtype == 0) return dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, p, stream);
  return int(cudaErrorInvalidValue);
}
