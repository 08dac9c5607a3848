// Flash-attention backward on the tensor cores, bf16 route: dQ, dK and dV of
// O = softmax(scale * Q K^T [+ mask]) V, with P recomputed from the forward's
// row log-sum-exp, GQA, an optional causal mask and dk != dv. It computes
// what csrc/flash_attention_bwd.cu computes (see its header) and replaces
// the same TPU kernels: repro/kernels/flash_attention.py::_bwd_dq_kernel
// (:152, called at :261) and _bwd_dkv_kernel (:196, called at :294).
//
// Route: the C entry points in flash_attention_bwd.cu dispatch by dtype, a
// fixed rule and not a fallback: bfloat16 launches these kernels, float32
// the CUDA-core kernels there (the fp32 gates need fp32 products; rounding
// fp32 operands to TF32 or bf16 would break them). A shape these kernels do
// not take returns cudaErrorInvalidValue and the wrapper raises.
//
// Bound on the H100: operations. At the training shape (B 8, H 32, KV 8,
// L = S = 2048, d 64, causal, bf16) bwd_work in chip_smoke.py counts 2.06e11
// flop for dQ (QK^T, dO V^T, dS K) and 2.75e11 for dK/dV (QK^T, dO V^T,
// P^T dO, dS^T Q) at 989 TFLOP/s: 0.21 and 0.28 ms.
//
// Why P and dS are split hi/lo. The reference computes in fp32, and the
// kernels are held to |g - w| <= 2e-4 + 2^-7 |w| against the fp32 plain
// version. Q, K, V and dO are bf16 already, so QK^T and dO V^T on bf16
// tensor cores with fp32 accumulation take exact products. P and dS are
// fp32: rounding P once to bf16 before dV = sum_i P_ij dO_i errs by about
// 2^-9 / sqrt(3) * sqrt(sum_i P_ij^2 dO_i^2), and for the first keys of a
// causal row (sum_i P_ij^2 ~ 1/j per head, over the 4 heads of a group) that
// is ~1.4e-3 where |w| is small: 7x the 2e-4 floor. So each fp32 x is
// written as hi = bf16(x) plus lo = bf16(x - hi) (relative error ~2^-17) and
// dS K, P^T dO and dS^T Q each run as two MMAs, hi then lo, into one fp32
// accumulator. Work: dQ 3 + 1 products' worth of MMAs, dK/dV 4 + 2.
//
// Design. 64-row tiles; each warp owns 16 rows of its block's tile.
//   dQ:    one block per (b, h, 64 query rows), longest causal rows first;
//          Q and dO stay in shared memory, K/V tiles stream through a ring
//          of kStages cp.async stages (the next tile's copy overlaps this
//          tile's MMAs). S = QK^T and dP = dO V^T accumulate in fp32
//          fragments (mma.sync m16n8k16, operands by ldmatrix), P and dS
//          are formed in those fragments and become the A operand of dS K
//          (K read with ldmatrix .trans) without leaving registers.
//   dK/dV: one block per (b, kv head, 64 key rows), key tile 0 first, over
//          the g query heads of the group and the query tiles the mask
//          reaches; K and V stay, Q/dO tiles with their LSE and Delta
//          stream through the ring. Per 32-query half of a tile (half the
//          registers of a whole tile), S^T = K Q^T and dP^T = V dO^T, then
//          dV += P^T dO and dK += dS^T Q (dO and Q read with .trans).
// No atomics: every block owns its output rows, so a step is deterministic.
// The causal mask and the key tail (columns >= S) are applied only on
// diagonal and partial tiles; tiles wholly above the diagonal are skipped.
// Query rows >= L carry LSE = +inf in the dK/dV kernel, so their P is 0;
// in the dQ kernel they are not stored. Tiles in shared memory are bf16
// with padded rows (mma.cuh: no ldmatrix bank conflicts); head dims are
// zero-padded to a multiple of 16, which leaves the products exact. Where a
// warp would hold more than 128 accumulator columns (dQ above d = 128,
// dK/dV above 64) the output columns are split between two warps per row
// group, which both compute the row group's S and dP, so the accumulators
// fit in registers. Rows are copied 16 bytes at a time, or 8 or 4 where a row
// start is not 16-byte aligned (e.g. d = 20); the wrapper picks the width.
//
// Resources (ptxas -v for sm_90a and flash_bwd_tc_smem_bytes, as
// chip_smoke.py phase 1 prints them): at the 64 / 128 / 256 head-dim
// classes dQ takes 128 / 167 / 196 registers and dK/dV 128 / 153 / 226, no
// spills (dK/dV at 64 is capped at 128 for 4 blocks per SM); dynamic shared
// memory 56,320 / 105,472 / 203,776 bytes (the larger of the two kernels:
// kRows x padded d bf16 tiles, 1 + kStages pairs, plus dK/dV's LSE and
// Delta).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;    // rows of every query and key tile
constexpr int kStages = 2;   // cp.async ring depth of the streamed tiles
constexpr int kMaxD = 256;   // dk, dv <= kMaxD
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (max relative error ~2^-22; -inf -> 0, results below
// 2^-126 flushed to 0, far under what P contributes to a sum)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  int B, H, KV, L, S, dk, dv;
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, do_sb, do_sh, do_sl;
  long long a_sb, a_sh, a_sl;  // dq (dq kernel) or dk (dkv kernel)
  long long b_sb, b_sh, b_sl;  // dv (dkv kernel)
  int causal, vec;
  float scale;
};

// DC: padded head dims at most DC (64, 128 or 256); NACC: fp32 output
// accumulators per warp (1 for dQ, 2 for dK and dV). Two warps share a row
// group, each with half the output columns, once a warp would hold more
// than 128 accumulator columns.
template <int DC, int NACC>
struct Cfg {
  static constexpr int kSplit = DC * NACC > 128 ? 2 : 1;
  static constexpr int kThreads = 128 * kSplit;     // 4 row groups of 16
  static constexpr int kPairs = DC / 16 / kSplit;   // 16-column output pairs per warp
};

inline int d_class(int dk, int dv) {
  const int d = mma::padded_ld(dk > dv ? dk : dv) - 8;
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= kMaxD ? 256 : 0;
}

// Tiles: bf16, kRows rows of stride padded_ld(d).
inline size_t tile_elems(int dk, int dv) {
  return size_t(kRows) * (mma::padded_ld(dk) + mma::padded_ld(dv));
}

inline size_t dq_smem(int dk, int dv) {
  return tile_elems(dk, dv) * (1 + kStages) * sizeof(bf16);
}

inline size_t dkv_smem(int dk, int dv) {
  return dq_smem(dk, dv) + size_t(kStages) * 2 * kRows * sizeof(float);
}

// Columns [d, padded d) of a tile are zero: the products read them.
template <int NT>
__device__ __forceinline__ void zero_pad(bf16* t, int ld, int d) {
  const int w = ld - 8 - d;
  for (int i = threadIdx.x; i < kRows * w; i += NT) {
    t[(i / w) * ld + d + i % w] = __float2bfloat16(0.f);
  }
}

// Rows [row0, row0 + kRows) of one head (d columns, row stride sl) into a
// tile of row stride ld, `vec` bytes per copy; rows at or past `valid` are
// zero-filled.
template <int NT>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, long long sl,
                                          int row0, int valid, int d, int vec) {
  const int per = vec / 2;
  const int cpr = d / per;
  for (int i = threadIdx.x; i < kRows * cpr; i += NT) {
    const int r = i / cpr, c = (i - r * cpr) * per;
    const bool ok = row0 + r < valid;
    const bf16* s = ok ? src + (long long)(row0 + r) * sl + c : src;
    bf16* t = dst + r * ld + c;
    if (vec == 16) {
      mma::cp_async<16>(t, s, ok);
    } else if (vec == 8) {
      mma::cp_async<8>(t, s, ok);
    } else {
      mma::cp_async<4>(t, s, ok);
    }
  }
}

// acc (16 x NJ n-tiles) += A (16 rows from r0 of tile a) B^T, B given as the
// n x k tile bt (its rows n0 .. n0 + 8 NJ are the n-tiles), over k < kp.
template <int DC, int NJ>
__device__ __forceinline__ void gemm_abt(float (&acc)[NJ][4], const bf16* a, const bf16* bt,
                                         int ld, int r0, int n0, int kp, int lane) {
#pragma unroll
  for (int ks = 0; ks < DC / 16; ++ks) {
    if (ks * 16 >= kp) break;
    uint32_t fa[4];
    mma::ldmatrix_x4(fa, mma::a_addr(a, ld, r0, ks * 16, lane));
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t fb[4];
      mma::ldmatrix_x4(fb, mma::bt_addr(bt, ld, n0 + jp * 16, ks * 16, lane));
      mma::mma_bf16(acc[2 * jp], fa, fb[0], fb[1]);
      mma::mma_bf16(acc[2 * jp + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x this warp's output columns) += W X, W the 16 x 8 NJ fp32 block
// in fragments w (split hi/lo here), X the tile x from row k0 (rows are k,
// read with .trans); the warp holds output pairs [pair0, pair0 + NP) below
// dp.
template <int NP, int NJ>
__device__ __forceinline__ void gemm_wx(float (&acc)[2 * NP][4], const float (&w)[NJ][4],
                                        const bf16* x, int ld, int k0, int pair0, int dp,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t hi[4], lo[4];
    mma::a_from_c_split(hi, lo, w[2 * kk], w[2 * kk + 1]);
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      const int c = (pair0 + pp) * 16;
      if (c >= dp) break;
      uint32_t fb[4];
      mma::ldmatrix_x4_trans(fb, mma::b_addr(x, ld, k0 + kk * 16, c, lane));
      mma::mma_bf16(acc[2 * pp], hi, fb[0], fb[1]);
      mma::mma_bf16(acc[2 * pp], lo, fb[0], fb[1]);
      mma::mma_bf16(acc[2 * pp + 1], hi, fb[2], fb[3]);
      mma::mma_bf16(acc[2 * pp + 1], lo, fb[2], fb[3]);
    }
  }
}

// Rows r (g, g + 8 of the warp's 16 from row0) and this warp's columns of a
// fragment accumulator to a strided bf16 output; rows >= valid and columns
// >= d are not written.
template <int NP>
__device__ __forceinline__ void store_acc(bf16* out, long long sl, int row0, int valid, int d,
                                          int pair0, int lane, const float (&acc)[2 * NP][4]) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= valid) continue;
    bf16* orow = out + (long long)row * sl;
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
      const int col = pair0 * 16 + n * 8 + 2 * tq;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(Cfg<DC, 1>::kThreads)
    flash_bwd_tc_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dq, Params p) {
  constexpr int NT = Cfg<DC, 1>::kThreads, NP = Cfg<DC, 1>::kPairs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = mma::padded_ld(p.dk), ldv = mma::padded_ld(p.dv);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kRows x ldk
  bf16* sdO = sQ + kRows * ldk;                   // kRows x ldv
  bf16* ring = sdO + kRows * ldv;                 // kStages x (K tile, V tile)
  const int stage = kRows * (ldk + ldv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, pair0 = (warp / 4) * NP;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest causal rows start first
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kRows;
  const bf16* kh = k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vh = v + b * p.v_sb + kvh * p.v_sh;

  zero_pad<NT>(sQ, ldk, p.dk);
  zero_pad<NT>(sdO, ldv, p.dv);
  for (int s = 0; s < kStages; ++s) {
    zero_pad<NT>(ring + s * stage, ldk, p.dk);
    zero_pad<NT>(ring + s * stage + kRows * ldk, ldv, p.dv);
  }
  load_tile<NT>(sQ, ldk, q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.L, p.dk, p.vec);
  load_tile<NT>(sdO, ldv, dout + b * p.do_sb + h * p.do_sh, p.do_sl, q0, p.L, p.dv, p.vec);
  load_tile<NT>(ring, ldk, kh, p.k_sl, 0, p.S, p.dk, p.vec);
  load_tile<NT>(ring + kRows * ldk, ldv, vh, p.v_sl, 0, p.S, p.dv, p.vec);
  mma::cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const long long stat0 = ((long long)b * p.H + h) * p.L;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr * 16 + g + 8 * i;
    lse2[i] = row < p.L ? lse[stat0 + row] * kLog2e : 0.f;
    dlt[i] = row < p.L ? delta[stat0 + row] : 0.f;
  }
  const float sc2 = p.scale * kLog2e;
  const int dkp = ldk - 8, dvp = ldv - 8;

  float acc[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // causal: key tiles wholly above the diagonal (col > every row) are skipped
  const int last = p.causal ? min(p.S - 1, q0 + kRows - 1) : p.S - 1;
  const int n_tiles = last / kRows + 1;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      bf16* nxt = ring + ((t + 1) % kStages) * stage;
      load_tile<NT>(nxt, ldk, kh, p.k_sl, (t + 1) * kRows, p.S, p.dk, p.vec);
      load_tile<NT>(nxt + kRows * ldk, ldv, vh, p.v_sl, (t + 1) * kRows, p.S, p.dv, p.vec);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in shared memory for every warp
    const bf16* sK = ring + (t % kStages) * stage;
    const bf16* sV = sK + kRows * ldk;
    const int s0 = t * kRows;

    float s[8][4] = {}, dp[8][4] = {};
    gemm_abt<DC, 8>(s, sQ, sK, ldk, wr * 16, 0, dkp, lane);
    gemm_abt<DC, 8>(dp, sdO, sV, ldv, wr * 16, 0, dvp, lane);
    // P = exp(S scale - LSE), dS = P o (dP - Delta) scale, in the fragments;
    // the mask only where a tile crosses the diagonal or the key tail
    const bool edge = (p.causal && s0 + kRows - 1 > q0) || s0 + kRows > p.S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2_approx(fmaf(s[j][e], sc2, -lse2[e >> 1]));
        if (edge) {
          const int col = s0 + j * 8 + 2 * tq + (e & 1);
          const int row = q0 + wr * 16 + g + 8 * (e >> 1);
          if (col >= p.S || (p.causal && col > row)) pr = 0.f;
        }
        dp[j][e] = pr * (dp[j][e] - dlt[e >> 1]) * p.scale;
      }
    }
    gemm_wx<NP, 8>(acc, dp, sK, ldk, 0, pair0, dkp, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_acc<NP>(dq + b * p.a_sb + h * p.a_sh, p.a_sl, q0 + wr * 16, p.L, p.dk, pair0, lane,
                acc);
}

// At d = 64 the register cap of 4 blocks per SM (128 per thread) holds
// without spills and runs ~7% faster than 3 blocks of 153 registers.
template <int DC>
__global__ void __launch_bounds__(Cfg<DC, 2>::kThreads, DC == 64 ? 4 : 1)
    flash_bwd_tc_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, Params p) {
  constexpr int NT = Cfg<DC, 2>::kThreads, NP = Cfg<DC, 2>::kPairs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = mma::padded_ld(p.dk), ldv = mma::padded_ld(p.dv);
  const int stage = kRows * (ldk + ldv);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kRows x ldk
  bf16* sV = sK + kRows * ldk;                    // kRows x ldv
  bf16* ring = sV + kRows * ldv;                  // kStages x (Q tile, dO tile)
  float* stats = reinterpret_cast<float*>(ring + kStages * stage);  // kStages x (LSE, Delta)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, pair0 = (warp / 4) * NP;
  const int g = lane >> 2, tq = lane & 3;
  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;  // key tile 0 meets the most
  const int group = p.H / p.KV;
  const int k0 = kt * kRows;
  // causal: query tiles wholly above this key tile (every row < k0) are skipped
  const int first = p.causal ? kt : 0;
  const int n_qt = (p.L + kRows - 1) / kRows;
  const int per_head = n_qt > first ? n_qt - first : 0;
  const int n_iter = group * per_head;

  zero_pad<NT>(sK, ldk, p.dk);
  zero_pad<NT>(sV, ldv, p.dv);
  for (int s = 0; s < kStages; ++s) {
    zero_pad<NT>(ring + s * stage, ldk, p.dk);
    zero_pad<NT>(ring + s * stage + kRows * ldk, ldv, p.dv);
  }
  load_tile<NT>(sK, ldk, k + b * p.k_sb + kvh * p.k_sh, p.k_sl, k0, p.S, p.dk, p.vec);
  load_tile<NT>(sV, ldv, v + b * p.v_sb + kvh * p.v_sh, p.v_sl, k0, p.S, p.dv, p.vec);

  // iteration it: query head kvh * group + it / per_head, query tile
  // first + it % per_head; LSE +inf and Delta 0 past L, so P is 0 there
  auto issue = [&](int it, int slot) {
    const int h = kvh * group + it / per_head;
    const int q0 = (first + it % per_head) * kRows;
    bf16* dst = ring + slot * stage;
    load_tile<NT>(dst, ldk, q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.L, p.dk, p.vec);
    load_tile<NT>(dst + kRows * ldk, ldv, dout + b * p.do_sb + h * p.do_sh, p.do_sl, q0, p.L,
                  p.dv, p.vec);
    const long long stat0 = ((long long)b * p.H + h) * p.L;
    float* st = stats + slot * 2 * kRows;
    for (int i = threadIdx.x; i < 2 * kRows; i += NT) {
      const int r = i % kRows, row = q0 + r;
      const float* src = (i < kRows ? lse : delta) + stat0 + row;
      if (row < p.L) {
        mma::cp_async<4>(st + i, src, true);
      } else {
        st[i] = i < kRows ? INFINITY : 0.f;
      }
    }
  };
  if (n_iter > 0) issue(0, 0);
  mma::cp_async_commit();

  const float sc2 = p.scale * kLog2e;
  const int dkp = ldk - 8, dvp = ldv - 8;
  float acc_k[2 * NP][4], acc_v[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      issue(it + 1, (it + 1) % kStages);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every warp
    const bf16* sQ = ring + (it % kStages) * stage;
    const bf16* sdO = sQ + kRows * ldk;
    const float* sL = stats + (it % kStages) * 2 * kRows;
    const float* sD = sL + kRows;
    const int q0 = (first + it % per_head) * kRows;

    const bool edge = p.causal && q0 < k0 + kRows - 1;  // the diagonal tile
    // two halves of 32 query columns: S^T, P^T, dP^T and dS^T of a half
    // take half the registers, so more warps fit on an SM
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = half * 32;
      float st[4][4] = {}, dpt[4][4] = {};  // S^T, dP^T: [key][query]
      gemm_abt<DC, 4>(dpt, sV, sdO, ldv, wr * 16, n0, dvp, lane);
      gemm_abt<DC, 4>(st, sK, sQ, ldk, wr * 16, n0, dkp, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + j * 8 + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
          float pr = exp2_approx(fmaf(st[j][e], sc2, -lv * kLog2e));
          if (edge) {
            const int key = k0 + wr * 16 + g + 8 * (e >> 1);
            if (q0 + c + (e & 1) < key) pr = 0.f;
          }
          st[j][e] = pr;
          dpt[j][e] = pr * (dpt[j][e] - dl) * p.scale;
        }
      }
      gemm_wx<NP, 4>(acc_v, st, sdO, ldv, n0, pair0, dvp, lane);  // dV += P^T dO
      gemm_wx<NP, 4>(acc_k, dpt, sQ, ldk, n0, pair0, dkp, lane);  // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (n_iter == 0) mma::cp_async_wait<0>();
  store_acc<NP>(dk + b * p.a_sb + kvh * p.a_sh, p.a_sl, k0 + wr * 16, p.S, p.dk, pair0, lane,
                acc_k);
  store_acc<NP>(dv + b * p.b_sb + kvh * p.b_sh, p.b_sl, k0 + wr * 16, p.S, p.dv, pair0, lane,
                acc_v);
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <int DC>
int launch_dq(const Params& p, const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, cudaStream_t stream) {
  const size_t smem = dq_smem(p.dk, p.dv);
  auto kern = flash_bwd_tc_dq_kernel<DC>;
  if (int e = set_smem(kern, smem)) return e;
  const dim3 grid(p.H, p.B, (p.L + kRows - 1) / kRows);
  kern<<<grid, Cfg<DC, 1>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), p);
  return int(cudaGetLastError());
}

template <int DC>
int launch_dkv(const Params& p, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, cudaStream_t stream) {
  const size_t smem = dkv_smem(p.dk, p.dv);
  auto kern = flash_bwd_tc_dkv_kernel<DC>;
  if (int e = set_smem(kern, smem)) return e;
  const dim3 grid(p.KV, p.B, (p.S + kRows - 1) / kRows);
  kern<<<grid, Cfg<DC, 2>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      p);
  return int(cudaGetLastError());
}

// `vec` 4, 8 or 16 bytes, dividing every row's bytes (the wrapper reads it
// from the pointers and strides); the entry points have checked the shape.
bool valid(const Params& p) {
  const int per = p.vec / 2;
  return (p.vec == 4 || p.vec == 8 || p.vec == 16) && p.dk % per == 0 && p.dv % per == 0 &&
         d_class(p.dk, p.dv) != 0;
}

}  // namespace

// Dynamic shared memory of the larger of the two kernels, in bytes.
size_t flash_bwd_tc_smem_bytes(int dk, int dv) {
  const size_t a = dq_smem(dk, dv), b = dkv_smem(dk, dv);
  return a > b ? a : b;
}

// Called by flash_attention_bwd_dq_launch for bfloat16 (strides in elements).
int flash_bwd_tc_dq(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq, int B, int H, int KV, int L,
                    int S, int dk, int dv, long long q_sb, long long q_sh, long long q_sl,
                    long long k_sb, long long k_sh, long long k_sl, long long v_sb,
                    long long v_sh, long long v_sl, long long do_sb, long long do_sh,
                    long long do_sl, long long dq_sb, long long dq_sh, long long dq_sl,
                    int causal, float scale, int vec, void* stream) {
  const Params p{B, H, KV, L, S, dk, dv, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                 v_sb, v_sh, v_sl, do_sb, do_sh, do_sl, dq_sb, dq_sh, dq_sl,
                 0, 0, 0, causal, vec, scale};
  if (!valid(p)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (d_class(dk, dv)) {
    case 64: return launch_dq<64>(p, q, k, v, dout, lse, delta, dq, st);
    case 128: return launch_dq<128>(p, q, k, v, dout, lse, delta, dq, st);
    default: return launch_dq<256>(p, q, k, v, dout, lse, delta, dq, st);
  }
}

// Called by flash_attention_bwd_dkv_launch for bfloat16.
int flash_bwd_tc_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                     int KV, int L, int S, int dk_, int dv_, long long q_sb, long long q_sh,
                     long long q_sl, long long k_sb, long long k_sh, long long k_sl,
                     long long v_sb, long long v_sh, long long v_sl, long long do_sb,
                     long long do_sh, long long do_sl, long long dk_sb, long long dk_sh,
                     long long dk_sl, long long dv_sb, long long dv_sh, long long dv_sl,
                     int causal, float scale, int vec, void* stream) {
  const Params p{B, H, KV, L, S, dk_, dv_, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                 v_sb, v_sh, v_sl, do_sb, do_sh, do_sl, dk_sb, dk_sh, dk_sl,
                 dv_sb, dv_sh, dv_sl, causal, vec, scale};
  if (!valid(p)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (d_class(dk_, dv_)) {
    case 64: return launch_dkv<64>(p, q, k, v, dout, lse, delta, dk, dv, st);
    case 128: return launch_dkv<128>(p, q, k, v, dout, lse, delta, dk, dv, st);
    default: return launch_dkv<256>(p, q, k, v, dout, lse, delta, dk, dv, st);
  }
}
