// Flash-attention forward on the tensor cores, bf16 route: O = softmax(scale
// * Q K^T [+ mask]) V and the row log-sum-exp, with GQA, an optional causal
// mask and dk != dv. It computes what csrc/flash_attention.cu computes (see
// its header) and replaces the same TPU kernel:
// repro/kernels/flash_attention.py::_flash_fwd (:107, pallas_call :121, body
// _fwd_kernel :57): bf16 inputs, S = scale Q K^T in fp32, the online softmax
// in fp32 (NEG_INF = -1e30, the top-left causal mask row >= col, tiles wholly
// above the diagonal skipped, l floored at 1e-30), P V with fp32-grade P,
// O = acc / l rounded to bf16 once and LSE = m + log l in fp32. Key columns
// >= S and query rows >= L are masked (ROADMAP Queue 3), and operands are
// read and written by stride in the model's (B, L, H, d) memory.
//
// Route: flash_attention_fwd_launch (flash_attention.cu) dispatches by dtype,
// a fixed rule and not a fallback: bfloat16 launches this kernel, float32
// the CUDA-core kernel there (its 1e-5 gate needs fp32 products).
//
// Bound on the H100: operations. At the RAG prefill shape (B 64, H 32, KV 8,
// L = S = 1088, d 64, causal) the masked work is 310.6 GFLOP, 0.31 ms at
// 989 TFLOP/s; at the training shape (B 8, L = S = 2048) 137.5 GFLOP,
// 0.14 ms. With P split the MMAs issued are 3 products' worth, not 2.
//
// Design (warp-specialised and persistent: one block of 384 threads per SM,
// walking work items of (b, h, 128 query rows), the longest causal rows
// first; the heads that share a kv head side by side, so their K/V tiles
// meet in L2):
//   - warpgroups 0 and 1 consume, 64 query rows each; one thread of
//     warpgroup 2 produces: it issues the TMA loads of each item's Q tile
//     (into one of kQSlots slots, so the next item's Q arrives while this
//     one runs) and of its K/V tiles into a ring of kStages stages that
//     runs on across items. BN, the keys of a tile, is 128 at d <= 64, where
//     S, the split P and O fit the consumers' registers and a tile's MMAs
//     are twice as long per barrier round trip (64 ran slower there), and
//     64 above, where O takes the registers. Each stage and slot fills on a
//     `full` mbarrier (TMA byte count) and is released on an `empty` one
//     that all 256 consumer threads arrive at once their MMAs on it have
//     completed. The producer warpgroup gives its registers to the
//     consumers (setmaxnreg 40 / 232).
//   - S = Q K^T by wgmma m64nBNk16 with both operands in shared memory
//     (K-major), fp32 accumulation: the products of bf16 values are exact,
//     only the order of the sums differs from the reference.
//   - the online softmax in the accumulator fragments: the row max over the
//     4 threads of a row by shuffles, exp2 with the scale folded into log2 e,
//     the row sum kept per thread and reduced once at the end; masks only on
//     diagonal and partial tiles; a warpgroup skips the tiles wholly above
//     its own diagonal.
//   - O += P V by wgmma m64nDCk16 with A = P from registers and B = V from
//     shared memory, MN-major (the transpose flag, no copy). P is fp32; it
//     enters as two bf16 operands, hi = bf16(P) and lo = bf16(P - hi)
//     (relative error ~2^-17), both into one fp32 accumulator, so O keeps
//     the reference's fp32-grade P: O feeds the backward's Delta, whose
//     rounding already dominates the bf16 gradient gap (PERF.md).
//   - tiles are 64-column blocks of 128-byte-swizzled bf16 (hopper.cuh), so
//     TMA writes them in the layout wgmma's descriptors read; TMA zero-fills
//     rows past L or S and columns past d. Head dims are templated by class
//     DC (64, 128, 256 >= max(dk, dv)); column blocks past dk or dv are
//     zeroed once and never loaded.
//   - the epilogue rounds O / l to bf16 once and writes it by stride; rows
//     >= L are not stored. No atomics, and a fixed assignment of items to
//     blocks: two launches give the same bits.
// What holds it back (PERF.md, Findings; examples/torch_flash_fwd_ablation.py
// times it with parts cut out): within a block the two warpgroups run in
// step, so the softmax (its exp2 on the SFU, the split) and the MMAs of a
// tile add up rather than overlap; the split makes the P V MMAs twice those
// of one bf16 P.
// TMA needs 16-byte aligned bases and row, head and batch strides; the
// wrapper copies a tensor that does not meet that into padded memory first.
// Tensor maps are built on the host with cuTensorMapEncodeTiled, fetched
// with cudaGetDriverEntryPointByVersion (no -lcuda), and passed as
// __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kCol = 64;           // bf16 columns of a 128-byte swizzled block
constexpr int kBlockRowBytes = 128;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DC>
struct Cfg {
  static constexpr int BN = DC == 64 ? 128 : 64;  // keys per tile
  static constexpr int NB = DC / kCol;            // column blocks
  // Q slots (the next item's Q loads while this one runs; one at DC = 256,
  // where two would not fit in shared memory) and K/V ring stages (a third
  // ran no faster)
  static constexpr int kQSlots = DC == 256 ? 1 : 2;
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kBM * DC * 2;
  static constexpr int kTileBytes = BN * DC * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // 1024 bytes of slack to align the tiles, then the barriers
  static constexpr size_t kSmem = 1024 + size_t(kQSlots) * kQBytes +
                                  size_t(kStages) * kStageBytes + 8 * 2 * (kQSlots + kStages);
};

struct Params {
  int B, H, KV, L, S, dk, dv;
  long long o_sb, o_sh, o_sl;
  int causal;
  float scale;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Work item w (query tile qt of head h, batch row b) in the order the
// persistent blocks take them: the longest causal rows first, and within a
// query tile the heads of one kv head side by side (their K/V meet in L2).
struct Item {
  int qt, h, b;
};

__device__ __forceinline__ Item item_of(int w, int n_qt, int H, int B) {
  const int hb = w % (H * B);
  return {n_qt - 1 - w / (H * B), hb % H, hb / H};
}

template <int DC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                        float* __restrict__ lse, Params p) {
  using C = Cfg<DC>;
  constexpr int BN = C::BN, kStages = C::kStages, kQSlots = C::kQSlots;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;                             // kQSlots x NB blocks of kBM x 64
  unsigned char* ring = base + kQSlots * C::kQBytes;    // kStages x (K: NB blocks of BN x 64, V)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * C::kStageBytes);
  uint64_t* q_empty = q_full + kQSlots;
  uint64_t* full = q_empty + kQSlots;
  uint64_t* empty = full + kStages;

  const int n_qt = (p.L + kBM - 1) / kBM, n_items = n_qt * p.H * p.B;
  const int nbk = (p.dk + kCol - 1) / kCol, nbv = (p.dv + kCol - 1) / kCol;
  // key tiles of query tile qt: causal, those wholly above the diagonal
  // (col > every row) are skipped
  auto tiles_of = [&](int qt) {
    return (p.causal ? min(p.S - 1, qt * kBM + kBM - 1) : p.S - 1) / BN + 1;
  };

  // column blocks past dk (Q, K) and dv (V) are never loaded, and the MMAs
  // read all DC columns: zero them once
  auto zero = [](unsigned char* blk, int rows) {
    uint4* z = reinterpret_cast<uint4*>(blk);
    for (int i = threadIdx.x; i < rows * kBlockRowBytes / 16; i += kThreads) {
      z[i] = make_uint4(0, 0, 0, 0);
    }
  };
  for (int qs = 0; qs < kQSlots; ++qs) {
    unsigned char* slot = sQ + qs * C::kQBytes;
    for (int blk = nbk; blk < C::NB; ++blk) zero(slot + blk * kBM * kBlockRowBytes, kBM);
  }
  for (int s = 0; s < kStages; ++s) {
    unsigned char* st = ring + s * C::kStageBytes;
    for (int blk = nbk; blk < C::NB; ++blk) zero(st + blk * BN * kBlockRowBytes, BN);
    for (int blk = nbv; blk < C::NB; ++blk) {
      zero(st + C::kTileBytes + blk * BN * kBlockRowBytes, BN);
    }
  }
  hopper::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int qs = 0; qs < kQSlots; ++qs) {
      hopper::mbar_init(&q_full[qs], 1);
      hopper::mbar_init(&q_empty[qs], kConsumers * 128);
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load, items in turn ----------------
    hopper::reg_dealloc<40>();
    if (threadIdx.x == kConsumers * 128) {
      int tile = 0, j = 0;  // K/V tiles and items this block has loaded
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++j) {
        const Item it = item_of(w, n_qt, p.H, p.B);
        const int kvh = it.h / (p.H / p.KV);
        const int qs = j % kQSlots;
        if (j >= kQSlots) hopper::mbar_wait(&q_empty[qs], (j / kQSlots - 1) & 1);
        hopper::mbar_expect_tx(&q_full[qs], nbk * kBM * kBlockRowBytes);
        for (int blk = 0; blk < nbk; ++blk) {
          hopper::tma_load_4d(sQ + qs * C::kQBytes + blk * kBM * kBlockRowBytes, &tq,
                              &q_full[qs], blk * kCol, it.qt * kBM, it.h, it.b);
        }
        for (int t = 0, n = tiles_of(it.qt); t < n; ++t, ++tile) {
          const int s = tile % kStages;
          if (tile >= kStages) hopper::mbar_wait(&empty[s], (tile / kStages - 1) & 1);
          unsigned char* st = ring + s * C::kStageBytes;
          hopper::mbar_expect_tx(&full[s], (nbk + nbv) * BN * kBlockRowBytes);
          for (int blk = 0; blk < nbk; ++blk) {
            hopper::tma_load_4d(st + blk * BN * kBlockRowBytes, &tk, &full[s], blk * kCol,
                                t * BN, kvh, it.b);
          }
          for (int blk = 0; blk < nbv; ++blk) {
            hopper::tma_load_4d(st + C::kTileBytes + blk * BN * kBlockRowBytes, &tv, &full[s],
                                blk * kCol, t * BN, kvh, it.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup -------------------------------
    hopper::reg_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq4 = lane & 3;
    const float sc2 = p.scale * kLog2e;
    int tile = 0, j = 0;  // K/V tiles and items this block has consumed
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++j) {
      const Item it = item_of(w, n_qt, p.H, p.B);
      const int qw = it.qt * kBM + wg * 64;  // this warpgroup's first row
      const int row0 = qw + warp * 16 + g;   // this thread's rows: row0, row0 + 8
      const int n_tiles = tiles_of(it.qt);
      const int qs = j % kQSlots;
      const unsigned char* sQw = sQ + qs * C::kQBytes + wg * 64 * kBlockRowBytes;

      float acc[DC / 2];
#pragma unroll
      for (int i = 0; i < DC / 2; ++i) acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only

      hopper::mbar_wait(&q_full[qs], (j / kQSlots) & 1);
      for (int t = 0; t < n_tiles; ++t, ++tile) {
        const int s = tile % kStages;
        hopper::mbar_wait(&full[s], (tile / kStages) & 1);
        const int s0 = t * BN;
        if (!p.causal || s0 <= qw + 63) {  // else wholly above this warpgroup's diagonal
          const unsigned char* sK = ring + s * C::kStageBytes;
          const unsigned char* sV = sK + C::kTileBytes;

          // S = Q K^T over all DC columns (a fixed count: a wgmma under a
          // branch would serialise the batch)
          float sacc[BN / 2];
          hopper::wg_fence();
#pragma unroll
          for (int ks = 0; ks < DC / 16; ++ks) {
            const int blk = ks / 4, kin = ks % 4;
            const uint64_t da =
                hopper::desc_sw128(sQw + blk * kBM * kBlockRowBytes, 16, 1024) + 2 * kin;
            const uint64_t db =
                hopper::desc_sw128(sK + blk * BN * kBlockRowBytes, 16, 1024) + 2 * kin;
            hopper::mma_ss<BN>(sacc, da, db, ks > 0);
          }
          hopper::wg_commit();
          hopper::wg_wait<0>();
          hopper::fence_regs(sacc);

          // mask (diagonal and partial tiles only), the row max over the 4
          // threads of a row, P = exp(S - m) in place, online rescale
          if ((p.causal && s0 + BN - 1 > qw) || s0 + BN > p.S) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
              const int col = s0 + (i / 4) * 8 + 2 * tq4 + (i & 1);
              const int row = row0 + 8 * ((i >> 1) & 1);
              if (col >= p.S || (p.causal && col > row)) sacc[i] = kNegInf;
            }
          }
          float mx[2] = {m[0], m[1]}, alpha[2], msc[2];
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = exp2_approx((m[r] - mx[r]) * sc2);
            m[r] = mx[r];
            msc[r] = mx[r] * sc2;
            l[r] *= alpha[r];
          }
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int r = (i >> 1) & 1;
            sacc[i] = exp2_approx(fmaf(sacc[i], sc2, -msc[r]));
            l[r] += sacc[i];
          }
#pragma unroll
          for (int i = 0; i < DC / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

          // O += P V, P split hi/lo into bf16 A fragments: 8-column blocks
          // 2 kk and 2 kk + 1 of S are the fragment of keys 16 kk .. + 15
          uint32_t hi[BN / 16][4], lo[BN / 16][4];
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              mma::split_pair(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1], hi[kk][r],
                              lo[kk][r]);
            }
          }
          hopper::fence_regs(acc);
          hopper::fence_regs(hi);
          hopper::fence_regs(lo);
          hopper::wg_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            // keys 16 kk .. 16 kk + 15: two 8-row groups of V's tile
            const uint64_t db =
                hopper::desc_sw128(sV + kk * 16 * kBlockRowBytes, BN * kBlockRowBytes, 1024);
            hopper::mma_rs_tb<DC>(acc, hi[kk], db);
            hopper::mma_rs_tb<DC>(acc, lo[kk], db);
          }
          hopper::wg_commit();
          hopper::wg_wait<0>();
          hopper::fence_regs(acc);
          hopper::fence_regs(hi);
          hopper::fence_regs(lo);
        }
        hopper::mbar_arrive(&empty[s]);  // this stage's MMAs are done
      }
      hopper::mbar_arrive(&q_empty[qs]);  // and so are this item's reads of Q

      // epilogue: O / l rounded to bf16 once, LSE = m scale + log l
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = row0 + 8 * r;
        if (row >= p.L) continue;
        const float lf = fmaxf(l[r], 1e-30f);
        const float inv = 1.f / lf;
        bf16* orow = o + it.b * p.o_sb + it.h * p.o_sh + (long long)row * p.o_sl;
#pragma unroll
        for (int jc = 0; jc < DC / 8; ++jc) {
          const int col = jc * 8 + 2 * tq4;
          if (col < p.dv) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                acc[4 * jc + 2 * r] * inv, acc[4 * jc + 2 * r + 1] * inv);
          }
        }
        if (tq4 == 0) {
          lse[((long long)it.b * p.H + it.h) * p.L + row] = m[r] * p.scale + logf(lf);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The map of one bf16 operand, (d, rows, heads, batch) with the given element
// strides, read in boxes of 64 columns x box_rows rows with the 128-byte
// swizzle; out-of-range elements read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads, int batch,
              long long s_row, long long s_head, long long s_batch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(rows), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s_row) * 2, cuuint64_t(s_head) * 2,
                                 cuuint64_t(s_batch) * 2};
  const cuuint32_t box[4] = {kCol, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int d_class(int dk, int dv) {
  const int d = dk > dv ? dk : dv;
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= kMaxD ? 256 : 0;
}

template <int DC>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
           float* lse, const Params& p, cudaStream_t stream) {
  auto kern = flash_fwd_tc_kernel<DC>;
  const size_t smem = Cfg<DC>::kSmem;
  if (cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
      e != cudaSuccess) {
    return int(e);
  }
  // persistent: one block per SM (or per item, if fewer), walking the items
  int device = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&device); e != cudaSuccess) return int(e);
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      e != cudaSuccess) {
    return int(e);
  }
  const long long items = (long long)((p.L + kBM - 1) / kBM) * p.H * p.B;
  const int grid = int(items < sms ? items : sms);
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, static_cast<bf16*>(o), lse, p);
  return int(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of the kernel for these head dims, in bytes.
size_t flash_fwd_tc_smem_bytes(int dk, int dv) {
  switch (d_class(dk, dv)) {
    case 64: return Cfg<64>::kSmem;
    case 128: return Cfg<128>::kSmem;
    default: return Cfg<256>::kSmem;
  }
}

// Called by flash_attention_fwd_launch for bfloat16 (strides in elements;
// base pointers and every stride but the last 16-byte aligned).
int flash_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                 int KV, int L, int S, int dk, int dv, long long q_sb, long long q_sh,
                 long long q_sl, long long k_sb, long long k_sh, long long k_sl, long long v_sb,
                 long long v_sh, long long v_sl, long long o_sb, long long o_sh, long long o_sl,
                 int causal, float scale, void* stream) {
  const int dc = d_class(dk, dv);
  if (dc == 0) return int(cudaErrorInvalidValue);
  const int bn = dc == 64 ? Cfg<64>::BN : Cfg<128>::BN;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, dk, L, H, B, q_sl, q_sh, q_sb, kBM) ||
      !make_map(&mk, k, dk, S, KV, B, k_sl, k_sh, k_sb, bn) ||
      !make_map(&mv, v, dv, S, KV, B, v_sl, v_sh, v_sb, bn)) {
    return int(cudaErrorInvalidValue);
  }
  const Params p{B, H, KV, L, S, dk, dv, o_sb, o_sh, o_sl, causal, scale};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dc) {
    case 64: return launch<64>(mq, mk, mv, o, lse, p, st);
    case 128: return launch<128>(mq, mk, mv, o, lse, p, st);
    default: return launch<256>(mq, mk, mv, o, lse, p, st);
  }
}
