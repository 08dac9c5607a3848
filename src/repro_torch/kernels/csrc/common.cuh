// Shared device helpers for the hybrid-score kernels (sm_90a).
//
// Layout contract (the port's FusedVectors, row-major, contiguous):
//   dense  (rows, Dd) float32
//   ELL    (rows, P)  int32 ids / float32 vals; id == -1 (PAD) <=> val == 0,
//          live ids unique within a row.
// Quantized storage (QuantizedFusedVectors, DESIGN.md §13):
//   dense  (rows, Dd) int8 + scale (rows,) float32
//   ELL    (rows, P)  int32 ids / float16 vals.
// Queries are always fp32.
//
// Sparse intersection follows the paper (§4.1): the query row's live ELL ids
// are sorted once per block into shared memory, and each lane binary-searches
// one candidate slot in them. The dense part is one warp per candidate row:
// coalesced 16-byte loads (4 floats or 16 int8 values), warp-shuffle
// reduction; int8 rows multiply the reduced sum by the row scale once.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace rt {

constexpr int kWarp = 32;
constexpr float kNeg = -1e30f;  // "no candidate" sentinel (fused top-k path)

inline __host__ __device__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Position of `key` in the ascending array s[0..n), or -1.
static __device__ __forceinline__ int find_sorted(const int* s, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (s[mid] < key) lo = mid + 1; else hi = mid;
  }
  return (lo < n && s[lo] == key) ? lo : -1;
}

// Rank-sort the live entries of one ELL row (ids idx[0..P), vals val[0..P))
// into sid/sval ascending by id. Strided over `nthreads` threads starting at
// `tid`; the caller synchronises before reading sid/sval.
static __device__ __forceinline__ void rank_sort_row(const int* idx, const float* val, int P,
                                                     int* sid, float* sval, int tid,
                                                     int nthreads) {
  for (int t = tid; t < P; t += nthreads) {
    int id = idx[t];
    if (id < 0) continue;
    int r = 0;
    for (int j = 0; j < P; ++j) {
      int o = idx[j];
      r += (o >= 0) && (o < id || (o == id && j < t));
    }
    sid[r] = id;
    sval[r] = val[t];
  }
}

static __device__ __forceinline__ int count_live(const int* idx, int P) {
  int n = 0;
  for (int j = 0; j < P; ++j) n += idx[j] >= 0;
  return n;
}

// One query row cached in shared memory: dense values plus both sorted ELL
// rows and their live counts.
struct QueryCache {
  float* dense;
  int* sid;
  float* sval;
  int* fid;
  float* fval;
  int* counts;  // [0] live learned ids, [1] live lexical ids
};

inline __host__ __device__ size_t query_cache_bytes(int dd, int psq, int pfq) {
  return align16(size_t(dd) * 4) + 2 * align16(size_t(psq) * 4) +
         2 * align16(size_t(pfq) * 4) + 16;
}

static __device__ __forceinline__ QueryCache carve_query_cache(char* base, int dd, int psq,
                                                               int pfq) {
  QueryCache q;
  size_t off = 0;
  q.dense = reinterpret_cast<float*>(base + off); off += align16(size_t(dd) * 4);
  q.sid = reinterpret_cast<int*>(base + off);     off += align16(size_t(psq) * 4);
  q.sval = reinterpret_cast<float*>(base + off);  off += align16(size_t(psq) * 4);
  q.fid = reinterpret_cast<int*>(base + off);     off += align16(size_t(pfq) * 4);
  q.fval = reinterpret_cast<float*>(base + off);  off += align16(size_t(pfq) * 4);
  q.counts = reinterpret_cast<int*>(base + off);
  return q;
}

// Block-cooperative load of query row b; ends with __syncthreads().
static __device__ __forceinline__ void load_query(QueryCache q, int b, const float* qd,
                                                  const int* qsi, const float* qsv,
                                                  const int* qfi, const float* qfv, int dd,
                                                  int psq, int pfq) {
  const float* drow = qd + size_t(b) * dd;
  for (int i = threadIdx.x; i < dd; i += blockDim.x) q.dense[i] = drow[i];
  const int* si = qsi + size_t(b) * psq;
  const int* fi = qfi + size_t(b) * pfq;
  rank_sort_row(si, qsv + size_t(b) * psq, psq, q.sid, q.sval, threadIdx.x, blockDim.x);
  rank_sort_row(fi, qfv + size_t(b) * pfq, pfq, q.fid, q.fval, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) {
    q.counts[0] = count_live(si, psq);
    q.counts[1] = count_live(fi, pfq);
  }
  __syncthreads();
}

// Candidate rows of the corpus, by pointer: fp32 storage.
struct CorpusView {
  const float* dense;
  const int* si;
  const float* sv;
  const int* fi;
  const float* fv;
  long long n;
  int dd;
  int ps;
  int pf;
  int vec;  // dense rows are 16-byte aligned and dd % 4 == 0

  // Lane-partial dense dot of row `row` with the cached query; the caller
  // reduces over the warp and applies `finish`.
  __device__ __forceinline__ float dense_dot(const float* qd, long long row, int lane) const {
    float d = 0.f;
    const float* crow = dense + size_t(row) * dd;
    if (vec) {
      const float4* c4 = reinterpret_cast<const float4*>(crow);
      const float4* q4 = reinterpret_cast<const float4*>(qd);
      const int n4 = dd >> 2;
#pragma unroll 4
      for (int i = lane; i < n4; i += kWarp) {
        float4 a = __ldg(c4 + i);
        float4 b = q4[i];
        d += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
    } else {
      for (int i = lane; i < dd; i += kWarp) d += __ldg(crow + i) * qd[i];
    }
    return d;
  }
  __device__ __forceinline__ float finish(float d, long long) const { return d; }
  static __device__ __forceinline__ float val(const float* p) { return __ldg(p); }
};

// Four int8 values packed in one 32-bit word (little-endian) dotted with four
// query floats.
static __device__ __forceinline__ float dot4_i8(int w, const float4 b) {
  return float(int8_t(w)) * b.x + float(int8_t(w >> 8)) * b.y +
         float(int8_t(w >> 16)) * b.z + float(int8_t(w >> 24)) * b.w;
}

// Candidate rows in quantized storage: int8 dense + fp32 row scale, fp16 ELL
// values (read as fp16, widened in registers).
struct CorpusViewQ8 {
  const int8_t* dense;
  const float* scale;
  const int* si;
  const __half* sv;
  const int* fi;
  const __half* fv;
  long long n;
  int dd;
  int ps;
  int pf;
  int vec;  // dense rows are 16-byte aligned and dd % 16 == 0

  __device__ __forceinline__ float dense_dot(const float* qd, long long row, int lane) const {
    float d = 0.f;
    const int8_t* crow = dense + size_t(row) * dd;
    if (vec) {
      const int4* c16 = reinterpret_cast<const int4*>(crow);
      const float4* q4 = reinterpret_cast<const float4*>(qd);
      const int n16 = dd >> 4;
#pragma unroll 2
      for (int i = lane; i < n16; i += kWarp) {
        const int4 raw = __ldg(c16 + i);
        d += dot4_i8(raw.x, q4[4 * i]) + dot4_i8(raw.y, q4[4 * i + 1]) +
             dot4_i8(raw.z, q4[4 * i + 2]) + dot4_i8(raw.w, q4[4 * i + 3]);
      }
    } else {
      for (int i = lane; i < dd; i += kWarp) d += float(__ldg(crow + i)) * qd[i];
    }
    return d;
  }
  // dequantize once per row, after the warp reduction (the Pallas kernel's
  // op order, repro/kernels/hybrid_distance.py:69)
  __device__ __forceinline__ float finish(float d, long long row) const {
    return d * __ldg(scale + row);
  }
  static __device__ __forceinline__ float val(const __half* p) { return __half2float(*p); }
};

// Warp-cooperative hybrid score of the cached query against corpus row `row`
// (every lane returns the same value): (dense + learned) + lexical.
template <typename View>
static __device__ __forceinline__ float warp_score(const QueryCache& q, const View& c,
                                                   long long row, int lane) {
  const float d = c.finish(warp_sum(c.dense_dot(q.dense, row, lane)), row);

  float s = 0.f;
  const int* srow = c.si + size_t(row) * c.ps;
  const auto* svrow = c.sv + size_t(row) * c.ps;
  const int ns = q.counts[0];
  for (int p = lane; p < c.ps; p += kWarp) {
    int id = __ldg(srow + p);
    if (id >= 0) {
      int j = find_sorted(q.sid, ns, id);
      if (j >= 0) s += View::val(svrow + p) * q.sval[j];
    }
  }
  s = warp_sum(s);

  float f = 0.f;
  const int* frow = c.fi + size_t(row) * c.pf;
  const auto* fvrow = c.fv + size_t(row) * c.pf;
  const int nf = q.counts[1];
  for (int p = lane; p < c.pf; p += kWarp) {
    int id = __ldg(frow + p);
    if (id >= 0) {
      int j = find_sorted(q.fid, nf, id);
      if (j >= 0) f += View::val(fvrow + p) * q.fval[j];
    }
  }
  f = warp_sum(f);
  return (d + s) + f;
}

}  // namespace rt
