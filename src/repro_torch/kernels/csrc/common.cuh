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
// One row scorer serves fused_topk.cu and hybrid_distance.cu: `score_row`
// gives the hybrid score of a query against one corpus row, a warp per row.
// Lane p holds the row's ELL slot p; every load of the row (its ELL ids and
// values, its scale, its dense words, 16 bytes a lane at a time) is issued
// before any result is used; the sparse intersection looks each slot's id up
// in the query's sorted ids (paper §4.1); the dense part is reduced over the
// warp by shuffles, and int8 rows multiply that sum by the row scale once.
// The query comes in one of two forms: staged in a block's shared memory
// (`QueryCache`: dense values and sorted ELL rows, read by all the block's
// warps), or held by one warp in registers (`WarpQuery`: the dense words a
// lane multiplies, the ELL rows sorted across the lanes, a binary search
// over shuffles), which needs no shared memory and no block barrier.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace rt {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoPos = 0x7fffffff;  // a sorted ELL row's dead slots: above every id
constexpr float kNeg = -1e30f;      // "no candidate" sentinel (fused top-k path)
constexpr int kOnePassVec = 4;      // 16-byte loads a lane in flight per row (Dd 1024: 2 steps)
constexpr int kQueryWords = 8;      // WarpQuery: 16-byte query words a lane (Dd <= 1024)

inline __host__ __device__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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

// The warp's 32 (key, v) sorted ascending by key across the lanes: a bitonic
// network over shuffles; lane t ends with the t-th smallest key.
static __device__ __forceinline__ void warp_bitonic(int& key, float& v, int lane) {
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1)
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
      const int ok = __shfl_xor_sync(kFull, key, d);
      const float ov = __shfl_xor_sync(kFull, v, d);
      const bool up = (lane & size) == 0;
      const bool take_min = ((lane & d) == 0) == up;
      if (take_min ? ok < key : ok > key) { key = ok; v = ov; }
    }
}

// Sort the live entries of one ELL row ascending by id into sid/sval with
// one warp; returns the live count. P <= 32: a bitonic sort over the lanes;
// wider rows: a rank sort over the warp's lanes.
static __device__ __forceinline__ int warp_sort_ell(const int* idx, const float* val, int P,
                                                    int* sid, float* sval, int lane) {
  if (P <= kWarp) {
    int key = lane < P ? idx[lane] : -1;
    float v = lane < P ? val[lane] : 0.f;
    const int n = __popc(__ballot_sync(kFull, key >= 0));
    if (key < 0) key = kNoPos;
    warp_bitonic(key, v, lane);
    if (lane < n) { sid[lane] = key; sval[lane] = v; }
    __syncwarp();
    return n;
  }
  rank_sort_row(idx, val, P, sid, sval, lane, kWarp);
  int n = 0;
  for (int p = lane; p < P; p += kWarp) n += idx[p] >= 0;
  n = __reduce_add_sync(kFull, n);
  __syncwarp();
  return n;
}

// Lane's slot (key, val) against a sorted id list held one per lane (qid,
// qval; n live): a binary search over shuffles, every lane taking part.
static __device__ __forceinline__ float lane_match(int key, float val, int qid, float qval,
                                                   int n) {
  int lo = 0, hi = n;
#pragma unroll
  for (int it = 0; it < 6; ++it) {  // n <= 32
    const int mid = (lo + hi) >> 1;
    const int x = __shfl_sync(kFull, qid, mid & (kWarp - 1));
    if (lo < hi) {
      if (x < key) lo = mid + 1;
      else hi = mid;
    }
  }
  const int x = __shfl_sync(kFull, qid, lo & (kWarp - 1));
  const float xv = __shfl_sync(kFull, qval, lo & (kWarp - 1));
  return (key >= 0 && lo < n && x == key) ? val * xv : 0.f;
}

// ---- corpus rows -------------------------------------------------------------

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
};

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
};

// Four int8 values packed in one 32-bit word (little-endian) dotted with four
// query floats.
static __device__ __forceinline__ float dot4_i8(int w, const float4 b) {
  return float(int8_t(w)) * b.x + float(int8_t(w >> 8)) * b.y +
         float(int8_t(w >> 16)) * b.z + float(int8_t(w >> 24)) * b.w;
}

static __device__ __forceinline__ float row_scale(const CorpusView&, long long) { return 1.f; }
static __device__ __forceinline__ float row_scale(const CorpusViewQ8& c, long long row) {
  return __ldg(c.scale + row);
}
static __device__ __forceinline__ float finish(const CorpusView&, float d, float) { return d; }
static __device__ __forceinline__ float finish(const CorpusViewQ8&, float d, float s) {
  return d * s;  // once per row, after the warp reduction (hybrid_distance.py:69)
}

static __device__ __forceinline__ float ell_val(const float* p) { return __ldg(p); }
static __device__ __forceinline__ float ell_val(const __half* p) { return __half2float(*p); }

// Lane-partial dense dot of corpus row `row` with a query row q4 (shared
// memory): kOnePassVec 16-byte loads a lane issued before any is used.
static __device__ __forceinline__ float dense_partial(const CorpusView& c, const float* qd,
                                                     long long row, int lane) {
  float d = 0.f;
  if (c.vec) {
    const int n4 = c.dd >> 2;
    const float4* c4 = reinterpret_cast<const float4*>(c.dense + size_t(row) * c.dd);
    const float4* q4 = reinterpret_cast<const float4*>(qd);
    for (int base = 0; base < n4; base += kOnePassVec * kWarp) {
      float4 a[kOnePassVec];
#pragma unroll
      for (int u = 0; u < kOnePassVec; ++u) {
        const int i = base + u * kWarp + lane;
        a[u] = i < n4 ? __ldg(c4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kOnePassVec; ++u) {
        const int i = base + u * kWarp + lane;
        if (i < n4) {
          const float4 b = q4[i];
          d += a[u].x * b.x + a[u].y * b.y + a[u].z * b.z + a[u].w * b.w;
        }
      }
    }
  } else {
    const float* crow = c.dense + size_t(row) * c.dd;
    for (int i = lane; i < c.dd; i += kWarp) d += __ldg(crow + i) * qd[i];
  }
  return d;
}

static __device__ __forceinline__ float dense_partial(const CorpusViewQ8& c, const float* qd,
                                                     long long row, int lane) {
  constexpr int U = 4;  // 16 int8 values a load: Dd = 1024 is 2 loads a lane
  float d = 0.f;
  if (c.vec) {
    const int n16 = c.dd >> 4;
    const int4* c16 = reinterpret_cast<const int4*>(c.dense + size_t(row) * c.dd);
    const float4* q4 = reinterpret_cast<const float4*>(qd);
    for (int base = 0; base < n16; base += U * kWarp) {
      int4 a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * kWarp + lane;
        a[u] = i < n16 ? __ldg(c16 + i) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * kWarp + lane;
        if (i < n16)
          d += dot4_i8(a[u].x, q4[4 * i]) + dot4_i8(a[u].y, q4[4 * i + 1]) +
               dot4_i8(a[u].z, q4[4 * i + 2]) + dot4_i8(a[u].w, q4[4 * i + 3]);
      }
    }
  } else {
    const int8_t* crow = c.dense + size_t(row) * c.dd;
    for (int i = lane; i < c.dd; i += kWarp) d += float(__ldg(crow + i)) * qd[i];
  }
  return d;
}

// ---- the query ---------------------------------------------------------------

struct QueryArgs {
  const float* dense;
  const int* si;
  const float* sv;
  const int* fi;
  const float* fv;
  int dd, psq, pfq;
};

// One query row staged in a block's shared memory: dense values plus both
// sorted ELL rows and their live counts.
struct QueryCache {
  float* dense;
  int* sid;
  float* sval;
  int* fid;
  float* fval;
  int* counts;  // [0] live learned ids, [1] live lexical ids

  template <typename View>
  __device__ __forceinline__ float dense_dot(const View& c, long long row, int lane) const {
    return dense_partial(c, dense, row, lane);
  }
  // lane's slot (key, val) of the row against the learned (path 0) or the
  // lexical (path 1) ids
  __device__ __forceinline__ float match(int path, int key, float val) const {
    if (key < 0) return 0.f;
    const int j = find_sorted(path ? fid : sid, counts[path], key);
    return j >= 0 ? val * (path ? fval : sval)[j] : 0.f;
  }
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

// Block-cooperative staging of query row b: its dense row copied, each ELL
// row sorted by one warp; ends with __syncthreads().
static __device__ __forceinline__ void stage_query(const QueryCache& q, const QueryArgs& qa,
                                                   int b) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const float* qrow = qa.dense + size_t(b) * qa.dd;
  for (int i = threadIdx.x; i < qa.dd; i += blockDim.x) q.dense[i] = qrow[i];
  if (warp == 0) {
    const int n = warp_sort_ell(qa.si + size_t(b) * qa.psq, qa.sv + size_t(b) * qa.psq, qa.psq,
                                q.sid, q.sval, lane);
    if (lane == 0) q.counts[0] = n;
  }
  if (warp == (nwarps > 1 ? 1 : 0)) {
    const int n = warp_sort_ell(qa.fi + size_t(b) * qa.pfq, qa.fv + size_t(b) * qa.pfq, qa.pfq,
                                q.fid, q.fval, lane);
    if (lane == 0) q.counts[1] = n;
  }
  __syncthreads();
}

// One query row held by one warp in registers: the 16-byte dense words each
// lane multiplies (laid out as the view's dense loop reads them) and the two
// ELL rows sorted across the lanes (lane t: the t-th smallest live id; dead
// lanes kNoPos). Takes 16-byte aligned query rows, Dd <= 1024 (fp32) and ELL
// widths <= 32; the block form takes the rest.
template <typename View>
struct WarpQuery {
  float4 w[kQueryWords];
  int sid, fid, ns, nf;
  float sval, fval;

  __device__ __forceinline__ void load_ell(const int* idx, const float* val, int P, int& key,
                                           float& v, int& n, int lane) {
    key = lane < P ? __ldg(idx + lane) : -1;
    v = key >= 0 ? __ldg(val + lane) : 0.f;
    n = __popc(__ballot_sync(kFull, key >= 0));
    if (key < 0) key = kNoPos;
    warp_bitonic(key, v, lane);
  }

  // fp32 rows: word u of the lane is query word u * 32 + lane; int8 rows
  // (16 values a corpus word): words 4 v + e are query word 4 (v * 32 +
  // lane) + e, the four that corpus word v * 32 + lane multiplies.
  __device__ __forceinline__ void load(const QueryArgs& qa, int b, int lane) {
    const float4* q4 = reinterpret_cast<const float4*>(qa.dense + size_t(b) * qa.dd);
    const int n4 = qa.dd >> 2;
#pragma unroll
    for (int u = 0; u < kQueryWords; ++u) {
      const int i = word(u, lane);
      w[u] = i < n4 ? __ldg(q4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    load_ell(qa.si + size_t(b) * qa.psq, qa.sv + size_t(b) * qa.psq, qa.psq, sid, sval, ns, lane);
    load_ell(qa.fi + size_t(b) * qa.pfq, qa.fv + size_t(b) * qa.pfq, qa.pfq, fid, fval, nf, lane);
  }

  static __device__ __forceinline__ int word(int u, int lane);
  __device__ __forceinline__ float dense_dot(const View& c, long long row, int lane) const;

  __device__ __forceinline__ float match(int path, int key, float val) const {
    return path ? lane_match(key, val, fid, fval, nf) : lane_match(key, val, sid, sval, ns);
  }
};

template <>
__device__ __forceinline__ int WarpQuery<CorpusView>::word(int u, int lane) {
  return u * kWarp + lane;
}
template <>
__device__ __forceinline__ int WarpQuery<CorpusViewQ8>::word(int u, int lane) {
  return 4 * ((u >> 2) * kWarp + lane) + (u & 3);
}

// The loops of dense_partial with the query words in registers: the same
// loads in flight and the same sums in the same order.
template <>
__device__ __forceinline__ float WarpQuery<CorpusView>::dense_dot(const CorpusView& c,
                                                                  long long row,
                                                                  int lane) const {
  float d = 0.f;
  const int n4 = c.dd >> 2;
  const float4* c4 = reinterpret_cast<const float4*>(c.dense + size_t(row) * c.dd);
#pragma unroll
  for (int v0 = 0; v0 < kQueryWords; v0 += kOnePassVec) {
    if (v0 * kWarp >= n4) break;
    float4 a[kOnePassVec];
#pragma unroll
    for (int u = 0; u < kOnePassVec; ++u) {
      const int i = (v0 + u) * kWarp + lane;
      a[u] = i < n4 ? __ldg(c4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kOnePassVec; ++u) {
      const int i = (v0 + u) * kWarp + lane;
      if (i < n4) {
        const float4 b = w[v0 + u];
        d += a[u].x * b.x + a[u].y * b.y + a[u].z * b.z + a[u].w * b.w;
      }
    }
  }
  return d;
}

template <>
__device__ __forceinline__ float WarpQuery<CorpusViewQ8>::dense_dot(const CorpusViewQ8& c,
                                                                    long long row,
                                                                    int lane) const {
  constexpr int U = kQueryWords / 4;  // corpus words a lane: Dd <= 1024
  float d = 0.f;
  const int n16 = c.dd >> 4;
  const int4* c16 = reinterpret_cast<const int4*>(c.dense + size_t(row) * c.dd);
  int4 a[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = u * kWarp + lane;
    a[u] = i < n16 ? __ldg(c16 + i) : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = u * kWarp + lane;
    if (i < n16)
      d += dot4_i8(a[u].x, w[4 * u]) + dot4_i8(a[u].y, w[4 * u + 1]) +
           dot4_i8(a[u].z, w[4 * u + 2]) + dot4_i8(a[u].w, w[4 * u + 3]);
  }
  return d;
}

// ---- the row scorer ------------------------------------------------------------

// Hybrid score (dense + learned) + lexical of live corpus row `row` against
// query q (a QueryCache or a WarpQuery); every lane returns it. Every load of
// the row is issued before any result is used: lane p's ELL id and value of
// both paths (a value loaded only on a match would be one more latency in the
// chain), the scale, then the dense words; the lookups in the query's sorted
// ids run while those loads are in flight. ELL slots past 32 (wider rows)
// take further rounds of the warp.
template <typename View, typename Query>
static __device__ __forceinline__ float score_row(const View& c, const Query& q, long long row,
                                                  int lane) {
  const size_t os = size_t(row) * c.ps + lane, of = size_t(row) * c.pf + lane;
  const int sid = lane < c.ps ? __ldg(c.si + os) : -1;
  const float sv = lane < c.ps ? ell_val(c.sv + os) : 0.f;
  const int fid = lane < c.pf ? __ldg(c.fi + of) : -1;
  const float fv = lane < c.pf ? ell_val(c.fv + of) : 0.f;
  const float sc = row_scale(c, row);
  float d = q.dense_dot(c, row, lane);
  float s = q.match(0, sid, sv);
  float f = q.match(1, fid, fv);
  float ts = 0.f, tf = 0.f;
  for (int p = kWarp + lane; p - lane < c.ps; p += kWarp) {
    const bool in = p < c.ps;
    ts += q.match(0, in ? __ldg(c.si + os + p - lane) : -1,
                  in ? ell_val(c.sv + os + p - lane) : 0.f);
  }
  for (int p = kWarp + lane; p - lane < c.pf; p += kWarp) {
    const bool in = p < c.pf;
    tf += q.match(1, in ? __ldg(c.fi + of + p - lane) : -1,
                  in ? ell_val(c.fv + of + p - lane) : 0.f);
  }
  s += ts;
  f += tf;
  d = finish(c, warp_sum(d), sc);
  s = warp_sum(s);
  f = warp_sum(f);
  return (d + s) + f;  // score_row
}

}  // namespace rt
