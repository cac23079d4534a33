// Flash TopK for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/flash_topk.py::flash_topk of the JAX
// package (grouped grid _flash_topk_kernel_grouped; the flat grid
// _flash_topk_kernel computes the same function).  Each query scores every
// key-block centroid with an unscaled fp32 dot product and keeps a running
// top-k; the (Nq, nb) score matrix never reaches device memory.
//
// Selection semantics (flash_topk.py:225-241, routing.select_blocks):
//   * causal: blocks after the query's own block score -1e30, the own
//     block +1e30 (always selected);
//   * slots scoring <= -5e29 at the end become the sentinel nb (so do
//     slots never filled when nb < top_k);
//   * ties keep the lower block id, as lax.top_k does.
// Future blocks are never offered instead of entering at -1e30: every such
// entry ends as the sentinel, and it can never displace a real score.
//
// What bounds it on an H100: bytes.  It reads q once (BH*Nq*d), the
// centroids (BKV*nb*d, served from L2 to the q tiles that share them) and
// writes BH*Nq*k int32 ids: 21.1 MB at moba-340m's training shape (Nq 8192,
// 16 heads, d 64, top_k 8, bf16), 6.3 us at 3.35 TB/s.  The 2*d flops per
// (query, block) pair are far below the compute roof.  The first design
// (one thread a row, a 64-long chain of scalar FMAs from shared memory per
// candidate, q loaded one row a thread, a 16-step compare-and-swap per
// candidate whatever top_k was) ran 22x that.
//
// What the design does about it.  One CTA of 128 threads covers R rows:
// the G query heads of a GQA group times R/G consecutive queries, so one
// centroid tile in shared memory serves all G*(R/G) rows, and every row of
// a CTA shares the causal extent (the CTA stages only the centroid tiles up
// to its last query's block).
//   * Staging: the CTA's q rows and 32-centroid tiles come in by 16-byte
//     cp.async copies (each q row read once, coalesced); the centroid tiles
//     are double-buffered, the next tile's copies issued before this
//     tile's scores.
//   * Scores, bf16: each warp computes S = Q C^T for 32 rows with
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate; products of two bf16
//     values are exact in fp32, so only the order of the sum differs from
//     the plain version's) and writes S to shared memory, rows padded by
//     one word.  fp32 keeps a SIMT body: each thread scores its own row
//     against four centroids at a time with float4 shared-memory reads
//     (TF32 would break the fp32 routing checks).
//   * Selection: thread r owns row r and is offered the candidates in
//     ascending block id.  A candidate that does not beat the row's k-th
//     score is filtered out with one compare.  A survivor is merged by
//     rank: its place is the number of list entries that beat it, and
//     each entry it beats moves down one place, its id with it.  Every
//     list entry has a lower id than the candidate, so "beats" is a strict
//     score compare, all k compares are independent (no carried chain),
//     and the tie order is lax.top_k's.  For top_k <= 32 the list lives in
//     registers, unrolled to the bucket KR in {8, 16, 32} with the first
//     KR - top_k slots blocked at +3e30 so they never move; above that it
//     lives in shared memory, [top_k][R] interleaved so the threads of a
//     warp touch distinct banks, with a binary search for the place.  Rows
//     per CTA follow from top_k so the lists fit: 128 rows up to top_k
//     128, then 16 * floor(1024 / top_k), which sets the limit
//     top_k <= 1024 (16 rows, 128 KB of lists).
//
// Registers and shared memory (ptxas, and smem_bytes below), bf16 at d 64:
// top_k 8 (KR 8) 56 registers, top_k 32 (KR 32) 124 registers, no spills;
// 44,544 bytes of dynamic shared memory for either (q 18,432, two centroid
// tiles 9,216, scores 16,896), so 4-5 CTAs an SM.  The shared-memory-list
// kernels (top_k > 32) keep a stack frame of 8-24 bytes.
//
// Where the time goes: selection, not scores.  A survivor costs a
// compare and four selects a slot.  At the small-block shape (nb 256,
// top_k 32) about 60% of the ~16.8 M causal (row, candidate) pairs survive
// the filter (a row keeps k(1 + ln(n/k)) of n candidates in ascending
// order), and the filter skips only a candidate all 32 rows of a warp
// skip, so the kernel is bound by issuing the merges, far above its bytes
// bound; at moba-340m's shape (top_k 8) the merges are short.
//
// Tried, not kept: two passes over the centroid tiles, pass 1 merging
// scores only (two min/max instructions a slot) and pass 2 recomputing
// the scores to give the slots their ids; its times were not recorded
// and it was not measured against the final kernel.  Not tried: a
// warp-wide selection (bitonic merges of per-thread queues, as in
// FAISS's WarpSelect), two threads a row.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// the cudaGetLastError() of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 128;        // rows a CTA covers at most
constexpr int kCentTile = 32;        // centroids staged per step
constexpr int kRegMaxK = 32;         // register lists up to this top_k
constexpr int kListBytes = 131072;   // shared-memory lists above it
constexpr int kMaxTopK = kListBytes / (8 * 16);   // 16 rows: 1024
constexpr float kNegInf = -1e30f;
constexpr float kPosInf = 1e30f;
constexpr float kInit = -3e30f;      // an empty slot: below every score
constexpr float kBlocked = 3e30f;    // an unused register slot

using bf16 = __nv_bfloat16;

// rows a CTA covers for this top_k: a multiple of 16 (one mma m-tile)
__host__ __device__ constexpr int rows_for(int top_k) {
  return top_k <= kRegMaxK
             ? kMaxRows
             : (16 * (kListBytes / (8 * 16 * top_k)) < kMaxRows
                    ? 16 * (kListBytes / (8 * 16 * top_k))
                    : kMaxRows);
}

// padded row strides (elements) of q and a centroid tile in shared memory
template <typename T, int D>
__host__ __device__ constexpr int ld_of() {
  return std::is_same<T, float>::value ? D + 4 : D + 8;
}
constexpr int kLdS = kCentTile + 1;  // fp32 score rows

template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes(int rows, int top_k) {
  return sizeof(T) * (static_cast<size_t>(rows) + 2 * kCentTile) *
             ld_of<T, D>() +
         (std::is_same<T, bf16>::value ? sizeof(float) * rows * kLdS : 0) +
         (top_k > kRegMaxK ? static_cast<size_t>(8) * rows * top_k : 0);
}

// The running top-k of one row in registers, ordered by (score
// descending, id ascending).  Candidates arrive in ascending id, so a
// candidate beats an entry iff its score is strictly higher.  The first
// KR - top_k slots are blocked at +3e30 so they never move.
template <int KR>
struct RegList {
  float s[KR];
  int id[KR];
  __device__ void init(int top_k) {
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      s[j] = j < KR - top_k ? kBlocked : kInit;
      id[j] = 0;
    }
  }
  __device__ __forceinline__ void offer(float x, int c) {
    if (!(x > s[KR - 1])) return;            // filtered: not in the top-k
    bool b[KR];
#pragma unroll
    for (int j = 0; j < KR; ++j) b[j] = x > s[j];
#pragma unroll
    for (int j = KR - 1; j > 0; --j)
      if (b[j]) {
        s[j] = b[j - 1] ? s[j - 1] : x;
        id[j] = b[j - 1] ? id[j - 1] : c;
      }
    if (b[0]) {
      s[0] = x;
      id[0] = c;
    }
  }
  __device__ void store(int32_t* dst, int top_k, int nb) const {
#pragma unroll
    for (int j = 0; j < KR; ++j)
      if (j >= KR - top_k)
        dst[j - (KR - top_k)] = s[j] <= kNegInf * 0.5f ? nb : id[j];
  }
};

// The list for top_k > 32, in shared memory (entry j of row r at
// [j * rows + r]): a survivor's place comes from a binary search, the
// entries below it move down one.
struct SmemList {
  float* s;
  int* id;
  int rows, top_k;
  float thr;                                 // the k-th score, cached
  __device__ void init(float* s_base, int* id_base, int r, int rows_,
                       int k) {
    s = s_base + r;
    id = id_base + r;
    rows = rows_;
    top_k = k;
    for (int j = 0; j < k; ++j) {
      s[j * rows] = kInit;
      id[j * rows] = 0;
    }
    thr = kInit;
  }
  __device__ __forceinline__ void offer(float x, int c) {
    if (!(x > thr)) return;
    int lo = 0, hi = top_k - 1;              // x beats entry top_k - 1
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (x > s[mid * rows]) hi = mid;
      else lo = mid + 1;
    }
    for (int j = top_k - 1; j > lo; --j) {
      s[j * rows] = s[(j - 1) * rows];
      id[j * rows] = id[(j - 1) * rows];
    }
    s[lo * rows] = x;
    id[lo * rows] = c;
    thr = s[(top_k - 1) * rows];
  }
  __device__ void store(int32_t* dst, int, int nb) const {
    for (int j = 0; j < top_k; ++j)
      dst[j] = s[j * rows] <= kNegInf * 0.5f ? nb : id[j * rows];
  }
};

template <int KR>
struct ListOf {
  using type = RegList<KR>;
};
template <>
struct ListOf<0> {
  using type = SmemList;
};

// KR: the register bucket (8, 16, 32), or 0 for shared-memory lists.
template <typename T, int D, int KR>
__global__ void __launch_bounds__(kThreads)
flash_topk_kernel(const T* __restrict__ q, const T* __restrict__ cents,
                  int32_t* __restrict__ out, int nq, int nb, int top_k,
                  int bs, int group, int qc, int causal, int q_pos_offset) {
  constexpr int LD = ld_of<T, D>();
  constexpr int kBf16 = std::is_same<T, bf16>::value;
  constexpr int kChunk = 16 / sizeof(T);     // elements a 16-byte copy
  constexpr int kChunks = D / kChunk;        // copies a row
  const int rows = group * qc;               // <= rows_for(top_k)
  const int rows_pad = (rows + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);                 // [rows_pad][LD]
  T* cs = qs + rows_pad * LD;                             // [2][kCentTile][LD]
  float* ss = reinterpret_cast<float*>(cs + 2 * kCentTile * LD);
  float* ls = ss + (kBf16 ? rows_pad * kLdS : 0);         // [top_k][rows_pad]
  int* li = reinterpret_cast<int*>(ls + (KR ? 0 : top_k * rows_pad));

  const int bkv = blockIdx.y;
  const int q0 = blockIdx.x * qc;
  const int tid = threadIdx.x;
  const T* crow = cents + static_cast<size_t>(bkv) * nb * D;
  // this CTA's candidates: blocks up to its last query's own block
  const int q_last = min(q0 + qc, nq) - 1;
  const int n_cand =
      causal ? min(nb, (q_pos_offset + q_last) / bs + 1) : nb;
  const int n_tiles = (n_cand + kCentTile - 1) / kCentTile;

  // q rows: row r = head r / qc of the group, query q0 + r % qc
  for (int e = tid; e < rows_pad * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * kChunk;
    const int gg = r / qc;
    const int qi = q0 + (r - gg * qc);
    const bool in = r < rows && qi < nq;
    const size_t src =
        in ? (static_cast<size_t>(bkv * group + gg) * nq + qi) * D + c : 0;
    mma::cp_async16(qs + r * LD + c, q + src, in);
  }
  auto load_tile = [&](int t) {
    T* dst = cs + (t & 1) * kCentTile * LD;
    const int c0 = t * kCentTile;
    for (int e = tid; e < kCentTile * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * kChunk;
      const bool in = c0 + r < n_cand;
      mma::cp_async16(dst + r * LD + c,
                      crow + static_cast<size_t>(in ? c0 + r : 0) * D + c,
                      in);
    }
  };
  // this thread's row
  const int r = tid;
  const int gg = r / qc;
  const int qi = q0 + (r - gg * qc);
  const bool active = r < rows && qi < nq;
  const int own = (q_pos_offset + qi) / bs;
  const int lim = causal ? min(own + 1, nb) : nb;  // candidates it sees
  typename ListOf<KR>::type list;
  if constexpr (KR == 0) {
    if (active) list.init(ls, li, r, rows_pad, top_k);
  } else {
    list.init(top_k);
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // every candidate this row sees, in ascending id (the own block +1e30)
  auto offer = [&](float s, int cand) {
    list.offer(causal && cand == own ? kPosInf : s, cand);
  };
  if (n_tiles > 0) load_tile(0);
  mma::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();                         // q and tile t landed
    const T* ct = cs + (t & 1) * kCentTile * LD;
    const int c0 = t * kCentTile;
    if constexpr (kBf16) {
      // S = Q C^T, 32 rows a warp: m-tiles 2 warp and 2 warp + 1
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m0 = (2 * warp + mt) * 16;
        if (m0 >= rows) continue;
        float acc[kCentTile / 8][4];
#pragma unroll
        for (int j = 0; j < kCentTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          mma::ldsm_x4(qs + mma::a_offset(lane, m0, kk * 16, LD), a);
#pragma unroll
          for (int np = 0; np < kCentTile / 16; ++np) {
            uint32_t b[4];
            mma::ldsm_x4(ct + mma::bn_offset(lane, np * 16, kk * 16, LD), b);
            mma::mma16816(acc[2 * np], a, b[0], b[1]);
            mma::mma16816(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
        const int g = lane >> 2;
        const int tq = lane & 3;
#pragma unroll
        for (int j = 0; j < kCentTile / 8; ++j) {
          float* lo = ss + (m0 + g) * kLdS + 8 * j + 2 * tq;
          float* hi = lo + 8 * kLdS;
          lo[0] = acc[j][0];
          lo[1] = acc[j][1];
          hi[0] = acc[j][2];
          hi[1] = acc[j][3];
        }
      }
      __syncthreads();
      if (active && c0 < lim) {
        const float* srow = ss + r * kLdS;
        const int nc = min(kCentTile, lim - c0);
        for (int c = 0; c < nc; ++c) offer(srow[c], c0 + c);
      }
    } else {
      // fp32: this row against four centroids at a time
      if (active && c0 < lim) {
        const float* qrow = reinterpret_cast<const float*>(qs) + r * LD;
        const int nc = min(kCentTile, lim - c0);
        for (int c = 0; c < nc; c += 4) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int kk = 0; kk < D; kk += 4) {
            const float4 a = *reinterpret_cast<const float4*>(qrow + kk);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 b = *reinterpret_cast<const float4*>(
                  reinterpret_cast<const float*>(ct) + (c + j) * LD + kk);
              acc[j] = fmaf(a.x, b.x, acc[j]);
              acc[j] = fmaf(a.y, b.y, acc[j]);
              acc[j] = fmaf(a.z, b.z, acc[j]);
              acc[j] = fmaf(a.w, b.w, acc[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < nc) offer(acc[j], c0 + c + j);
        }
      }
    }
    __syncthreads();                         // tile t and S consumed
  }
  if (active)
    list.store(out + (static_cast<size_t>(bkv * group + gg) * nq + qi) *
                         top_k,
               top_k, nb);
}

template <typename T, int D, int KR>
int launch(const void* q, const void* cents, void* out, int bkv, int nq,
           int nb, int top_k, int bs, int group, int causal,
           int q_pos_offset, cudaStream_t s) {
  const int rows_cap = rows_for(top_k);
  const int qc = rows_cap / group;
  const int rows_pad = (group * qc + 15) & ~15;
  const size_t smem = smem_bytes<T, D>(rows_pad, top_k);
  auto kernel = flash_topk_kernel<T, D, KR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + qc - 1) / qc, bkv);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(cents),
      static_cast<int32_t*>(out), nq, nb, top_k, bs, group, qc, causal,
      q_pos_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch(const void* q, const void* cents, void* out, int bkv, int nq,
             int nb, int top_k, int bs, int group, int causal,
             int q_pos_offset, cudaStream_t s) {
  auto* run = top_k <= 8    ? &launch<T, D, 8>
              : top_k <= 16 ? &launch<T, D, 16>
              : top_k <= 32 ? &launch<T, D, 32>
                            : &launch<T, D, 0>;
  return run(q, cents, out, bkv, nq, nb, top_k, bs, group, causal,
             q_pos_offset, s);
}

}  // namespace

// q (BKV*group, nq, d), cents (BKV, nb, d), out (BKV*group, nq, top_k)
// int32.  dtype: 0 = float32, 1 = bfloat16 (q and centroids share it).
// top_k 1..1024; group at most the rows a CTA covers for this top_k (the
// kernel picks its own rows per CTA: rows_for).
extern "C" int flash_topk(const void* q, const void* cents, void* out,
                          int bkv, int nq, int nb, int d, int top_k, int bs,
                          int group, int causal, int q_pos_offset, int dtype,
                          void* stream) {
  if (bkv < 1 || bkv > 65535 || nq < 1 || nb < 1 || (d != 64 && d != 128) ||
      top_k < 1 || top_k > kMaxTopK || bs < 1 || group < 1 ||
      group > rows_for(top_k) || q_pos_offset < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (d == 64 ? &dispatch<float, 64> : &dispatch<float, 128>)(
        q, cents, out, bkv, nq, nb, top_k, bs, group, causal, q_pos_offset,
        s);
  if (dtype == 1)
    return (d == 64 ? &dispatch<bf16, 64> : &dispatch<bf16, 128>)(
        q, cents, out, bkv, nq, nb, top_k, bs, group, causal, q_pos_offset,
        s);
  return cudaErrorInvalidValue;
}
