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
//   * ties keep the lower block id, as lax.top_k does: candidates are
//     visited in ascending id and the running list is ordered by (score
//     descending, id ascending).
// Future blocks are skipped instead of inserted at -1e30: every such
// entry ends as the sentinel, and it can never displace a real score.
//
// What bounds it on an H100: bytes.  It reads q once (BH*Nq*d), the
// centroids (BKV*nb*d) and writes BH*Nq*k int32 ids; 2*d flops per
// (query, block) pair are far below the compute roof at nb = N/128.
//
// What the design does about it: one CTA per (batch*kv head, q tile)
// covers the G query heads of the group, so one staged centroid tile in
// shared memory serves all G*q_tile rows.  One thread per (head, query)
// row keeps its query in registers and its k-entry list in registers; q
// is read from device memory exactly once and the list never leaves the
// thread.  Rows beyond 128 are handled in further passes of the CTA.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// the cudaGetLastError() of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCentTile = 32;   // centroids staged in shared memory per step
constexpr int kMaxK = 16;
constexpr float kNegInf = -1e30f;
constexpr float kPosInf = 1e30f;
constexpr float kInit = -3e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_topk_kernel(const T* __restrict__ q, const T* __restrict__ cents,
                  int32_t* __restrict__ out, int nq, int nb, int top_k,
                  int bs, int group, int q_tile, int causal,
                  int q_pos_offset) {
  __shared__ float cs[kCentTile][D];
  const int bkv = blockIdx.y;
  const int qt = blockIdx.x;
  const int rows = group * q_tile;
  const T* crow = cents + static_cast<size_t>(bkv) * nb * D;

  for (int r0 = 0; r0 < rows; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    const int g = r / q_tile;
    const int qi = qt * q_tile + (r - g * q_tile);
    const bool active = r < rows && qi < nq;
    const int bh = bkv * group + g;   // heads of a group are contiguous
    float qv[D];
    if (active) {
      const T* src = q + (static_cast<size_t>(bh) * nq + qi) * D;
#pragma unroll
      for (int kk = 0; kk < D; ++kk) qv[kk] = to_float(src[kk]);
    } else {
#pragma unroll
      for (int kk = 0; kk < D; ++kk) qv[kk] = 0.f;
    }
    const int own = (q_pos_offset + qi) / bs;
    float ls[kMaxK];
    int li[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      ls[j] = kInit;
      li[j] = 0;
    }

    for (int c0 = 0; c0 < nb; c0 += kCentTile) {
      const int nc = min(kCentTile, nb - c0);
      __syncthreads();                 // the previous tile is consumed
      for (int e = threadIdx.x; e < nc * D; e += kThreads)
        cs[e / D][e % D] = to_float(crow[static_cast<size_t>(c0) * D + e]);
      __syncthreads();
      if (!active) continue;
      for (int cc = 0; cc < nc; ++cc) {
        const int cand = c0 + cc;
        if (causal && cand > own) break;   // ids ascend: the rest is future
        float s;
        if (causal && cand == own) {
          s = kPosInf;
        } else {
          s = 0.f;
#pragma unroll
          for (int kk = 0; kk < D; ++kk) s = fmaf(qv[kk], cs[cc][kk], s);
        }
        // insert, carrying displaced entries down the list
        float cs_ = s;
        int ci = cand;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          if (j < top_k) {
            const bool win = cs_ > ls[j] || (cs_ == ls[j] && ci < li[j]);
            if (win) {
              const float ts = ls[j];
              const int ti = li[j];
              ls[j] = cs_;
              li[j] = ci;
              cs_ = ts;
              ci = ti;
            }
          }
        }
      }
    }
    if (active) {
      int32_t* dst = out + (static_cast<size_t>(bh) * nq + qi) * top_k;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j < top_k) dst[j] = ls[j] <= kNegInf * 0.5f ? nb : li[j];
    }
  }
}

template <typename T>
int launch(const void* q, const void* cents, void* out, int bkv, int nq,
           int nb, int d, int top_k, int bs, int group, int q_tile,
           int causal, int q_pos_offset, cudaStream_t s) {
  const dim3 grid((nq + q_tile - 1) / q_tile, bkv);
  const auto* qp = static_cast<const T*>(q);
  const auto* cp = static_cast<const T*>(cents);
  auto* op = static_cast<int32_t*>(out);
  if (d == 64)
    flash_topk_kernel<T, 64><<<grid, kThreads, 0, s>>>(
        qp, cp, op, nq, nb, top_k, bs, group, q_tile, causal, q_pos_offset);
  else
    flash_topk_kernel<T, 128><<<grid, kThreads, 0, s>>>(
        qp, cp, op, nq, nb, top_k, bs, group, q_tile, causal, q_pos_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (BKV*group, nq, d), cents (BKV, nb, d), out (BKV*group, nq, top_k)
// int32.  dtype: 0 = float32, 1 = bfloat16 (q and centroids share it).
extern "C" int flash_topk(const void* q, const void* cents, void* out,
                          int bkv, int nq, int nb, int d, int top_k, int bs,
                          int group, int q_tile, int causal,
                          int q_pos_offset, int dtype, void* stream) {
  if (bkv < 1 || bkv > 65535 || nq < 1 || nb < 1 || (d != 64 && d != 128) ||
      top_k < 1 || top_k > kMaxK || bs < 1 || group < 1 || q_tile < 1 ||
      q_pos_offset < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, cents, out, bkv, nq, nb, d, top_k, bs, group,
                         q_tile, causal, q_pos_offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, cents, out, bkv, nq, nb, d, top_k, bs,
                                 group, q_tile, causal, q_pos_offset, s);
  return cudaErrorInvalidValue;
}
