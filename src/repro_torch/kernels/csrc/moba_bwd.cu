// FlashMoBA backward for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/moba_bwd.py::moba_bwd of the JAX package
// (kb-tiled grid _bwd_kernel_tiled; the flat grid _bwd_kernel computes the
// same function).  Over the forward's key-block-major layout it recomputes
// p = exp(s - lse) per slot and produces per-slot dQ and per-block dK/dV
// for every query head (the wrapper sums the GQA group):
//   dV_j += p^T dO,  dS = p * (dO V^T - delta) * scale,
//   dK_j += dS^T Q,  dQ_slot = dS K_j.
//
// The TPU kernel accumulated dK/dV across consecutive grid steps, which
// blocks that run in no order cannot do.  This kernel is key-block
// parallel (the paper's FlashMoBA design): block j's tiles are one
// contiguous run of the sorted layout.  A run can be long (routing sends
// many queries to a few blocks), so the wrapper cuts every run into
// segments of at most a few tiles; pass 1 runs one CTA per segment, which
// writes dQ of its slots directly (every slot belongs to one segment: no
// atomics, deterministic) and its partial dK/dV of the block into scratch.
// Pass 2 sums each block's partials in segment order into dK/dV (again
// deterministic); a block no tile visits gets zeros.  One extra CTA per
// row zeroes dQ of the inactive tiles at the layout's tail.
//
// What bounds it on an H100: bytes, because q_sorted, dO (fp32) and dQ
// (fp32) live in device memory in the sorted layout: at moba-340m
// training shapes ~0.9 GB against ~86 GFLOP, ~100 flops per byte.
//
// What the design does about it: per 32-key chunk of the block, the
// segment's q/dO rows stream through shared memory in 32-row slices with
// 16-byte loads issued together; p and dS of a (32 x 32) slice live in
// shared memory and feed the three products, each mapped so that one
// operand is a broadcast and the other a conflict-free row, with the
// reused operand held in registers.  dK/dV of the chunk accumulate in
// registers across the segment.  (q_sorted and dO are read once per
// 32-key chunk, bs/32 times in all.)
//
// Not done yet (later work): wgmma for the five products, and keeping the
// whole block's dK/dV on chip so q_sorted and dO are read once.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// the cudaGetLastError() of the launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                    // keys per chunk (one per lane)
constexpr int kRows = 32;                    // q rows per slice
constexpr int kRowsPerWarp = kRows / kWarps; // 8

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = __bfloat162float(h[j]);
}

// Stage 32 rows of width D (row stride D in src) as fp32 rows of stride
// D + 1; rows at or past `rows` are zero.  All loads are issued before the
// first store so their latencies overlap.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows,
                                      float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPer = kRows * D / (kVec * kThreads);
  float tmp[kPer][kVec];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = (threadIdx.x + i * kThreads) * kVec;
    if (e / D < rows) {
      load16(src + e, tmp[i]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) tmp[i][j] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = (threadIdx.x + i * kThreads) * kVec;
    const int r = e / D;
    const int c = e - r * D;
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * (D + 1) + c + j] = tmp[i][j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
moba_bwd_kernel(const int32_t* __restrict__ seg_block,
                const int32_t* __restrict__ seg_lo,
                const int32_t* __restrict__ seg_hi,
                const int32_t* __restrict__ tail_lo,
                const T* __restrict__ q_sorted,
                const int32_t* __restrict__ q_pos,
                const float* __restrict__ do_sorted,
                const float* __restrict__ lse_sorted,
                const float* __restrict__ delta_sorted,
                const T* __restrict__ k_blocks,
                const T* __restrict__ v_blocks, float* __restrict__ dq,
                float* __restrict__ part_dk, float* __restrict__ part_dv,
                int n_tiles, int n_seg, int num_q_heads, int group, int nb,
                int bs, int n_tokens, int q_tile, float scale, int causal) {
  constexpr int kCols = D / 32;
  extern __shared__ float smem[];
  float* qs = smem;                          // [kRows][D + 1]
  float* dos = qs + kRows * (D + 1);         // [kRows][D + 1]
  float* ks = dos + kRows * (D + 1);         // [kKeys][D + 1]
  float* vs = ks + kKeys * (D + 1);          // [kKeys][D + 1]
  float* ps = vs + kKeys * (D + 1);          // [kRows][kKeys + 1]
  float* dss = ps + kRows * (kKeys + 1);     // [kRows][kKeys + 1]
  float* lse_s = dss + kRows * (kKeys + 1);  // [kRows]
  float* delta_s = lse_s + kRows;            // [kRows]
  int* qpos_s = reinterpret_cast<int*>(delta_s + kRows);  // [kRows]

  const int bh = blockIdx.y;
  const int seg = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t slot0 = static_cast<size_t>(bh) * n_tiles * q_tile;

  if (seg == n_seg) {       // tiles no block owns: their dQ slots are zero
    const size_t lo = (slot0 + static_cast<size_t>(tail_lo[bh]) * q_tile) * D;
    const size_t hi = (slot0 + static_cast<size_t>(n_tiles) * q_tile) * D;
    for (size_t e = lo + tid; e < hi; e += kThreads) dq[e] = 0.f;
    return;
  }
  const size_t sidx = static_cast<size_t>(bh) * n_seg + seg;
  const int j = seg_block[sidx];
  if (j < 0) return;        // spare CTA: the row has fewer segments
  const int t_lo = seg_lo[sidx];
  const int t_hi = seg_hi[sidx];
  float* pdk = part_dk + sidx * bs * D;
  float* pdv = part_dv + sidx * bs * D;

  const int hkv = num_q_heads / group;
  const int kv = (bh / num_q_heads) * hkv + (bh % num_q_heads) / group;
  const size_t kv_off = (static_cast<size_t>(kv) * nb + j) * bs * D;

  for (int kc0 = 0; kc0 < bs; kc0 += kKeys) {
    const int nk = min(kKeys, bs - kc0);
    __syncthreads();
    stage<T, D>(k_blocks + kv_off + static_cast<size_t>(kc0) * D, nk, ks);
    stage<T, D>(v_blocks + kv_off + static_cast<size_t>(kc0) * D, nk, vs);
    float dk_acc[kRowsPerWarp][kCols];
    float dv_acc[kRowsPerWarp][kCols];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dk_acc[i][c] = 0.f;
        dv_acc[i][c] = 0.f;
      }
    const int kpos = j * bs + kc0 + lane;    // this lane's key

    for (int t = t_lo; t < t_hi; ++t) {
      for (int rq0 = 0; rq0 < q_tile; rq0 += kRows) {
        const int nrow = min(kRows, q_tile - rq0);
        const size_t s0 = slot0 + static_cast<size_t>(t) * q_tile + rq0;
        __syncthreads();                     // previous slice consumed
        stage<T, D>(q_sorted + s0 * D, nrow, qs);
        stage<float, D>(do_sorted + s0 * D, nrow, dos);
        if (tid < kRows) {
          const bool in = tid < nrow;
          lse_s[tid] = in ? lse_sorted[s0 + tid] : 0.f;
          delta_s[tid] = in ? delta_sorted[s0 + tid] : 0.f;
          qpos_s[tid] = in ? q_pos[s0 + tid] : -1;
        }
        __syncthreads();
        // p and dS: lane = key, warp = rows warp + 4i
        float s[kRowsPerWarp];
        float dp[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          s[i] = 0.f;
          dp[i] = 0.f;
        }
        for (int kk = 0; kk < D; ++kk) {
          const float kv_ = ks[lane * (D + 1) + kk];
          const float vv = vs[lane * (D + 1) + kk];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const int r = warp + kWarps * i;
            s[i] = fmaf(qs[r * (D + 1) + kk], kv_, s[i]);
            dp[i] = fmaf(dos[r * (D + 1) + kk], vv, dp[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = warp + kWarps * i;
          const int qp = qpos_s[r];
          const bool ok = lane < nk && qp >= 0 && kpos < n_tokens &&
                          (!causal || kpos <= qp);
          const float p = ok ? expf(s[i] * scale - lse_s[r]) : 0.f;
          ps[r * (kKeys + 1) + lane] = p;
          dss[r * (kKeys + 1) + lane] = p * (dp[i] - delta_s[r]) * scale;
        }
        __syncthreads();
        // dV += p^T dO, dK += dS^T Q: lane = column, warp = keys warp + 4i
        for (int r = 0; r < nrow; ++r) {
          float dor[kCols];
          float qr[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dor[c] = dos[r * (D + 1) + lane + 32 * c];
            qr[c] = qs[r * (D + 1) + lane + 32 * c];
          }
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float p = ps[r * (kKeys + 1) + warp + kWarps * i];
            const float ds = dss[r * (kKeys + 1) + warp + kWarps * i];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              dv_acc[i][c] = fmaf(p, dor[c], dv_acc[i][c]);
              dk_acc[i][c] = fmaf(ds, qr[c], dk_acc[i][c]);
            }
          }
        }
        // dQ = dS K: lane = column, warp = rows warp + 4i
        float acc[kRowsPerWarp][kCols];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
        for (int jj = 0; jj < kKeys; ++jj) {
          float kc[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            kc[c] = ks[jj * (D + 1) + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float ds = dss[(warp + kWarps * i) * (kKeys + 1) + jj];
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[i][c] = fmaf(ds, kc[c], acc[i][c]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = warp + kWarps * i;
          if (r >= nrow) continue;
          float* dst = dq + (s0 + r) * D + lane;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            // the same thread owns this element in every chunk
            if (kc0 == 0) dst[32 * c] = acc[i][c];
            else dst[32 * c] += acc[i][c];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int key = warp + kWarps * i;
      if (key >= nk) continue;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const size_t e = static_cast<size_t>(kc0 + key) * D + lane + 32 * c;
        pdk[e] = dk_acc[i][c];
        pdv[e] = dv_acc[i][c];
      }
    }
  }
}

// Pass 2: dK/dV of block j = the sum of its segments' partials, in
// segment order; zero for a block no tile visits.
__global__ void __launch_bounds__(kThreads)
moba_bwd_reduce(const float* __restrict__ part_dk,
                const float* __restrict__ part_dv,
                const int32_t* __restrict__ seg_first,
                const int32_t* __restrict__ seg_count,
                float* __restrict__ dk, float* __restrict__ dv, int nb,
                int n_seg, int block_elems) {
  const int bh = blockIdx.y;
  const int j = blockIdx.x;
  const size_t bj = static_cast<size_t>(bh) * nb + j;
  const int first = seg_first[bj];
  const int count = seg_count[bj];
  const size_t base = (static_cast<size_t>(bh) * n_seg + first) * block_elems;
  for (int e = threadIdx.x; e < block_elems; e += kThreads) {
    float a = 0.f;
    float b = 0.f;
    for (int s = 0; s < count; ++s) {
      a += part_dk[base + static_cast<size_t>(s) * block_elems + e];
      b += part_dv[base + static_cast<size_t>(s) * block_elems + e];
    }
    dk[bj * block_elems + e] = a;
    dv[bj * block_elems + e] = b;
  }
}

template <typename T, int D>
int launch(const int32_t* const* tables, const void* qs, const void* qp,
           const void* dos, const void* lse, const void* delta,
           const void* kb, const void* vb, float* dq, float* dk, float* dv,
           float* part_dk, float* part_dv, int bh, int n_tiles, int n_seg,
           int h, int g, int nb, int bs, int n, int q_tile, float scale,
           int causal, cudaStream_t s) {
  const size_t smem = sizeof(float) * (2 * kRows * (D + 1) +
                                       2 * kKeys * (D + 1) +
                                       2 * kRows * (kKeys + 1) + 3 * kRows);
  auto kernel = moba_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_seg + 1, bh), kThreads, smem, s>>>(
      tables[0], tables[1], tables[2], tables[3],
      static_cast<const T*>(qs), static_cast<const int32_t*>(qp),
      static_cast<const float*>(dos), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(kb),
      static_cast<const T*>(vb), dq, part_dk, part_dv, n_tiles, n_seg, h, g,
      nb, bs, n, q_tile, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moba_bwd_reduce<<<dim3(nb, bh), kThreads, 0, s>>>(
      part_dk, part_dv, tables[4], tables[5], dk, dv, nb, n_seg, bs * D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Segment tables, all int32: seg_block/seg_lo/seg_hi (bh, n_seg) — the
// block (-1 = spare CTA) and tiles [lo, hi) of each segment; tail_lo (bh,)
// the first inactive tile; seg_first/seg_count (bh, nb) each block's
// segments.  q_sorted (bh, L, d); q_pos (bh, L) int32; do_sorted (bh, L,
// d), lse/delta (bh, L) float32; k/v_blocks (bh/group, nb, bs, d); dq (bh,
// L, d), dk/dv (bh, nb, bs, d) and the scratch part_dk/part_dv (bh, n_seg,
// bs, d) float32.  dtype: 0 = float32, 1 = bfloat16 (q_sorted and K/V).
extern "C" int moba_bwd(const void* seg_block, const void* seg_lo,
                        const void* seg_hi, const void* tail_lo,
                        const void* seg_first, const void* seg_count,
                        const void* q_sorted, const void* q_pos,
                        const void* do_sorted, const void* lse_sorted,
                        const void* delta_sorted, const void* k_blocks,
                        const void* v_blocks, void* dq, void* dk, void* dv,
                        void* part_dk, void* part_dv, int bh, int n_tiles,
                        int n_seg, int num_q_heads, int group, int nb, int bs,
                        int d, int n_tokens, int q_tile, float scale,
                        int causal, int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || n_tiles < 1 || n_seg < 1 ||
      num_q_heads < 1 || group < 1 || num_q_heads % group != 0 || nb < 1 ||
      bs < 1 || (d != 64 && d != 128) || q_tile < 1)
    return cudaErrorInvalidValue;
  const int32_t* tables[6] = {
      static_cast<const int32_t*>(seg_block),
      static_cast<const int32_t*>(seg_lo), static_cast<const int32_t*>(seg_hi),
      static_cast<const int32_t*>(tail_lo),
      static_cast<const int32_t*>(seg_first),
      static_cast<const int32_t*>(seg_count)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* dqp = static_cast<float*>(dq);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
  auto* pk = static_cast<float*>(part_dk);
  auto* pv = static_cast<float*>(part_dv);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(tables, q_sorted, q_pos, do_sorted, lse_sorted,
                             delta_sorted, k_blocks, v_blocks, dqp, dkp, dvp,
                             pk, pv, bh, n_tiles, n_seg, num_q_heads, group,
                             nb, bs, n_tokens, q_tile, scale, causal, s);
  if (dtype == 0)
    return launch<float, 128>(tables, q_sorted, q_pos, do_sorted, lse_sorted,
                              delta_sorted, k_blocks, v_blocks, dqp, dkp, dvp,
                              pk, pv, bh, n_tiles, n_seg, num_q_heads, group,
                              nb, bs, n_tokens, q_tile, scale, causal, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(
        tables, q_sorted, q_pos, do_sorted, lse_sorted, delta_sorted,
        k_blocks, v_blocks, dqp, dkp, dvp, pk, pv, bh, n_tiles, n_seg,
        num_q_heads, group, nb, bs, n_tokens, q_tile, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(
        tables, q_sorted, q_pos, do_sorted, lse_sorted, delta_sorted,
        k_blocks, v_blocks, dqp, dkp, dvp, pk, pv, bh, n_tiles, n_seg,
        num_q_heads, group, nb, bs, n_tokens, q_tile, scale, causal, s);
  return cudaErrorInvalidValue;
}
