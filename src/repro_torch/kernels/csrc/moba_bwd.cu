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
// segments of at most RUN_TILES tiles; pass 1 runs one CTA per segment,
// which writes dQ of its slots directly (every slot belongs to one
// segment: no atomics, deterministic) and its partial dK/dV of the block
// into scratch, or, for a block of one segment, dK/dV themselves.  Pass 2
// sums each other block's partials in segment order into dK/dV (again
// deterministic); a block no tile visits gets zeros.  One extra CTA per
// row zeroes dQ of the inactive tiles at the layout's tail.
//
// What bounds it on an H100: bytes, because q_sorted, dO and dQ (fp32)
// live in device memory in the sorted layout: at moba-340m training shapes
// ~0.72 GB with bf16 dO against ~86 GFLOP, ~120 flops a byte.  The first
// design did the five products with scalar fp32 FMAs (~16 TFLOP/s) and
// walked the block 32 keys at a time, re-reading the segment's q/dO rows
// and read-modify-writing dQ for every chunk.
//
// bf16 (the training path): one CTA of 8 warps per segment (and per 128
// keys of the block, for blocks above 128).  The block's K and V stay in
// shared memory as bf16; warp w owns keys 16w..16w+15 and keeps their dK
// and dV in fp32 registers across the whole segment.  The segment's rows
// (one contiguous range of slots) stream through a 2-stage cp.async ring
// in R-row slices (64 at d 64; 32 at d 128, where dK/dV alone take 128
// registers a thread): Q and dO (bf16, rows padded by 16 bytes for
// conflict-free ldmatrix), lse, delta and q_pos.  Per slice each warp runs
// on the tensor cores (mma.m16n8k16, bf16 in, fp32 accumulate)
//   S^T = K_w Q^T, dP^T = V_w dO^T              (B from the Q/dO rows)
//   P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale  (fp32)
//   dV_w += P^T dO, dK_w += dS^T Q              (A from the registers)
// writes dS^T to shared memory as bf16, and after one barrier all warps
// compute dQ = dS K for the slice (each warp 16 rows and a share of the
// columns, over every key the CTA holds) and store it once as fp32.  So
// q and dO are read once a segment and dQ is written once; the next
// slice's copies run under this slice's math; a slice takes two barriers.
// Rows past the segment's end are zero-filled, masked and never stored.
// Blocks above 128 keys split their keys across ceil(bs / 128) CTAs
// (blockIdx.z, any number: original MoBA's 512-key blocks take 4); each
// split writes its own dQ partial, summed in split order by the wrapper,
// so dQ stays exact and deterministic.  The registers this takes (~220 a
// thread) leave one CTA an SM; longer segments cost no re-reads now, and
// the wrapper's RUN_TILES is the fastest of 4, 8 and 16 on the card.
//
// fp32 keeps the SIMT body of the first design: TF32 products would break
// the fp32 tolerances the checks hold.  The dtype picks the body in the C
// entry point; a bf16 shape the tensor-core kernel cannot take is refused
// by the wrapper and never reaches the SIMT body.
//
// Not done yet (later work): fusing the Q/dO gather and the dQ
// segment-sum so the sorted copies never reach device memory; wgmma once
// the kernel is FLOP-bound.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// the cudaGetLastError() of the launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// ------------------------------------------------- bf16: tensor cores
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kSplitKeys = 16 * kMmaWarps;   // keys a CTA holds

using bf16 = __nv_bfloat16;

// Shared memory of moba_bwd_mma<DK, DV, R>, in bytes.
template <int DK, int DV, int R>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * ((kSplitKeys + 2 * R) * (DK + 8 + DV + 8) +
                         kSplitKeys * (R + 8)) +
         sizeof(float) * 6 * R;
}

// DK is the width of q, k and their gradients, DV that of v, dO and dV
// (equal but for latent attention's 192 / 128).  The products over the
// shared width run fused, as at DK == DV; the rest of q's width runs
// after them.
template <int DK, int DV, int R>
__global__ void __launch_bounds__(kMmaThreads, 1)
moba_bwd_mma(const int32_t* __restrict__ seg_block,
             const int32_t* __restrict__ seg_lo,
             const int32_t* __restrict__ seg_hi,
             const int32_t* __restrict__ tail_lo,
             const bf16* __restrict__ q_sorted,
             const int32_t* __restrict__ q_pos,
             const bf16* __restrict__ do_sorted,
             const float* __restrict__ lse_sorted,
             const float* __restrict__ delta_sorted,
             const bf16* __restrict__ k_blocks,
             const bf16* __restrict__ v_blocks,
             const int32_t* __restrict__ seg_count, float* __restrict__ dq,
             float* __restrict__ dk_out, float* __restrict__ dv_out,
             float* __restrict__ part_dk, float* __restrict__ part_dv,
             int n_tiles, int n_seg, int num_q_heads, int group, int nb,
             int bs, int n_tokens, int q_tile, float scale, int causal) {
  static_assert(DK >= DV, "the fused products cover v's width");
  constexpr int LD = DK + 8;                 // bf16 row stride of K/Q
  constexpr int LDV = DV + 8;                // bf16 row stride of V/dO
  constexpr int LDS = R + 8;                 // bf16 row stride of dS^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);     // [kSplitKeys][LD]
  bf16* vs = ks + kSplitKeys * LD;                   // [kSplitKeys][LDV]
  bf16* qs = vs + kSplitKeys * LDV;                  // [2][R][LD]
  bf16* dos = qs + 2 * R * LD;                       // [2][R][LDV]
  bf16* dss = dos + 2 * R * LDV;                     // [kSplitKeys][LDS]
  float* lse_s = reinterpret_cast<float*>(dss + kSplitKeys * LDS);  // [2][R]
  float* delta_s = lse_s + 2 * R;                    // [2][R]
  int* qpos_s = reinterpret_cast<int*>(delta_s + 2 * R);            // [2][R]

  const int seg = blockIdx.x;
  const int bh = blockIdx.y;
  const int key0 = blockIdx.z * kSplitKeys;  // this CTA's keys of the block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int L = n_tiles * q_tile;
  const size_t slot0 = static_cast<size_t>(bh) * L;
  float* dqz = dq + static_cast<size_t>(blockIdx.z) * gridDim.y * L * DK;

  if (seg == n_seg) {       // tiles no block owns: their dQ slots are zero
    const size_t lo = (slot0 + static_cast<size_t>(tail_lo[bh]) * q_tile) * DK;
    const size_t hi = (slot0 + L) * DK;
    for (size_t e = lo + tid; e < hi; e += kMmaThreads) dqz[e] = 0.f;
    return;
  }
  const size_t sidx = static_cast<size_t>(bh) * n_seg + seg;
  const int j = seg_block[sidx];
  if (j < 0) return;        // spare CTA: the row has fewer segments
  const int row_lo = seg_lo[sidx] * q_tile;  // the segment's slots
  const int row_hi = seg_hi[sidx] * q_tile;
  const int n_slices = (row_hi - row_lo + R - 1) / R;
  const int nkeys = min(kSplitKeys, bs - key0);

  const int hkv = num_q_heads / group;
  const int kv = (bh / num_q_heads) * hkv + (bh % num_q_heads) / group;
  const size_t kv_key = (static_cast<size_t>(kv) * nb + j) * bs + key0;

  auto load_slice = [&](int i) {
    const int st = i & 1;
    const int r0 = row_lo + i * R;
    const int rows = min(R, row_hi - r0);
    const size_t src0 = slot0 + r0;
    mma::copy_rows<DK, kMmaThreads>(qs + st * R * LD, q_sorted + src0 * DK,
                                    rows, R);
    mma::copy_rows<DV, kMmaThreads>(dos + st * R * LDV, do_sorted + src0 * DV,
                                    rows, R);
    for (int e = tid; e < 3 * R; e += kMmaThreads) {
      const int which = e / R;
      const int r = e - which * R;
      const bool in = r < rows;
      const size_t src = slot0 + r0 + (in ? r : 0);
      const int dst = st * R + r;
      if (which == 0)
        mma::cp_async4(lse_s + dst, lse_sorted + src, in);
      else if (which == 1)
        mma::cp_async4(delta_s + dst, delta_sorted + src, in);
      else
        mma::cp_async4(qpos_s + dst, q_pos + src, in);
    }
  };
  mma::copy_rows<DK, kMmaThreads>(ks, k_blocks + kv_key * DK, nkeys, nkeys);
  mma::copy_rows<DV, kMmaThreads>(vs, v_blocks + kv_key * DV, nkeys, nkeys);
  load_slice(0);
  mma::cp_async_commit();

  const int wkey = warp * 16;                // this warp's keys (local)
  const bool has_keys = wkey < nkeys;        // nkeys is a multiple of 16
  const int kpos_lo = j * bs + key0 + wkey + g;
  const int kpos_hi = kpos_lo + 8;
  float dk[DK / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;
  // the dQ product's share of this warp: rows 16 rg.., columns dc0..
  constexpr int kRowGroups = R / 16;
  constexpr int kColW = DK * kRowGroups / kMmaWarps;
  static_assert(kColW % 16 == 0, "a warp's dQ columns are whole n16 tiles");
  const int rg = warp % kRowGroups;
  const int dc0 = (warp / kRowGroups) * kColW;

  for (int i = 0; i < n_slices; ++i) {
    if (i + 1 < n_slices) load_slice(i + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();                 // slice i (and K/V) landed
    __syncthreads();
    const int st = i & 1;
    const int r0 = row_lo + i * R;
    const int rows = min(R, row_hi - r0);
    const bf16* q_st = qs + st * R * LD;
    const bf16* do_st = dos + st * R * LDV;
    if (has_keys) {
      float s[R / 8][4], dp[R / 8][4];
#pragma unroll
      for (int n = 0; n < R / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = 0.f;
          dp[n][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t ka[4], va[4];
        mma::ldsm_x4(ks + mma::a_offset(lane, wkey, kk * 16, LD), ka);
        mma::ldsm_x4(vs + mma::a_offset(lane, wkey, kk * 16, LDV), va);
#pragma unroll
        for (int np = 0; np < R / 16; ++np) {
          uint32_t b[4];
          mma::ldsm_x4(q_st + mma::bn_offset(lane, np * 16, kk * 16, LD), b);
          mma::mma16816(s[2 * np], ka, b[0], b[1]);
          mma::mma16816(s[2 * np + 1], ka, b[2], b[3]);
          mma::ldsm_x4(do_st + mma::bn_offset(lane, np * 16, kk * 16, LDV),
                       b);
          mma::mma16816(dp[2 * np], va, b[0], b[1]);
          mma::mma16816(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      if constexpr (DK > DV) {               // S^T over the rest of q's width
#pragma unroll
        for (int kk = DV / 16; kk < DK / 16; ++kk) {
          uint32_t ka[4];
          mma::ldsm_x4(ks + mma::a_offset(lane, wkey, kk * 16, LD), ka);
#pragma unroll
          for (int np = 0; np < R / 16; ++np) {
            uint32_t b[4];
            mma::ldsm_x4(q_st + mma::bn_offset(lane, np * 16, kk * 16, LD),
                         b);
            mma::mma16816(s[2 * np], ka, b[0], b[1]);
            mma::mma16816(s[2 * np + 1], ka, b[2], b[3]);
          }
        }
      }
      // P^T and dS^T in place: element (key g / g + 8, row 8n + 2t (+1))
#pragma unroll
      for (int n = 0; n < R / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * n + 2 * tq + (e & 1);
          const int st_r = st * R + r;
          const int kpos = e < 2 ? kpos_lo : kpos_hi;
          const int qp = qpos_s[st_r];
          const bool ok = r < rows && qp >= 0 && kpos < n_tokens &&
                          (!causal || kpos <= qp);
          const float p = ok ? __expf(s[n][e] * scale - lse_s[st_r]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_s[st_r]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk) {
        uint32_t pa[4], da[4];
        mma::acc_to_a(s[2 * kk], s[2 * kk + 1], pa);
        mma::acc_to_a(dp[2 * kk], dp[2 * kk + 1], da);
#pragma unroll
        for (int dn = 0; dn < DV / 16; ++dn) {
          uint32_t b[4];
          mma::ldsm_x4_t(do_st + mma::bk_offset(lane, kk * 16, dn * 16, LDV),
                         b);
          mma::mma16816(dv[2 * dn], pa, b[0], b[1]);
          mma::mma16816(dv[2 * dn + 1], pa, b[2], b[3]);
          mma::ldsm_x4_t(q_st + mma::bk_offset(lane, kk * 16, dn * 16, LD), b);
          mma::mma16816(dk[2 * dn], da, b[0], b[1]);
          mma::mma16816(dk[2 * dn + 1], da, b[2], b[3]);
        }
#pragma unroll
        for (int dn = DV / 16; dn < DK / 16; ++dn) {   // dK's other columns
          uint32_t b[4];
          mma::ldsm_x4_t(q_st + mma::bk_offset(lane, kk * 16, dn * 16, LD), b);
          mma::mma16816(dk[2 * dn], da, b[0], b[1]);
          mma::mma16816(dk[2 * dn + 1], da, b[2], b[3]);
        }
      }
      // dS^T to shared memory, [key][row], for the dQ product
      uint32_t* d_lo =
          reinterpret_cast<uint32_t*>(dss + (wkey + g) * LDS + 2 * tq);
      uint32_t* d_hi = d_lo + 4 * LDS;       // key g + 8
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        d_lo[4 * n] = mma::pack_bf16(dp[n][0], dp[n][1]);
        d_hi[4 * n] = mma::pack_bf16(dp[n][2], dp[n][3]);
      }
    }
    __syncthreads();                         // dS^T of every warp written
    // dQ of the slice = dS K over the CTA's keys, stored once
    float qa[kColW / 8][4];
#pragma unroll
    for (int n = 0; n < kColW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[n][e] = 0.f;
    for (int kk = 0; kk < nkeys / 16; ++kk) {
      uint32_t a[4];
      mma::ldsm_x4_t(dss + mma::at_offset(lane, rg * 16, kk * 16, LDS), a);
#pragma unroll
      for (int dn = 0; dn < kColW / 16; ++dn) {
        uint32_t b[4];
        mma::ldsm_x4_t(ks + mma::bk_offset(lane, kk * 16, dc0 + dn * 16, LD),
                       b);
        mma::mma16816(qa[2 * dn], a, b[0], b[1]);
        mma::mma16816(qa[2 * dn + 1], a, b[2], b[3]);
      }
    }
    const int rq = rg * 16 + g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (rq + 8 * half >= rows) continue;
      float* dst = dqz + (slot0 + r0 + rq + 8 * half) * DK + dc0 + 2 * tq;
#pragma unroll
      for (int n = 0; n < kColW / 8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(qa[n][2 * half], qa[n][2 * half + 1]);
    }
  }

  if (has_keys) {
    // a block's only segment writes dK/dV itself; pass 2 skips the block
    const size_t bj = static_cast<size_t>(bh) * nb + j;
    const bool alone = seg_count[bj] == 1;
    float* out_k = alone ? dk_out + bj * bs * DK : part_dk + sidx * bs * DK;
    float* out_v = alone ? dv_out + bj * bs * DV : part_dv + sidx * bs * DV;
    const int key = key0 + wkey + g;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = (key + 8 * half) * DK + 2 * tq + 8 * n;
        *reinterpret_cast<float2*>(out_k + e) =
            make_float2(dk[n][2 * half], dk[n][2 * half + 1]);
      }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = (key + 8 * half) * DV + 2 * tq + 8 * n;
        *reinterpret_cast<float2*>(out_v + e) =
            make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
      }
  }
}

// ------------------------------------------------------ fp32: SIMT
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                    // keys per chunk (one per lane)
constexpr int kRows = 32;                    // q rows per slice
constexpr int kRowsPerWarp = kRows / kWarps; // 8

// Stage 32 rows of width D (row stride D in src) as rows of stride D + 1;
// rows at or past `rows` are zero.  All loads are issued before the first
// store so their latencies overlap.
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int rows, float* dst) {
  constexpr int kPer = kRows * D / (4 * kThreads);
  float4 tmp[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = (threadIdx.x + i * kThreads) * 4;
    tmp[i] = e / D < rows ? __ldg(reinterpret_cast<const float4*>(src + e))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = (threadIdx.x + i * kThreads) * 4;
    float* d = dst + (e / D) * (D + 1) + e % D;
    d[0] = tmp[i].x;
    d[1] = tmp[i].y;
    d[2] = tmp[i].z;
    d[3] = tmp[i].w;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
moba_bwd_simt(const int32_t* __restrict__ seg_block,
              const int32_t* __restrict__ seg_lo,
              const int32_t* __restrict__ seg_hi,
              const int32_t* __restrict__ tail_lo,
              const float* __restrict__ q_sorted,
              const int32_t* __restrict__ q_pos,
              const float* __restrict__ do_sorted,
              const float* __restrict__ lse_sorted,
              const float* __restrict__ delta_sorted,
              const float* __restrict__ k_blocks,
              const float* __restrict__ v_blocks,
              const int32_t* __restrict__ seg_count, float* __restrict__ dq,
              float* __restrict__ dk_out, float* __restrict__ dv_out,
              float* __restrict__ part_dk, float* __restrict__ part_dv,
              int n_tiles, int n_seg, int num_q_heads, int group, int nb,
              int bs, int n_tokens, int q_tile, float scale, int causal) {
  static_assert(DK >= DV, "the fused loops cover v's width");
  constexpr int kCols = DK / 32;             // columns of q, k, dq, dk
  constexpr int kColsV = DV / 32;            // columns of dO, v, dv
  extern __shared__ float smem[];
  float* qs = smem;                          // [kRows][DK + 1]
  float* dos = qs + kRows * (DK + 1);        // [kRows][DV + 1]
  float* ks = dos + kRows * (DV + 1);        // [kKeys][DK + 1]
  float* vs = ks + kKeys * (DK + 1);         // [kKeys][DV + 1]
  float* ps = vs + kKeys * (DV + 1);         // [kRows][kKeys + 1]
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
    const size_t lo = (slot0 + static_cast<size_t>(tail_lo[bh]) * q_tile) * DK;
    const size_t hi = (slot0 + static_cast<size_t>(n_tiles) * q_tile) * DK;
    for (size_t e = lo + tid; e < hi; e += kThreads) dq[e] = 0.f;
    return;
  }
  const size_t sidx = static_cast<size_t>(bh) * n_seg + seg;
  const int j = seg_block[sidx];
  if (j < 0) return;        // spare CTA: the row has fewer segments
  const int t_lo = seg_lo[sidx];
  const int t_hi = seg_hi[sidx];
  // a block's only segment writes dK/dV itself; pass 2 skips the block
  const size_t bj = static_cast<size_t>(bh) * nb + j;
  const bool alone = seg_count[bj] == 1;
  float* pdk = alone ? dk_out + bj * bs * DK : part_dk + sidx * bs * DK;
  float* pdv = alone ? dv_out + bj * bs * DV : part_dv + sidx * bs * DV;

  const int hkv = num_q_heads / group;
  const int kv = (bh / num_q_heads) * hkv + (bh % num_q_heads) / group;
  const size_t kv_blk = (static_cast<size_t>(kv) * nb + j) * bs;

  for (int kc0 = 0; kc0 < bs; kc0 += kKeys) {
    const int nk = min(kKeys, bs - kc0);
    __syncthreads();
    stage<DK>(k_blocks + (kv_blk + kc0) * DK, nk, ks);
    stage<DV>(v_blocks + (kv_blk + kc0) * DV, nk, vs);
    float dk_acc[kRowsPerWarp][kCols];
    float dv_acc[kRowsPerWarp][kColsV];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) dk_acc[i][c] = 0.f;
#pragma unroll
      for (int c = 0; c < kColsV; ++c) dv_acc[i][c] = 0.f;
    }
    const int kpos = j * bs + kc0 + lane;    // this lane's key

    for (int t = t_lo; t < t_hi; ++t) {
      for (int rq0 = 0; rq0 < q_tile; rq0 += kRows) {
        const int nrow = min(kRows, q_tile - rq0);
        const size_t s0 = slot0 + static_cast<size_t>(t) * q_tile + rq0;
        __syncthreads();                     // previous slice consumed
        stage<DK>(q_sorted + s0 * DK, nrow, qs);
        stage<DV>(do_sorted + s0 * DV, nrow, dos);
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
        for (int kk = 0; kk < DV; ++kk) {
          const float kv_ = ks[lane * (DK + 1) + kk];
          const float vv = vs[lane * (DV + 1) + kk];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const int r = warp + kWarps * i;
            s[i] = fmaf(qs[r * (DK + 1) + kk], kv_, s[i]);
            dp[i] = fmaf(dos[r * (DV + 1) + kk], vv, dp[i]);
          }
        }
        for (int kk = DV; kk < DK; ++kk) {   // s over the rest of q's width
          const float kv_ = ks[lane * (DK + 1) + kk];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            s[i] = fmaf(qs[(warp + kWarps * i) * (DK + 1) + kk], kv_, s[i]);
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
          float dor[kColsV];
          float qr[kCols];
#pragma unroll
          for (int c = 0; c < kColsV; ++c)
            dor[c] = dos[r * (DV + 1) + lane + 32 * c];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            qr[c] = qs[r * (DK + 1) + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float p = ps[r * (kKeys + 1) + warp + kWarps * i];
            const float ds = dss[r * (kKeys + 1) + warp + kWarps * i];
#pragma unroll
            for (int c = 0; c < kColsV; ++c)
              dv_acc[i][c] = fmaf(p, dor[c], dv_acc[i][c]);
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              dk_acc[i][c] = fmaf(ds, qr[c], dk_acc[i][c]);
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
            kc[c] = ks[jj * (DK + 1) + lane + 32 * c];
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
          float* dst = dq + (s0 + r) * DK + lane;
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
      for (int c = 0; c < kCols; ++c)
        pdk[static_cast<size_t>(kc0 + key) * DK + lane + 32 * c] =
            dk_acc[i][c];
#pragma unroll
      for (int c = 0; c < kColsV; ++c)
        pdv[static_cast<size_t>(kc0 + key) * DV + lane + 32 * c] =
            dv_acc[i][c];
    }
  }
}

// Pass 2: dK/dV of block j = the sum of its segments' partials, in
// segment order; zero for a block no tile visits; a block of one segment
// was written by pass 1.
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
  if (count == 1) return;
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

// Pass 2 for one tensor: dK (or dV) of block j alone, where dK and dV
// differ in width (latent attention).
__global__ void __launch_bounds__(kThreads)
moba_bwd_reduce_one(const float* __restrict__ part,
                    const int32_t* __restrict__ seg_first,
                    const int32_t* __restrict__ seg_count,
                    float* __restrict__ out, int nb, int n_seg,
                    int block_elems) {
  const int bh = blockIdx.y;
  const int j = blockIdx.x;
  const size_t bj = static_cast<size_t>(bh) * nb + j;
  const int first = seg_first[bj];
  const int count = seg_count[bj];
  if (count == 1) return;
  const size_t base = (static_cast<size_t>(bh) * n_seg + first) * block_elems;
  for (int e = threadIdx.x; e < block_elems; e += kThreads) {
    float a = 0.f;
    for (int s = 0; s < count; ++s)
      a += part[base + static_cast<size_t>(s) * block_elems + e];
    out[bj * block_elems + e] = a;
  }
}

// Pass 2 over blocks of dk_elems (dK) and dv_elems (dV) values: one
// launch at equal widths, one a tensor where they differ.
int launch_reduce(const int32_t* const* tables, float* dk, float* dv,
                  const float* part_dk, const float* part_dv, int bh, int nb,
                  int n_seg, int dk_elems, int dv_elems, cudaStream_t s) {
  if (dk_elems == dv_elems) {
    moba_bwd_reduce<<<dim3(nb, bh), kThreads, 0, s>>>(
        part_dk, part_dv, tables[4], tables[5], dk, dv, nb, n_seg, dk_elems);
  } else {
    moba_bwd_reduce_one<<<dim3(nb, bh), kThreads, 0, s>>>(
        part_dk, tables[4], tables[5], dk, nb, n_seg, dk_elems);
    moba_bwd_reduce_one<<<dim3(nb, bh), kThreads, 0, s>>>(
        part_dv, tables[4], tables[5], dv, nb, n_seg, dv_elems);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV, int R>
int launch_mma(const int32_t* const* tables, const void* qs, const void* qp,
               const void* dos, const void* lse, const void* delta,
               const void* kb, const void* vb, float* dq, float* dk,
               float* dv, float* part_dk, float* part_dv, int bh,
               int n_tiles, int n_seg, int h, int g, int nb, int bs, int n,
               int q_tile, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = mma_smem_bytes<DK, DV, R>();
  auto kernel = moba_bwd_mma<DK, DV, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = (bs + kSplitKeys - 1) / kSplitKeys;
  kernel<<<dim3(n_seg + 1, bh, splits), kMmaThreads, smem, s>>>(
      tables[0], tables[1], tables[2], tables[3],
      static_cast<const bf16*>(qs), static_cast<const int32_t*>(qp),
      static_cast<const bf16*>(dos), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const bf16*>(kb),
      static_cast<const bf16*>(vb), tables[5], dq, dk, dv, part_dk, part_dv,
      n_tiles, n_seg, h, g, nb, bs, n, q_tile, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(tables, dk, dv, part_dk, part_dv, bh, nb, n_seg,
                       bs * DK, bs * DV, s);
}

template <int DK, int DV>
int launch_simt(const int32_t* const* tables, const void* qs, const void* qp,
                const void* dos, const void* lse, const void* delta,
                const void* kb, const void* vb, float* dq, float* dk,
                float* dv, float* part_dk, float* part_dv, int bh,
                int n_tiles, int n_seg, int h, int g, int nb, int bs, int n,
                int q_tile, float scale, int causal, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((kRows + kKeys) * (DK + DV + 2) +
                                       2 * kRows * (kKeys + 1) + 3 * kRows);
  auto kernel = moba_bwd_simt<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_seg + 1, bh), kThreads, smem, s>>>(
      tables[0], tables[1], tables[2], tables[3],
      static_cast<const float*>(qs), static_cast<const int32_t*>(qp),
      static_cast<const float*>(dos), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(kb),
      static_cast<const float*>(vb), tables[5], dq, dk, dv, part_dk,
      part_dv, n_tiles, n_seg, h, g, nb, bs, n, q_tile, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(tables, dk, dv, part_dk, part_dv, bh, nb, n_seg,
                       bs * DK, bs * DV, s);
}

}  // namespace

// Segment tables, all int32: seg_block/seg_lo/seg_hi (bh, n_seg) — the
// block (-1 = spare CTA) and tiles [lo, hi) of each segment; tail_lo (bh,)
// the first inactive tile; seg_first/seg_count (bh, nb) each block's
// segments.  q_sorted (bh, L, d); q_pos (bh, L) int32; do_sorted (bh, L,
// dv) in q_sorted's dtype; lse/delta (bh, L) float32; k_blocks (bh/group,
// nb, bs, d), v_blocks (bh/group, nb, bs, dv); dk (bh, nb, bs, d), dv
// (bh, nb, bs, dv) and the scratch part_dk/part_dv (bh, n_seg, bs, d /
// dv) float32.  (d, d_v): (64, 64), (128, 128) or latent attention's
// (192, 128), d_v the width of dO, v and dv.  dtype: 0 = float32 (SIMT
// body; dq (bh, L, d)), 1 = bfloat16 (tensor cores; bs any multiple of
// 16; dq (ceil(bs / 128), bh, L, d): one dQ partial per 128 keys).
extern "C" int moba_bwd(const void* seg_block, const void* seg_lo,
                        const void* seg_hi, const void* tail_lo,
                        const void* seg_first, const void* seg_count,
                        const void* q_sorted, const void* q_pos,
                        const void* do_sorted, const void* lse_sorted,
                        const void* delta_sorted, const void* k_blocks,
                        const void* v_blocks, void* dq, void* dk, void* dv,
                        void* part_dk, void* part_dv, int bh, int n_tiles,
                        int n_seg, int num_q_heads, int group, int nb, int bs,
                        int d, int d_v, int n_tokens, int q_tile,
                        float scale, int causal, int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || n_tiles < 1 || n_seg < 1 ||
      num_q_heads < 1 || group < 1 || num_q_heads % group != 0 || nb < 1 ||
      bs < 1 || q_tile < 1 ||
      !((d == 64 && d_v == 64) || (d == 128 && d_v == 128) ||
        (d == 192 && d_v == 128)) ||
      (dtype == 1 && bs % 16 != 0) ||
      (dtype != 0 && dtype != 1))
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
  auto* run = dtype == 1 ? (d == 64    ? &launch_mma<64, 64, 64>
                            : d == 128 ? &launch_mma<128, 128, 32>
                                       : &launch_mma<192, 128, 32>)
                         : (d == 64    ? &launch_simt<64, 64>
                            : d == 128 ? &launch_simt<128, 128>
                                       : &launch_simt<192, 128>);
  return run(tables, q_sorted, q_pos, do_sorted, lse_sorted, delta_sorted,
             k_blocks, v_blocks, dqp, dkp, dvp, pk, pv, bh, n_tiles, n_seg,
             num_q_heads, group, nb, bs, n_tokens, q_tile, scale, causal, s);
}
