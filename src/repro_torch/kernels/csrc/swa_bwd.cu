// Banded causal flash attention (sliding window), backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's swa kernel is forward only, and
// its SWA layers differentiate dense attention through XLA.  The port's
// flash backend trains its SWA layers on the banded kernels (kernels/swa.py's
// SWAAttention: csrc/swa.cu forward with its log-sum-exp, this backward), so
// no (N, N) scores exist.  Query i attends keys j with i - window < j <= i,
// GQA by swa.cu's row map.  From q, k, v, the forward's output o and its
// log-sum-exp, and dO (bf16; lse fp32):
//   delta = rowsum(dO o)          P = exp(S - lse),  S = scale Q K^T
//   dP = dO V^T                   dS = P (dP - delta)
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K
// over the band only, every product on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), S and dP in fp32 in registers, P rounded once to bf16 for
// P^T dO and dS once for dS^T Q and dS K (FlashAttention-2's choices; the
// sums are fp32), delta in fp32.
//
// What bounds it on an H100: bytes.  At the training shapes (BH 32, N 8192,
// window 256, d 64) it must read q, k, v, o and dO and write dq, dk and dv,
// 268.4 MB (0.0801 ms at 3.35 TB/s), against 10 * d flops a query head and
// key, 42.3 GFLOP (0.0428 ms at the bf16 tensor-core peak).  What the design
// does about it: every tensor is bf16 on both sides of the kernel (dq, dk,
// dv too: no fp32 partials reach device memory), each output is written
// once from registers, and no atomics: two passes, so the sums run in a
// fixed order and a seed gives the same gradients on every run.
//
// Pass A (query-major, swa_bwd_dq_mma): the forward's grid and chunk walk
// (swa.py::band_chunks), a CTA of 4 warps per (bh, 64 query rows).  Q and
// dO of the tile stay in shared memory and are read as A fragments at each
// chunk (held in registers across the band, they cost 32 registers at d 64
// and 64 at d 128, and a third CTA an SM); K and V stream through the
// forward's two-stage cp.async ring (KC 64 keys at d 64, 32 at d 128).
// Its prologue computes delta for the tile's rows (lanes 2r and 2r + 1 sum
// row r's halves of dO o) and writes it for pass B.  Per chunk: S = Q K^T,
// dP = dO V^T, P and dS in registers, dQ += dS K, with the forward's
// per-warp chunk and 16-key-step skips and its mask only on chunks that
// are not inside every row's band.  dQ is scaled, staged through the warp's
// own Q rows in shared memory and stored as 16-byte rows.
//
// Pass B (key-major, swa_bwd_dkv_mma): a CTA of 4 warps per (kv head, 64
// keys); warp w owns keys 16w..16w+15 and keeps their dK and dV in fp32
// registers.  It walks, for each of the kv head's `group` query heads in
// turn, the query rows whose band holds its keys, k0 .. k0 + 63 + window -
// 1, in slices of R rows (64 at d 64; 32 at d 128, where dK/dV take 128
// registers a thread) through a two-stage cp.async ring of Q, dO, lse and
// delta (swa.py::band_slices is the plain mirror of the walk and of which
// slices take a mask).  Per slice, in halves of 32 rows (so that S^T and
// dP^T take half the registers, and d 64 fits 3 CTAs an SM), with K and V
// from shared memory as A fragments: S^T = K_w Q^T, dP^T = V_w dO^T, P^T
// and dS^T in registers, dV += P^T dO, dK += dS^T Q; one barrier a slice.
// dK and dV are staged through the warp's own K and V rows and stored as
// 16-byte rows.
//
// On the card ("NVIDIA H100 80GB HBM3, 700.00 W", CUDA events, L2 flushed):
// 0.502 ms at the training shape above (pass A 149 registers, pass B 163,
// no spills), 6.3x its bound; with Q and dO held in registers and whole
// 64-row slices (175 / 192 registers, 2 CTAs an SM) it took 0.627 ms, with
// the same bits.  4 CTAs an SM (128 registers) spill and gain 1%.  At d 128
// / G 2 (BH 32, N 8192): 0.92 ms.  Causal SDPA's dense backward at the
// training shape: 1.67 ms.
//
// Pass A runs before pass B on the stream (pass B reads delta).  Rows and
// keys past n are zero-filled and never stored.  A window above n is the
// window n (the same band).
//
// C interface (ctypes): every pointer and the stream are void*; returns the
// cudaGetLastError() of the launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // a pass A tile of rows, a pass B of keys
constexpr int kHalf = 32;            // rows of pass B's slice taken at once

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// sum of a[i] * b[i] over the eight bf16 of each
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pa[i]);
    const float2 y = __bfloat1622float2(pb[i]);
    s += x.x * y.x + x.y * y.y;
  }
  return s;
}

// Store the first `rows` rows of a warp's 16 x D fp32 accumulator tile
// (times `mul`) as bf16 rows of dst (row stride D), staged through `stage`,
// 16 rows of stride D + 8 that only this warp uses.
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 8][4],
                                           float mul, bf16* stage,
                                           bf16* __restrict__ dst, int rows,
                                           int lane) {
  constexpr int LD = D + 8;
  const int g = lane >> 2;
  const int tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * j + 2 * tq) =
        mma::pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * j + 2 * tq) =
        mma::pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  constexpr int kVecs = D / 8;                   // 16-byte pieces a row
  for (int e = lane; e < 16 * kVecs; e += 32) {
    const int r = e / kVecs;
    const int c = (e - r * kVecs) * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// ------------------------------------------------ pass A: dQ and delta
template <int D, int KC>
__global__ void __launch_bounds__(kThreads, 3)
swa_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, bf16* __restrict__ dq, int n, int h,
               int group, int window, float scale_log2, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kRows][LD]
  bf16* dos = qs + kRows * LD;                    // [kRows][LD]
  bf16* ks = dos + kRows * LD;                    // [2][KC][LD]
  bf16* vs = ks + 2 * KC * LD;                    // [2][KC][LD]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int kv = (bh / h) * (h / group) + (bh % h) / group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;

  // the forward's chunks and per-warp rows (band_chunks)
  const int q_end = min(q0 + kRows, n);
  const int c_first = max(q0 - window + 1, 0) / KC;
  const int c_last = (q_end - 1) / KC;
  const int r0 = q0 + warp * 16;
  const int r_last = min(r0 + 16, n) - 1;         // < r0: no row of its own
  const bool rows_here = r_last >= r0;            // warp-uniform
  const int w_lo = max(r0 - window + 1, 0);

  const size_t row0 = static_cast<size_t>(bh) * n;
  const bf16* kp = k + static_cast<size_t>(kv) * n * D;
  const bf16* vp = v + static_cast<size_t>(kv) * n * D;
  mma::copy_rows<D, kThreads>(qs, q + (row0 + q0) * D, q_end - q0, kRows);
  mma::copy_rows<D, kThreads>(dos, dout + (row0 + q0) * D, q_end - q0,
                              kRows);
  auto load_chunk = [&](int c) {
    const int c0 = c * KC;
    const int rows = min(KC, n - c0);
    mma::copy_rows<D, kThreads>(ks + (c & 1) * KC * LD,
                                kp + static_cast<size_t>(c0) * D, rows, KC);
    mma::copy_rows<D, kThreads>(vs + (c & 1) * KC * LD,
                                vp + static_cast<size_t>(c0) * D, rows, KC);
  };
  load_chunk(c_first);
  mma::cp_async_commit();

  const int qp_lo = r0 + g;                      // this thread's two rows
  const int qp_hi = qp_lo + 8;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float lse_lo = 0.f, lse_hi = 0.f;              // log2 domain
  float dl_lo = 0.f, dl_hi = 0.f;                // delta of the two rows

  for (int c = c_first; c <= c_last; ++c) {
    mma::cp_async_wait<0>();                     // chunk c (and Q, dO)
    __syncthreads();                             // and chunk c - 1 is done
    if (c == c_first && rows_here) {
      // delta = rowsum(dO o): lanes 2r and 2r + 1 sum halves of row r
      const int rr = lane >> 1;
      const int half = (lane & 1) * (D / 2);
      float dsum = 0.f;
      if (r0 + rr <= r_last) {
        const bf16* orow = o + (row0 + r0 + rr) * D + half;
        const bf16* drow = dos + (warp * 16 + rr) * LD + half;
#pragma unroll
        for (int e = 0; e < D / 2; e += 8)
          dsum += dot8(*reinterpret_cast<const uint4*>(orow + e),
                       *reinterpret_cast<const uint4*>(drow + e));
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      if (half == 0 && r0 + rr <= r_last) delta[row0 + r0 + rr] = dsum;
      dl_lo = __shfl_sync(0xffffffffu, dsum, 2 * g);
      dl_hi = __shfl_sync(0xffffffffu, dsum, 2 * g + 16);
      if (qp_lo <= r_last) lse_lo = lse[row0 + qp_lo] * kLog2e;
      if (qp_hi <= r_last) lse_hi = lse[row0 + qp_hi] * kLog2e;
    }
    if (c < c_last) {
      load_chunk(c + 1);
      mma::cp_async_commit();
    }
    const int c0 = c * KC;
    if (!rows_here || c0 > r_last || c0 + KC - 1 < w_lo)
      continue;                                  // warp-uniform
    const bool masked = !(c0 + KC - 1 <= r0 && r_last - c0 < window);
    const bf16* kc = ks + (c & 1) * KC * LD;
    const bf16* vc = vs + (c & 1) * KC * LD;
    auto step_in = [&](int i) {
      return c0 + 16 * i <= r_last && c0 + 16 * i + 15 >= w_lo;
    };

    float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
    // Q and dO as A fragments straight from shared memory, not held in
    // registers across the band: the registers go to occupancy
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      mma::ldsm_x4(qs + mma::a_offset(lane, warp * 16, kk * 16, LD), qa);
      mma::ldsm_x4(dos + mma::a_offset(lane, warp * 16, kk * 16, LD), da);
#pragma unroll
      for (int np = 0; np < KC / 16; ++np) {
        if (!step_in(np)) continue;
        uint32_t b[4];
        mma::ldsm_x4(kc + mma::bn_offset(lane, np * 16, kk * 16, LD), b);
        mma::mma16816(s[2 * np], qa, b[0], b[1]);
        mma::mma16816(s[2 * np + 1], qa, b[2], b[3]);
        mma::ldsm_x4(vc + mma::bn_offset(lane, np * 16, kk * 16, LD), b);
        mma::mma16816(dp[2 * np], da, b[0], b[1]);
        mma::mma16816(dp[2 * np + 1], da, b[2], b[3]);
      }
    }
    // dS in place of dP; a masked (or skipped) key's P is 0
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = c0 + 8 * j + 2 * tq + (e & 1);
        const int qp = e < 2 ? qp_lo : qp_hi;
        const bool ok = !masked || (kpos <= qp && qp - kpos < window);
        const float p = ok ? exp2_approx(s[j][e] * scale_log2 -
                                         (e < 2 ? lse_lo : lse_hi))
                           : 0.f;
        dp[j][e] = p * (dp[j][e] - (e < 2 ? dl_lo : dl_hi));
      }
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (!step_in(kk)) continue;                // its dS are all 0
      uint32_t da[4];
      mma::acc_to_a(dp[2 * kk], dp[2 * kk + 1], da);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        mma::ldsm_x4_t(kc + mma::bk_offset(lane, kk * 16, dn * 16, LD), b);
        mma::mma16816(acc[2 * dn], da, b[0], b[1]);
        mma::mma16816(acc[2 * dn + 1], da, b[2], b[3]);
      }
    }
  }

  if (!rows_here) return;
  // the warp's own Q rows (in registers since its first chunk) stage dQ
  store_tile<D>(acc, scale, qs + warp * 16 * LD, dq + (row0 + r0) * D,
                r_last - r0 + 1, lane);
}

// ------------------------------------------------- pass B: dK and dV
template <int D, int R>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 2)
swa_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int n, int h, int group, int window,
                float scale_log2, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [kRows][LD]
  bf16* vs = ks + kRows * LD;                     // [kRows][LD]
  bf16* qs = vs + kRows * LD;                     // [2][R][LD]
  bf16* dos = qs + 2 * R * LD;                    // [2][R][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * R * LD);   // [2][R]
  float* dl_s = lse_s + 2 * R;                                  // [2][R]

  const int kv = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int hkv = h / group;
  const int bh0 = (kv / hkv) * h + (kv % hkv) * group;  // its first q head

  // the rows whose band holds one of the CTA's keys, in slices of R
  // (band_slices); window <= n, so the sum does not overflow
  const int k_end = min(k0 + kRows, n);
  const int row_last = min(k0 + kRows - 1 + window - 1, n - 1);
  const int n_slices = (row_last - k0) / R + 1;
  const int total = group * n_slices;
  // the warp's keys kw0 .. kw_last and the rows they meet, kw0 .. band_hi
  const int kw0 = k0 + warp * 16;
  const int kw_last = min(kw0 + 16, n) - 1;       // < kw0: no key of its own
  const bool keys_here = kw_last >= kw0;          // warp-uniform
  const int band_hi = kw0 + 15 + window - 1;

  const size_t kv_row0 = static_cast<size_t>(kv) * n + k0;
  mma::copy_rows<D, kThreads>(ks, k + kv_row0 * D, k_end - k0, kRows);
  mma::copy_rows<D, kThreads>(vs, v + kv_row0 * D, k_end - k0, kRows);
  auto load_slice = [&](int it) {
    const int st = it & 1;
    const int gq = it / n_slices;
    const int s0 = k0 + (it - gq * n_slices) * R;
    const int rows = min(R, row_last + 1 - s0);
    const size_t src = static_cast<size_t>(bh0 + gq) * n + s0;
    mma::copy_rows<D, kThreads>(qs + st * R * LD, q + src * D, rows, R);
    mma::copy_rows<D, kThreads>(dos + st * R * LD, dout + src * D, rows, R);
    for (int e = tid; e < 2 * R; e += kThreads) {
      const int which = e / R;
      const int r = e - which * R;
      const bool in = r < rows;
      const size_t at = src + (in ? r : 0);
      if (which == 0)
        mma::cp_async4(lse_s + st * R + r, lse + at, in);
      else
        mma::cp_async4(dl_s + st * R + r, delta + at, in);
    }
  };
  load_slice(0);
  mma::cp_async_commit();

  const int kpos_lo = kw0 + g;                   // this thread's two keys
  const int kpos_hi = kpos_lo + 8;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[j][e] = 0.f;
      dva[j][e] = 0.f;
    }

  for (int it = 0; it < total; ++it) {
    mma::cp_async_wait<0>();                     // slice it (and K, V)
    __syncthreads();                             // and slice it - 1 is done
    if (it + 1 < total) {
      load_slice(it + 1);
      mma::cp_async_commit();
    }
    const int st = it & 1;
    const int gq = it / n_slices;
    const int s0 = k0 + (it - gq * n_slices) * R;
    if (!keys_here || s0 > band_hi || s0 + R - 1 < kw0)
      continue;                                  // warp-uniform
    // unmasked: every row of the slice inside every key's band, below n
    const bool masked =
        !(s0 >= kw0 + 15 && s0 + R - 1 <= kw0 + window - 1 && s0 + R <= n);
    const bf16* q_st = qs + st * R * LD;
    const bf16* do_st = dos + st * R * LD;
    const float* lse_st = lse_s + st * R;
    const float* dl_st = dl_s + st * R;
    // 16-row step i of the slice meets the warp's keys' bands
    auto step_in = [&](int i) {
      const int a = s0 + 16 * i;
      return a < n && a <= band_hi && a + 15 >= kw0;
    };
    // the slice in halves of kHalf rows, so S^T and dP^T take half the
    // registers (the rest go to occupancy)
#pragma unroll
    for (int hh = 0; hh < R / kHalf; ++hh) {
      const int i0 = hh * (kHalf / 16);          // its first 16-row step
      float s[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        mma::ldsm_x4(ks + mma::a_offset(lane, warp * 16, kk * 16, LD), ka);
        mma::ldsm_x4(vs + mma::a_offset(lane, warp * 16, kk * 16, LD), va);
#pragma unroll
        for (int np = 0; np < kHalf / 16; ++np) {
          if (!step_in(i0 + np)) continue;
          const int rs = 16 * (i0 + np);
          uint32_t b[4];
          mma::ldsm_x4(q_st + mma::bn_offset(lane, rs, kk * 16, LD), b);
          mma::mma16816(s[2 * np], ka, b[0], b[1]);
          mma::mma16816(s[2 * np + 1], ka, b[2], b[3]);
          mma::ldsm_x4(do_st + mma::bn_offset(lane, rs, kk * 16, LD), b);
          mma::mma16816(dp[2 * np], va, b[0], b[1]);
          mma::mma16816(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      // P^T in place of S^T, dS^T of dP^T: element (key g / g + 8, row
      // 8j + 2t (+1) of the half); a masked (or skipped) row's P is 0
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = hh * kHalf + 8 * j + 2 * tq + (e & 1);
          const int row = s0 + r;
          const int kpos = e < 2 ? kpos_lo : kpos_hi;
          const bool ok = !masked ||
                          (row < n && kpos <= row && row - kpos < window);
          const float p =
              ok ? exp2_approx(s[j][e] * scale_log2 - lse_st[r] * kLog2e)
                 : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_st[r]);
        }
#pragma unroll
      for (int kk = 0; kk < kHalf / 16; ++kk) {
        if (!step_in(i0 + kk)) continue;         // its P and dS are all 0
        const int rs = 16 * (i0 + kk);
        uint32_t pa[4], da[4];
        mma::acc_to_a(s[2 * kk], s[2 * kk + 1], pa);
        mma::acc_to_a(dp[2 * kk], dp[2 * kk + 1], da);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t b[4];
          mma::ldsm_x4_t(do_st + mma::bk_offset(lane, rs, dn * 16, LD), b);
          mma::mma16816(dva[2 * dn], pa, b[0], b[1]);
          mma::mma16816(dva[2 * dn + 1], pa, b[2], b[3]);
          mma::ldsm_x4_t(q_st + mma::bk_offset(lane, rs, dn * 16, LD), b);
          mma::mma16816(dka[2 * dn], da, b[0], b[1]);
          mma::mma16816(dka[2 * dn + 1], da, b[2], b[3]);
        }
      }
    }
  }

  if (!keys_here) return;
  // the warp's own K and V rows (read by no other warp) stage dK and dV
  const size_t out0 = (static_cast<size_t>(kv) * n + kw0) * D;
  store_tile<D>(dka, scale, ks + warp * 16 * LD, dk + out0,
                kw_last - kw0 + 1, lane);
  store_tile<D>(dva, 1.f, vs + warp * 16 * LD, dv + out0, kw_last - kw0 + 1,
                lane);
}

// Above 48 KB of dynamic shared memory only after the attribute, set once
// per instantiation and card.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool (&set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) set[dev] = true;
  return err;
}

template <int D, int KC, int R>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* delta, void* dq, void* dk, void* dv, int bh,
                       int n, int h, int group, int window, float scale,
                       cudaStream_t s) {
  constexpr int LD = D + 8;
  const size_t smem_a = sizeof(bf16) * (2 * kRows + 4 * KC) * LD;
  const size_t smem_b =
      sizeof(bf16) * (2 * kRows + 4 * R) * LD + sizeof(float) * 4 * R;
  auto pass_a = swa_bwd_dq_mma<D, KC>;
  auto pass_b = swa_bwd_dkv_mma<D, R>;
  static bool set_a[kMaxDevices], set_b[kMaxDevices];
  cudaError_t err = allow_smem(pass_a, smem_a, set_a);
  if (err != cudaSuccess) return err;
  err = allow_smem(pass_b, smem_b, set_b);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kRows - 1) / kRows;
  const float scale_log2 = scale * kLog2e;
  pass_a<<<dim3(bh, tiles), kThreads, smem_a, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), n, h, group,
      window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pass_b<<<dim3(bh / group, tiles), kThreads, smem_b, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, h, group, window,
      scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 only.  q, o, dout and dq are (bh, n, d); k, v, dk and dv (bh / h *
// h / group, n, d); all contiguous and 16-byte aligned; lse (the forward's,
// natural log) and delta (scratch, written by pass A) are (bh, n) fp32.  At
// most 65535 tiles of 64 rows.
extern "C" int swa_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int bh, int n, int d,
                                 int h, int group, int window, float scale,
                                 void* stream) {
  if (bh < 1 || n < 1 || h < 1 || bh % h != 0 || group < 1 ||
      h % group != 0 || window < 1 || (d != 64 && d != 128) ||
      (n + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window > n) window = n;                 // the same band
  return d == 64 ? launch_bwd<64, 64, 64>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, bh, n, h, group, window,
                                          scale, s)
                 : launch_bwd<128, 32, 32>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, bh, n, h, group, window,
                                           scale, s);
}
