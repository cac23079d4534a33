// Banded causal flash attention (sliding window) for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/swa.py::swa_attention of the JAX package
// (_swa_kernel).  Query i attends keys j with i - window < j <= i, GQA by
// the reference's row map kv = (bh / h) * (h / group) + (bh % h) / group, an
// online softmax in fp32 with the reference's m_safe = max(m, -5e29) guard,
// l floored at 1e-30, the output in q's dtype.  Forward only, as in JAX.
//
// What bounds it on an H100: bytes.  The function reads q, k and v once and
// writes o once (at N 8192, window 256, 16 heads, d 64, bf16: 67.1 MB, 0.020
// ms at 3.35 TB/s), against 4 * N * window * d flops a head (8.46 GFLOP,
// 0.0086 ms at the bf16 tensor-core peak).  The first design ran both
// products on the CUDA cores in fp32 (one thread a query row, K and V
// converted to fp32 in shared memory, synchronous staging, the reference's
// 128-key tiles): 0.680 ms at that shape, 1.757 ms at d 128.  This
// design: 0.0709 ms (9.6x faster, 3.5x the bound) and 0.127 ms at d 128
// (chip_smoke.py --ab against the first design, the wrapper's device ms,
// "NVIDIA H100 80GB HBM3, 700.00 W").
//
// bf16 (tensor cores): a CTA of kWarps = 4 warps (16 query rows each) per
// (bh, tile of 64 rows); the card's tile is the kernel's own, not the
// reference's q_tile / k_tile, which only block the TPU's grid.  Q is
// copied once with cp.async and held in registers as mma A fragments for
// the whole band.  K and V stay bf16 and stream through a two-stage
// cp.async ring in chunks of KC keys, rows padded by 16 bytes so ldmatrix
// is conflict-free; one barrier a chunk, after which chunk i + 1's copies
// are issued before chunk i's Q K^T.  KC is 64 at d 64 (119 registers,
// 46,080 B of shared memory, 4 CTAs an SM) and 32 at d 128 (168 registers,
// 52,224 B, 3 CTAs an SM): KC 64 at d 128 needs 183 registers and fits 2
// CTAs; a tree with the other chunk at each head dim took 0.0792 ms
// against 0.0707 at d 64 and 0.1344 against 0.1259 at d 128.  Tiles of
// 128 rows (8 warps) took 0.0750 against 0.0705 ms at d 64 and 0.1649
// against 0.1261 at d 128 (chip_smoke.py --ab against each such tree, the
// same card).  The chunk list comes from the band
// (swa.py::band_chunks is its plain mirror, and the CPU tests check it):
// the CTA walks chunks floor(max(q0 - window + 1, 0) / KC) ..
// ceil(min(q0 + 64, n) / KC) - 1; a warp skips, with no mma, a chunk
// outside all of its 16 rows' bands (its lanes stay together for the quad
// shuffles), and inside a chunk the 16-key steps outside them.  A chunk
// inside every row's band of the warp (c0 + KC - 1 <= r0 and
// r_last - c0 < window) takes no mask; the diagonal chunk, the window's
// lower edge and ragged ends take the per-element mask on the accumulator
// fragments.  S = Q K^T and O += P V on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), scores kept in the log2 domain (scale * log2 e folded in,
// ex2.approx), the online softmax in fp32 with quad shuffles; P goes back
// as the A operand of P V rounded once to bf16 (FlashAttention-2's
// choice: o is normalised in the kernel, so P's rounding error averages
// out, unlike moba_fwd's un-normalised partials, which need P as hi + lo),
// V through ldmatrix.trans.  The output is normalised in registers,
// staged through the warp's own Q rows in shared memory (its Q lives in
// registers by then) and stored as 16-byte rows: each store instruction
// writes whole 128-byte lines, where fragment stores would write 4 bytes a
// lane.  Grid (bh, tiles): blockIdx.x runs fastest in launch order, so the
// `group` query heads of one kv head, and all heads of one tile, are
// adjacent, and their K/V re-reads hit L2.
//
// fp32 keeps the SIMT body of the first design (one thread a query row, fp32
// FMAs, the reference's tiles and 32-key chunks): TF32 products would break
// the 2e-4 fp32 tolerance, as in moba_fwd.cu.  The dtype picks the body in
// the C entry point; the wrapper refuses, before any launch, a shape the
// chosen body does not take.
//
// Not done yet (later work): wgmma / TMA with a producer warp; a windowed
// backward, which waits until a serving or training path calls the kernel.
//
// C interface (ctypes): every pointer and the stream are void*; returns the
// cudaGetLastError() of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;
constexpr int kWarps = 4;            // 16 query rows each: a 64-row tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;

using bf16 = __nv_bfloat16;

// ------------------------------------------------- bf16: tensor cores
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d 64: at most 128 registers, 4 CTAs an SM; d 128: 2 CTAs at least
template <int D, int KC>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 2)
swa_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, bf16* __restrict__ out, int n, int h,
        int group, int window, float scale_log2) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kRows][LD]
  bf16* ks = qs + kRows * LD;                     // [2][KC][LD]
  bf16* vs = ks + 2 * KC * LD;                    // [2][KC][LD]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int kv = (bh / h) * (h / group) + (bh % h) / group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;

  // the CTA's chunks (band_chunks over its rows; rows past n are not stored)
  const int q_end = min(q0 + kRows, n);
  const int c_first = max(q0 - window + 1, 0) / KC;
  const int c_last = (q_end - 1) / KC;
  // the warp's rows r0 .. r_last and the keys they see, w_lo .. r_last
  const int r0 = q0 + warp * 16;
  const int r_last = min(r0 + 16, n) - 1;         // < r0: no row of its own
  const int w_lo = max(r0 - window + 1, 0);

  const bf16* kp = k + static_cast<size_t>(kv) * n * D;
  const bf16* vp = v + static_cast<size_t>(kv) * n * D;
  mma::copy_rows<D, kThreads>(qs, q + (static_cast<size_t>(bh) * n + q0) * D,
                              q_end - q0, kRows);
  // chunk c goes to buffer c & 1; keys past n are zero-filled
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
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;          // running row max (log2)
  float l_lo = 0.f, l_hi = 0.f;                  // this thread's share of l

  for (int c = c_first; c <= c_last; ++c) {
    mma::cp_async_wait<0>();                     // chunk c (and Q) landed
    __syncthreads();                             // and chunk c - 1 is done
    if (c == c_first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma::ldsm_x4(qs + mma::a_offset(lane, warp * 16, kk * 16, LD),
                     qf[kk]);
    }
    if (c < c_last) {
      load_chunk(c + 1);
      mma::cp_async_commit();
    }
    const int c0 = c * KC;
    if (r_last < r0 || c0 > r_last || c0 + KC - 1 < w_lo)
      continue;                                  // warp-uniform
    // keys <= r0 < n, so an unmasked chunk has no ragged end
    const bool masked = !(c0 + KC - 1 <= r0 && r_last - c0 < window);
    const bf16* kc = ks + (c & 1) * KC * LD;
    const bf16* vc = vs + (c & 1) * KC * LD;
    // 16-key step i of the chunk meets the warp's keys
    auto step_in = [&](int i) {
      return c0 + 16 * i <= r_last && c0 + 16 * i + 15 >= w_lo;
    };

    float s[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int np = 0; np < KC / 16; ++np) {
      if (!step_in(np)) continue;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        mma::ldsm_x4(kc + mma::bn_offset(lane, np * 16, kk * 16, LD), b);
        mma::mma16816(s[2 * np], qf[kk], b[0], b[1]);
        mma::mma16816(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
    if (masked) {
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = c0 + 8 * j + 2 * tq + (e & 1);
          const int qp = e < 2 ? qp_lo : qp_hi;
          const bool ok = kpos <= qp && qp - kpos < window;
          s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
        }
    } else {
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    }
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
    }
    const float ms_lo = fmaxf(mx_lo, kNegInf * 0.5f);
    const float ms_hi = fmaxf(mx_hi, kNegInf * 0.5f);
    const float a_lo = exp2_approx(m_lo - ms_lo);
    const float a_hi = exp2_approx(m_hi - ms_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    // a masked score sits at -1e30 <= m_safe - 5e29, so its p is 0
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      s[j][0] = exp2_approx(s[j][0] - ms_lo);
      s[j][1] = exp2_approx(s[j][1] - ms_lo);
      s[j][2] = exp2_approx(s[j][2] - ms_hi);
      s[j][3] = exp2_approx(s[j][3] - ms_hi);
      ps_lo += s[j][0] + s[j][1];
      ps_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * a_lo + ps_lo;
    l_hi = l_hi * a_hi + ps_hi;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= a_lo;
      acc[j][1] *= a_lo;
      acc[j][2] *= a_hi;
      acc[j][3] *= a_hi;
    }
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (!step_in(kk)) continue;                // its p are all 0
      uint32_t pa[4];
      mma::acc_to_a(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        mma::ldsm_x4_t(vc + mma::bk_offset(lane, kk * 16, dp * 16, LD), b);
        mma::mma16816(acc[2 * dp], pa, b[0], b[1]);
        mma::mma16816(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

  if (r_last < r0) return;                       // no row of its own
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, sh);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, sh);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  // the warp's own Q rows (read into qf at its first chunk) stage its output
  bf16* os = qs + warp * 16 * LD;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(os + g * LD + 8 * j + 2 * tq) =
        mma::pack_bf16(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + 8 * j + 2 * tq) =
        mma::pack_bf16(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
  }
  __syncwarp();
  constexpr int kVecs = D / 8;                   // 16-byte pieces a row
  for (int e = lane; e < 16 * kVecs; e += 32) {
    const int r = e / kVecs;
    const int c = (e - r * kVecs) * 8;
    if (r0 + r <= r_last)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(bh) * n + r0 + r) *
                                          D + c) =
          *reinterpret_cast<const uint4*>(os + r * LD + c);
  }
}

template <int D, int KC>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int bh, int n, int h, int group,
                       int window, float scale, cudaStream_t s) {
  const size_t smem = sizeof(bf16) * (kRows + 4 * KC) * (D + 8);
  auto kernel = swa_mma<D, KC>;
  // above 48 KB only after the attribute, set once per instantiation and card
  static bool attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  kernel<<<dim3(bh, (n + kRows - 1) / kRows), kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, h, group,
      window, scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------------------ fp32: SIMT
constexpr int kDT = 64;              // head dims a thread owns
constexpr int kChunk = 32;           // keys staged per step

// Stage keys [c0, c0 + rows) of kv row `kv` (zeros past `rows`).
template <int D>
__device__ __forceinline__ void load_chunk(const float* __restrict__ src,
                                           int kv, int n, int c0, int rows,
                                           float (*dst)[D]) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < kChunk * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      val = __ldg(reinterpret_cast<const float4*>(
          src + (static_cast<size_t>(kv) * n + c0 + r) * D + c));
    *reinterpret_cast<float4*>(&dst[r][c]) = val;
  }
}

// Block: q_tile * (D / kDT) threads.  Thread t owns query row t / R of the
// tile and head dims [(t % R) * kDT, (t % R + 1) * kDT).  The CTA visits
// the reference's key tiles (its steps formula, clamped), in chunks of 32
// keys, skipping a chunk outside the tile's band; a warp skips a chunk
// outside all of its rows' bands.
template <int D>
__global__ void __launch_bounds__(256)
swa_simt(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ out, int n, int h,
         int group, int window, int q_tile, int k_tile, float scale) {
  constexpr int R = D / kDT;
  __shared__ __align__(16) float ks[kChunk][D];
  __shared__ __align__(16) float vs[kChunk][D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * q_tile;
  const int kv = (bh / h) * (h / group) + (bh % h) / group;
  const int row = threadIdx.x / R;
  const int part = threadIdx.x % R;
  const int qpos = q0 + row;
  const int dim0 = part * kDT;

  float qr[kDT], acc[kDT];
  {
    const float* qp = q + (static_cast<size_t>(bh) * n + qpos) * D + dim0;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      qr[j] = qp[j];
      acc[j] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const int n_kv_tiles = n / k_tile;
  const int steps =
      min((window - 1 + q_tile - 1) / k_tile + 2, n_kv_tiles);
  const int first = max(q0 - (window - 1), 0) / k_tile;
  const int tile_lo = q0 - window + 1;       // lowest key any row may see
  const int tile_hi = q0 + q_tile - 1;       // highest key any row may see
  for (int st = 0; st < steps; ++st) {
    const int tile = first + st;
    if (tile >= n_kv_tiles) break;           // clamped steps add nothing
    const int t_end = (tile + 1) * k_tile;
    for (int c0 = tile * k_tile; c0 < t_end; c0 += kChunk) {
      const int rows = min(kChunk, t_end - c0);
      if (c0 > tile_hi || c0 + rows - 1 < tile_lo) continue;  // CTA-uniform
      __syncthreads();                       // the last chunk is consumed
      load_chunk<D>(k, kv, n, c0, rows, ks);
      load_chunk<D>(v, kv, n, c0, rows, vs);
      __syncthreads();
      // keys of this chunk inside (qpos - window, qpos]
      const int lo = max(qpos - window + 1 - c0, 0);
      const int hi = min(qpos - c0, rows - 1);
      // a warp skips a chunk none of its rows can see; all its lanes stay
      // together for the shuffles below
      if (__all_sync(0xffffffffu, lo > hi)) continue;
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kDT; e += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[j][dim0 + e]);
          dot += qr[e] * kk.x + qr[e + 1] * kk.y + qr[e + 2] * kk.z +
                 qr[e + 3] * kk.w;
        }
#pragma unroll
        for (int o = 1; o < R; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[j] = (j >= lo && j <= hi) ? dot * scale : kNegInf;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < kDT; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = (j >= lo && j <= hi) ? expf(s[j] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int e = 0; e < kDT; e += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j][dim0 + e]);
          acc[e] += p * vv.x;
          acc[e + 1] += p * vv.y;
          acc[e + 2] += p * vv.z;
          acc[e + 3] += p * vv.w;
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* op = out + (static_cast<size_t>(bh) * n + qpos) * D + dim0;
#pragma unroll
  for (int j = 0; j < kDT; ++j) op[j] = acc[j] * inv;
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int bh, int n, int h, int group,
                        int window, int q_tile, int k_tile, float scale,
                        cudaStream_t s) {
  const dim3 grid(n / q_tile, bh);
  swa_simt<D><<<grid, q_tile * (D / kDT), 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, h, group,
      window, q_tile, k_tile, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the SIMT body over the reference's q_tile / k_tile:
// q_tile a multiple of 32 with q_tile * d / 64 <= 256 threads, both
// dividing n, bh <= 65535), 1 = bfloat16 (the tensor-core body over tiles
// of 64 query rows, at most 65535 tiles; q_tile and k_tile unused).  q, k,
// v and out share the dtype.  q and out are (bh, n, d), k and v (bh / h *
// h / group, n, d), all contiguous and 16-byte aligned.
extern "C" int swa_attention(const void* q, const void* k, const void* v,
                             void* out, int bh, int n, int d, int h,
                             int group, int window, int q_tile, int k_tile,
                             float scale, int dtype, void* stream) {
  if (bh < 1 || n < 1 || h < 1 || bh % h != 0 || group < 1 ||
      h % group != 0 || window < 1 || (d != 64 && d != 128))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (bh > 65535 || q_tile < 32 || q_tile % 32 != 0 ||
        q_tile * (d / kDT) > 256 || n % q_tile != 0 || k_tile < 1 ||
        n % k_tile != 0)
      return cudaErrorInvalidValue;
    return d == 64 ? launch_simt<64>(q, k, v, out, bh, n, h, group, window,
                                     q_tile, k_tile, scale, s)
                   : launch_simt<128>(q, k, v, out, bh, n, h, group, window,
                                      q_tile, k_tile, scale, s);
  }
  if (dtype != 1 || (n + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  return d == 64 ? launch_mma<64, 64>(q, k, v, out, bh, n, h, group, window,
                                      scale, s)
                 : launch_mma<128, 32>(q, k, v, out, bh, n, h, group, window,
                                       scale, s);
}
