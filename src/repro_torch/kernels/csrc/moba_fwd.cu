// FlashMoBA forward (gather-and-densify) for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/moba_fwd.py::moba_fwd of the JAX package
// (kb-tiled grid _fwd_kernel_tiled; the flat grid _fwd_kernel computes the
// same function).  The wrapper has already gathered the queries routed to
// each key block into the key-block-major layout (q_sorted, one key block
// per q tile); each tile attends to its block under
//   kpos <= q_pos (causal), kpos < n_tokens, q_pos >= 0
// and emits un-normalised partials o (fp32), row max m and row sum l.  The
// per-query merge of the k partials happens in the wrapper.
//
// What bounds it on an H100: bytes.  The layout materialises q_sorted
// (read once) and the fp32 partials (written once) in device memory: at
// moba-340m training shapes about 0.5 GB against 34.6 GFLOP, ~70 flops a
// byte, below the ~295 where the bf16 tensor cores become the limit.  So
// the products must run on the tensor cores (scalar fp32 FMAs reach ~19
// TFLOP/s, which made the first design compute-bound at 12x its bound),
// and loads must overlap the math.
//
// bf16 (the training path): one CTA of 8 warps per (batch*head, q tile),
// each warp owning 16 query rows.  For blocks up to kWholeBlock (256)
// keys, the tile's Q and the whole key block's K and V are staged in
// shared memory as bf16 with 16-byte cp.async copies, rows padded by 16
// bytes so ldmatrix is conflict-free (55 KB at d 64, block 128).  V is its
// own copy group, issued after Q and K, so the first chunk's Q K^T and
// softmax run while V lands.  Longer blocks (original MoBA's 512, or any
// multiple of 16 keys) stream K and V through a two-chunk cp.async ring
// instead: chunk i + 1's copies are issued before chunk i's Q K^T, so the
// shared memory no longer grows with the block (Q plus 2 x 2 x KC rows:
// 37 KB at d 64, KC 32).  Blocks up to kWholeBlock keep the whole-block
// staging because the ring is slower there: at block 128, d 64 (moba-340m
// training) the ring alone took 0.3191 ms against 0.2844 ms staged whole
// (chip_smoke.py --ab, medians of two processes each, H100 80GB HBM3 at
// 700 W): KC 32 doubles the chunks, their barriers and the per-chunk
// rescales, and KC 64 spills in the ring.  Each warp keeps its Q
// fragments in registers for the whole block and walks the block in
// chunks of KC keys (64 where the block allows): S = Q K^T with
// mma.m16n8k16 (bf16 in, fp32 accumulate), the masks per accumulator
// element, the online softmax in fp32 with quad shuffles and the m_safe =
// max(m, -5e29) guard of the reference, then O += P V with P's
// accumulators as the A operand (no shared-memory round trip) and V
// through ldmatrix.trans.  P goes in as two bf16 parts, hi = bf16(p) and
// lo = bf16(p - hi): o is an un-normalised sum over up to a block of keys,
// and p rounded once to bf16 misses the 3e-2 tolerance on it at
// moba-340m shapes; the second part costs one more mma per P V step and
// keeps the partials as exact as fp32 p.  Sentinels stay in fp32
// registers.
// Rows past a ragged q_tile are zero-filled and carry q_pos -1, so they
// mask themselves, and are never stored.  o is stored straight from the
// accumulators as float2: each warp store covers eight whole 32-byte
// sectors, so staging through shared memory would save instructions but
// no bytes.  An inactive tile (block id nb) still writes o = 0, m =
// -1e30, l = 0: the merge reads those slots.
//
// fp32 keeps the SIMT body of the first design (one thread per query row,
// fp32 FMAs, K/V streamed in kb_tile chunks): TF32 products would break
// the fp32 tolerances the checks hold.  The dtype picks the body in the C
// entry point; a bf16 shape the tensor-core kernel cannot take is refused
// by the wrapper and never reaches the SIMT body.
//
// Not done yet (later work): fusing the Q gather and the lse merge so
// q_sorted and the fp32 partials never reach device memory (the bytes
// that bound this kernel); wgmma once the kernel is FLOP-bound.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// the cudaGetLastError() of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------- bf16: tensor cores
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTileRows = 16 * kMmaWarps;    // the largest q tile
constexpr int kWholeBlock = 256;   // blocks staged whole; longer ones ring

using bf16 = __nv_bfloat16;

// RING false: the whole block's K and V staged at once (blocks up to
// kWholeBlock keys); RING true: K and V stream through a two-chunk ring.
// DK is the width of q and k, DV that of v and o (equal but for latent
// attention's 192 / 128).
template <int DK, int DV, int KC, bool RING>
__global__ void __launch_bounds__(kMmaThreads, DK == 64 ? 2 : 1)
moba_fwd_mma(const int32_t* __restrict__ tile_block,
             const bf16* __restrict__ q_sorted,
             const int32_t* __restrict__ q_pos,
             const bf16* __restrict__ k_blocks,
             const bf16* __restrict__ v_blocks, float* __restrict__ o,
             float* __restrict__ m_out, float* __restrict__ l_out,
             int n_tiles, int num_q_heads, int group, int nb, int bs,
             int n_tokens, int q_tile, float scale, int causal) {
  static_assert(DK >= DV, "o is staged in q's rows");
  constexpr int LD = DK + 8;                  // q and k rows
  constexpr int LDV = DV + 8;                 // v rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kKeyRows = KC * 2;            // ring rows of K (and V)
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);     // [kTileRows][LD]
  bf16* ks = qs + kTileRows * LD;          // [bs][LD], ring: [2][KC][LD]
  bf16* vs = ks + (RING ? kKeyRows : bs) * LD;  // the same for V, LDV

  const int bh = blockIdx.y;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int L = n_tiles * q_tile;
  const size_t row0 =
      static_cast<size_t>(bh) * L + static_cast<size_t>(t) * q_tile;
  const int blk = tile_block[static_cast<size_t>(bh) * n_tiles + t];

  if (blk < 0 || blk >= nb) {                // inactive tile
    for (int e = tid; e < q_tile * DV; e += kMmaThreads)
      o[row0 * DV + e] = 0.f;
    if (tid < q_tile) {
      m_out[row0 + tid] = kNegInf;
      l_out[row0 + tid] = 0.f;
    }
    return;
  }

  const int hkv = num_q_heads / group;
  const int kv = (bh / num_q_heads) * hkv + (bh % num_q_heads) / group;
  const size_t kv_blk = (static_cast<size_t>(kv) * nb + blk) * bs;
  mma::copy_rows<DK, kMmaThreads>(qs, q_sorted + row0 * DK, q_tile,
                                  kTileRows);
  // chunk i of the ring goes to buffer i & 1
  auto load_chunk = [&](int i) {
    const size_t off = kv_blk + static_cast<size_t>(i) * KC;
    mma::copy_rows<DK, kMmaThreads>(ks + (i & 1) * KC * LD,
                                    k_blocks + off * DK, KC, KC);
    mma::copy_rows<DV, kMmaThreads>(vs + (i & 1) * KC * LDV,
                                    v_blocks + off * DV, KC, KC);
  };
  if constexpr (RING) {
    load_chunk(0);
    mma::cp_async_commit();
  } else {
    mma::copy_rows<DK, kMmaThreads>(ks, k_blocks + kv_blk * DK, bs, bs);
    mma::cp_async_commit();
    mma::copy_rows<DV, kMmaThreads>(vs, v_blocks + kv_blk * DV, bs, bs);
    mma::cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of the warp's 16)
  const int r_lo = warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int qp_lo = r_lo < q_tile ? q_pos[row0 + r_lo] : -1;
  const int qp_hi = r_hi < q_tile ? q_pos[row0 + r_hi] : -1;
  const int kbase = blk * bs;

  uint32_t qf[DK / 16][4];
  if constexpr (!RING) {
    mma::cp_async_wait<1>();                 // Q and K landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      mma::ldsm_x4(qs + mma::a_offset(lane, warp * 16, kk * 16, LD), qf[kk]);
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;      // running row max
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of l

  for (int c0 = 0; c0 < bs; c0 += KC) {
    // the chunk's keys: rows kc0.. of the staged K and V
    int kc0 = c0;
    if constexpr (RING) {
      const int i = c0 / KC;
      if (c0 + KC < bs) {
        __syncthreads();                     // chunk i - 1's buffer is free
        load_chunk(i + 1);
        mma::cp_async_commit();
        mma::cp_async_wait<1>();             // chunk i (and Q) landed
      } else {
        mma::cp_async_wait<0>();
      }
      __syncthreads();
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          mma::ldsm_x4(qs + mma::a_offset(lane, warp * 16, kk * 16, LD),
                       qf[kk]);
      }
      kc0 = (i & 1) * KC;
    }
    float s[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
#pragma unroll
      for (int np = 0; np < KC / 16; ++np) {
        uint32_t b[4];
        mma::ldsm_x4(ks + mma::bn_offset(lane, kc0 + np * 16, kk * 16, LD),
                     b);
        mma::mma16816(s[2 * np], qf[kk], b[0], b[1]);
        mma::mma16816(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    // masks, scale and the chunk's row max
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kbase + c0 + 8 * j + 2 * tq + (e & 1);
        const int qp = e < 2 ? qp_lo : qp_hi;
        const bool ok = qp >= 0 && kpos < n_tokens && (!causal || kpos <= qp);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        if (e < 2) mx_lo = fmaxf(mx_lo, s[j][e]);
        else mx_hi = fmaxf(mx_hi, s[j][e]);
      }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
    }
    const float ms_lo = fmaxf(mx_lo, kNegInf * 0.5f);
    const float ms_hi = fmaxf(mx_hi, kNegInf * 0.5f);
    const float a_lo = __expf(m_lo - ms_lo);
    const float a_hi = __expf(m_hi - ms_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    // a masked score sits at -1e30 <= m_safe - 5e29, so its p is 0
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      s[j][0] = __expf(s[j][0] - ms_lo);
      s[j][1] = __expf(s[j][1] - ms_lo);
      s[j][2] = __expf(s[j][2] - ms_hi);
      s[j][3] = __expf(s[j][3] - ms_hi);
      ps_lo += s[j][0] + s[j][1];
      ps_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * a_lo + ps_lo;
    l_hi = l_hi * a_hi + ps_hi;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[j][0] *= a_lo;
      acc[j][1] *= a_lo;
      acc[j][2] *= a_hi;
      acc[j][3] *= a_hi;
    }
    if (!RING && c0 == 0) {                  // V landed
      mma::cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t ph[4], pl[4];
      mma::acc_to_a_split(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t b[4];
        mma::ldsm_x4_t(vs + mma::bk_offset(lane, kc0 + kk * 16, dp * 16, LDV),
                       b);
        mma::mma16816(acc[2 * dp], ph, b[0], b[1]);
        mma::mma16816(acc[2 * dp + 1], ph, b[2], b[3]);
        mma::mma16816(acc[2 * dp], pl, b[0], b[1]);
        mma::mma16816(acc[2 * dp + 1], pl, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, sh);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, sh);
  }
  if (r_lo < q_tile) {
    float* dst = o + (row0 + r_lo) * DV + 2 * tq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[j][0], acc[j][1]);
    if (tq == 0) {
      m_out[row0 + r_lo] = l_lo > 0.f ? m_lo : kNegInf;
      l_out[row0 + r_lo] = l_lo;
    }
  }
  if (r_hi < q_tile) {
    float* dst = o + (row0 + r_hi) * DV + 2 * tq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[j][2], acc[j][3]);
    if (tq == 0) {
      m_out[row0 + r_hi] = l_hi > 0.f ? m_hi : kNegInf;
      l_out[row0 + r_hi] = l_hi;
    }
  }
}

template <int DK, int DV, int KC, bool RING>
int launch_mma(const void* tile_block, const void* q_sorted,
               const void* q_pos, const void* k_blocks, const void* v_blocks,
               void* o, void* m, void* l, int bh, int n_tiles,
               int num_q_heads, int group, int nb, int bs, int n_tokens,
               int q_tile, float scale, int causal, cudaStream_t s) {
  const size_t key_rows = RING ? 2 * KC : bs;   // K (and V) rows staged
  const size_t smem = sizeof(bf16) * ((kTileRows + key_rows) * (DK + 8) +
                                      key_rows * (DV + 8));
  auto kernel = moba_fwd_mma<DK, DV, KC, RING>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_tiles, bh), kMmaThreads, smem, s>>>(
      static_cast<const int32_t*>(tile_block),
      static_cast<const bf16*>(q_sorted), static_cast<const int32_t*>(q_pos),
      static_cast<const bf16*>(k_blocks), static_cast<const bf16*>(v_blocks),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      n_tiles, num_q_heads, group, nb, bs, n_tokens, q_tile, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The chunk: the largest of 64, 32, 16 keys that divides the block (32,
// 16 for the ring: at KC 64 its d-64 body needs more than the 128
// registers two CTAs an SM leave, and spills); the whole block staged up
// to kWholeBlock keys, the ring above.
template <int DK, int DV, bool RING>
int dispatch_chunk(const void* tb, const void* qs, const void* qp,
                   const void* kb, const void* vb, void* o, void* m, void* l,
                   int bh, int n_tiles, int h, int g, int nb, int bs, int n,
                   int q_tile, float scale, int causal, cudaStream_t s) {
  if constexpr (!RING) {
    if (bs % 64 == 0)
      return launch_mma<DK, DV, 64, false>(tb, qs, qp, kb, vb, o, m, l, bh,
                                      n_tiles, h, g, nb, bs, n, q_tile,
                                      scale, causal, s);
  }
  if (bs % 32 == 0)
    return launch_mma<DK, DV, 32, RING>(tb, qs, qp, kb, vb, o, m, l, bh, n_tiles,
                                   h, g, nb, bs, n, q_tile, scale, causal,
                                   s);
  return launch_mma<DK, DV, 16, RING>(tb, qs, qp, kb, vb, o, m, l, bh, n_tiles, h,
                                 g, nb, bs, n, q_tile, scale, causal, s);
}

// ------------------------------------------------------ fp32: SIMT
constexpr int kThreads = 128;   // one thread per query row of the tile
constexpr int kSub = 16;        // keys scored per register pass

// Stage `rows` contiguous rows of width D from src as rows of stride `ld`
// in shared memory.
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int rows, float* dst, int ld) {
  for (int e = threadIdx.x * 4; e < rows * D; e += kThreads * 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + e));
    const int r = e / D;
    float* d = dst + r * ld + e - r * D;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
moba_fwd_simt(const int32_t* __restrict__ tile_block,
              const float* __restrict__ q_sorted,
              const int32_t* __restrict__ q_pos,
              const float* __restrict__ k_blocks,
              const float* __restrict__ v_blocks, float* __restrict__ o,
              float* __restrict__ m_out, float* __restrict__ l_out,
              int n_tiles, int num_q_heads, int group, int nb, int bs,
              int n_tokens, int q_tile, int kb_tile, float scale,
              int causal) {
  static_assert(DK >= DV, "o is staged in q's rows");
  extern __shared__ float smem[];
  float* qs = smem;                          // [kThreads][DK + 1]
  float* ks = qs + kThreads * (DK + 1);      // [kb_tile][DK]
  float* vs = ks + kb_tile * DK;             // [kb_tile][DV]

  const int bh = blockIdx.y;
  const int t = blockIdx.x;
  const int r = threadIdx.x;
  const int L = n_tiles * q_tile;
  const size_t row0 = static_cast<size_t>(bh) * L + static_cast<size_t>(t) * q_tile;
  const int blk = tile_block[static_cast<size_t>(bh) * n_tiles + t];

  if (blk < 0 || blk >= nb) {                // inactive tile
    for (int e = r; e < q_tile * DV; e += kThreads) o[row0 * DV + e] = 0.f;
    if (r < q_tile) {
      m_out[row0 + r] = kNegInf;
      l_out[row0 + r] = 0.f;
    }
    return;
  }

  const int hkv = num_q_heads / group;
  const int kv = (bh / num_q_heads) * hkv + (bh % num_q_heads) / group;
  const size_t kv_blk = (static_cast<size_t>(kv) * nb + blk) * bs;
  stage<DK>(q_sorted + row0 * DK, q_tile, qs, DK + 1);
  const int qpos = r < q_tile ? q_pos[row0 + r] : -1;
  const int kbase = blk * bs;

  float m = kNegInf;
  float l = 0.f;
  float acc[DV];
#pragma unroll
  for (int dd = 0; dd < DV; ++dd) acc[dd] = 0.f;

  for (int kb0 = 0; kb0 < bs; kb0 += kb_tile) {
    __syncthreads();                         // previous chunk consumed
    stage<DK>(k_blocks + (kv_blk + kb0) * DK, kb_tile, ks, DK);
    stage<DV>(v_blocks + (kv_blk + kb0) * DV, kb_tile, vs, DV);
    __syncthreads();
    for (int j0 = 0; j0 < kb_tile; j0 += kSub) {
      float s[kSub];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) s[jj] = 0.f;
      for (int kk = 0; kk < DK; ++kk) {
        const float qk = qs[r * (DK + 1) + kk];
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj)
          s[jj] = fmaf(qk, ks[(j0 + jj) * DK + kk], s[jj]);
      }
      unsigned valid = 0;
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int kpos = kbase + kb0 + j0 + jj;
        const bool ok = qpos >= 0 && kpos < n_tokens &&
                        (!causal || kpos <= qpos);
        valid |= static_cast<unsigned>(ok) << jj;
        s[jj] = ok ? s[jj] * scale : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      const float m_safe = fmaxf(mx, kNegInf * 0.5f);
      const float alpha = expf(m - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        s[jj] = (valid >> jj & 1u) ? expf(s[jj] - m_safe) : 0.f;
        psum += s[jj];
      }
      l = l * alpha + psum;
      m = mx;
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) {
        float a = acc[dd] * alpha;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj)
          a = fmaf(s[jj], vs[(j0 + jj) * DV + dd], a);
        acc[dd] = a;
      }
    }
  }

  // coalesced store of the partials through shared memory
  __syncthreads();
#pragma unroll
  for (int dd = 0; dd < DV; ++dd) qs[r * (DV + 1) + dd] = acc[dd];
  __syncthreads();
  for (int e = r; e < q_tile * DV; e += kThreads)
    o[row0 * DV + e] = qs[(e / DV) * (DV + 1) + e % DV];
  if (r < q_tile) {
    m_out[row0 + r] = l > 0.f ? m : kNegInf;
    l_out[row0 + r] = l;
  }
}

template <int DK, int DV>
int launch_simt(const void* tile_block, const void* q_sorted,
                const void* q_pos, const void* k_blocks, const void* v_blocks,
                void* o, void* m, void* l, int bh, int n_tiles,
                int num_q_heads, int group, int nb, int bs, int n_tokens,
                int q_tile, int kb_tile, float scale, int causal,
                cudaStream_t s) {
  const size_t smem = sizeof(float) * (kThreads * (DK + 1) +
                                       static_cast<size_t>(kb_tile) * (DK + DV));
  auto kernel = moba_fwd_simt<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_tiles, bh), kThreads, smem, s>>>(
      static_cast<const int32_t*>(tile_block),
      static_cast<const float*>(q_sorted), static_cast<const int32_t*>(q_pos),
      static_cast<const float*>(k_blocks),
      static_cast<const float*>(v_blocks), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), n_tiles, num_q_heads,
      group, nb, bs, n_tokens, q_tile, kb_tile, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile_block (bh, n_tiles) int32; q_sorted (bh, n_tiles*q_tile, d);
// q_pos (bh, n_tiles*q_tile) int32; k_blocks (bh/group, nb, bs, d);
// v_blocks (bh/group, nb, bs, dv); o (bh, L, dv), m, l (bh, L) float32.
// (d, dv): (64, 64), (128, 128) or latent attention's (192, 128).  dtype: 0 = float32 (SIMT body,
// K/V streamed in kb_tile chunks), 1 = bfloat16 (tensor cores: the whole
// block staged up to kWholeBlock keys, streamed through the ring above;
// kb_tile is only checked); bs a multiple of kb_tile, itself a multiple of
// 16 up to 128; q_sorted and the K/V blocks share the dtype.
extern "C" int moba_fwd(const void* tile_block, const void* q_sorted,
                        const void* q_pos, const void* k_blocks,
                        const void* v_blocks, void* o, void* m, void* l,
                        int bh, int n_tiles, int num_q_heads, int group,
                        int nb, int bs, int d, int dv, int n_tokens,
                        int q_tile,
                        int kb_tile, float scale, int causal, int dtype,
                        void* stream) {
  if (bh < 1 || bh > 65535 || n_tiles < 1 || num_q_heads < 1 || group < 1 ||
      num_q_heads % group != 0 || nb < 1 ||
      !((d == 64 && dv == 64) || (d == 128 && dv == 128) ||
        (d == 192 && dv == 128)) ||
      q_tile < 1 || q_tile > kTileRows || kb_tile < kSub ||
      kb_tile % kSub != 0 || kb_tile > 128 || bs % kb_tile != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    auto* simt = d == 64    ? &launch_simt<64, 64>
                 : d == 128 ? &launch_simt<128, 128>
                            : &launch_simt<192, 128>;
    return simt(tile_block, q_sorted, q_pos, k_blocks, v_blocks, o, m, l, bh,
                n_tiles, num_q_heads, group, nb, bs, n_tokens, q_tile,
                kb_tile, scale, causal, s);
  }
  if (dtype != 1 || bs % 16 != 0) return cudaErrorInvalidValue;
  const bool ring = bs > kWholeBlock;
  auto* run = d == 64    ? (ring ? &dispatch_chunk<64, 64, true>
                                 : &dispatch_chunk<64, 64, false>)
              : d == 128 ? (ring ? &dispatch_chunk<128, 128, true>
                                 : &dispatch_chunk<128, 128, false>)
                         : (ring ? &dispatch_chunk<192, 128, true>
                                 : &dispatch_chunk<192, 128, false>);
  return run(tile_block, q_sorted, q_pos, k_blocks, v_blocks, o, m, l, bh,
             n_tiles, num_q_heads, group, nb, bs, n_tokens, q_tile, scale,
             causal, s);
}
