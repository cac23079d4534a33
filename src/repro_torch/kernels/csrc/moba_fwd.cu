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
// What bounds it on an H100: bytes, because the layout materialises
// q_sorted (read once) and the fp32 partials (written once) in device
// memory: at moba-340m training shapes about 0.5 GB against 34 GFLOP of
// products, i.e. ~70 flops per byte, below the ~295 where the tensor
// cores would become the limit.
//
// What the design does about it: one CTA per (batch*head, q tile) reads
// its tile's block id itself, stages the q tile once in shared memory and
// streams the block's K/V through shared memory in kb_tile chunks (16-byte
// loads), so every q_sorted element is read once and every output element
// written once, through shared memory so the stores are coalesced.  Each
// thread owns one query row: scores for 16 keys at a time stay in
// registers, the online softmax runs in fp32 with the m_safe =
// max(m, -5e29) guard of the reference, and the row's d-wide accumulator
// stays in registers.  An inactive tile (block id nb) still writes o = 0,
// m = -1e30, l = 0: the merge reads those slots.
//
// Not done yet (later work): wgmma for the (q_tile, kb) products and a TMA
// ring that overlaps the next chunk's load with this chunk's math; fusing
// the gather and the merge so q_sorted and the partials never reach
// device memory.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// the cudaGetLastError() of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // one thread per query row of the tile
constexpr int kSub = 16;        // keys scored per register pass
constexpr float kNegInf = -1e30f;

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

// Stage `rows` contiguous rows of width D from src as fp32 rows of stride
// `ld` in shared memory.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows,
                                      float* dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  for (int e = threadIdx.x * kVec; e < rows * D; e += kThreads * kVec) {
    float tmp[kVec];
    load16(src + e, tmp);
    const int r = e / D;
    const int c = e - r * D;
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * ld + c + j] = tmp[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
moba_fwd_kernel(const int32_t* __restrict__ tile_block,
                const T* __restrict__ q_sorted,
                const int32_t* __restrict__ q_pos,
                const T* __restrict__ k_blocks,
                const T* __restrict__ v_blocks, float* __restrict__ o,
                float* __restrict__ m_out, float* __restrict__ l_out,
                int n_tiles, int num_q_heads, int group, int nb, int bs,
                int n_tokens, int q_tile, int kb_tile, float scale,
                int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kThreads][D + 1]
  float* ks = qs + kThreads * (D + 1);       // [kb_tile][D]
  float* vs = ks + kb_tile * D;              // [kb_tile][D]

  const int bh = blockIdx.y;
  const int t = blockIdx.x;
  const int r = threadIdx.x;
  const int L = n_tiles * q_tile;
  const size_t row0 = static_cast<size_t>(bh) * L + static_cast<size_t>(t) * q_tile;
  const int blk = tile_block[static_cast<size_t>(bh) * n_tiles + t];

  if (blk < 0 || blk >= nb) {                // inactive tile
    for (int e = r; e < q_tile * D; e += kThreads) o[row0 * D + e] = 0.f;
    if (r < q_tile) {
      m_out[row0 + r] = kNegInf;
      l_out[row0 + r] = 0.f;
    }
    return;
  }

  const int hkv = num_q_heads / group;
  const int kv = (bh / num_q_heads) * hkv + (bh % num_q_heads) / group;
  const size_t kv_off = (static_cast<size_t>(kv) * nb + blk) * bs * D;
  stage<T, D>(q_sorted + row0 * D, q_tile, qs, D + 1);
  const int qpos = r < q_tile ? q_pos[row0 + r] : -1;
  const int kbase = blk * bs;

  float m = kNegInf;
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) acc[dd] = 0.f;

  for (int kb0 = 0; kb0 < bs; kb0 += kb_tile) {
    __syncthreads();                         // previous chunk consumed
    stage<T, D>(k_blocks + kv_off + static_cast<size_t>(kb0) * D, kb_tile,
                ks, D);
    stage<T, D>(v_blocks + kv_off + static_cast<size_t>(kb0) * D, kb_tile,
                vs, D);
    __syncthreads();
    for (int j0 = 0; j0 < kb_tile; j0 += kSub) {
      float s[kSub];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) s[jj] = 0.f;
      for (int kk = 0; kk < D; ++kk) {
        const float qk = qs[r * (D + 1) + kk];
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj)
          s[jj] = fmaf(qk, ks[(j0 + jj) * D + kk], s[jj]);
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
      for (int dd = 0; dd < D; ++dd) {
        float a = acc[dd] * alpha;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj)
          a = fmaf(s[jj], vs[(j0 + jj) * D + dd], a);
        acc[dd] = a;
      }
    }
  }

  // coalesced store of the partials through shared memory
  __syncthreads();
#pragma unroll
  for (int dd = 0; dd < D; ++dd) qs[r * (D + 1) + dd] = acc[dd];
  __syncthreads();
  for (int e = r; e < q_tile * D; e += kThreads)
    o[row0 * D + e] = qs[(e / D) * (D + 1) + e % D];
  if (r < q_tile) {
    m_out[row0 + r] = l > 0.f ? m : kNegInf;
    l_out[row0 + r] = l;
  }
}

template <typename T, int D>
int launch(const void* tile_block, const void* q_sorted, const void* q_pos,
           const void* k_blocks, const void* v_blocks, void* o, void* m,
           void* l, int bh, int n_tiles, int num_q_heads, int group, int nb,
           int bs, int n_tokens, int q_tile, int kb_tile, float scale,
           int causal, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (kThreads * (D + 1) + 2 * static_cast<size_t>(kb_tile) * D);
  auto kernel = moba_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, bh);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int32_t*>(tile_block), static_cast<const T*>(q_sorted),
      static_cast<const int32_t*>(q_pos), static_cast<const T*>(k_blocks),
      static_cast<const T*>(v_blocks), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), n_tiles, num_q_heads,
      group, nb, bs, n_tokens, q_tile, kb_tile, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* tb, const void* qs, const void* qp,
               const void* kb, const void* vb, void* o, void* m, void* l,
               int bh, int n_tiles, int h, int g, int nb, int bs, int n,
               int q_tile, int kb_tile, float scale, int causal,
               cudaStream_t s) {
  if (d == 64)
    return launch<T, 64>(tb, qs, qp, kb, vb, o, m, l, bh, n_tiles, h, g, nb,
                         bs, n, q_tile, kb_tile, scale, causal, s);
  return launch<T, 128>(tb, qs, qp, kb, vb, o, m, l, bh, n_tiles, h, g, nb,
                        bs, n, q_tile, kb_tile, scale, causal, s);
}

}  // namespace

// tile_block (bh, n_tiles) int32; q_sorted (bh, n_tiles*q_tile, d);
// q_pos (bh, n_tiles*q_tile) int32; k/v_blocks (bh/group, nb, bs, d);
// o (bh, L, d), m, l (bh, L) float32.  dtype: 0 = float32, 1 = bfloat16
// (q_sorted and the K/V blocks share it).
extern "C" int moba_fwd(const void* tile_block, const void* q_sorted,
                        const void* q_pos, const void* k_blocks,
                        const void* v_blocks, void* o, void* m, void* l,
                        int bh, int n_tiles, int num_q_heads, int group,
                        int nb, int bs, int d, int n_tokens, int q_tile,
                        int kb_tile, float scale, int causal, int dtype,
                        void* stream) {
  if (bh < 1 || bh > 65535 || n_tiles < 1 || num_q_heads < 1 || group < 1 ||
      num_q_heads % group != 0 || nb < 1 || (d != 64 && d != 128) ||
      q_tile < 1 || q_tile > kThreads || kb_tile < kSub ||
      kb_tile % kSub != 0 || kb_tile > 128 || bs % kb_tile != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, tile_block, q_sorted, q_pos, k_blocks,
                             v_blocks, o, m, l, bh, n_tiles, num_q_heads,
                             group, nb, bs, n_tokens, q_tile, kb_tile, scale,
                             causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, tile_block, q_sorted, q_pos, k_blocks,
                                     v_blocks, o, m, l, bh, n_tiles,
                                     num_q_heads, group, nb, bs, n_tokens,
                                     q_tile, kb_tile, scale, causal, s);
  return cudaErrorInvalidValue;
}
