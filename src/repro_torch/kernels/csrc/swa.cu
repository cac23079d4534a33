// Banded causal flash attention (sliding window) for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/swa.py::swa_attention of the JAX package
// (_swa_kernel).  Query i attends keys j with i - window < j <= i, GQA by
// the reference's row map kv = (bh / h) * (h / group) + (bh % h) / group, an
// online softmax in fp32, the output in q's dtype.  Forward only, as in JAX.
//
// What bounds it on an H100: bytes.  The function reads q, k and v once and
// writes o once (at N 8192, window 256, 16 heads, d 64, bf16: 67.1 MB, 0.020
// ms at 3.35 TB/s), against 4 * N * window * d flops a head (8.5 GFLOP, 0.009
// ms at the bf16 tensor-core peak).
//
// What the design does about it: one CTA per (bh, q tile) keeps its queries
// and their accumulators in registers (a thread per query row and 64 head
// dims; two threads per row at d 128, their partial dot products summed by a
// shuffle), so q is read once and o written once.  The CTA visits only the
// key tiles that can meet its band (the reference's steps formula,
// ceil((window - 1 + Tq - 1) / Tk) + 2, clamped), stages their keys and values
// in fp32 shared memory in chunks of 32 keys, and skips a chunk that lies
// wholly outside the tile's band; a warp skips a chunk outside all of its
// rows' bands.  K/V rows are re-read by the window / Tq tiles that share them,
// mostly from L2.  The products run on the CUDA cores in fp32.
//
// Not done yet (later work): mma.sync / wgmma for the two products, a TMA
// ring that overlaps the next chunk's load with this chunk's math.
//
// C interface (ctypes): every pointer and the stream are void*; returns the
// cudaGetLastError() of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDT = 64;              // head dims a thread owns
constexpr int kChunk = 32;           // keys staged per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage keys [c0, c0 + rows) of kv row `kv` (zeros past `rows`) as fp32.
template <typename T, int D>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, int kv,
                                           int n, int c0, int rows,
                                           float (*dst)[D]) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kChunk * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    if (r < rows) {
      const T* p = src + (static_cast<size_t>(kv) * n + c0 + r) * D + c;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[r][c + j] = to_float(vals[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[r][c + j] = 0.f;
    }
  }
}

// Block: q_tile * (D / kDT) threads.  Thread t owns query row t / R of the
// tile and head dims [(t % R) * kDT, (t % R + 1) * kDT).
template <typename T, int D>
__global__ void __launch_bounds__(256)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int n, int h,
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
    const T* qp = q + (static_cast<size_t>(bh) * n + qpos) * D + dim0;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      qr[j] = to_float(qp[j]);
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
      load_chunk<T, D>(k, kv, n, c0, rows, ks);
      load_chunk<T, D>(v, kv, n, c0, rows, vs);
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
  T* op = out + (static_cast<size_t>(bh) * n + qpos) * D + dim0;
#pragma unroll
  for (int j = 0; j < kDT; ++j) store(op + j, acc[j] * inv);
}

template <typename T, int D>
cudaError_t launch_swa(const void* q, const void* k, const void* v, void* out,
                       int bh, int n, int h, int group, int window, int q_tile,
                       int k_tile, float scale, cudaStream_t s) {
  const dim3 grid(n / q_tile, bh);
  swa_kernel<T, D><<<grid, q_tile * (D / kDT), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, h, group, window,
      q_tile, k_tile, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int d, const void* q, const void* k, const void* v,
                         void* out, int bh, int n, int h, int group,
                         int window, int q_tile, int k_tile, float scale,
                         cudaStream_t s) {
  if (d == 64)
    return launch_swa<T, 64>(q, k, v, out, bh, n, h, group, window, q_tile,
                             k_tile, scale, s);
  return launch_swa<T, 128>(q, k, v, out, bh, n, h, group, window, q_tile,
                            k_tile, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q and out
// are (bh, n, d), k and v (bh / h * h / group, n, d), all contiguous.
extern "C" int swa_attention(const void* q, const void* k, const void* v,
                             void* out, int bh, int n, int d, int h,
                             int group, int window, int q_tile, int k_tile,
                             float scale, int dtype, void* stream) {
  if (bh < 1 || h < 1 || bh % h != 0 || group < 1 || h % group != 0 ||
      window < 1 || (d != 64 && d != 128) || q_tile < 32 ||
      q_tile % 32 != 0 || q_tile * (d / kDT) > 256 || n % q_tile != 0 ||
      k_tile < 1 || n % k_tile != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch_dim<float>(d, q, k, v, out, bh, n, h, group,
                                       window, q_tile, k_tile, scale, s)
                 : dispatch_dim<__nv_bfloat16>(d, q, k, v, out, bh, n, h,
                                               group, window, q_tile, k_tile,
                                               scale, s);
  return static_cast<int>(err);
}
