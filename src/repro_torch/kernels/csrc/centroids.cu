// Key-block centroids for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/centroids.py::block_centroids_kernel of
// the JAX package (_centroid_kernel): keys (rows, N, d) are mean-pooled
// into (rows, nb, d) block centroids; the ragged tail block is averaged
// over its valid rows (pos < N) only.  Sums run in fp32 and the result is
// stored in the keys' dtype, so routing sees centroids rounded as the
// plain version rounds them (the sum order differs, so a bf16 centroid may
// move by one ulp).
//
// What bounds it on an H100: bytes.  It reads every key once (rows*N*d
// elements) and writes bs times fewer; one add per element read, far
// below the ~295 flops/byte where compute would matter.  At the training
// shape (16 kv rows x 8192 keys x 64, bf16) that is 16.8 MB, ~5 us at
// 3.35 TB/s.
//
// What the design does about it: a bandwidth-shaped pass.  One CTA of 128
// threads per (kv row, key block); each thread loads 16 bytes at a time
// (8 bf16 or 4 fp32 values), so d*sizeof(T)/16 threads span one key row
// and the CTA covers 128 / that many rows per step (16 rows for bf16 at
// d 64).  kUnroll independent 16-byte loads per thread are issued before
// any of them is summed, so many loads are in flight per SM.  The row
// groups combine once, through shuffles inside a warp and shared memory
// across the four warps, and each centroid is written once with 16-byte
// stores.  At the training shape the grid is 64 blocks x 16 rows = 1,024
// CTAs, ~7.8 per SM.  Latent attention's 192-wide keys (128 + 64) do not
// split into whole 16-byte row groups of a warp, so a CTA there covers one
// 64-wide column slice of the row (blockIdx.z, three slices); every other
// width takes its whole row in one CTA.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// the cudaGetLastError() of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void add(const uint4& raw, float (&acc)[kN]) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] += f[j];
  }
  __device__ static uint4 pack(const float (&v)[kN]) {
    uint4 raw;
    float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
    for (int j = 0; j < kN; ++j) f[j] = v[j];
    return raw;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void add(const uint4& raw, float (&acc)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc[2 * j] += f.x;
      acc[2 * j + 1] += f.y;
    }
  }
  __device__ static uint4 pack(const float (&v)[kN]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kN / 2; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    return raw;
  }
};

// W: the columns one CTA sums, the whole row (W == D) or a slice of it.
template <typename T, int D, int W = D>
__global__ void __launch_bounds__(kThreads)
centroids_kernel(const T* __restrict__ k, T* __restrict__ out, int n,
                 int nb, int bs) {
  constexpr int kN = Vec<T>::kN;           // values in 16 bytes
  constexpr int kSpan = W / kN;            // threads across one key row
  constexpr int kRows = kThreads / kSpan;  // key rows per step
  constexpr int kPerWarp = 32 / kSpan;     // row groups inside one warp
  __shared__ float part[kWarps][W];
  const int row = blockIdx.y;
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int col = tid % kSpan;
  const int rg = tid / kSpan;
  const int t0 = j * bs;
  const int valid = min(bs, n - t0);
  const T* k_row = k + (static_cast<size_t>(row) * n + t0) * D;
  T* out_row = out + (static_cast<size_t>(row) * nb + j) * D;
  if constexpr (W < D) {                   // this CTA's column slice
    k_row += blockIdx.z * W;
    out_row += blockIdx.z * W;
  }
  const uint4* src = reinterpret_cast<const uint4*>(k_row) + col;
  constexpr int kRowVecs = D / kN;         // uint4 per key row
  float acc[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) acc[e] = 0.f;
  for (int r0 = rg; r0 < valid; r0 += kRows * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kRows;
      raw[u] = r < valid ? __ldg(src + static_cast<size_t>(r) * kRowVecs)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Vec<T>::add(raw[u], acc);
  }
  // row groups of one warp: lanes col, col + kSpan, ... share a column
#pragma unroll
  for (int o = kSpan; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < kN; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  const int warp = tid >> 5;
  if ((tid & 31) < kSpan) {
#pragma unroll
    for (int e = 0; e < kN; ++e) part[warp][col * kN + e] = acc[e];
  }
  __syncthreads();
  if (tid < kSpan) {
    const float inv = 1.f / static_cast<float>(max(valid, 1));
    float v[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][col * kN + e];
      v[e] = s * inv;
    }
    reinterpret_cast<uint4*>(out_row)[col] = Vec<T>::pack(v);
  }
  static_assert(kPerWarp * kSpan == 32, "row groups tile a warp");
}

template <typename T>
cudaError_t launch(const void* k, void* out, int rows, int n, int bs, int d,
                   cudaStream_t s) {
  const int nb = (n + bs - 1) / bs;
  const dim3 grid(nb, rows);
  if (d == 64)
    centroids_kernel<T, 64><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(k), static_cast<T*>(out), n, nb, bs);
  else if (d == 128)
    centroids_kernel<T, 128><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(k), static_cast<T*>(out), n, nb, bs);
  else
    centroids_kernel<T, 192, 64><<<dim3(nb, rows, 3), kThreads, 0, s>>>(
        static_cast<const T*>(k), static_cast<T*>(out), n, nb, bs);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (keys and centroids share it).  k and
// out must be 16-byte aligned (the wrapper checks).
extern "C" int block_centroids(const void* k, void* out, int rows, int n,
                               int bs, int d, int dtype, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || bs < 1 ||
      (d != 64 && d != 128 && d != 192))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(k, out, rows, n, bs, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(k, out, rows, n, bs, d, s);
  return cudaErrorInvalidValue;
}
