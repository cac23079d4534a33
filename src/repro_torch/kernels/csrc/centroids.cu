// Key-block centroids for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/centroids.py::block_centroids_kernel of
// the JAX package (_centroid_kernel): keys (rows, N, d) are mean-pooled
// into (rows, nb, d) block centroids; the ragged tail block is averaged
// over its valid rows (pos < N) only.  Sums run in fp32 and the result is
// stored in the keys' dtype, so routing sees centroids rounded exactly as
// the plain version rounds them.
//
// What bounds it on an H100: bytes.  It reads every key once (rows*N*d
// elements) and writes bs times fewer; one add per element read, far
// below the ~295 flops/byte where compute would matter.
//
// What the design does about it: one CTA per (kv row, key block); the
// 128 threads split into 128/d row groups of d columns, so each key row
// is read as one coalesced d-wide segment, summed in registers, and the
// row groups combine through shared memory once.  Nothing is staged
// twice and the output is written once.
//
// C interface (ctypes): every pointer and the stream are void*; returns
// the cudaGetLastError() of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
centroids_kernel(const T* __restrict__ k, T* __restrict__ out, int n,
                 int nb, int bs, int d) {
  __shared__ float part[kThreads];
  const int row = blockIdx.y;
  const int j = blockIdx.x;
  const int groups = kThreads / d;
  const int c = threadIdx.x % d;
  const int rg = threadIdx.x / d;
  const int t0 = j * bs;
  const int valid = min(bs, n - t0);
  const T* src = k + (static_cast<size_t>(row) * n + t0) * d + c;
  float acc = 0.f;
  for (int r = rg; r < valid; r += groups)
    acc += to_float(src[static_cast<size_t>(r) * d]);
  part[threadIdx.x] = acc;
  __syncthreads();
  if (rg == 0) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[g * d + c];
    store(out + (static_cast<size_t>(row) * nb + j) * d + c,
          s / static_cast<float>(max(valid, 1)));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (keys and centroids share it).
extern "C" int block_centroids(const void* k, void* out, int rows, int n,
                               int bs, int d, int dtype, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || bs < 1 || (d != 64 && d != 128))
    return cudaErrorInvalidValue;
  const int nb = (n + bs - 1) / bs;
  const dim3 grid(nb, rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    centroids_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(k), static_cast<float*>(out), n, nb, bs, d);
  } else if (dtype == 1) {
    centroids_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(out),
        n, nb, bs, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
