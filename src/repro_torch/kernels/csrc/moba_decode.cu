// Paged MoBA decode for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/moba_decode.py::moba_paged_decode_pallas
// of the JAX package (grouped grid: _decode_grouped / _decode_kernel_grouped;
// the flat grid computes the same function).  One query token per sequence
// attends to the pages its heads routed to; K/V are read through the block
// table and merged with an online softmax in fp32.
//
// What bounds it on an H100: bytes.  Each (sequence, kv head) reads at most
// n_uniq pages of ps tokens x d values of K and of V, about
// sum(n_uniq * ps * d * 2 * sizeof(pool)) over the batch at 3.35 TB/s, and
// does ~4 flops per byte read, far below the ~295 flops/byte where the
// tensor cores would become the limit.  An int8 or fp8 pool moves a quarter
// of an fp32 pool's bytes and half of a bf16 pool's.
//
// What the design does about it: the wrapper (kernels/moba_decode.py) routes,
// deduplicates the GQA group's selection into a page union and resolves the
// physical page ids, so every selected page is read from HBM exactly once
// with 16-byte coalesced loads, straight from the pool (no gathered copy),
// and a CTA stops at the union's end and at the last valid token of the
// page instead of visiting all G*top_k slots.  One CTA per (batch, kv head)
// row walks its pages in tiles of kTile tokens staged in shared memory.
// Per-head page membership comes as token offsets: a head that did not
// select a page gets the sentinel npg*ps, so its scores mask out.
//
// Quantized pools (int8, or fp8 e4m3 "fn": torch.float8_e4m3fn) carry one
// fp32 scale per (page, kv head).  As in the TPU kernel (ksc_ref/vsc_ref,
// moba_decode.py:126-127 and :258-259 there) the staged tile is upcast and
// multiplied by its page's scale in fp32 before both products; the scale of
// each union slot is read once per CTA.  Only the first n_uniq slots are
// visited, so the clamped padding slots never read a scale.
//
// Not done yet (later work): wgmma for the (G, ps) products, a TMA ring that
// overlaps the next tile's load with this tile's math, and splitting a row's
// pages across CTAs when batch*kv_heads < 132 SMs.
//
// C interface (ctypes): every pointer and the stream are void*; returns the
// cudaGetLastError() of the launch (0 = success).  scales_k / scales_v are
// the (P, Hkv) fp32 dequant scales of a quantized pool, null otherwise.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens staged per step (one per lane)
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;
constexpr int kAcc = kMaxG * kMaxD / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename P>
constexpr bool kQuantized =
    std::is_same<P, int8_t>::value || std::is_same<P, __nv_fp8_e4m3>::value;
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [tok0, tok0 + rows) of kv head h of one page as fp32, times
// the page's dequant scale for a quantized pool.
template <typename P>
__device__ __forceinline__ void load_tile(const P* __restrict__ pool,
                                          int page, int tok0, int rows,
                                          int ps, int hkv, int h, int d,
                                          float scale,
                                          float (*dst)[kMaxD + 1]) {
  constexpr int kVec = 16 / sizeof(P);
  const int per_row = d / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec;
    const P* src =
        pool + ((static_cast<size_t>(page) * ps + tok0 + r) * hkv + h) * d + c;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const P* vals = reinterpret_cast<const P*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if constexpr (kQuantized<P>)
        dst[r][c + j] = to_float(vals[j]) * scale;
      else
        dst[r][c + j] = to_float(vals[j]);
    }
  }
}

// T: q and out (fp32 or bf16); P: the pool payload (T itself, int8 or fp8).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
moba_paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ pk,
                         const P* __restrict__ pv,
                         const float* __restrict__ scales_k,
                         const float* __restrict__ scales_v,
                         const int32_t* __restrict__ phys,
                         const int32_t* __restrict__ base,
                         const int32_t* __restrict__ n_uniq,
                         const int32_t* __restrict__ kv_len,
                         T* __restrict__ out, int hkv, int g, int u_cap,
                         int ps, int d, float scale) {
  __shared__ float qs[kMaxG][kMaxD];
  __shared__ float ks[kTile][kMaxD + 1];
  __shared__ float vs[kTile][kMaxD + 1];
  __shared__ float pr[kMaxG][kTile];   // probabilities of the current tile
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  __shared__ int base_s[kMaxG];
  __shared__ float sk_s, sv_s;         // dequant scales of the current page

  const int row = blockIdx.x;          // b * hkv + h
  const int b = row / hkv;
  const int h = row - b * hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvl = kv_len[b];
  const int nu = n_uniq[row];
  const int n_out = g * d;

  for (int i = tid; i < n_out; i += kThreads)
    qs[i / d][i % d] = to_float(q[static_cast<size_t>(row) * n_out + i]);
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int u = 0; u < nu; ++u) {
    const int page = phys[row * u_cap + u];
    if (tid < g) base_s[tid] = base[(row * g + tid) * u_cap + u];
    if constexpr (kQuantized<P>) {
      if (tid == kThreads - 1) {
        sk_s = scales_k[page * hkv + h];
        sv_s = scales_v[page * hkv + h];
      }
    }
    __syncthreads();
    float sk = 1.f, sv = 1.f;
    if constexpr (kQuantized<P>) {
      sk = sk_s;
      sv = sv_s;
    }
    // tokens of this page that any head of the group may still see
    int limit = 0;
    for (int gg = 0; gg < g; ++gg)
      limit = max(limit, min(ps, kvl - base_s[gg]));
    for (int t0 = 0; t0 < limit; t0 += kTile) {
      const int rows = min(kTile, limit - t0);
      load_tile(pk, page, t0, rows, ps, hkv, h, d, sk, ks);
      load_tile(pv, page, t0, rows, ps, hkv, h, d, sv, vs);
      __syncthreads();
      // online softmax over this tile: warp w owns heads w, w + kWarps, ...
      for (int gg = warp; gg < g; gg += kWarps) {
        const bool valid = lane < rows && base_s[gg] + t0 + lane < kvl;
        float s = kNegInf;
        if (valid) {
          float dot = 0.f;
          for (int k = 0; k < d; ++k) dot += qs[gg][k] * ks[lane][k];
          s = dot * scale;
        }
        const float m_old = m_s[gg];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float m_safe = fmaxf(m_new, kNegInf / 2);  // all-masked guard
        const float p = valid ? expf(s - m_safe) : 0.f;
        const float sum = warp_sum(p);
        pr[gg][lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_old - m_safe);
          alpha_s[gg] = alpha;
          m_s[gg] = m_new;
          l_s[gg] = l_s[gg] * alpha + sum;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int e = tid + j * kThreads;
        if (e < n_out) {
          const int gg = e / d;
          const int dd = e - gg * d;
          float a = acc[j] * alpha_s[gg];
          for (int t = 0; t < rows; ++t) a += pr[gg][t] * vs[t][dd];
          acc[j] = a;
        }
      }
      __syncthreads();
    }
    __syncthreads();   // base_s and the scales are rewritten by the next page
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int e = tid + j * kThreads;
    if (e < n_out) {
      const float l = l_s[e / d];
      store(out + static_cast<size_t>(row) * n_out + e,
            acc[j] / (l > 0.f ? l : 1.f));
    }
  }
}

template <typename T, typename P>
cudaError_t launch_decode(const void* q, const void* pages_k,
                          const void* pages_v, const void* scales_k,
                          const void* scales_v, const int32_t* phys,
                          const int32_t* base, const int32_t* n_uniq,
                          const int32_t* kv_len, void* out, int rows, int hkv,
                          int g, int u_cap, int ps, int d, float scale,
                          cudaStream_t s) {
  moba_paged_decode_kernel<T, P><<<rows, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const P*>(pages_k),
      static_cast<const P*>(pages_v), static_cast<const float*>(scales_k),
      static_cast<const float*>(scales_v), phys, base, n_uniq, kv_len,
      static_cast<T*>(out), hkv, g, u_cap, ps, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_payload(int payload, const void* q, const void* pk,
                             const void* pv, const void* sk, const void* sv,
                             const int32_t* ph, const int32_t* bs,
                             const int32_t* nu, const int32_t* kl, void* out,
                             int rows, int hkv, int g, int u_cap, int ps,
                             int d, float scale, cudaStream_t s) {
  if (payload == 2)
    return launch_decode<T, int8_t>(q, pk, pv, sk, sv, ph, bs, nu, kl, out,
                                    rows, hkv, g, u_cap, ps, d, scale, s);
  if (payload == 3)
    return launch_decode<T, __nv_fp8_e4m3>(q, pk, pv, sk, sv, ph, bs, nu, kl,
                                           out, rows, hkv, g, u_cap, ps, d,
                                           scale, s);
  return launch_decode<T, T>(q, pk, pv, sk, sv, ph, bs, nu, kl, out, rows,
                             hkv, g, u_cap, ps, d, scale, s);
}

}  // namespace

// dtype: q and out, 0 = float32, 1 = bfloat16.  payload: the pools, 0 or 1
// as dtype (and equal to it, with null scales), 2 = int8, 3 = fp8 e4m3 (both
// with non-null scales).
extern "C" int moba_paged_decode(const void* q, const void* pages_k,
                                 const void* pages_v, const void* scales_k,
                                 const void* scales_v, const void* phys,
                                 const void* base, const void* n_uniq,
                                 const void* kv_len, void* out, int rows,
                                 int hkv, int g, int u_cap, int ps, int d,
                                 float scale, int dtype, int payload,
                                 void* stream) {
  const bool quant = payload == 2 || payload == 3;
  const bool has_scales = scales_k != nullptr && scales_v != nullptr;
  const bool no_scales = scales_k == nullptr && scales_v == nullptr;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (quant ? !has_scales : (payload != dtype || !no_scales))
    return cudaErrorInvalidValue;
  if (rows < 1 || g < 1 || g > kMaxG || d < 16 || d > kMaxD || d % 16 != 0 ||
      ps < 16 || ps % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ph = static_cast<const int32_t*>(phys);
  const auto* bs = static_cast<const int32_t*>(base);
  const auto* nu = static_cast<const int32_t*>(n_uniq);
  const auto* kl = static_cast<const int32_t*>(kv_len);
  const cudaError_t err =
      dtype == 0
          ? dispatch_payload<float>(payload, q, pages_k, pages_v, scales_k,
                                    scales_v, ph, bs, nu, kl, out, rows, hkv,
                                    g, u_cap, ps, d, scale, s)
          : dispatch_payload<__nv_bfloat16>(payload, q, pages_k, pages_v,
                                            scales_k, scales_v, ph, bs, nu,
                                            kl, out, rows, hkv, g, u_cap, ps,
                                            d, scale, s);
  return static_cast<int>(err);
}
