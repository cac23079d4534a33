// Paged MoBA decode for Hopper (sm_90a): routing, page union, tables and a
// split-page attention, all on the card.
//
// Replaces the TPU kernel kernels/moba_decode.py::moba_paged_decode_pallas
// of the JAX package (grouped grid: _decode_grouped / _decode_kernel_grouped;
// the flat grid computes the same function) together with the routing and
// table building its wrapper runs before the pallas_call
// (core/moba.py::moba_paged_route, union_pages).  One query token per
// sequence attends to the pages its heads routed to.
//
// What bounds it on an H100: bytes.  Per (sequence, kv head) it must read
// the centroid rows of the assigned pages once (routing), then K and V of
// the valid tokens of the group's union pages once: about
// sum(n_uniq * ps * d * 2 * sizeof(pool)) over the batch at 3.35 TB/s, at
// ~4 flops per byte, far below the ~295 flops/byte where tensor cores would
// matter.  At moba-340m's decode shapes that is ~17.5 MB from a bf16 pool,
// a bound of ~5.2 us, so the design is about latency and parallelism.
//
// Three kernels, launched back to back by one C call:
//
//  1. moba_decode_route_kernel, one CTA per (sequence, kv head).  It scores
//     every page of the block table for each of the G query heads (fp32 dot
//     of the unscaled q with the page's fp32 centroid; each centroid row is
//     read once and serves all G heads), forces the own page (+1e30), masks
//     pages past kv_len or unassigned (-1e30), and keeps a running top-k in
//     shared memory over chunks of kRouteChunk pages, so npg is unbounded.
//     The lists and the union tables sit in dynamic shared memory sized
//     from G * min(top_k, npg), the slots that can be filled (7 words a
//     slot: 112 KB at G 8, top_k 512), which sets top_k <= kMaxTopK.
//     Each chunk is merged by rank: an entry's new position is the number
//     of entries that beat it (higher score, or equal score and lower page),
//     which keeps lax.top_k's tie order.  Per-head budgets (adaptive
//     routing, the JAX package's head_top_k: an optional (Hkv, G) int32
//     table) cut each head's sorted list: slot j of head (h, g) is kept
//     only if j < budget[h][g], so rank 0, the forced own page, always
//     stays, and a truncated slot is written -1 like an invalid one and
//     never enters the union.  Then the group's union is sorted and
//     compacted by the same rank arithmetic, and the kernel writes
//     exactly what moba_paged_route + decode_tables compute: the selections
//     (-1 = invalid slot), the physical page of each union slot, the
//     per-(head, slot) token base (npg*ps for a head that did not pick the
//     page) and n_uniq.  A smaller budget thus shrinks n_uniq, and with it
//     the attention grid's live CTAs and the K/V bytes read; the tables'
//     widths (plan()'s slot counts) stay the static top_k's.
//  2. moba_decode_attend_kernel, flash-decoding: one CTA per (sequence, kv
//     head, union slot, token chunk), so the card gets ~B*Hkv*n_uniq CTAs
//     instead of B*Hkv.  A CTA past n_uniq exits at once.  It copies its
//     chunk's K and V rows (ps rows of a page at stride Hkv*d in the pool)
//     with 16-byte cp.async into shared memory in the pool's own dtype, V's
//     copies issued before the Q.K math so they overlap it, and only the
//     rows that some head of the group may still see.  Upcast (and a
//     quantized page's scale, applied to the dot and to the partial output)
//     happen in registers.  Q.K: d/8 lanes per token, 8 values a lane,
//     reduced by shuffles; P.V: every thread owns 8 output columns of one
//     head over a stride of tokens, reduced through shared memory.  It
//     writes one online-softmax partial (o, m, l) per (row, slot, head).
//     A chunk that no head may see, and an inactive row (kv_len 0), reads
//     no page and no scale and writes the empty partial (0, -1e30, 0).
//  3. moba_decode_merge_kernel, one CTA per (sequence, kv head): merges the
//     n_uniq * n_chunks partials in slot order and writes the output in q's
//     dtype (zeros where no token was visible, as for kv_len 0).
//
// No tensor cores: with moba-340m's G = 1 (H = Hkv) Q.K is a matrix-vector
// product of one query against ps keys, and a wgmma needs 64 rows; at
// G <= 8 the products stay on the CUDA cores, in fp32.
//
// Quantized pools (int8, or fp8 e4m3 "fn": torch.float8_e4m3fn) carry one
// fp32 scale per (page, kv head), as the TPU kernel's ksc_ref/vsc_ref
// (moba_decode.py:126-127 there).  The scale multiplies the dot product and
// the partial output; padding slots and empty chunks never read one.
//
// C interface (ctypes): one entry point, moba_paged_decode; every pointer
// and the stream are void*; it returns the first cudaGetLastError() of its
// launches (0 = success).
// The wrapper allocates every table and partial; the kernels allocate
// nothing.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxTopK = 512;      // every page of 8K tokens at page 16
constexpr int kRouteChunk = 128;   // pages scored per step of the route
constexpr int kVec = 8;            // values a lane holds in the products
constexpr int kTileBytes = 16384;  // K (and V) bytes one CTA stages at most
constexpr int kMaxChunk = 128;     // tokens one CTA attends at most
constexpr float kNegInf = -1e30f;
constexpr float kPosInf = 1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename P>
constexpr bool kQuantized =
    std::is_same<P, int8_t>::value || std::is_same<P, __nv_fp8_e4m3>::value;

// tokens one attention CTA covers for pool payload P at head dim D (the
// wrapper's plan() computes the same number)
template <typename P, int D>
__host__ __device__ constexpr int chunk_tokens() {
  return kTileBytes / (D * static_cast<int>(sizeof(P))) < kMaxChunk
             ? kTileBytes / (D * static_cast<int>(sizeof(P)))
             : kMaxChunk;
}

// 8 consecutive pool values at a 16-byte (8 for int8/fp8) aligned address
// of shared memory, as fp32
template <typename P>
__device__ __forceinline__ void load8(const unsigned char* p, float (&v)[8]) {
  if constexpr (std::is_same<P, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 16);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (std::is_same<P, __nv_bfloat16>::value) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = static_cast<float>(e[j]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// programmatic dependent launch: a kernel launched with the
// programmatic-serialization attribute may start while the kernel before
// it drains; griddep_wait() blocks until that kernel has finished and its
// writes are visible (a no-op without the attribute), griddep_launch()
// lets the next kernel's CTAs be scheduled.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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
// sum over the kLanes lanes of an aligned lane group
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int load_len(const void* kv_len, int kvl64,
                                        int b) {
  return kvl64 ? static_cast<int>(static_cast<const int64_t*>(kv_len)[b])
               : static_cast<const int32_t*>(kv_len)[b];
}

// entry (s, p) ranks above (t, r): higher score, or equal score and lower
// page (lax.top_k's order)
__device__ __forceinline__ bool beats(float s, int p, float t, int r) {
  return s > t || (s == t && p < r);
}

struct Query {
  const void* q;
  long long sb, sh;  // element strides of q's batch and head dims
};

struct RouteArgs {
  Query q;
  const float* cent;     // (P, Hkv, d) fp32
  const int32_t* table;  // (B, npg)
  const void* kv_len;    // (B,) int32 or int64
  int kvl64;
  const int32_t* budget; // (Hkv, G) per-head top_k, or null (static)
  int32_t* sel;          // (B*Hkv, G, top_k), -1 = invalid slot
  int32_t* phys;         // (B*Hkv, U)
  int32_t* base;         // (B*Hkv, G, U)
  int32_t* n_uniq;       // (B*Hkv,)
  int hkv, g, top_k, npg, ps, num_pages;
};

// ---------------------------------------------------------------- route
// Slots a head can fill: min(top_k, npg).  The route's lists and union
// tables live in dynamic shared memory sized from G times that: 7 words a
// slot (route_smem_bytes).
__host__ __device__ inline int live_slots(int top_k, int npg) {
  return top_k < npg ? top_k : npg;
}
inline size_t route_smem_bytes(int g, int top_k, int npg) {
  return sizeof(int) * 7 * static_cast<size_t>(g) * live_slots(top_k, npg);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
moba_decode_route_kernel(RouteArgs a) {
  __shared__ __align__(16) float qs[kMaxG][D];
  __shared__ float cs[kMaxG][kRouteChunk];  // the chunk's masked scores
  const int row = blockIdx.x;
  const int b = row / a.hkv;
  const int h = row - b * a.hkv;
  const int tid = threadIdx.x;
  const int G = a.g, K = a.top_k, npg = a.npg, ps = a.ps;
  const int KE = live_slots(K, npg);        // slots a head can fill
  const int NE = G * KE;
  extern __shared__ int dyn[];
  float* ts = reinterpret_cast<float*>(dyn);  // [2][G][KE] running top-k
  int* ti = dyn + 2 * NE;                   // [2][G][KE] their pages
  int* ids = ti + 2 * NE;                   // [G][KE] head-major selections
  int* first = ids + NE;                    // first occurrence of a page
  int* uni = first + NE;                    // the sorted union
  const int kvl = load_len(a.kv_len, a.kvl64, b);
  const int own = max(kvl - 1, 0) / ps;
  const int32_t* tbl = a.table + static_cast<size_t>(b) * npg;
  const T* qb = static_cast<const T*>(a.q.q) + b * a.q.sb;

  griddep_launch();    // the attention kernel's CTAs may start waiting
  for (int i = tid; i < G * D; i += kThreads) {
    const int gg = i / D;
    const int dd = i - gg * D;
    qs[gg][dd] = to_float(qb[(h * G + gg) * a.q.sh + dd]);
  }
  __syncthreads();

  int cur = 0, filled = 0;
  for (int c0 = 0; c0 < npg; c0 += kRouteChunk) {
    const int cn = min(kRouteChunk, npg - c0);
    // scores of this chunk: one thread per page, its centroid row loaded
    // 64 values at a time with all loads in flight together
    if (tid < cn) {
      const int p = c0 + tid;
      const int entry = tbl[p];
      const bool is_own = p == own;
      const bool valid = static_cast<long long>(p) * ps < kvl && entry >= 0 &&
                         entry < a.num_pages;
      float dot[kMaxG];
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg) dot[gg] = 0.f;
      if (valid && !is_own) {
        const float4* src = reinterpret_cast<const float4*>(
            a.cent + (static_cast<size_t>(entry) * a.hkv + h) * D);
#pragma unroll
        for (int half = 0; half < D / 64; ++half) {
          float4 c[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) c[j] = __ldg(src + half * 16 + j);
#pragma unroll
          for (int gg = 0; gg < kMaxG; ++gg) {
            if (gg < G) {
              const float4* qv =
                  reinterpret_cast<const float4*>(&qs[gg][half * 64]);
              float acc = dot[gg];
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                const float4 w = qv[j];
                acc += w.x * c[j].x;
                acc += w.y * c[j].y;
                acc += w.z * c[j].z;
                acc += w.w * c[j].w;
              }
              dot[gg] = acc;
            }
          }
        }
      }
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg)
        if (gg < G)
          cs[gg][tid] = is_own ? kPosInf : (valid ? dot[gg] : kNegInf);
    }
    __syncthreads();
    // merge the chunk into the running list by rank; the list holds pages
    // below c0, the chunk pages c0.. in order
    const int ncand = filled + cn;
    const int keep = min(K, ncand);
    for (int e = tid; e < G * ncand; e += kThreads) {
      const int gg = e / ncand;
      const int i = e - gg * ncand;
      const float* ls = ts + cur * NE + gg * KE;
      const int* li = ti + cur * NE + gg * KE;
      const float s = i < filled ? ls[i] : cs[gg][i - filled];
      const int p = i < filled ? li[i] : c0 + i - filled;
      int rank = 0;
      for (int j = 0; j < filled; ++j) rank += beats(ls[j], li[j], s, p);
      for (int j = 0; j < cn; ++j) rank += beats(cs[gg][j], c0 + j, s, p);
      if (rank < keep) {
        ts[(cur ^ 1) * NE + gg * KE + rank] = s;
        ti[(cur ^ 1) * NE + gg * KE + rank] = p;
      }
    }
    __syncthreads();
    cur ^= 1;
    filled = keep;
  }

  // selections: slots past the table, past the head's budget or scoring
  // <= -5e29 are invalid
  const int nsel = G * K;
  int32_t* sel = a.sel + static_cast<size_t>(row) * nsel;
  const int32_t* budget = a.budget ? a.budget + h * G : nullptr;
  for (int e = tid; e < nsel; e += kThreads) {
    const int gg = e / K;
    const int j = e - gg * K;
    const int x = cur * NE + gg * KE + j;
    const int kept = budget ? min(filled, budget[gg]) : filled;
    const int id = (j < kept && ts[x] > kNegInf / 2) ? ti[x] : -1;
    if (j < KE) ids[gg * KE + j] = id;
    sel[e] = id;
  }
  __syncthreads();
  // the union: a page's first occurrence counts; its slot is the number of
  // distinct pages below it
  for (int e = tid; e < NE; e += kThreads) {
    const int id = ids[e];
    int f = id >= 0;
    for (int j = 0; j < e && f; ++j) f = ids[j] != id;
    first[e] = f;
    uni[e] = 0;
  }
  int nu = 0;
  for (int e0 = 0; e0 < NE; e0 += kThreads) {
    __syncthreads();
    const int e = e0 + tid;
    nu += __syncthreads_count(e < NE && first[e]);
  }
  const int U = nsel;                       // the tables' width, G * top_k
  int32_t* base = a.base + static_cast<size_t>(row) * G * U;
  const int sentinel = npg * ps;
  for (int i = tid; i < G * U; i += kThreads) base[i] = sentinel;
  __syncthreads();
  for (int e = tid; e < NE; e += kThreads) {
    const int id = ids[e];
    if (id < 0) continue;
    int slot = 0;
    for (int j = 0; j < NE; ++j) slot += first[j] && ids[j] < id;
    if (first[e]) uni[slot] = id;
    base[(e / KE) * U + slot] = id * ps;
  }
  __syncthreads();
  int32_t* phys = a.phys + static_cast<size_t>(row) * U;
  for (int u = tid; u < U; u += kThreads) {
    const int entry = tbl[u < NE ? uni[u] : 0];
    phys[u] = min(max(entry, 0), a.num_pages - 1);
  }
  if (tid == 0) a.n_uniq[row] = nu;
}

// ---------------------------------------------------------------- attend
struct AttendArgs {
  Query q;
  const void* pk;
  const void* pv;
  const float* sk;  // (P, Hkv) for a quantized pool, else null
  const float* sv;
  const void* kv_len;
  int kvl64;
  const int32_t* phys;
  const int32_t* base;
  const int32_t* n_uniq;
  float* o_part;    // (B*Hkv, slots, G, d)
  float* ml_part;   // (B*Hkv, slots, G, 2)
  int hkv, g, u_cap, ps, chunk, n_chunks, slots;
  float scale;
};

template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
moba_decode_attend_kernel(AttendArgs a) {
  constexpr int kChunk = chunk_tokens<P, D>();
  constexpr int kRowBytes = D * static_cast<int>(sizeof(P));
  constexpr int kStride = kRowBytes + 16;    // padded: no bank conflicts
  constexpr int kPieces = kRowBytes / 16;    // 16-byte copies per row
  constexpr int kLanes = D / kVec;           // lanes per token in Q.K
  constexpr int kPerWarp = 32 / kLanes;
  constexpr int kCols = D / kVec;            // 8-column units in P.V
  __shared__ __align__(16) unsigned char ks[kChunk * kStride];
  __shared__ __align__(16) unsigned char vs[kChunk * kStride];
  __shared__ float qs[kMaxG][D];
  __shared__ float pr[kMaxG][kChunk];
  static_assert(kChunk * kStride >= kThreads * kVec * 4,
                "the P.V reduction reuses the K tile");

  const int row = blockIdx.y;
  const int x = blockIdx.x;
  const int u = x / a.n_chunks;
  const int c = x - u * a.n_chunks;
  const int b = row / a.hkv;
  const int h = row - b * a.hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.g;
  const int kvl = load_len(a.kv_len, a.kvl64, b);
  const T* qb = static_cast<const T*>(a.q.q) + b * a.q.sb;
  for (int i = tid; i < G * D; i += kThreads) {
    const int gg = i / D;
    const int dd = i - gg * D;
    qs[gg][dd] = to_float(qb[(h * G + gg) * a.q.sh + dd]);
  }
  griddep_wait();      // the route's tables are complete
  griddep_launch();    // the merge kernel's CTAs may start waiting
  // every table read of this CTA at once: n_uniq, the page, the bases
  const int nu = a.n_uniq[row];
  const int page = a.phys[row * a.u_cap + u];
  int bg[kMaxG];
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg)
    bg[gg] = gg < G ? a.base[(row * G + gg) * a.u_cap + u] : 0;
  if (u >= nu) return;                       // padding slot: nothing to do
  const int t0 = c * a.chunk;
  int limit = 0;                             // tokens of the page in view
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg)
    if (gg < G) limit = max(limit, kvl - bg[gg]);
  const int rows = max(0, min(min(a.chunk, a.ps - t0), limit - t0));
  const size_t pidx = (static_cast<size_t>(row) * a.slots + x) * G;
  float* o_out = a.o_part + pidx * D;
  float* ml_out = a.ml_part + pidx * 2;
  if (rows == 0) {                           // no page, no scale read
    for (int i = tid; i < G * D; i += kThreads) o_out[i] = 0.f;
    if (tid < G) {
      ml_out[2 * tid] = kNegInf;
      ml_out[2 * tid + 1] = 0.f;
    }
    return;
  }
  const size_t row0 =
      (static_cast<size_t>(page) * a.ps + t0) * a.hkv + h;  // pool row
  const size_t pitch = static_cast<size_t>(a.hkv) * kRowBytes;
  const unsigned char* gk =
      static_cast<const unsigned char*>(a.pk) + row0 * kRowBytes;
  const unsigned char* gv =
      static_cast<const unsigned char*>(a.pv) + row0 * kRowBytes;
  for (int i = tid; i < rows * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int o = (i - r * kPieces) * 16;
    cp_async16(ks + r * kStride + o, gk + r * pitch + o);
  }
  cp_async_commit();
  for (int i = tid; i < rows * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int o = (i - r * kPieces) * 16;
    cp_async16(vs + r * kStride + o, gv + r * pitch + o);
  }
  cp_async_commit();

  float sk = 1.f, sv = 1.f;
  if constexpr (kQuantized<P>) {
    sk = __ldg(a.sk + static_cast<size_t>(page) * a.hkv + h);
    sv = __ldg(a.sv + static_cast<size_t>(page) * a.hkv + h);
  }
  const float qk_scale = sk * a.scale;
  cp_async_wait<1>();                        // K has landed
  __syncthreads();

  // Q.K: kLanes lanes per token, kPerWarp tokens per warp step
  const int sub = lane / kLanes;
  const int part = lane - sub * kLanes;
  for (int r0 = warp * kPerWarp; r0 < rows; r0 += kWarps * kPerWarp) {
    const int r = r0 + sub;
    float kf[kVec];
    if (r < rows) {
      load8<P>(ks + r * kStride + part * kVec * sizeof(P), kf);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) kf[j] = 0.f;
    }
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg) {
      if (gg < G) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) dot += qs[gg][part * kVec + j] * kf[j];
        dot = group_sum<kLanes>(dot);
        if (r < rows && part == 0)
          pr[gg][r] = bg[gg] + t0 + r < kvl ? dot * qk_scale : kNegInf;
      }
    }
  }
  __syncthreads();
  // softmax of this chunk: warp w owns heads w, w + 4
  for (int gg = warp; gg < G; gg += kWarps) {
    float m = kNegInf;
    for (int r = lane; r < rows; r += 32) m = fmaxf(m, pr[gg][r]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float s = pr[gg][r];
      const float p = s > kNegInf / 2 ? expf(s - m) : 0.f;
      pr[gg][r] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml_out[2 * gg] = m;
      ml_out[2 * gg + 1] = l;
    }
  }
  cp_async_wait<0>();                        // V has landed
  __syncthreads();

  // P.V: thread (token group, head, 8 columns), tokens strided by groups
  const int units = G * kCols;
  const int groups = kThreads / units;
  const int tg = tid / units;
  const int e = tid - tg * units;
  const int gg = e / kCols;
  const int cu = e - gg * kCols;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  if (tg < groups) {
    for (int r = tg; r < rows; r += groups) {
      const float p = pr[gg][r];
      float vf[kVec];
      load8<P>(vs + r * kStride + cu * kVec * sizeof(P), vf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] += p * vf[j];
    }
  }
  float* red = reinterpret_cast<float*>(ks);  // K is no longer read
  if (tg < groups) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[(tg * units + e) * kVec + j] = acc[j];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int hh = i / D;
    const int dd = i - hh * D;
    const int eu = hh * kCols + dd / kVec;
    const int j = dd % kVec;
    float s = 0.f;
    for (int t = 0; t < groups; ++t) s += red[(t * units + eu) * kVec + j];
    o_out[i] = s * sv;
  }
}

// ---------------------------------------------------------------- merge
template <typename T>
__global__ void __launch_bounds__(kThreads)
moba_decode_merge_kernel(const float* __restrict__ o_part,
                         const float* __restrict__ ml_part,
                         const int32_t* __restrict__ n_uniq,
                         T* __restrict__ out, int g, int d, int slots,
                         int n_chunks) {
  griddep_wait();      // every partial is written
  const int row = blockIdx.x;
  const int n = n_uniq[row] * n_chunks;
  const size_t row_base = static_cast<size_t>(row) * slots * g;
  for (int i = threadIdx.x; i < g * d; i += kThreads) {
    const int gg = i / d;
    const int dd = i - gg * d;
    float m = kNegInf;
    for (int j = 0; j < n; ++j)
      m = fmaxf(m, ml_part[(row_base + static_cast<size_t>(j) * g + gg) * 2]);
    float l = 0.f, acc = 0.f;
    for (int j = 0; j < n; ++j) {
      const size_t p = row_base + static_cast<size_t>(j) * g + gg;
      const float lj = ml_part[2 * p + 1];
      if (lj > 0.f) {
        const float w = expf(ml_part[2 * p] - m);
        l += w * lj;
        acc += w * o_part[p * d + dd];
      }
    }
    store(out + static_cast<size_t>(row) * g * d + i, l > 0.f ? acc / l : 0.f);
  }
}

// ---------------------------------------------------------------- host
template <typename T, int D>
cudaError_t launch_route(const RouteArgs& a, int rows, cudaStream_t s) {
  const size_t smem = route_smem_bytes(a.g, a.top_k, a.npg);
  auto kernel = moba_decode_route_kernel<T, D>;
  // always: the kernel's static arrays (qs, cs: 6-8 KB) count against the
  // 48 KB a block gets without the request
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<rows, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t route_dtype(const RouteArgs& a, int rows, int d,
                        cudaStream_t s) {
  return d == 64 ? launch_route<T, 64>(a, rows, s)
                 : launch_route<T, 128>(a, rows, s);
}

cudaError_t route(const RouteArgs& a, int rows, int d, int dtype,
                  cudaStream_t s) {
  return dtype == 0 ? route_dtype<float>(a, rows, d, s)
                    : route_dtype<__nv_bfloat16>(a, rows, d, s);
}

// a launch that may overlap the tail of the kernel before it (see
// griddep_wait)
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch_attend(const AttendArgs& a, int rows, cudaStream_t s) {
  if (a.chunk > chunk_tokens<P, D>()) return cudaErrorInvalidValue;
  return launch_dependent(moba_decode_attend_kernel<T, P, D>,
                          dim3(a.slots, rows), s, a);
}

template <typename T, typename P>
cudaError_t attend_dim(const AttendArgs& a, int rows, int d,
                       cudaStream_t s) {
  return d == 64 ? launch_attend<T, P, 64>(a, rows, s)
                 : launch_attend<T, P, 128>(a, rows, s);
}

template <typename T>
cudaError_t attend_payload(const AttendArgs& a, int rows, int d, int payload,
                           cudaStream_t s) {
  if (payload == 2) return attend_dim<T, int8_t>(a, rows, d, s);
  if (payload == 3) return attend_dim<T, __nv_fp8_e4m3>(a, rows, d, s);
  return attend_dim<T, T>(a, rows, d, s);
}

bool shapes_ok(int rows, int hkv, int g, int top_k, int npg, int ps, int d,
               int num_pages) {
  return rows >= 1 && rows <= 65535 && hkv >= 1 && rows % hkv == 0 &&
         g >= 1 && g <= kMaxG && top_k >= 1 && top_k <= kMaxTopK &&
         npg >= 1 && ps >= 16 && ps <= 256 && ps % 16 == 0 &&
         (d == 64 || d == 128) && num_pages >= 1;
}

}  // namespace

// The whole decode: route, attend, merge, back to back on the stream.
// dtype: q and out, 0 = float32, 1 = bfloat16; q_sb / q_sh are q's element
// strides over batch and heads (its last dim is contiguous).
// payload: the pools, 0 or 1 as dtype (and equal to it, with null scales),
// 2 = int8, 3 = fp8 e4m3 (both with non-null scales).  head_top_k: null
// (static top_k) or a contiguous (Hkv, G) int32 table of per-head budgets
// on the card, read by the route kernel only.  chunk, n_chunks and
// slots (= min(G*top_k, npg) * n_chunks) come from the wrapper's plan; out
// is a contiguous (B, H, 1, d) tensor of q's dtype.
extern "C" int moba_paged_decode(
    const void* q, long long q_sb, long long q_sh, const void* pages_k,
    const void* pages_v, const void* scales_k, const void* scales_v,
    const void* centroids, const void* block_table, const void* kv_len,
    int kvl64, const void* head_top_k, void* sel, void* phys, void* base,
    void* n_uniq, void* o_part, void* ml_part, void* out, int rows, int hkv,
    int g, int top_k, int npg, int ps, int d, int num_pages, int chunk,
    int n_chunks, int slots, float scale, int dtype, int payload,
    void* stream) {
  const bool quant = payload == 2 || payload == 3;
  const bool has_scales = scales_k != nullptr && scales_v != nullptr;
  const bool no_scales = scales_k == nullptr && scales_v == nullptr;
  if (!shapes_ok(rows, hkv, g, top_k, npg, ps, d, num_pages) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (quant ? !has_scales : (payload != dtype || !no_scales))
    return cudaErrorInvalidValue;
  const int u_cap = g * top_k;
  const int u_grid = u_cap < npg ? u_cap : npg;
  if (chunk < 16 || chunk % 16 != 0 || n_chunks * chunk < ps ||
      slots < 1 || slots > u_grid * n_chunks || slots % n_chunks != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RouteArgs ra{{q, q_sb, q_sh},
                     static_cast<const float*>(centroids),
                     static_cast<const int32_t*>(block_table),
                     kv_len, kvl64,
                     static_cast<const int32_t*>(head_top_k),
                     static_cast<int32_t*>(sel), static_cast<int32_t*>(phys),
                     static_cast<int32_t*>(base),
                     static_cast<int32_t*>(n_uniq),
                     hkv, g, top_k, npg, ps, num_pages};
  cudaError_t err = route(ra, rows, d, dtype, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const AttendArgs aa{{q, q_sb, q_sh},
                      pages_k, pages_v,
                      static_cast<const float*>(scales_k),
                      static_cast<const float*>(scales_v),
                      kv_len, kvl64,
                      static_cast<const int32_t*>(phys),
                      static_cast<const int32_t*>(base),
                      static_cast<const int32_t*>(n_uniq),
                      static_cast<float*>(o_part),
                      static_cast<float*>(ml_part),
                      hkv, g, u_cap, ps, chunk, n_chunks, slots, scale};
  err = dtype == 0 ? attend_payload<float>(aa, rows, d, payload, s)
                   : attend_payload<__nv_bfloat16>(aa, rows, d, payload, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* op = static_cast<const float*>(o_part);
  const auto* mp = static_cast<const float*>(ml_part);
  const auto* nu = static_cast<const int32_t*>(n_uniq);
  err = dtype == 0
            ? launch_dependent(moba_decode_merge_kernel<float>, dim3(rows), s,
                               op, mp, nu, static_cast<float*>(out), g, d,
                               slots, n_chunks)
            : launch_dependent(moba_decode_merge_kernel<__nv_bfloat16>,
                               dim3(rows), s, op, mp, nu,
                               static_cast<__nv_bfloat16*>(out), g, d, slots,
                               n_chunks);
  return static_cast<int>(err);
}
