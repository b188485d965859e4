// Kernel 6: paged decode attention with partial outputs.
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention/decode_attention.py:
// paged_decode_attention (_decode_kernel): one decode query per row over
// the KV pages its page table names, returning the un-normalised
// flash-decoding partials (acc, m, l) that ops.merge_partials combines
// across page owners. GQA: the G = H / KH query heads of a kv head share
// its K/V rows.
//
// Bound on an H100 SXM: bytes. Each valid token's K and V rows are read
// once (2 x D x 4 bytes per kv head for f32 pages) against about 4 x D
// floating-point operations per query head. At the server's shape (one
// sequence, three page owners stacked as three rows, 16 kv heads, 120
// valid tokens) that is under 1 MB, 0.3 us at 3.35 TB/s: a launch there
// is latency, the length of the chain of dependent steps, not bytes. At a
// batched decode of 64 sequences x 2048 tokens it is 1.07 GB, 0.32 ms.
//
// The TPU grid stepped over one page per step and carried (m, l, acc) in
// VMEM scratch. Here the work of a row is split across the card
// (flash-decoding split-K):
//
// - A block owns one (row, kv head, group of up to 8 query heads) and one
//   contiguous run of page-table slots; the wrapper picks the number of
//   runs (splits) from the shape, about two waves of the SMs, no run
//   shorter than a 64-token tile, none when the rows already fill the
//   card. The 64 x 2048 shape keeps one block per (row, kv head).
// - Inside a block every group of lanes that spans one K/V row (16 bytes
//   a lane: 16 lanes for an f32 row of 64, 8 for bf16) is a worker that
//   owns every W-th token of the run. It keeps q and its share of acc in
//   registers, issues the 16-byte loads of four tokens' K and V rows
//   before their arithmetic, takes the dot products with __shfl_xor_sync
//   across its lanes, and carries its own online-softmax state (m, l,
//   acc). One shared-memory pass merges the workers at the end.
// - A token is read only if it is valid: a slot with page id -1 (or an
//   id past the pool), or whose page_pos is at or past the length, is
//   skipped, and so is every token at or past the length. A row without
//   a valid token returns m = -1e30, l = 0, acc = 0, as the JAX kernel
//   and paged_decode_ref do.
// - One launch per call: a split writes its partial to a scratch buffer,
//   fences it (__threadfence) and takes a ticket from a per-(row, kv
//   head, head group) counter. The block that draws the last ticket
//   reads every split's partial (through L2) in split order, merges them
//   with the log-sum-exp combine, writes the outputs and resets the
//   counter to 0 for the next launch. The merge order is fixed, so the
//   result does not depend on which block finishes last; a row whose
//   splits are all empty merges to (0, -1e30, 0) exactly (every m is
//   -1e30, so every weight is exp(0) = 1 times l = 0). Launches in
//   flight at once must not share counters: the wrapper keeps one zeroed
//   buffer per stream (launches of one stream run in order).
//
// Mixed types: q is read in its own type (f32 or bf16) through a row
// stride that may be 0 (the stacked owners of one sequence share one q
// row); pages are f32 (the server) or bf16; all arithmetic is f32.
//
// Measured on an H100 SXM at 700 W (chip_smoke.py, PERF.md): 11.7 us a
// launch for the server's three stacked owners (the design before took
// 17.4 us for each owner's own launch), 0.350 ms at 64 x 2048 against
// its 0.321 ms bound (0.500 before).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// 16 bytes of page data -> f32
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T, int D, int GB>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);        // elements a lane
  static constexpr int kLanes = D / kVec;            // lanes a row
  static constexpr int kRowsPerWarp = 32 / kLanes;   // workers a warp
  static constexpr int kWorkers = kWarps * kRowsPerWarp;
  static constexpr int kUnroll = GB <= 2 ? 4 : 2;    // tokens a worker a step
  static_assert(kLanes >= 1 && kLanes <= 32, "row must fit a warp");
};

template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const void* __restrict__ q, int q_bf16, int64_t q_row_stride,
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ page_pos, const int32_t* __restrict__ lengths,
    int64_t num_pages, int heads, int kv_heads, int slots, int page_size,
    float scale, float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ partials,
    int32_t* __restrict__ tickets) {
  using S = Shape<T, D, GB>;
  constexpr int V = S::kVec, LN = S::kLanes, W = S::kWorkers,
                U = S::kUnroll;
  __shared__ float m_s[W][GB], l_s[W][GB];
  __shared__ float acc_s[W][GB][D];
  __shared__ int last_s;

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int group = heads / kv_heads, gcount = group / GB;
  const int kh = blockIdx.y / gcount, gc = blockIdx.y % gcount;
  const int b = blockIdx.z;
  const int h0 = kh * group + gc * GB;  // first query head of the block
  const int tid = threadIdx.x, lane = tid & 31;
  const int worker = (tid >> 5) * S::kRowsPerWarp + lane / LN;
  const int part = lane % LN;  // this lane's 16 bytes of a row
  const int32_t len = lengths[b];

  float qv[GB][V], acc[GB][V], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const int64_t at = b * q_row_stride + (h0 + g) * D + part * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qv[g][e] = q_bf16 ? __bfloat162float(
                              static_cast<const __nv_bfloat16*>(q)[at + e])
                        : static_cast<const float*>(q)[at + e];
      acc[g][e] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int64_t s0 = static_cast<int64_t>(split) * slots / nsplit;
  const int64_t s1 = static_cast<int64_t>(split + 1) * slots / nsplit;
  const int64_t t_end = s1 * page_size;
  const int32_t* table = page_table + static_cast<int64_t>(b) * slots;
  const int32_t* poss = page_pos + static_cast<int64_t>(b) * slots;
  for (int64_t t0 = s0 * page_size; t0 < t_end; t0 += W * U) {
    int64_t row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t0 + u * W + worker;
      row[u] = -1;
      if (t < t_end) {
        const int64_t slot = t / page_size;
        const int off = static_cast<int>(t - slot * page_size);
        const int32_t pid = table[slot];
        const int32_t base = poss[slot];
        if (pid >= 0 && pid < num_pages && base < len && base + off < len)
          row[u] = ((static_cast<int64_t>(pid) * page_size + off) * kv_heads +
                    kh) * D + part * V;
      }
    }
    // every load of the step in flight before any arithmetic
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (row[u] >= 0) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(k_pages + row[u]));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(v_pages + row[u]));
      }
    }
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[V];
      widen(kr[u], kx);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) dot = fmaf(qv[g][e], kx[e], dot);
#pragma unroll
        for (int o = LN / 2; o; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u][g] = row[u] >= 0 ? dot * scale : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[V];
      widen(vr[u], vx);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = expf(s[u][g] - m[g]);  // 0 for an invalid token
        l[g] += p;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
      }
    }
  }

  // merge the block's workers
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc_s[worker][g][part * V + e] = acc[g][e];
    if (part == 0) {
      m_s[worker][g] = m[g];
      l_s[worker][g] = l[g];
    }
  }
  __syncthreads();
  const int64_t out_row = static_cast<int64_t>(b) * heads + h0;
  for (int i = tid; i < GB * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, m_s[w][g]);
    float a = 0.f, sum = 0.f;
    for (int w = 0; w < W; ++w) {
      const float wt = expf(m_s[w][g] - mx);
      a += wt * acc_s[w][g][d];
      sum += wt * l_s[w][g];
    }
    if (nsplit == 1) {
      acc_out[(out_row + g) * D + d] = a;
      if (d == 0) {
        m_out[out_row + g] = mx;
        l_out[out_row + g] = sum;
      }
    } else {
      float* p = partials + ((out_row + g) * nsplit + split) * (D + 2);
      p[d] = a;
      if (d == 0) {
        p[D] = mx;
        p[D + 1] = sum;
      }
    }
  }
  if (nsplit == 1) return;

  // the last split of this (row, kv head, head group) merges them all
  __threadfence();
  __syncthreads();
  const int64_t ticket_id =
      static_cast<int64_t>(b) * gridDim.y + blockIdx.y;
  if (tid == 0)
    last_s = atomicAdd(&tickets[ticket_id], 1) == nsplit - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int i = tid; i < GB * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float* p = partials + (out_row + g) * nsplit * (D + 2);
    float mx = kNegInf;
    for (int sp = 0; sp < nsplit; ++sp)
      mx = fmaxf(mx, __ldcg(p + sp * (D + 2) + D));
    float a = 0.f, sum = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float* ps = p + sp * (D + 2);
      const float wt = expf(__ldcg(ps + D) - mx);
      a += wt * __ldcg(ps + d);
      sum += wt * __ldcg(ps + D + 1);
    }
    acc_out[(out_row + g) * D + d] = a;
    if (d == 0) {
      m_out[out_row + g] = mx;
      l_out[out_row + g] = sum;
    }
  }
  if (tid == 0) tickets[ticket_id] = 0;
}

template <typename T, int D, int GB>
cudaError_t launch(const void* q, int q_bf16, int64_t q_row_stride,
                   const void* k_pages, const void* v_pages,
                   const int32_t* page_table, const int32_t* page_pos,
                   const int32_t* lengths, int64_t batch, int64_t heads,
                   int64_t kv_heads, int64_t num_pages, int64_t page_size,
                   int64_t slots, int64_t nsplit, float scale, float* acc,
                   float* m, float* l, float* partials, int32_t* tickets,
                   cudaStream_t stream) {
  const int64_t gcount = heads / kv_heads / GB;
  const dim3 grid(static_cast<unsigned>(nsplit),
                  static_cast<unsigned>(kv_heads * gcount),
                  static_cast<unsigned>(batch));
  paged_decode_kernel<T, D, GB><<<grid, kThreads, 0, stream>>>(
      q, q_bf16, q_row_stride, static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, page_pos, lengths,
      num_pages, static_cast<int>(heads), static_cast<int>(kv_heads),
      static_cast<int>(slots), static_cast<int>(page_size), scale, acc, m, l,
      partials, tickets);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_gb(int64_t gb, const void* q, int q_bf16,
                        int64_t q_row_stride, const void* k_pages,
                        const void* v_pages, const int32_t* page_table,
                        const int32_t* page_pos, const int32_t* lengths,
                        int64_t batch, int64_t heads, int64_t kv_heads,
                        int64_t num_pages, int64_t page_size, int64_t slots,
                        int64_t nsplit, float scale, float* acc, float* m,
                        float* l, float* partials, int32_t* tickets,
                        cudaStream_t stream) {
#define DINOMO_DECODE_GB(G)                                                  \
  case G:                                                                    \
    return launch<T, D, G>(q, q_bf16, q_row_stride, k_pages, v_pages,        \
                           page_table, page_pos, lengths, batch, heads,      \
                           kv_heads, num_pages, page_size, slots, nsplit,    \
                           scale, acc, m, l, partials, tickets, stream);
  switch (gb) {
    DINOMO_DECODE_GB(1)
    DINOMO_DECODE_GB(2)
    DINOMO_DECODE_GB(4)
    DINOMO_DECODE_GB(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DINOMO_DECODE_GB
}

template <typename T>
cudaError_t dispatch_d(int64_t d, int64_t gb, const void* q, int q_bf16,
                       int64_t q_row_stride, const void* k_pages,
                       const void* v_pages, const int32_t* page_table,
                       const int32_t* page_pos, const int32_t* lengths,
                       int64_t batch, int64_t heads, int64_t kv_heads,
                       int64_t num_pages, int64_t page_size, int64_t slots,
                       int64_t nsplit, float scale, float* acc, float* m,
                       float* l, float* partials, int32_t* tickets,
                       cudaStream_t stream) {
#define DINOMO_DECODE_D(DIM)                                                 \
  case DIM:                                                                  \
    return dispatch_gb<T, DIM>(gb, q, q_bf16, q_row_stride, k_pages,         \
                               v_pages, page_table, page_pos, lengths,       \
                               batch, heads, kv_heads, num_pages, page_size, \
                               slots, nsplit, scale, acc, m, l, partials,    \
                               tickets, stream);
  switch (d) {
    DINOMO_DECODE_D(16)
    DINOMO_DECODE_D(32)
    DINOMO_DECODE_D(64)
    DINOMO_DECODE_D(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DINOMO_DECODE_D
}

}  // namespace

// dtype: the pages' type, q_dtype: q's (0 float32, 1 bfloat16). q is
// (B, H, D) with rows ``q_row_stride`` elements apart (0: one row for
// all); pages (NP, PS, KH, D); page_table, page_pos (B, P) and lengths
// (B,) int32; acc (B, H, D), m and l (B, H) f32. ``head_block`` query
// heads of a kv head share a block (it divides H / KH); ``nsplit`` runs of
// slots split each row, and then ``partials`` holds B x H x nsplit x
// (D + 2) floats and ``tickets`` B x KH x (H / KH / head_block) int32
// zeros, left zero again by the launch.
extern "C" int paged_decode_attention_launch(
    int64_t dtype, int64_t q_dtype, const void* q, int64_t q_row_stride,
    const void* k_pages, const void* v_pages, const int32_t* page_table,
    const int32_t* page_pos, const int32_t* lengths, int64_t batch,
    int64_t heads, int64_t kv_heads, int64_t num_pages, int64_t page_size,
    int64_t slots, int64_t d, int64_t head_block, int64_t nsplit,
    float scale, float* acc, float* m, float* l, float* partials,
    int32_t* tickets, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads || page_size <= 0 || slots < 0 ||
      head_block <= 0 || (heads / kv_heads) % head_block || nsplit <= 0 ||
      nsplit > 65535 || batch > 65535 || (q_dtype != 0 && q_dtype != 1) ||
      (nsplit > 1 && (partials == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_bf16 = static_cast<int>(q_dtype);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, head_block, q, q_bf16, q_row_stride, k_pages,
                            v_pages, page_table, page_pos, lengths, batch,
                            heads, kv_heads, num_pages, page_size, slots,
                            nsplit, scale, acc, m, l, partials, tickets,
                            stream);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(
        d, head_block, q, q_bf16, q_row_stride, k_pages, v_pages, page_table,
        page_pos, lengths, batch, heads, kv_heads, num_pages, page_size,
        slots, nsplit, scale, acc, m, l, partials, tickets, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
