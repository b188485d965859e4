// Kernel 6: paged decode attention with partial outputs.
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention/decode_attention.py:
// paged_decode_attention (_decode_kernel): one decode query per sequence
// over the KV pages its page table names, returning the un-normalised
// flash-decoding partials (acc, m, l) that ops.merge_partials combines
// across page owners. GQA: the G = H / KH query heads of a kv head share
// its K/V rows.
//
// The TPU grid stepped over one page per step and carried (m, l, acc) in
// VMEM scratch. Here one block owns one (sequence, kv head) and walks the
// sequence's page-table slots itself, as a run of logical tokens (slot,
// offset) cut into tiles of 64. For each tile the block first decides
// which tokens are valid: a slot with page id -1 (or an id past the
// pool), or whose page_pos is at or past the length, is skipped, and so
// is every token at or past the length. A tile without a valid token is
// skipped whole and nothing of it is read (the JAX kernel reads page 0
// for an invalid slot and masks it). The valid K and V rows are staged in
// shared memory as f32 with 16-byte loads, then the G x 64 scores, the
// online-softmax update of (m, l) and acc += p.V run from shared memory.
// A sequence without a valid slot returns m = -1e30, l = 0, acc = 0, as
// the JAX kernel and paged_decode_ref do.
//
// Mixed types: the wrapper converts q to f32 (B x H x D values); the
// kernel is templated over the page type (f32 on the server, bf16 as
// well), and all arithmetic is f32.
//
// Bound on an H100 SXM: bytes. Each valid token's K and V rows are read
// once (2 x D x 4 bytes per kv head for f32 pages), against about 4 x D
// floating-point operations per query head; at the main path's decode
// batch (64 sequences x 2048 tokens x 16 kv heads x 64, f32 pages) that
// is 1.07 GB, about 0.32 ms at 3.35 TB/s. The design keeps every page
// byte read exactly once per (sequence, kv head) and issues each tile's
// row loads before any of its arithmetic, so many 16-byte loads are in
// flight per block; each block holds about 36 KB of shared memory, so
// several blocks share an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 128;
constexpr int kTile = 64;  // logical tokens per shared-memory tile
constexpr int kPad = 4;    // f32 row padding: conflict-free row reads

// f32 words of shared memory before the row offsets, rounded up to an
// even count so that the int64 offsets are 8-byte aligned
__host__ __device__ __forceinline__ int smem_floats(int group, int d) {
  const int n = 2 * kTile * (d + kPad) + 2 * group * d + group * kTile +
                3 * group;
  return (n + 1) & ~1;
}

// 16 bytes of page data -> f32 in shared memory
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ page_pos, const int32_t* __restrict__ lengths,
    int64_t num_pages, int heads, int kv_heads, int slots, int page_size,
    float scale, float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out) {
  constexpr int kRow = D + kPad;
  constexpr int kVec = 16 / sizeof(T);  // page elements per 16-byte load
  extern __shared__ float4 smem4[];
  const int group = heads / kv_heads;
  float* const k_s = reinterpret_cast<float*>(smem4);  // [kTile][kRow]
  float* const v_s = k_s + kTile * kRow;               // [kTile][kRow]
  float* const q_s = v_s + kTile * kRow;               // [G][D]
  float* const acc_s = q_s + group * D;                // [G][D]
  float* const s_s = acc_s + group * D;                // [G][kTile]
  float* const m_s = s_s + group * kTile;              // [G]
  float* const l_s = m_s + group;                      // [G]
  float* const alpha_s = l_s + group;                  // [G]
  // element offset of each tile token's row in the pages, -1 if invalid
  int64_t* const row_s =
      reinterpret_cast<int64_t*>(k_s + smem_floats(group, D));

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int32_t len = lengths[b];
  const int64_t h0 = static_cast<int64_t>(b) * heads + kh * group;

  for (int i = tid; i < group * D; i += kThreads) {
    q_s[i] = q[h0 * D + i];
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int64_t ntok = static_cast<int64_t>(slots) * page_size;
  for (int64_t t0 = 0; t0 < ntok; t0 += kTile) {
    int valid = 0;
    if (tid < kTile) {
      const int64_t t = t0 + tid;
      int64_t row = -1;
      if (t < ntok) {
        const int slot = static_cast<int>(t / page_size);
        const int off = static_cast<int>(t % page_size);
        const int32_t pid = page_table[static_cast<int64_t>(b) * slots + slot];
        const int32_t base = page_pos[static_cast<int64_t>(b) * slots + slot];
        if (pid >= 0 && pid < num_pages && base < len && base + off < len)
          row = ((static_cast<int64_t>(pid) * page_size + off) * kv_heads +
                 kh) * D;
      }
      row_s[tid] = row;
      valid = row >= 0;
    }
    // block-uniform: a tile with no valid token reads nothing
    if (!__syncthreads_or(valid)) continue;

    for (int i = tid; i < kTile * (D / kVec); i += kThreads) {
      const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec;
      const int64_t row = row_s[r];
      float* kd = k_s + r * kRow + c;
      float* vd = v_s + r * kRow + c;
      if (row >= 0) {
        load16(k_pages + row + c, kd);
        load16(v_pages + row + c, vd);
      } else {
        // zeros, so that p = 0 times the row stays 0
        for (int j = 0; j < kVec; ++j) kd[j] = vd[j] = 0.f;
      }
    }
    __syncthreads();

    for (int i = tid; i < group * kTile; i += kThreads) {
      const int g = i / kTile, r = i % kTile;
      float s = kNegInf;
      if (row_s[r] >= 0) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + g * D);
        const float4* kv = reinterpret_cast<const float4*>(k_s + r * kRow);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 a = qv[c], x = kv[c];
          dot += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
        }
        s = dot * scale;
      }
      s_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < group; g += kThreads / 32) {
      float* s_row = s_s + g * kTile;
      float mx = kNegInf;
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, s_row[r]);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        const float p = row_s[r] >= 0 ? expf(s_row[r] - m_new) : 0.f;
        s_row[r] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* p = s_s + g * kTile;
      float a = acc_s[i] * alpha_s[g];
#pragma unroll 8
      for (int r = 0; r < kTile; ++r) a += p[r] * v_s[r * kRow + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * D; i += kThreads) acc_out[h0 * D + i] = acc_s[i];
  for (int g = tid; g < group; g += kThreads) {
    m_out[h0 + g] = m_s[g];
    l_out[h0 + g] = l_s[g];
  }
}

size_t smem_bytes(int group, int d) {
  return smem_floats(group, d) * sizeof(float) + kTile * sizeof(int64_t);
}

template <typename T, int D>
cudaError_t launch(const float* q, const void* k_pages, const void* v_pages,
                   const int32_t* page_table, const int32_t* page_pos,
                   const int32_t* lengths, int64_t batch, int64_t heads,
                   int64_t kv_heads, int64_t num_pages, int64_t page_size,
                   int64_t slots, float scale, float* acc, float* m, float* l,
                   cudaStream_t stream) {
  const int group = static_cast<int>(heads / kv_heads);
  const size_t smem = smem_bytes(group, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(kv_heads),
                  static_cast<unsigned>(batch));
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      page_table, page_pos, lengths, num_pages, static_cast<int>(heads),
      static_cast<int>(kv_heads), static_cast<int>(slots),
      static_cast<int>(page_size), scale, acc, m, l);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int64_t d, const float* q, const void* k_pages,
                       const void* v_pages, const int32_t* page_table,
                       const int32_t* page_pos, const int32_t* lengths,
                       int64_t batch, int64_t heads, int64_t kv_heads,
                       int64_t num_pages, int64_t page_size, int64_t slots,
                       float scale, float* acc, float* m, float* l,
                       cudaStream_t stream) {
#define DINOMO_DECODE_CASE(DIM)                                              \
  case DIM:                                                                  \
    return launch<T, DIM>(q, k_pages, v_pages, page_table, page_pos,         \
                          lengths, batch, heads, kv_heads, num_pages,        \
                          page_size, slots, scale, acc, m, l, stream);
  switch (d) {
    DINOMO_DECODE_CASE(16)
    DINOMO_DECODE_CASE(32)
    DINOMO_DECODE_CASE(64)
    DINOMO_DECODE_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DINOMO_DECODE_CASE
}

}  // namespace

// dtype 0: float32 pages, 1: bfloat16 pages. q is f32 (B, H, D); pages
// (NP, PS, KH, D); page_table, page_pos (B, P) and lengths (B,) int32;
// acc (B, H, D), m and l (B, H) f32. Every tensor is contiguous.
extern "C" int paged_decode_attention_launch(
    int64_t dtype, const float* q, const void* k_pages, const void* v_pages,
    const int32_t* page_table, const int32_t* page_pos,
    const int32_t* lengths, int64_t batch, int64_t heads, int64_t kv_heads,
    int64_t num_pages, int64_t page_size, int64_t slots, int64_t d,
    float scale, float* acc, float* m, float* l, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads || page_size <= 0 || slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k_pages, v_pages, page_table, page_pos,
                            lengths, batch, heads, kv_heads, num_pages,
                            page_size, slots, scale, acc, m, l, stream);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k_pages, v_pages, page_table,
                                    page_pos, lengths, batch, heads, kv_heads,
                                    num_pages, page_size, slots, scale, acc, m,
                                    l, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
