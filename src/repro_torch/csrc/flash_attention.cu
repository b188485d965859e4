// Kernel 5: prefill attention.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// (_attn_kernel): multi-head / grouped-query attention with an online
// softmax in f32, the causal mask of the TPU kernel (top-left: query i
// sees keys 0..i, `qpos >= kpos`) and its causal block skip. Query head h
// reads kv head h / group, so no K/V copy is made for GQA.
//
// The TPU grid's sequential kv axis, which carried (m, l, acc) in VMEM
// scratch from one grid step to the next, becomes a loop inside the
// block, with the online-softmax state in registers and tiles of keys
// and values in shared memory. Under the causal mask the tiles past the
// block's last query are never loaded, and the blocks of the latest
// queries, which do the most work, are scheduled first.
//
// Bound on an H100 SXM: operations. At the main path's shapes (4 x 16
// heads x 2048 x 64, bf16, causal) the scores and P.V take
// 2*B*H*D*S*(S+1) floating-point operations, about 34 GFLOP, against
// 67 MB of q, k, v and out. Two kernels, chosen by the input type:
//
// - bf16 (the model's type): the products run on the tensor cores with
//   mma.sync m16n8k16 (bf16 in, f32 accumulate). A block is 4 warps x 16
//   query rows; S = Q.K^T stays in registers as f32, the online softmax
//   works on it there, and P is packed from those registers straight into
//   the A operand of P.V. P is rounded to bf16 for that product, where
//   the TPU kernel keeps it in f32: the output moves by about 2^-9 of its
//   size, inside the 2.5e-2 that bf16 outputs are held to (the row sums l
//   use the f32 p). K is staged row-major and V transposed in shared
//   memory, rows padded so that the fragment reads hit distinct banks.
// - f32 (the tests' sweep): one thread per query row, f32 FMAs on the
//   CUDA cores (67 TFLOP/s), the exact arithmetic of the TPU kernel up to
//   the order of sums.
//
// Inputs keep their caller's layout: q, k, v and out are read and
// written through (batch, head, position) strides, with the head
// dimension contiguous, so the model layout (B, S, H, D) needs no
// transposed copy. The bf16 kernel reads rows as 16-byte vectors: its
// wrapper requires 16-byte aligned rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
// the f32 kernel: one thread per query row
constexpr int kBQ = 128;           // queries per block
constexpr int kBK = 32;            // keys per shared-memory tile

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Strides {
  int64_t b, h, s;  // in elements; the head dimension is contiguous
};

template <int D>
__global__ void __launch_bounds__(kBQ)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out,
                           int group, int64_t sq, int64_t sk, Strides qs,
                           Strides ks, Strides vs, Strides os, float scale,
                           bool causal) {
  __shared__ float4 k_tile[kBK][D / 4];
  __shared__ float4 v_tile[kBK][D / 4];
  const int64_t qb = gridDim.x - 1 - blockIdx.x;  // latest queries first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int64_t q0 = qb * kBQ;
  const int64_t qi = q0 + tid;
  const bool live = qi < sq;

  float qr[D];
  float acc[D];
  const float* qp = q + b * qs.b + h * qs.h + (live ? qi : 0) * qs.s;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? qp[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  // causal block skip: a key tile that starts after the block's last
  // query is masked for every row of the block
  const int64_t kend = causal ? imin(sk, q0 + kBQ) : sk;
  for (int64_t k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kBQ) {
      const int r = i / D, c = i % D;
      const int64_t kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < sk) {
        kx = kb[kp * ks.s + c];
        vx = vb[kp * vs.s + c];
      }
      reinterpret_cast<float*>(k_tile[r])[c] = kx;
      reinterpret_cast<float*>(v_tile[r])[c] = vx;
    }
    __syncthreads();
    const int64_t nk = imin(kBK, sk - k0);
    float s[kBK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 kk = k_tile[j][c];
        dot += qr[4 * c] * kk.x + qr[4 * c + 1] * kk.y + qr[4 * c + 2] * kk.z +
               qr[4 * c + 3] * kk.w;
      }
      float sv = dot * scale;
      if (causal && qi < k0 + j) sv = kNegInf;
      s[j] = sv;
      if (j < nk) m_new = fmaxf(m_new, sv);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = j < nk ? expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 vv = v_tile[j][c];
        acc[4 * c] += p * vv.x;
        acc[4 * c + 1] += p * vv.y;
        acc[4 * c + 2] += p * vv.z;
        acc[4 * c + 3] += p * vv.w;
      }
    }
    m = m_new;
  }
  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* op = out + b * os.b + h * os.h + qi * os.s;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
}

// the bf16 kernel: mma.sync tiles
constexpr int kMmaBQ = 64;   // queries per block: 4 warps x 16 rows
constexpr int kMmaBK = 64;   // keys per shared-memory tile
constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K tile [kMmaBK][D] and V^T tile [D][kMmaBK] in shared memory as bf16,
// rows padded by 4 words: the fragment reads below hit 32 distinct banks
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int group,
                               int64_t sq, int64_t sk, Strides qs, Strides ks,
                               Strides vs, Strides os, float scale,
                               bool causal) {
  constexpr int kKRow = D / 2 + 4;        // words per K row
  constexpr int kVRow = kMmaBK / 2 + 4;   // words per V^T row
  __shared__ uint32_t k_s[kMmaBK * kKRow];
  __shared__ uint32_t vt_s[D * kVRow];
  const int64_t qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q0 = qb * kMmaBQ;
  const int64_t r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8

  // Q as A fragments, one per 16 dims
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = r0 + (i & 1) * 8;
        const int col = c * 16 + (i >> 1) * 8 + t * 2;
        qa[c][i] = row < sq ? *reinterpret_cast<const uint32_t*>(
                                  qp + row * qs.s + col)
                            : 0u;
      }
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  const int64_t kend = causal ? imin(sk, q0 + kMmaBQ) : sk;
  for (int64_t k0 = 0; k0 < kend; k0 += kMmaBK) {
    __syncthreads();
    // 16-byte loads: 8 dims of one key per load
    for (int i = tid; i < kMmaBK * (D / 8); i += kMmaThreads) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      const int64_t kp = k0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (kp < sk) {
        kx = *reinterpret_cast<const uint4*>(kb + kp * ks.s + c8);
        vx = *reinterpret_cast<const uint4*>(vb + kp * vs.s + c8);
      }
      *reinterpret_cast<uint4*>(&k_s[r * kKRow + c8 / 2]) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
      __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(vt_s);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c8 + j) * (2 * kVRow) + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x kMmaBK keys
    float s[kMmaBK / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
      const uint32_t* krow = k_s + (n * 8 + g) * kKRow + t;
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        mma_bf16(s[n], qa[c], krow[c * 8], krow[c * 8 + 4]);
    }
    // scale, mask, online softmax (rows r0 and r0 + 8)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t key = k0 + n * 8 + t * 2 + (i & 1);
        const int64_t row = r0 + (i >> 1) * 8;
        float x = s[n][i] * scale;
        if (causal && row < key) x = kNegInf;
        if (key >= sk) x = -INFINITY;       // past the keys: p = 0
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
    // P = exp(S - m), rounded to bf16 as the A operand of P.V
    uint32_t pa[kMmaBK / 16][4];
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = expf(s[n][i] - m[i >> 1]);
        l[i >> 1] += p[i];
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // O += P V
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t* vrow = vt_s + (n * 8 + g) * kVRow + t;
#pragma unroll
      for (int c = 0; c < kMmaBK / 16; ++c)
        mma_bf16(o[n], pa[c], vrow[c * 8], vrow[c * 8 + 4]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = r0 + r * 8;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + row * os.s + n * 8 + t * 2) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}


template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t batch, int64_t heads, int64_t group, int64_t sq,
                   int64_t sk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, bool causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const dim3 grid(static_cast<unsigned>((sq + kMmaBQ - 1) / kMmaBQ),
                    static_cast<unsigned>(heads),
                    static_cast<unsigned>(batch));
    flash_attention_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<int>(group), sq, sk, qs, ks, vs, os, scale, causal);
  } else {
    const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                    static_cast<unsigned>(heads),
                    static_cast<unsigned>(batch));
    flash_attention_kernel<D><<<grid, kBQ, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<int>(group), sq, sk, qs, ks, vs, os, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int64_t d, const void* q, const void* k, const void* v,
                       void* out, int64_t batch, int64_t heads, int64_t group,
                       int64_t sq, int64_t sk, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, bool causal,
                       cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, batch, heads, group, sq, sk, qs, ks,
                           vs, os, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, batch, heads, group, sq, sk, qs, ks,
                           vs, os, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, heads, group, sq, sk, qs, ks,
                           vs, os, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16. Strides are in elements, (b, h, s) for
// each of q, k, v, out; the head dimension of every tensor is contiguous.
extern "C" int flash_attention_launch(
    int64_t dtype, const void* q, const void* k, const void* v, void* out,
    int64_t batch, int64_t heads, int64_t kv_heads, int64_t sq, int64_t sk,
    int64_t d, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
    int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
    int64_t osb, int64_t osh, int64_t oss, float scale, int64_t causal,
    cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads || sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const int64_t group = heads / kv_heads;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, out, batch, heads, group, sq, sk, qs,
                            ks, vs, os, scale, causal != 0, stream);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, out, batch, heads, group, sq,
                                    sk, qs, ks, vs, os, scale, causal != 0,
                                    stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
