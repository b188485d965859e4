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
// block, with the online-softmax state in registers. Under the causal
// mask the tiles past the block's last query are never loaded, and the
// blocks of the latest queries, which do the most work, run first.
//
// Bound on an H100 SXM: operations. At qwen1.5-0.5b's prefill shapes (4 x
// 16 heads x 2048 x 64, bf16, causal) the scores and P.V take
// 2*B*H*D*S*(S+1) floating-point operations, 34.4 GFLOP, 0.0348 ms at
// the 989 TFLOP/s of the bf16 tensor cores, against 67 MB of q, k, v and
// out (0.020 ms); at llama3.2-3b's (4 x 24 heads over 8 x 2048 x 128)
// 103.1 GFLOP, 0.104 ms, against 134 MB (0.040 ms). Head dims 16, 32, 64
// and 128. Two kernels, chosen by the input type:
//
// - bf16 (the model's type), built for Hopper (sm_90a):
//   * a block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows and one producer warp;
//   * the producer loads Q once and K and V in tiles of 64 keys through a
//     ring of two stages with TMA (cp.async.bulk.tensor), full and empty
//     mbarriers per stage, so the loads of tile j+1 run under the
//     products of tile j. The tensor maps are built on the host over the
//     caller's strided 4-D views (D, S, heads, batch; the outer three
//     ordered by stride), with the swizzle that matches a row's bytes
//     (128 B at D = 64, 64 B at 32, 32 B at 16). At D = 128 a row's 256
//     bytes are two 128-byte swizzle atoms, more than one box may hold:
//     each tile is loaded as two boxes of 64 columns into two halves
//     (64 rows x 128 B each), and both count toward the stage's
//     transaction bytes. Rows past the end of the sequence arrive as
//     zeros;
//   * S = Q.K^T runs as wgmma m64n64k16 with Q and K read from the
//     swizzled tiles (K-major descriptors; at D = 128 the k-steps 4-7
//     start in the second half); O += P.V as wgmma m64nDk16 with P from
//     registers (the S accumulator's layout, repacked to bf16 pairs, is
//     the A operand's) and V read in its natural (keys, D) layout through
//     a transposed (MN-major) descriptor, whose leading byte offset steps
//     from the first 64 columns to the second at D = 128: no transpose
//     through shared memory;
//   * the softmax runs on the f32 accumulators with exp2f and
//     scale*log2(e) folded in; only the tile on a warpgroup's diagonal
//     takes the causal compare (tiles are 64 keys and warpgroups 64 rows,
//     so every other tile is wholly below it), and only the last tile of
//     a non-causal call the compare against Sk;
//   * P is rounded to bf16 for P.V, where the TPU kernel keeps it in f32:
//     the output moves by about 2^-9 of its size, inside the 2.5e-2 that
//     bf16 outputs are held to (the row sums l use the f32 p);
//   * a consumer waits for each product before it goes on. At D = 64, 92
//     registers a thread, two blocks (four consumer warpgroups) share an
//     SM, and one warpgroup's softmax runs under the others' products. A
//     consumer that also ran its own next softmax under P.V needs a
//     second P fragment, fits one block an SM, and was slower. At D = 128
//     the O accumulator is 64 f32 a thread and a block takes 96 KB of
//     shared memory (Q 32, K and V 2 x 16 each).
//   Measured on an H100 SXM at 700 W (chip_smoke.py, PERF.md): 0.109 ms
//   at the main path's shape, against 0.453 ms for the mma.sync kernel
//   this design replaced and 0.105 ms for PyTorch's SDPA; 32 % of the
//   bound.
// - f32 (the tests' sweep): one thread per query row, f32 FMAs on the
//   CUDA cores (67 TFLOP/s), the exact arithmetic of the TPU kernel up to
//   the order of sums. At D = 128 its 2 x 128 accumulators spill.
//
// Inputs keep their caller's layout: q, k and v are read through their
// (batch, head, position) strides and out written through its own, with
// the head dimension contiguous, so the model layout (B, S, H, D) needs
// no transposed copy. TMA needs 16-byte aligned rows and strides: the
// wrapper checks them. The tensor-map encoder is reached through
// cudaGetDriverEntryPoint, so the library needs no link to libcuda.
#include <cuda.h>
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

// the bf16 kernel: TMA loads, wgmma products, warp-specialised
constexpr int kWgRows = 64;             // query rows per consumer warpgroup
constexpr int kWgBQ = 2 * kWgRows;      // query rows per block
constexpr int kWgBK = 64;               // keys per K/V tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kWgThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity ``parity`` has completed; a wait of
// more than about ten seconds (a pipeline fault) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 34))
      __trap();
  }
}

// one TMA tile load of a 4-D tensor map into shared memory, completing
// on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until every committed group of this warpgroup has completed
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from reading accumulators that an asynchronous wgmma
// writes before the wait above
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The bytes of a row inside one swizzle atom: a whole bf16 row of D <= 64
// elements (128, 64 or 32 bytes), or one 64-column half of a row of 128.
template <int D>
constexpr int kAtomRow = (D > 64 ? 64 : D) * 2;
// The bytes of one 64-row tile's half (the whole tile at D <= 64).
template <int D>
constexpr int kHalf = kWgBK * kAtomRow<D>;

// Shared-memory matrix descriptors for wgmma over tiles that TMA wrote
// with the swizzle of an atom row (128 B at D = 64 and 128, 64 B at 32,
// 32 B at 16), rows packed at that pitch and every half 1024-byte
// aligned. An 8-row group spans 8 atom rows (SBO). K-major (Q, K: the
// reduction runs along the row) ignores LBO: a k-step of 16 columns lies
// in one atom. MN-major (V: the reduction runs down the rows) reads N = D
// across the row: one atom at D <= 64, where LBO is never used and is
// given the group stride too; two at D = 128, where LBO is the offset
// from the first half to the second.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kLayout = D >= 64 ? 1 : (D == 32 ? 2 : 3);
  constexpr uint64_t kGroup = 8 * kAtomRow<D>;
  constexpr uint64_t kLead = D > 64 ? kHalf<D> : kGroup;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         ((kLead >> 4) << 16) | ((kGroup >> 4) << 32) | (kLayout << 62);
}
// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A in registers, B in shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A in registers, B in shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B in shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B in shared
// memory MN-major (transposed): two swizzle atoms across N, LBO apart
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(d, a, db);
  else if constexpr (D == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (D == 32)
    wgmma_rs_n32(d, a, db);
  else
    wgmma_rs_n16(d, a, db);
}

template <int D>
struct WgLayout {
  static constexpr int kTile = kWgBK * D * 2;  // bytes of 64 bf16 rows
  // a tile's halves of 64 columns, kHalf<D> bytes apart (1 at D <= 64)
  static constexpr int kHalves = D > 64 ? 2 : 1;
  static constexpr int kQ = 0;                 // two 64-row tiles
  static constexpr int kK = 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align to 1024
};

// Coordinates of a tile in a tensor map whose dims are (D, then the
// position, head and batch axes in the order of their strides):
// ``order`` gives, for position, head and batch, the map dimension.
struct MapOrder {
  int s, h, b;
};

__device__ __forceinline__ void tile_coords(const MapOrder& o, int col,
                                            int s, int h, int b,
                                            int (&c)[4]) {
  c[0] = col;
  c[1 + o.s] = s;
  c[1 + o.h] = h;
  c[1 + o.b] = b;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 MapOrder q_order, MapOrder kv_order,
                                 __nv_bfloat16* __restrict__ out, int group,
                                 int sq, int sk, Strides os, float scale_log2,
                                 bool causal) {
  using L = WgLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  // latest queries first across every (batch, head): the query-block
  // index varies slowest in the launch order
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / group;
  const int q0 = qb * kWgBQ;
  // causal block skip: no key past the block's last query is loaded
  const int kend = causal ? min(sk, q0 + kWgBQ) : sk;
  const int n_tiles = (kend + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      int c[4];
      // each barrier expects a whole tile's bytes: every half adds its own
      mbar_expect_tx(q_full, 2 * L::kTile);
      for (int r = 0; r < 2; ++r)
        for (int hf = 0; hf < L::kHalves; ++hf) {
          tile_coords(q_order, 64 * hf, q0 + r * kWgRows, h, b, c);
          tma_load_4d(base + L::kQ + r * L::kTile + hf * kHalf<D>, &q_map,
                      q_full, c[0], c[1], c[2], c[3]);
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        // the first round finds every stage free
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, L::kTile);
        mbar_expect_tx(v_full + 8 * s, L::kTile);
        for (int hf = 0; hf < L::kHalves; ++hf) {
          tile_coords(kv_order, 64 * hf, j * kWgBK, kvh, b, c);
          tma_load_4d(base + L::kK + s * L::kTile + hf * kHalf<D>, &k_map,
                      k_full + 8 * s, c[0], c[1], c[2], c[3]);
          tma_load_4d(base + L::kV + s * L::kTile + hf * kHalf<D>, &v_map,
                      v_full + 8 * s, c[0], c[1], c[2], c[3]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread
  // holds rows r0 and r0 + 8 of the accumulators, columns 8 n + 2 t, +1
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * kWgRows;
  const int r0 = wg_row0 + (warp & 3) * 16 + g;
  // the warpgroup's diagonal tile: every earlier tile is wholly below
  // the diagonal, every later one wholly above it (and skipped)
  const int diag = wg_row0 / kWgBK;
  const int nt = causal ? min(n_tiles, diag + 1) : n_tiles;
  const bool ragged = !causal && (sk % kWgBK) != 0;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint64_t q_desc = smem_desc<D>(base + L::kQ + wg * L::kTile);

  mbar_wait(q_full, 0);
  for (int j = 0; j < nt; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint64_t k_desc = smem_desc<D>(base + L::kK + s * L::kTile);
    const uint64_t v_desc = smem_desc<D>(base + L::kV + s * L::kTile);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(k_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16 dims = 32 bytes a step inside an atom; at D = 128 steps 4-7
      // read the second half
      const int step = (kk / 4) * (kHalf<D> >> 4) + (kk % 4) * 2;
      wgmma_ss_n64(sc, q_desc + step, k_desc + step, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int key0 = j * kWgBK + 2 * t;
    if (causal && j == diag) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + (i >> 2) * 8 + (i & 1);
        const int row = r0 + ((i >> 1) & 1) * 8;
        if (key > row) sc[i] = -INFINITY;
      }
    } else if (ragged && j == nt - 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (key0 + (i >> 2) * 8 + (i & 1) >= sk) sc[i] = -INFINITY;
    }
    // online softmax on rows r0 (i & 2 == 0) and r0 + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      mc[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
    // P = exp(scale (S - m)), rounded to bf16 pairs in the A operand's
    // layout: step kk covers keys 16 kk .. 16 kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = exp2f(fmaf(sc[4 * n + i], scale_log2, -mc[i >> 1]));
        l[i >> 1] += p[i];
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    mbar_wait(v_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // 16 keys = 16 atom rows of V a step
      wgmma_rs<D>(o, pa[kk], v_desc + kk * (16 * kAtomRow<D> >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + row * os.s + n * 8 + t * 2) =
          pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link to libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over the bf16 view (D, S, heads, batch) of ``ptr`` with
// element strides ``st``, loading boxes of min(D, 64) columns x ``rows``
// positions of one head (a row of 128 takes two boxes). The outer three dims are ordered by stride (the model layout's
// views have a head stride below the position stride), and ``order``
// says where each landed. False if the encoder refuses it.
bool make_map(CUtensorMap* map, MapOrder* order, const void* ptr, int d,
              int64_t s, int64_t heads, int64_t batch, Strides st, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  int64_t extent[3] = {s, heads, batch}, stride[3] = {st.s, st.h, st.b};
  int axis[3] = {0, 1, 2};  // 0 position, 1 head, 2 batch
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[axis[j]] < stride[axis[j - 1]]; --j) {
      const int x = axis[j];
      axis[j] = axis[j - 1];
      axis[j - 1] = x;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t bytes[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(d > 64 ? 64 : d), 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int where[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(extent[axis[i]]);
    bytes[i] = static_cast<cuuint64_t>(stride[axis[i]]) * 2;
    if (axis[i] == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
    where[axis[i]] = i;
  }
  *order = MapOrder{where[0], where[1], where[2]};
  const CUtensorMapSwizzle swizzle =
      d >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : (d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, bytes, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int64_t batch, int64_t heads,
                         int64_t group, int64_t sq, int64_t sk, Strides qs,
                         Strides ks, Strides vs, Strides os, float scale,
                         bool causal, cudaStream_t stream) {
  using L = WgLayout<D>;
  if (sq > INT32_MAX || sk > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  MapOrder q_order, k_order, v_order;
  const int64_t kv_heads = heads / group;
  if (!make_map(&q_map, &q_order, q, D, sq, heads, batch, qs, kWgRows) ||
      !make_map(&k_map, &k_order, k, D, sk, kv_heads, batch, ks, kWgBK) ||
      !make_map(&v_map, &v_order, v, D, sk, kv_heads, batch, vs, kWgBK))
    return cudaErrorInvalidValue;
  // K and V share their tile coordinates
  if (k_order.s != v_order.s || k_order.h != v_order.h ||
      k_order.b != v_order.b)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(batch),
                  static_cast<unsigned>((sq + kWgBQ - 1) / kWgBQ));
  flash_attention_wgmma_kernel<D><<<grid, kWgThreads, L::kAlloc, stream>>>(
      q_map, k_map, v_map, q_order, k_order,
      static_cast<__nv_bfloat16*>(out), static_cast<int>(group),
      static_cast<int>(sq), static_cast<int>(sk), os, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t batch, int64_t heads, int64_t group, int64_t sq,
                   int64_t sk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, bool causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_wgmma<D>(q, k, v, out, batch, heads, group, sq, sk, qs, ks,
                           vs, os, scale, causal, stream);
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
    case 128:
      return launch<T, 128>(q, k, v, out, batch, heads, group, sq, sk, qs,
                            ks, vs, os, scale, causal, stream);
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
