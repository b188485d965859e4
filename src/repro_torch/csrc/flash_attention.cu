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
// - bf16 (the model's type), built for Hopper (sm_90a), warp-specialised:
//   * a persistent grid: one block an SM walks work items, a query block of
//     one (batch, head) each, latest query block first and in a snake over
//     rounds of the grid, so that the long items of the causal mask spread
//     evenly over the SMs;
//   * a block is one producer warpgroup and C consumer warpgroups of 64
//     query rows: C = 2 (128 rows, 384 threads) at D = 128; at D <= 64,
//     where a tile's exponentials take as long as its products, C = 3 (192
//     rows, 512 threads) unless 192-row blocks pad Sq by more than 1/16
//     beyond 128-row ones (the wrapper's consumer_warpgroups). With
//     __launch_bounds__(threads, 1) a thread has 168 or 128 registers at
//     entry; setmaxnreg takes the producer down to 40 or 32 and the
//     consumers up to 232 or 160, which hold O (D / 2 f32), a tile's
//     scores (64 f32) and P (32 bf16 pairs) without spilling (ptxas -v:
//     168 and 128 registers, 0 bytes spilled);
//   * the producer's one thread loads an item's Q and then K and V in
//     tiles of 128 keys through a ring each, with full and empty mbarriers
//     per stage, by TMA (cp.async.bulk.tensor) over tensor maps built on
//     the host over the caller's strided 4-D views (D, S, heads, batch; the
//     outer three ordered by stride), with the swizzle that matches a row's
//     bytes (128 B at D = 64, 64 B at 32, 32 B at 16). At D = 128 a row's
//     256 bytes are two 128-byte swizzle atoms: each tile is loaded as two
//     boxes of 64 columns into two halves, both counted in the stage's
//     transaction bytes. Rows past the end arrive as zeros. The next item's
//     Q loads once the consumers have issued their last products, and its
//     tiles as the rings free, under the current item's last softmax and
//     epilogue;
//   * shared memory (of 227 KB): at D = 128 Q 2 x 16 KB and 2 stages of K
//     and V, 32 KB each, 160 KB; at D = 64 Q 3 x 8 KB and 3 stages of 16
//     KB each, 120 KB (2, 3 and 4 stages timed within 2 % there);
//   * S = Q.K^T as wgmma m64n128k16 with Q and K read from the swizzled
//     tiles (K-major descriptors; at D = 128 the k-steps 4-7 start in the
//     second half); O += P.V as wgmma m64nDk16 with P from registers (the
//     S accumulator's layout, repacked to bf16 pairs, is the A operand's)
//     and V in its natural (keys, D) layout through a transposed
//     (MN-major) descriptor, whose leading byte offset steps from the first
//     64 columns to the second at D = 128;
//   * a consumer takes turns with the others on named barriers: in its
//     turn it issues tile j's scores and tile j - 1's P.V back to back and
//     hands the turn on, so the tensor cores run one consumer's products
//     while the others run their softmax; wgmma.wait_group 1 waits for the
//     scores and leaves P.V in flight, and the wait for P.V comes before
//     the softmax, so that O's rescale runs beside the exponentials (the
//     softmax wholly under P.V measured 1-4 % slower);
//   * the softmax runs on the f32 accumulators with ex2.approx.ftz and
//     scale*log2(e) folded in, maxima and sums in 8 partials a row; only
//     the tiles that reach the block's first row take the causal compare,
//     and only the last tile of a non-causal call the compare against Sk;
//   * P is rounded to bf16 for P.V, where the TPU kernel keeps it in f32:
//     the output moves by about 2^-9 of its size, inside the 2.5e-2 that
//     bf16 outputs are held to (the row sums l use the f32 p);
//   * the mbarrier waits poll inside their asm on uniform branches and
//     the releases are predicated: a C loop or branch there is a divergent
//     path to ptxas, which then serialises every wgmma (C7520). A wait
//     of more than 2^28 polls traps instead of hanging.
//   Measured (tools/ab_attention.py against commit db81ff5, one call on an
//   NVIDIA H100 80GB HBM3 at 700.00 W, seeded views of the main path's
//   shapes): ms, the replaced design's in brackets, then SDPA's:
//   llama3.2-3b prefill (4, 2048, 24 over 8, 128) 0.195 (0.280), 0.203;
//   seamless cross (4, 256, 16, 64) over 1,500 0.0239 (0.0308), 0.0254;
//   qwen long prefill (1, 32768, 16, 64) 4.03 (5.49), 4.51;
//   qwen prefill (4, 2048, 16, 64) 0.0964 (0.1074), 0.1068;
//   qwen long train (2, 4096, 16, 64) 0.164 (0.199), 0.188;
//   seamless encoder (4, 1500, 16, 64) 0.0889 (0.1204), 0.1109;
//   zamba2 shared block (4, 2048, 32, 64) 0.190 (0.213), 0.192.
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

// the bf16 kernel: warp-specialised, TMA loads, overlapped wgmma products
constexpr int kWgRows = 64;   // query rows a consumer warpgroup
constexpr int kWgBK = 128;    // keys a K/V tile

// The block's shape: one producer warpgroup and C consumer warpgroups of
// 64 query rows. At D = 128 two consumers hold O (64 f32 a thread), the
// scores (64) and P (32) in 232 registers. At D <= 64 a tile's
// exponentials take as long as its products, so three consumers (the
// wrapper's choice, where 192-row blocks pad Sq little) give each softmax
// two other consumers' products to run under, in 160 registers (O 32,
// scores 64, P 32). setmaxnreg moves registers inside the block's
// allocation, 65,536 / threads at entry (__launch_bounds__(threads, 1)):
// 128 x 40 + 256 x 232 = 64,512 = 384 x 168, and 128 x 32 + 384 x 160 =
// 65,536 = 512 x 128.
template <int D, int C>
struct WgShape {
  static_assert(C == 2 || (C == 3 && D <= 64), "no such block shape");
  static constexpr int kConsumers = C;
  static constexpr int kBQ = kConsumers * kWgRows;  // query rows a block
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kEntryRegs = (65536 / kThreads) / 8 * 8;
  static constexpr int kProducerRegs = kConsumers == 2 ? 40 : 32;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 232 : 160;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    kThreads * kEntryRegs,
                "the register split overdraws");
};

// named barriers kTurnBar + w: consumer warpgroup w's turn to issue its
// products, handed on by warpgroup w - 1 (barrier 0 is __syncthreads')
constexpr int kTurnBar = 1;
constexpr int kTurnThreads = 256;   // the warpgroup and the one before it
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

// wait until the phase of parity ``parity`` has completed. The polling
// loop lies inside the asm, on uniform branches, so that the compiler
// sees no divergent path between a warpgroup's asynchronous products
// (where it would serialise them); after 2^28 polls (seconds: a pipeline
// fault) it traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, %2;\n"
      "@p bra.uni WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "n"(1 << 28)
      : "memory");
}

// a warp is done with a stage: lane 0 arrives, predicated rather than
// branched on, for the reason above
__device__ __forceinline__ void mbar_release(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
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

// bar.sync / bar.arrive on named barrier ``id`` over ``threads`` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// every warp of a warpgroup executes these together
template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading accumulators that an asynchronous wgmma
// writes, or writing operands it reads, on the far side of a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The bytes of a row inside one swizzle atom: a whole bf16 row of D <= 64
// elements (128, 64 or 32 bytes), or one 64-column half of a row of 128.
template <int D>
constexpr int kAtomRow = (D > 64 ? 64 : D) * 2;

// Shared-memory matrix descriptors for wgmma over tiles that TMA wrote
// with the swizzle of an atom row (128 B at D = 64 and 128, 64 B at 32,
// 32 B at 16), rows packed at that pitch and every half 1024-byte
// aligned. An 8-row group spans 8 atom rows (SBO). K-major (Q, K: the
// reduction runs along the row) ignores LBO: a k-step of 16 columns lies
// in one atom. MN-major (V: the reduction runs down the rows) reads N = D
// across the row: one atom at D <= 64, where LBO is never used and is
// given the group stride too; two at D = 128, where LBO is ``half``, the
// offset from a tile's first 64 columns to its second.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t half) {
  constexpr uint64_t kLayout = D >= 64 ? 1 : (D == 32 ? 2 : 3);
  constexpr uint64_t kGroup = 8 * kAtomRow<D>;
  const uint64_t lead = D > 64 ? half : kGroup;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         ((lead >> 4) << 16) | ((kGroup >> 4) << 32) | (kLayout << 62);
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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


// The bytes of one 64-column half of a consumer's Q tile (64 rows) and of
// a K or V tile (128 rows); the whole tile at D <= 64.
template <int D>
constexpr int kQHalf = kWgRows * kAtomRow<D>;
template <int D>
constexpr int kKVHalf = kWgBK * kAtomRow<D>;

// Shared memory of one block: the C consumers' Q tiles (64 rows each),
// then a ring of K tiles and a ring of V tiles (128 rows each), then the
// mbarriers. A tile of D = 128 is two 64-column halves, each its own
// swizzled block of rows; a tile of D <= 64 is one.
template <int D, int C>
struct WgLayout {
  // ring depth: 2 x (K 32 KB + V 32 KB) at D = 128 beside Q's 32 KB (160
  // KB); 3 x (16 + 16) at D = 64 beside Q's 24 (120 KB). At D = 64, 2, 3
  // and 4 stages timed within 2 % of each other (PERF.md)
  static constexpr int kStages = D > 64 ? 2 : 3;
  static constexpr int kHalves = D > 64 ? 2 : 1;
  static constexpr int kQTile = kWgRows * D * 2;
  static constexpr int kKVTile = kWgBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = C * kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBars = kV + kStages * kKVTile;
  // q_full, q_empty, k_full[kStages], v_full[kStages], k_empty[kStages],
  // v_empty[kStages]
  static constexpr int kBytes = kBars + 8 * (2 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align to 1024
  static_assert(kAlloc <= 232448, "more than a block's shared memory");
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

constexpr int kScores = kWgBK / 2;   // f32 scores a thread holds
constexpr int kPSteps = kWgBK / 16;  // k-steps of P.V a tile

// S = Q.K^T for one tile: D / 16 k-steps of 32 bytes, inside an atom row;
// at D = 128 the steps 4-7 read the second half
template <int D>
__device__ __forceinline__ void tile_scores(float (&sc)[kScores],
                                            uint64_t q_desc,
                                            uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(sc, q_desc + (kk / 4) * (kQHalf<D> >> 4) + (kk % 4) * 2,
                  k_desc + (kk / 4) * (kKVHalf<D> >> 4) + (kk % 4) * 2,
                  kk > 0);
}

// O += P.V for one tile: 16 keys (16 atom rows of V) a step
template <int D>
__device__ __forceinline__ void tile_pv(float (&o)[D / 2],
                                        const uint32_t (&pa)[kPSteps][4],
                                        uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk)
    wgmma_rs<D>(o, pa[kk], v_desc + kk * (16 * kAtomRow<D> >> 4));
}

// the causal compare (key > row) or, for a ragged non-causal tile, the
// compare against Sk; this thread holds rows r0 and r0 + 8, keys
// key0 + 8 n and + 1 (key0 = the tile's first key + 2 t)
__device__ __forceinline__ void mask_tile(float (&sc)[kScores], int key0,
                                          int r0, bool causal, int sk) {
#pragma unroll
  for (int i = 0; i < kScores; ++i) {
    const int key = key0 + (i >> 2) * 8 + (i & 1);
    const int row = r0 + ((i >> 1) & 1) * 8;
    if (causal ? key > row : key >= sk) sc[i] = -INFINITY;
  }
}

// 2^x on the special-function unit, flushing a denormal result to 0
// (exp2f without fast math adds a scaling around it for denormals, which
// a probability below 2^-126 of the row's largest never needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile on rows r0 (i & 2 == 0) and r0 + 8, in
// two halves. tile_max: the new row maxima m, the factor alpha that
// rescales what was summed under the old ones, and mc = m scale log2(e).
// tile_exp: sc replaced by p = exp(scale (S - m)) in f32, whose sum l
// takes. Maxima and sums run in 8 partials a row, so that no chain of 32
// dependent operations sets the pace
__device__ __forceinline__ void tile_max(const float (&sc)[kScores],
                                         float (&m)[2], float (&alpha)[2],
                                         float (&mc)[2], float scale_log2) {
  float part[2][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    part[0][k] = m[0];
    part[1][k] = m[1];
  }
#pragma unroll
  for (int i = 0; i < kScores; ++i) {
    float& x = part[(i >> 1) & 1][((i >> 2) & 3) * 2 + (i & 1)];
    x = fmaxf(x, sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(fmaxf(fmaxf(part[r][0], part[r][1]),
                           fmaxf(part[r][2], part[r][3])),
                     fmaxf(fmaxf(part[r][4], part[r][5]),
                           fmaxf(part[r][6], part[r][7])));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = ex2((m[r] - mx) * scale_log2);
    m[r] = mx;
    mc[r] = mx * scale_log2;
  }
}

__device__ __forceinline__ void tile_exp(float (&sc)[kScores],
                                         float (&l)[2],
                                         const float (&alpha)[2],
                                         const float (&mc)[2],
                                         float scale_log2) {
  float part[2][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) part[0][k] = part[1][k] = 0.f;
#pragma unroll
  for (int i = 0; i < kScores; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = ex2(fmaf(sc[i], scale_log2, -mc[r]));
    part[r][((i >> 2) & 3) * 2 + (i & 1)] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] +
           (((part[r][0] + part[r][1]) + (part[r][2] + part[r][3])) +
            ((part[r][4] + part[r][5]) + (part[r][6] + part[r][7])));
}

// P rounded to bf16 pairs in the A operand's layout: step kk covers keys
// 16 kk .. 16 kk + 15
__device__ __forceinline__ void pack_p(const float (&sc)[kScores],
                                       uint32_t (&pa)[kPSteps][4]) {
#pragma unroll
  for (int n = 0; n < kScores / 4; ++n) {
    pa[n / 2][(n & 1) * 2] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
    pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

// One work item: query block qb (of 64 C rows) of one (batch, head). Items
// are numbered latest query block first, heads fastest, and a block takes
// them in a snake over rounds of the grid: in round r block p takes item
// r G + p, or r G + G - 1 - p when r is odd, so that the long items of
// the causal mask spread evenly over the blocks.
struct Item {
  int qb, h, b;
};

__device__ __forceinline__ Item item_at(int round, int heads, int batch,
                                        int n_qb) {
  const int g = gridDim.x;
  const int i = round * g + ((round & 1) ? g - 1 - blockIdx.x : blockIdx.x);
  const int hb = heads * batch;
  return Item{n_qb - 1 - i / hb, i % hb % heads, i % hb / heads};
}

template <int D, int C>
__global__ void __launch_bounds__(WgShape<D, C>::kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 MapOrder q_order, MapOrder kv_order,
                                 __nv_bfloat16* __restrict__ out, int heads,
                                 int batch, int group, int sq, int sk,
                                 Strides os, float scale_log2, bool causal) {
  using L = WgLayout<D, C>;
  using W = WgShape<D, C>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t k_empty = v_full + 8 * S;
  const uint32_t v_empty = k_empty + 8 * S;

  const int n_qb = (sq + W::kBQ - 1) / W::kBQ;
  const int items = heads * batch * n_qb;
  // this block's items: rounds 0 .. rounds - 1
  const int g = gridDim.x;
  const int full = items / g, rest = items % g;
  const int mine = (full & 1) ? g - 1 - static_cast<int>(blockIdx.x)
                              : static_cast<int>(blockIdx.x);
  const int rounds = full + (mine < rest ? 1 : 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, W::kConsumerWarps);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, W::kConsumerWarps);
      mbar_init(v_empty + 8 * s, W::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, read through a shuffle so that the compiler knows it
  // is the same on every lane: the roles below are no divergent paths
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (role == 0) {
    // the producer warpgroup: one thread keeps Q and both rings full. It
    // loads an item's Q once every consumer's last scores over the
    // previous item have landed, under their last softmax and epilogue
    regs_down<W::kProducerRegs>();
    if (threadIdx.x == 0) {
      int c[4];
      int it = 0;  // tiles loaded so far: the rings' position
      for (int r = 0; r < rounds; ++r) {
        const Item w = item_at(r, heads, batch, n_qb);
        const int q0 = w.qb * W::kBQ, kvh = w.h / group;
        // causal block skip: no key past the block's last query is loaded
        const int kend = causal ? min(sk, q0 + W::kBQ) : sk;
        const int nt = (kend + kWgBK - 1) / kWgBK;
        // the first round finds Q and every stage free
        mbar_wait(q_empty, (r & 1) ^ 1);
        // each barrier expects a whole tile's bytes: every half adds its own
        mbar_expect_tx(q_full, W::kConsumers * L::kQTile);
        for (int cw = 0; cw < W::kConsumers; ++cw)
          for (int hf = 0; hf < L::kHalves; ++hf) {
            tile_coords(q_order, 64 * hf, q0 + cw * kWgRows, w.h, w.b, c);
            tma_load_4d(base + L::kQ + cw * L::kQTile + hf * kQHalf<D>,
                        &q_map, q_full, c[0], c[1], c[2], c[3]);
          }
        for (int j = 0; j < nt; ++j, ++it) {
          const int s = it % S;
          const uint32_t empty_parity = ((it / S) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, empty_parity);
          mbar_expect_tx(k_full + 8 * s, L::kKVTile);
          for (int hf = 0; hf < L::kHalves; ++hf) {
            tile_coords(kv_order, 64 * hf, j * kWgBK, kvh, w.b, c);
            tma_load_4d(base + L::kK + s * L::kKVTile + hf * kKVHalf<D>,
                        &k_map, k_full + 8 * s, c[0], c[1], c[2], c[3]);
          }
          mbar_wait(v_empty + 8 * s, empty_parity);
          mbar_expect_tx(v_full + 8 * s, L::kKVTile);
          for (int hf = 0; hf < L::kHalves; ++hf) {
            tile_coords(kv_order, 64 * hf, j * kWgBK, kvh, w.b, c);
            tma_load_4d(base + L::kV + s * L::kKVTile + hf * kKVHalf<D>,
                        &v_map, v_full + 8 * s, c[0], c[1], c[2], c[3]);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of an item;
  // this thread holds rows r0 and r0 + 8 of the accumulators, columns
  // 8 n + 2 t, +1
  regs_up<W::kConsumerRegs>();
  const int wg = role - 1;
  const int g4 = lane >> 2, t = lane & 3;
  // Only an item's last tiles take a compare: under the causal mask those
  // that reach the block's first row (the last, or at 192-row blocks the
  // last two), else the ragged end of Sk
  const bool ragged = !causal && (sk % kWgBK) != 0;
  const uint64_t q_desc =
      smem_desc<D>(base + L::kQ + wg * L::kQTile, kQHalf<D>);
  auto k_desc = [&](int s) {
    return smem_desc<D>(base + L::kK + s * L::kKVTile, kKVHalf<D>);
  };
  auto v_desc = [&](int s) {
    return smem_desc<D>(base + L::kV + s * L::kKVTile, kKVHalf<D>);
  };

  float o[D / 2];
  float sc[kScores];
#pragma unroll
  for (int i = 0; i < kScores; ++i) sc[i] = 0.f;
  uint32_t pa[kPSteps][4];

  // Turns: a consumer issues its products only in its turn and hands the
  // turn to the next (w + 1, cyclically) as soon as they are issued, so
  // that a warpgroup's softmax runs under the others' products.
  // Warpgroup 0 goes first; over the block's T tiles each takes T turns
  // and hands on T (the last warpgroup's first hand-on is this arrival,
  // and it does not hand on after its very last tile), so no arrival is
  // left over.
  const bool last_wg = wg + 1 == W::kConsumers;
  if (last_wg) named_arrive(kTurnBar, kTurnThreads);
  const int turn = kTurnBar + wg;
  const int next = kTurnBar + (last_wg ? 0 : wg + 1);
  int it = 0;  // tiles consumed so far: the rings' position
  for (int r = 0; r < rounds; ++r) {
    const Item w = item_at(r, heads, batch, n_qb);
    const int q0 = w.qb * W::kBQ;
    const int kend = causal ? min(sk, q0 + W::kBQ) : sk;
    const int nt = (kend + kWgBK - 1) / kWgBK;
    const int r0 = q0 + wg * kWgRows + (warp & 3) * 16 + g4;
    const bool last_item = r + 1 == rounds;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2], mc[2];

    mbar_wait(q_full, r & 1);
    // tile 0: its scores alone
    {
      const int s = it % S;
      named_sync(turn, kTurnThreads);
      mbar_wait(k_full + 8 * s, (it / S) & 1);
      wgmma_fence();
      tile_scores<D>(sc, q_desc, k_desc(s));
      wgmma_commit();
      if (!last_wg || nt > 1 || !last_item) named_arrive(next, kTurnThreads);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_release(k_empty + 8 * s, lane);
      if (nt == 1) mbar_release(q_empty, lane);
      if (causal ? kWgBK > q0 : ragged && nt == 1)
        mask_tile(sc, 2 * t, r0, causal, sk);
      tile_max(sc, m, alpha, mc, scale_log2);
      tile_exp(sc, l, alpha, mc, scale_log2);
      pack_p(sc, pa);
    }
    // Tile j's scores are issued before tile j - 1's P.V, so the two run
    // back to back on the tensor cores, and the wait for the scores
    // leaves P.V in flight while the K stage is released and the mask
    // applied. The softmax follows the wait for P.V, so that O's rescale
    // runs beside the exponentials; while it runs, the other consumers'
    // products fill the tensor cores. (With the row maxima under P.V the
    // kernel was 0.4-2.8 % slower, with the whole softmax under it and
    // the rescale after it 1-4 %: PERF.md, section 6)
    for (int j = 1; j < nt; ++j) {
      const int s = (it + j) % S, sp = (it + j - 1) % S;
      named_sync(turn, kTurnThreads);
      mbar_wait(k_full + 8 * s, ((it + j) / S) & 1);
      wgmma_fence();
      tile_scores<D>(sc, q_desc, k_desc(s));
      wgmma_commit();
      mbar_wait(v_full + 8 * sp, ((it + j - 1) / S) & 1);
      tile_pv<D>(o, pa, v_desc(sp));
      wgmma_commit();
      if (!last_wg || j + 1 < nt || !last_item)
        named_arrive(next, kTurnThreads);
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_release(k_empty + 8 * s, lane);
      if (j == nt - 1) mbar_release(q_empty, lane);
      if (causal ? (j + 1) * kWgBK > q0 : ragged && j == nt - 1)
        mask_tile(sc, j * kWgBK + 2 * t, r0, causal, sk);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_release(v_empty + 8 * sp, lane);
      tile_max(sc, m, alpha, mc, scale_log2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      tile_exp(sc, l, alpha, mc, scale_log2);
      pack_p(sc, pa);
    }
    // the last tile's P.V
    const int sl = (it + nt - 1) % S;
    mbar_wait(v_full + 8 * sl, ((it + nt - 1) / S) & 1);
    wgmma_fence();
    tile_pv<D>(o, pa, v_desc(sl));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_release(v_empty + 8 * sl, lane);
    it += nt;

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    }
    __nv_bfloat16* ob = out + w.b * os.b + w.h * os.h;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + rr * 8;
      if (row >= sq) continue;
      const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + row * os.s + n * 8 + t * 2) =
            pack_bf16(o[4 * n + 2 * rr] * inv, o[4 * n + 2 * rr + 1] * inv);
    }
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

// The register split moves registers inside the block's allocation, which
// is the kernel's count at entry: with fewer, the consumers' increase
// would wait for ever. Refuse the launch instead.
template <int D, int C>
cudaError_t check_entry_regs() {
  static const cudaError_t status = [] {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, flash_attention_wgmma_kernel<D, C>);
    if (err != cudaSuccess) return err;
    return attr.numRegs == WgShape<D, C>::kEntryRegs
               ? cudaSuccess
               : cudaErrorInvalidConfiguration;
  }();
  return status;
}

template <int D, int C>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int64_t batch, int64_t heads,
                         int64_t group, int64_t sq, int64_t sk, Strides qs,
                         Strides ks, Strides vs, Strides os, float scale,
                         bool causal, cudaStream_t stream) {
  using L = WgLayout<D, C>;
  using W = WgShape<D, C>;
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
  cudaError_t err = check_entry_regs<D, C>();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kAlloc);
  if (err != cudaSuccess) return err;
  // persistent: one block an SM (or one an item, if fewer)
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t items = heads * batch * ((sq + W::kBQ - 1) / W::kBQ);
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  flash_attention_wgmma_kernel<D, C>
      <<<grid, W::kThreads, L::kAlloc, stream>>>(
      q_map, k_map, v_map, q_order, k_order,
      static_cast<__nv_bfloat16*>(out), static_cast<int>(heads),
      static_cast<int>(batch), static_cast<int>(group),
      static_cast<int>(sq), static_cast<int>(sk), os, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t batch, int64_t heads, int64_t group, int64_t sq,
                   int64_t sk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, bool causal, int64_t consumers,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (consumers == 2)
      return launch_wgmma<D, 2>(q, k, v, out, batch, heads, group, sq, sk,
                                qs, ks, vs, os, scale, causal, stream);
    if constexpr (D <= 64) {
      if (consumers == 3)
        return launch_wgmma<D, 3>(q, k, v, out, batch, heads, group, sq, sk,
                                  qs, ks, vs, os, scale, causal, stream);
    }
    return cudaErrorInvalidValue;
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
                       int64_t consumers, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, batch, heads, group, sq, sk, qs, ks,
                           vs, os, scale, causal, consumers, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, batch, heads, group, sq, sk, qs, ks,
                           vs, os, scale, causal, consumers, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, heads, group, sq, sk, qs, ks,
                           vs, os, scale, causal, consumers, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, heads, group, sq, sk, qs,
                            ks, vs, os, scale, causal, consumers, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16. Strides are in elements, (b, h, s) for
// each of q, k, v, out; the head dimension of every tensor is contiguous.
// consumers: the bf16 kernel's consumer warpgroups, 2 or (at D <= 64) 3,
// so 128 or 192 query rows a block; the f32 kernel ignores it.
extern "C" int flash_attention_launch(
    int64_t dtype, const void* q, const void* k, const void* v, void* out,
    int64_t batch, int64_t heads, int64_t kv_heads, int64_t sq, int64_t sk,
    int64_t d, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
    int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
    int64_t osb, int64_t osh, int64_t oss, float scale, int64_t causal,
    int64_t consumers, cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads || sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const int64_t group = heads / kv_heads;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, out, batch, heads, group, sq, sk, qs,
                            ks, vs, os, scale, causal != 0, consumers,
                            stream);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, out, batch, heads, group, sq,
                                    sk, qs, ks, vs, os, scale, causal != 0,
                                    consumers, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
