// Kernel 7: the Mamba2 SSD (state-space duality) chunked scan.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan/ssd_scan.py:
// ssd_scan (_ssd_kernel). Per batch b and head h it computes the
// recurrence
//     state_t = exp(dt_t a_h) state_{t-1} + dt_t outer(B_t, x_t)
//     y_t     = C_t . state_t + d_h x_t
// in chunks of L tokens. With cum the prefix sum of dt.a inside a chunk:
//     S   = (C B^T) o exp(min(cum_i - cum_j, 0)) o dt_j, for i >= j
//     y   = S x + exp(cum) (C h) + d x
//     h  <- exp(cum_L) h + (B o w)^T x,   w = exp(cum_L - cum) dt
// Every exponent is of a sum that is not positive, so a long chunk can
// underflow to 0 but never overflow; the i < j entries are never formed.
//
// The TPU grid walked (B, H, S/L) with the chunk axis sequential and the
// (N, P) state in VMEM scratch. Here one block owns one (b, h) and loops
// over the chunks itself, carrying the state for the whole sequence.
// Group g = h / (H / G) is read for B and C.
//
// Bound on an H100 SXM: bytes. Per (b, h, chunk) the function needs
// L (L + 1) P FLOP for S x (the lower triangle with its diagonal) and
// 4 L N P for C h and the state update, and per (b, group, chunk)
// L (L + 1) N for C B^T: at mamba2-2.7b's prefill (4 x 2048 tokens, 80
// heads of 64, N 128, G 1, L 64) 24.3 GFLOP, 0.025 ms at the bf16 tensor
// rate, under the 0.0521 ms that its 174.6 MB of x, y, B, C and dt take
// at 3.35 TB/s. Two kernels, chosen by type, shape and alignment (the
// SIMT one takes every input the wrapper accepts):
//
// - bf16 with N in {16, 32, 64, 128}, P in {8, 16, 32, 64} and 16-byte
//   aligned rows (the prefill path): the four products on the tensor
//   cores, mma.sync m16n8k16 bf16 with f32 accumulation, operands through
//   ldmatrix from XOR-swizzled shared tiles (conflict-free at 128- and
//   256-byte rows). Four warps; warp w owns rows 16w..16w+15 of the chunk
//   for C B^T, S and y, and state rows 16w.. and 16(w + 4).. for the
//   update, so the master state stays in f32 registers for the whole
//   sequence. One pass over k = n feeds C h and the first 32 columns of
//   C B^T from the same C fragments, a second the last 32 (only for the
//   warps whose rows reach them); each half of S goes from its f32
//   accumulators straight into bf16 A fragments for S x (kernel 5 rounds
//   P the same way). C h reads a bf16 copy of the state. The update reads
//   B^T through ldmatrix.trans and scales its fragments by w along k in
//   registers, rounding B o w to bf16. Every warp scans dt.a itself and
//   takes the cum, exp(cum), dt and w of other tokens by shuffle, so a
//   chunk has two barriers: one at its top, one when x has landed. The
//   output moves by about 2^-9 of its size, inside the bar chip_smoke.py
//   holds the main path to (rtol 2^-7, atol 2^-8 of max |y|); TF32 was
//   not needed.
//   Loads are cp.async with zero fill past the chunk's last token (a
//   chunk pads to a multiple of 16 rows), issued as soon as their buffer
//   is free: x of the chunk and B and dt of the next (two buffers) at its
//   top, C of the next once every warp is past C B^T and C h. B arrives
//   under a whole chunk, C under S x and the update, x under C B^T.
//   Shared memory is 72.5 KB at mamba2's shapes and 168 registers are
//   allowed (some spill), so three blocks share an SM and the 320 (b, h)
//   blocks of prefill are all resident on 132 SMs at once. One head a
//   block: with G = 1 a block of two heads could share C B^T and the
//   staged B and C, but at 160 blocks on 132 SMs the card would run 1.2
//   waves of the longest block. At L = 64, N = 128, P = 64 a variant with
//   the chunk fixed at compile time forms every j tile and S x step (the
//   zeros above the diagonal included), so no branch splits the products.
//   What bounds it now is latency, not bytes or tensor work: a chunk is
//   a chain of dependent steps (scan, products, exps, stores) of four
//   warps, and a block alone on an SM is not much faster than three
//   sharing one (tools/ab_kernels.py times both). Left: warp specialisation that overlaps one chunk's
//   intra-chunk products with the previous chunk's state update; the y
//   stores as 4-byte pairs.
// - f32, and bf16 shapes or views the first kernel does not take: the
//   three products on the CUDA cores in f32 (4 x 4 register tiles over
//   f32 copies of x, B and C in shared memory, 132.6 KB at L 64, N 128,
//   P 64: one 256-thread block an SM), C B^T recomputed per head. It
//   keeps the f32 path's accuracy (the teacher-forced f32 decode agrees
//   with forward to 1e-5 of max |logit|).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;     // two tokens per lane of the scan warp
constexpr int kMaxP = 64;         // head-dim columns per block
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

struct Dims {
  int seq, heads, groups, n, p, chunk;
  int64_t x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;  // (batch, seq) strides
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// The chunk's rows padded to a multiple of 4 (the register tiles' height);
// padded rows hold zeros and are never written out.
__host__ __device__ __forceinline__ int padded(int chunk) {
  return (chunk + 3) & ~3;
}

// f32 words of shared memory, with LP = padded(L): x [LP][P], h [N][P],
// S [LP][LP], B and C [LP][N + 1], then cum, exp(cum), w and dt [LP]
// each. x and h come first, so that their rows start 16-byte aligned for
// float4 reads.
__host__ __device__ __forceinline__ int smem_floats(int chunk, int n, int p) {
  const int lp = padded(chunk);
  return lp * p + n * p + lp * lp + 2 * lp * (n + 1) + 4 * lp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dskip,
    T* __restrict__ y, Dims dm) {
  extern __shared__ float4 smem4[];
  const int L = dm.chunk, LP = padded(L), N = dm.n, P = dm.p;
  const int NP = N + 1;
  float* const xs = reinterpret_cast<float*>(smem4);  // [LP][P]
  float* const hs = xs + LP * P;                      // [N][P]
  float* const ss = hs + N * P;                       // [LP][LP]
  float* const bs = ss + LP * LP;                     // [LP][NP]
  float* const cs = bs + LP * NP;                     // [LP][NP]
  float* const cum = cs + LP * NP;                    // [LP]
  float* const ecum = cum + LP;                       // [LP] exp(cum)
  float* const wv = ecum + LP;                        // [LP]
  float* const dts = wv + LP;                         // [LP]

  const int h = blockIdx.x;
  const int64_t bi = blockIdx.y;
  const int g = h / (dm.heads / dm.groups);
  const int tid = threadIdx.x;
  const float ah = a[h], dh = dskip[h];
  const int LT = LP / 4, P4 = P / 4, NT = N / 4;

  for (int i = tid; i < N * P; i += kThreads) hs[i] = 0.f;
  // the padded rows of x, B and C: zero for the whole sequence, since the
  // staging below writes rows 0..L-1 only
  for (int i = L * P + tid; i < LP * P; i += kThreads) xs[i] = 0.f;
  for (int i = L * N + tid; i < LP * N; i += kThreads) {
    bs[(i / N) * NP + i % N] = 0.f;
    cs[(i / N) * NP + i % N] = 0.f;
  }

  const int nchunks = dm.seq / L;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int64_t t0 = static_cast<int64_t>(ci) * L;
    // the previous chunk's reads of x, B and C and its writes of h are done
    __syncthreads();

    // 1. stage the chunk's x, B and C as f32 (rows L..LP stay zero)
    for (int i = tid; i < L * P; i += kThreads) {
      const int l = i / P, c = i % P;
      xs[i] = to_f32(x[bi * dm.x_sb + (t0 + l) * dm.x_ss +
                       static_cast<int64_t>(h) * P + c]);
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int l = i / N, k = i % N;
      const int64_t col = static_cast<int64_t>(g) * N + k;
      bs[l * NP + k] = to_f32(bm[bi * dm.b_sb + (t0 + l) * dm.b_ss + col]);
      cs[l * NP + k] = to_f32(cm[bi * dm.c_sb + (t0 + l) * dm.c_ss + col]);
    }

    // 2. cum = inclusive prefix sum of dt.a: warp 0, two tokens a lane
    if (tid < 32) {
      const int64_t base = (bi * dm.seq + t0) * dm.heads + h;
      const int l0 = 2 * tid, l1 = l0 + 1;
      const float d0 = l0 < L ? dt[base + static_cast<int64_t>(l0) * dm.heads]
                              : 0.f;
      const float d1 = l1 < L ? dt[base + static_cast<int64_t>(l1) * dm.heads]
                              : 0.f;
      const float e0 = d0 * ah, e1 = d1 * ah;
      float incl = e0 + e1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      if (l0 < L) {
        cum[l0] = excl + e0;
        dts[l0] = d0;
      }
      if (l1 < L) {
        cum[l1] = excl + e0 + e1;
        dts[l1] = d1;
      }
    }
    __syncthreads();
    const float last = cum[L - 1];
    // read only after the sync that ends step 3
    if (tid < LP) {
      ecum[tid] = tid < L ? expf(cum[tid]) : 0.f;
      wv[tid] = tid < L ? expf(last - cum[tid]) * dts[tid] : 0.f;
    }

    // 3. S = (C B^T) o exp(min(cum_i - cum_j, 0)) o dt_j below the diagonal
    // (zero in the padded rows and columns, whose cum is never written)
    for (int t = tid; t < LT * LT; t += kThreads) {
      const int i0 = (t / LT) * 4, j0 = (t % LT) * 4;
      float acc[4][4] = {};
      if (j0 <= i0 + 3) {
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            cv[r] = cs[(i0 + r) * NP + k];
            bv[r] = bs[(j0 + r) * NP + k];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += cv[r] * bv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + r, j = j0 + q;
          ss[i * LP + j] =
              i >= j && i < L
                  ? acc[r][q] * expf(fminf(cum[i] - cum[j], 0.f)) * dts[j]
                  : 0.f;
        }
    }
    __syncthreads();

    // 4. y = S x + exp(cum) (C h) + d x, with h the state entering the chunk
    for (int t = tid; t < LT * P4; t += kThreads) {
      const int l0 = (t / P4) * 4, c0 = (t % P4) * 4;
      float acc[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < l0 + 4; ++j) {  // S[l][j] = 0 for j > l
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + c0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float s = ss[(l0 + r) * LP + j];
          acc[r][0] += s * xv.x;
          acc[r][1] += s * xv.y;
          acc[r][2] += s * xv.z;
          acc[r][3] += s * xv.w;
        }
      }
      for (int k = 0; k < N; ++k) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + k * P + c0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = cs[(l0 + r) * NP + k];
          inter[r][0] += cv * hv.x;
          inter[r][1] += cv * hv.y;
          inter[r][2] += cv * hv.z;
          inter[r][3] += cv * hv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = l0 + r;
        if (l >= L) break;
        const float* xr = xs + l * P + c0;
        T* out = y + ((bi * dm.seq + t0 + l) * dm.heads + h) * P + c0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          out[q] = from_f32<T>(acc[r][q] + ecum[l] * inter[r][q] + dh * xr[q]);
      }
    }
    __syncthreads();

    // 5. h <- exp(cum_L) h + (B o w)^T x
    const float decay = expf(last);
    for (int t = tid; t < NT * P4; t += kThreads) {
      const int n0 = (t / P4) * 4, c0 = (t % P4) * 4;
      float acc[4][4] = {};
      for (int l = 0; l < L; ++l) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + l * P + c0);
        const float wl = wv[l];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bw = bs[l * NP + n0 + r] * wl;
          acc[r][0] += bw * xv.x;
          acc[r][1] += bw * xv.y;
          acc[r][2] += bw * xv.z;
          acc[r][3] += bw * xv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* hp = reinterpret_cast<float4*>(hs + (n0 + r) * P + c0);
        float4 hv = *hp;
        hv.x = decay * hv.x + acc[r][0];
        hv.y = decay * hv.y + acc[r][1];
        hv.z = decay * hv.z + acc[r][2];
        hv.w = decay * hv.w + acc[r][3];
        *hp = hv;
      }
    }
  }
}

// ------------------------------------------------------------------------
// the bf16 kernel on the tensor cores
constexpr int kTcThreads = 128;     // four warps
constexpr int kTcWarps = kTcThreads / 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 of v times (lo, hi), rounded to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo,
                                                 float hi) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(b) * lo, __high2float(b) * hi);
}

// 16 bytes from global to shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A bf16 tile in shared memory: rows of PC 16-byte chunks (a power of
// two), chunk c of row r stored at chunk c ^ (r & MASK), so the 8 rows an
// ldmatrix reads at one column fall in 8 different bank groups.
template <int PC>
struct Tile {
  static constexpr int kMask = (PC < 8 ? PC : 8) - 1;
  __nv_bfloat16* p;
  uint32_t s;  // p as a shared-memory address
  __device__ __forceinline__ Tile(__nv_bfloat16* ptr)
      : p(ptr), s(smem_u32(ptr)) {}
  __device__ __forceinline__ int at(int r, int c) const {  // c: element
    return r * PC * 8 + ((((c >> 3) ^ (r & kMask))) << 3) + (c & 7);
  }
  __device__ __forceinline__ uint32_t addr(int r, int c) const {
    return s + 2 * at(r, c);
  }
};

__host__ __device__ __forceinline__ int tc_rows(int chunk) {
  return (chunk + 15) & ~15;
}

// bytes of shared memory: B twice, C, x, the bf16 state and dt twice
__host__ __device__ __forceinline__ int tc_smem_bytes(int chunk, int n,
                                                      int p) {
  const int lp = tc_rows(chunk);
  return (3 * lp * n + lp * p + n * p) * 2 + 2 * kMaxChunk * 4;
}

// Rows [t0, t0 + LP) of a strided (seq, COLS) bf16 operand into a tile;
// rows at or past L arrive as zeros.
template <int COLS>
__device__ __forceinline__ void stage_rows(const Tile<COLS / 8>& t,
                                           const __nv_bfloat16* src,
                                           int64_t row_stride, int64_t t0,
                                           int L, int LP, int tid) {
  constexpr int kCh = COLS / 8;
  for (int i = tid; i < LP * kCh; i += kTcThreads) {
    const int r = i / kCh, c = i % kCh;
    const bool ok = r < L;
    const __nv_bfloat16* s = ok ? src + (t0 + r) * row_stride + c * 8 : src;
    cp_async16(t.addr(r, c * 8), s, ok);
  }
}

// B operand (k16 x n8, two n tiles where TWO) of a [k][n] tile: rows
// k0.., columns n0..; r[0..1] for tile n0, r[2..3] for n0 + 8
template <bool TWO, int PC>
__device__ __forceinline__ void ldsm_b_kn(const Tile<PC>& t, int k0, int n0,
                                          int lane, uint32_t (&r)[4]) {
  const int row = k0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  if (TWO)
    ldsm_x4_t(t.addr(row, n0 + 8 * (lane >> 4)), r);
  else
    ldsm_x2_t(t.addr(row, n0), r);
}

// yacc[2 pp (+1)] += a . t[k0.., 16 pp..]: the p tiles of one k step
template <int P, int PC>
__device__ __forceinline__ void mma_p_tiles(float (&acc)[P / 8][4],
                                            const uint32_t (&a)[4],
                                            const Tile<PC>& t, int k0,
                                            int lane) {
#pragma unroll
  for (int pp = 0; pp < (P + 15) / 16; ++pp) {
    constexpr bool kOdd = P % 16 != 0;
    uint32_t bf[4];
    if (kOdd && pp == P / 16) {
      ldsm_b_kn<false>(t, k0, 16 * pp, lane, bf);
      mma_bf16(acc[2 * pp], a, bf[0], bf[1]);
    } else {
      ldsm_b_kn<true>(t, k0, 16 * pp, lane, bf);
      mma_bf16(acc[2 * pp], a, bf[0], bf[1]);
      mma_bf16(acc[2 * pp + 1], a, bf[2], bf[3]);
    }
  }
}

// LPC: the chunk's padded rows when fixed at compile time (64: every warp
// forms all j tiles and all S x steps, the zeros above the diagonal
// included, so no branch splits the products), or 0 (from dm.chunk).
template <int N, int P, int LPC>
__global__ void __launch_bounds__(kTcThreads, 3) ssd_scan_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
    const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dskip,
    __nv_bfloat16* __restrict__ y, Dims dm) {
  constexpr int NT = P / 8;                             // p tiles
  constexpr int MS = (N / 16 + kTcWarps - 1) / kTcWarps;  // state tiles a warp
  using NTile = Tile<N / 8>;
  using PTile = Tile<P / 8>;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int L = dm.chunk, LP = LPC ? LPC : tc_rows(L);
  __nv_bfloat16* const base = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* const bbuf = base;                     // [2][LP][N]
  const NTile ct{base + 2 * LP * N};
  const PTile xt{base + 3 * LP * N};
  const PTile ht{xt.p + LP * P};
  float* const dtbuf = reinterpret_cast<float*>(ht.p + N * P);  // [2][64]

  const int h = blockIdx.x;
  const int64_t bi = blockIdx.y;
  const int g = h / (dm.heads / dm.groups);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, c4 = lane & 3;
  const float ah = a[h], dh = dskip[h];
  const __nv_bfloat16* const xh = x + bi * dm.x_sb + static_cast<int64_t>(h) * P;
  const __nv_bfloat16* const bg = bm + bi * dm.b_sb + static_cast<int64_t>(g) * N;
  const __nv_bfloat16* const cg = cm + bi * dm.c_sb + static_cast<int64_t>(g) * N;
  const float* const dth = dt + bi * dm.seq * dm.heads + h;

  // B and dt of the chunk at t0 into buffer `buf`
  auto stage_b = [&](int64_t t0, int buf) {
    stage_rows<N>(NTile{bbuf + buf * LP * N}, bg, dm.b_ss, t0, L, LP, tid);
    if (tid < LP)
      cp_async4(smem_u32(dtbuf + buf * kMaxChunk + tid),
                tid < L ? dth + (t0 + tid) * dm.heads : dth, tid < L);
  };

  // the state, h = 0: its bf16 copy in shared memory, the master in
  // registers (state row tile warp + 4 s, p tile nt)
  for (int i = tid; i < N * P; i += kTcThreads)
    ht.p[i] = __float2bfloat16(0.f);
  float hacc[MS][NT][4];
#pragma unroll
  for (int s = 0; s < MS; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) hacc[s][nt][q] = 0.f;

  // copies in groups, in this order: (B, dt) and C of chunk 0; then per
  // chunk c: x of c and (B, dt) of c + 1 at its top, C of c + 1 once
  // every warp is past C B^T and C h
  const int nchunks = dm.seq / L;
  stage_b(0, 0);
  cp_commit();
  stage_rows<N>(ct, cg, dm.c_ss, 0, L, LP, tid);
  cp_commit();

  const int i0 = 16 * warp;           // this warp's rows of the chunk
  const bool rows = LPC ? true : i0 < LP;
  const int r0 = i0 + g8, r1 = r0 + 8;
  // the causal j tiles, j < i0 + 16 (or all of them)
  const int jtiles = LPC ? LPC / 8 : 2 * warp + 2;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int64_t t0 = static_cast<int64_t>(ci) * L;
    const NTile bt{bbuf + (ci & 1) * LP * N};
    const float* const dts = dtbuf + (ci & 1) * kMaxChunk;
    // B, dt and C of this chunk have landed; every warp is done with the
    // previous chunk (its x, the other B and dt buffers, its state writes)
    cp_wait_all();
    __syncthreads();
    stage_rows<P>(xt, xh, dm.x_ss, t0, L, LP, tid);
    cp_commit();
    if (ci + 1 < nchunks) stage_b(t0 + L, (ci + 1) & 1);
    cp_commit();

    // cum = inclusive prefix sum of dt.a, in every warp (lane k holds
    // tokens 2k and 2k + 1), and from it exp(cum) and w = exp(cum_L -
    // cum) dt; a thread takes the values of other tokens by shuffle
    const int l0 = 2 * lane, l1 = l0 + 1;
    const float d0 = l0 < L ? dts[l0] : 0.f, d1 = l1 < L ? dts[l1] : 0.f;
    float cum0, cum1, ec0, ec1, w0, w1, decay;
    {
      const float e0 = d0 * ah, e1 = d1 * ah;
      float incl = e0 + e1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      cum0 = excl + e0;
      cum1 = cum0 + e1;
      ec0 = __expf(cum0);
      ec1 = __expf(cum1);
      w0 = l0 < L ? __expf(last - cum0) * d0 : 0.f;
      w1 = l1 < L ? __expf(last - cum1) * d1 : 0.f;
      decay = __expf(last);
    }
    auto token = [&](float v0, float v1, int l) {  // v of token l
      const float u0 = __shfl_sync(0xffffffffu, v0, l >> 1);
      const float u1 = __shfl_sync(0xffffffffu, v1, l >> 1);
      return (l & 1) ? u1 : u0;
    };

    // y = exp(cum) (C h) + S x. C h, and C B^T in two halves of 32 j
    // (the second only where the warp's rows reach it), from the same C
    // fragments; each half of S goes from its f32 accumulators to bf16 A
    // fragments by k step at once, which keeps 16 accumulators live
    float yacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) yacc[nt][q] = 0.f;
    uint32_t sf[4][4];
    const float cr0 = token(cum0, cum1, r0), cr1 = token(cum0, cum1, r1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sacc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) sacc[nt][q] = 0.f;
      if (rows && (half == 0 || jtiles > 4)) {
#pragma unroll
        for (int k0 = 0; k0 < N; k0 += 16) {
          uint32_t af[4];
          ldsm_x4(ct.addr(i0 + (lane & 7) + 8 * ((lane >> 3) & 1),
                          k0 + 8 * (lane >> 4)), af);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            if (4 * half + 2 * jp < jtiles) {
              uint32_t bf[4];
              ldsm_x4(bt.addr(32 * half + 16 * jp + (lane & 7) +
                                  8 * (lane >> 4),
                              k0 + 8 * ((lane >> 3) & 1)), bf);
              mma_bf16(sacc[2 * jp], af, bf[0], bf[1]);
              mma_bf16(sacc[2 * jp + 1], af, bf[2], bf[3]);
            }
          }
          if (half == 0) mma_p_tiles<P>(yacc, af, ht, k0, lane);
        }
      }
      // S = (C B^T) o exp(min(cum_i - cum_j, 0)) o dt_j below the diagonal
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int nt = 4 * half + t;
        const int src = 4 * nt + c4;  // the lane holding tokens j, j + 1
        const float cj[2] = {__shfl_sync(0xffffffffu, cum0, src),
                             __shfl_sync(0xffffffffu, cum1, src)};
        const float dj[2] = {__shfl_sync(0xffffffffu, d0, src),
                             __shfl_sync(0xffffffffu, d1, src)};
        const int j0 = 8 * nt + 2 * c4;
        float sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = q < 2 ? r0 : r1, j = j0 + (q & 1);
          const float cri = q < 2 ? cr0 : cr1;
          sv[q] = (nt < jtiles && i >= j && i < L)
                      ? sacc[t][q] * __expf(fminf(cri - cj[q & 1], 0.f)) *
                            dj[q & 1]
                      : 0.f;
        }
        sf[nt >> 1][(nt & 1) * 2] = pack_bf16(sv[0], sv[1]);
        sf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(sv[2], sv[3]);
      }
    }
    {
      const float e0 = token(ec0, ec1, r0), e1 = token(ec0, ec1, r1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        yacc[nt][0] *= e0;
        yacc[nt][1] *= e0;
        yacc[nt][2] *= e1;
        yacc[nt][3] *= e1;
      }
    }
    // x of this chunk has landed ((B, dt) of the next may be in flight),
    // and every warp is past C B^T and C h: C of the next chunk loads
    cp_wait_all_but_one();
    __syncthreads();
    if (ci + 1 < nchunks)
      stage_rows<N>(ct, cg, dm.c_ss, t0 + L, L, LP, tid);
    cp_commit();
    if (rows) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (LPC || kk <= warp)
          mma_p_tiles<P>(yacc, sf[kk], xt, 16 * kk, lane);
      // + d x, and out
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * c4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r1 : r0;
          if (r < L) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                xt.p + xt.at(r, col));
            const float v0 = yacc[nt][2 * half] + dh * __low2float(xv);
            const float v1 = yacc[nt][2 * half + 1] + dh * __high2float(xv);
            *reinterpret_cast<__nv_bfloat162*>(
                y + ((bi * dm.seq + t0 + r) * dm.heads + h) * P + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }

    // h <- exp(cum_L) h + (B o w)^T x: state rows 16 (warp + 4 s); B^T's
    // fragments are scaled by w along k and rounded to bf16 in registers
#pragma unroll
    for (int s = 0; s < MS; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) hacc[s][nt][q] *= decay;
    for (int k0 = 0; k0 < LP; k0 += 16) {
      const int src = (k0 >> 1) + c4;  // tokens k0 + 2 c4 (+1), then + 8
      const float wa0 = __shfl_sync(0xffffffffu, w0, src);
      const float wa1 = __shfl_sync(0xffffffffu, w1, src);
      const float wb0 = __shfl_sync(0xffffffffu, w0, src + 4);
      const float wb1 = __shfl_sync(0xffffffffu, w1, src + 4);
      uint32_t af[MS][4];
#pragma unroll
      for (int s = 0; s < MS; ++s) {
        if (16 * (warp + kTcWarps * s) < N) {
          ldsm_x4_t(bt.addr(k0 + (lane & 7) + 8 * (lane >> 4),
                            16 * (warp + kTcWarps * s) +
                                8 * ((lane >> 3) & 1)), af[s]);
          af[s][0] = scale_bf16x2(af[s][0], wa0, wa1);
          af[s][1] = scale_bf16x2(af[s][1], wa0, wa1);
          af[s][2] = scale_bf16x2(af[s][2], wb0, wb1);
          af[s][3] = scale_bf16x2(af[s][3], wb0, wb1);
        }
      }
#pragma unroll
      for (int pp = 0; pp < (P + 15) / 16; ++pp) {
        const bool two = !(P % 16 != 0 && pp == P / 16);
        uint32_t bf[4];
        if (two)
          ldsm_b_kn<true>(xt, k0, 16 * pp, lane, bf);
        else
          ldsm_b_kn<false>(xt, k0, 16 * pp, lane, bf);
#pragma unroll
        for (int s = 0; s < MS; ++s) {
          if (16 * (warp + kTcWarps * s) < N) {
            mma_bf16(hacc[s][2 * pp], af[s], bf[0], bf[1]);
            if (two) mma_bf16(hacc[s][2 * pp + 1], af[s], bf[2], bf[3]);
          }
        }
      }
    }
    // the state's bf16 copy for the next chunk's C h (every read of this
    // one was before the barrier above)
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      const int m0 = 16 * (warp + kTcWarps * s);
      if (m0 < N) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = 8 * nt + 2 * c4;
          *reinterpret_cast<uint32_t*>(ht.p + ht.at(m0 + g8, col)) =
              pack_bf16(hacc[s][nt][0], hacc[s][nt][1]);
          *reinterpret_cast<uint32_t*>(ht.p + ht.at(m0 + g8 + 8, col)) =
              pack_bf16(hacc[s][nt][2], hacc[s][nt][3]);
        }
      }
    }
  }
  // no copy may still be in flight when the block exits
  cp_wait_all();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int N, int P, int LPC>
cudaError_t launch_tc(const void* x, const float* dt, const float* a,
                      const void* b, const void* c, const float* d, void* y,
                      int64_t batch, const Dims& dm, cudaStream_t stream) {
  const int smem = tc_smem_bytes(dm.chunk, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tc_kernel<N, P, LPC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)  // three blocks an SM need the most shared memory
    err = cudaFuncSetAttribute(ssd_scan_tc_kernel<N, P, LPC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(dm.heads),
                  static_cast<unsigned>(batch));
  ssd_scan_tc_kernel<N, P, LPC><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, a,
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), d,
      static_cast<__nv_bfloat16*>(y), dm);
  return cudaGetLastError();
}

// The tensor-core kernel: bf16, N in {16, 32, 64, 128}, P in {8, 16, 32,
// 64}, rows that start on 16-byte boundaries. Returns false (launching
// nothing) for the shapes and views it does not take.
bool launch_tc_if_taken(const void* x, const float* dt, const float* a,
                        const void* b, const void* c, const float* d, void* y,
                        int64_t batch, const Dims& dm, cudaStream_t stream,
                        cudaError_t& err) {
  if (!(aligned16(x) && aligned16(b) && aligned16(c) && dm.x_sb % 8 == 0 &&
        dm.x_ss % 8 == 0 && dm.b_sb % 8 == 0 && dm.b_ss % 8 == 0 &&
        dm.c_sb % 8 == 0 && dm.c_ss % 8 == 0))
    return false;
  if (dm.n == 128 && dm.p == 64 && dm.chunk == 64) {  // mamba2's shapes
    err = launch_tc<128, 64, 64>(x, dt, a, b, c, d, y, batch, dm, stream);
    return true;
  }
#define SSD_TC_CASE(NN, PP)                                               \
  if (dm.n == NN && dm.p == PP) {                                         \
    err = launch_tc<NN, PP, 0>(x, dt, a, b, c, d, y, batch, dm, stream);  \
    return true;                                                          \
  }
#define SSD_TC_N(NN) \
  SSD_TC_CASE(NN, 8) SSD_TC_CASE(NN, 16) SSD_TC_CASE(NN, 32) SSD_TC_CASE(NN, 64)
  SSD_TC_N(16) SSD_TC_N(32) SSD_TC_N(64) SSD_TC_N(128)
#undef SSD_TC_N
#undef SSD_TC_CASE
  return false;
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* b, const void* c, const float* d, void* y,
                   int64_t batch, const Dims& dm, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(smem_floats(dm.chunk, dm.n, dm.p)) *
      sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(dm.heads),
                  static_cast<unsigned>(batch));
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), d, static_cast<T*>(y), dm);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32 x, b, c, y; 1: bfloat16. x (B, S, H, P) and b, c
// (B, S, G, N) with their last two dims packed and the (batch, seq)
// strides given in elements; dt (B, S, H), a and d (H,) contiguous f32;
// y (B, S, H, P) contiguous. S % chunk == 0, chunk at most 64, N and P
// multiples of 4, P at most 64 (N at most 128: the wrapper's limit).
extern "C" int ssd_scan_launch(int64_t dtype, const void* x, const float* dt,
                               const float* a, const void* b, const void* c,
                               const float* d, void* y, int64_t batch,
                               int64_t seq, int64_t heads, int64_t groups,
                               int64_t n, int64_t p, int64_t chunk,
                               int64_t x_sb, int64_t x_ss, int64_t b_sb,
                               int64_t b_ss, int64_t c_sb, int64_t c_ss,
                               cudaStream_t stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || p <= 0) return 0;
  if (groups <= 0 || heads % groups || chunk <= 0 || chunk > kMaxChunk ||
      seq % chunk || n <= 0 || n % 4 || p % 4 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims dm;
  dm.seq = static_cast<int>(seq);
  dm.heads = static_cast<int>(heads);
  dm.groups = static_cast<int>(groups);
  dm.n = static_cast<int>(n);
  dm.p = static_cast<int>(p);
  dm.chunk = static_cast<int>(chunk);
  dm.x_sb = x_sb;
  dm.x_ss = x_ss;
  dm.b_sb = b_sb;
  dm.b_ss = b_ss;
  dm.c_sb = c_sb;
  dm.c_ss = c_ss;
  cudaError_t err = cudaSuccess;
  if (dtype == 1 &&
      launch_tc_if_taken(x, dt, a, b, c, d, y, batch, dm, stream, err))
    return static_cast<int>(err);
  if (dtype == 0)
    err = launch<float>(x, dt, a, b, c, d, y, batch, dm, stream);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, dt, a, b, c, d, y, batch, dm, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
