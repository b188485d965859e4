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
// (N, P) state in VMEM scratch. Here one block owns one (b, h) and
// loops over the chunks itself, with the state in shared memory for the
// whole sequence. Per chunk it stages x, B and C as f32 in shared
// memory (B and C rows padded to N + 1 floats: conflict-free column
// reads), warp 0 scans dt.a, and the three products run on the CUDA
// cores in f32, each thread computing 4 x 4 outputs from shared memory:
// C B^T (tiles wholly above the diagonal skipped), S x + C h (S x only up
// to the diagonal), and the state update. Group g = h / (H / G) is read
// for B and C, so with G = 1 every head reads the same rows (from L2).
//
// Bound on an H100 SXM: bytes. The function needs, per (b, h, chunk),
// L (L + 1) P FLOP for S x (the lower triangle with its diagonal) and
// 4 L N P for C h and the state update, and per (b, group, chunk)
// L (L + 1) N for C B^T, which the heads of a group share: 2.36 MFLOP a
// head at L 64, N 128, P 64. At mamba2-2.7b's prefill (4 x 2048 tokens,
// 80 heads, G 1) that is 24.3 GFLOP, 0.049 ms at the TF32 tensor rate,
// under the 0.052 ms that its 174.6 MB of x, y, B, C and dt take at the
// memory rate. This first version does more: it recomputes C B^T for
// every head (skipping only the 4 x 4 tiles above the diagonal) on the
// f32 CUDA cores (67 TFLOP/s). Shared memory for L 64, N 128, P 64 is
// 132.6 KB, so one block runs per SM; the grid of 4 x 80 blocks is 2.4
// waves on 132 SMs. Tensor cores and sharing
// C B^T across the heads of a group are left for later.
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
// multiples of 4, P at most 64.
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
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, dt, a, b, c, d, y, batch, dm, stream);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, dt, a, b, c, d, y, batch, dm, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
