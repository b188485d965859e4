// Kernel 4: the planned cache-transition space machine.
//
// Replaces the Pallas kernel
// src/repro/kernels/cache_transition/cache_transition.py:cache_transition
// (_transition_kernel), the device twin of the host planner
// core/transition.py:plan_dac_window. Per op row (code, rm, vb, zhit,
// zfill) it decides an Eq. 1 fast-path promote or a fill's value-vs-shortcut
// class against the running occupancy u, and makes space by consuming a
// frozen queue of LRU victims, of which only the final one of a make-space
// may re-insert as a 32-byte shortcut. Outputs per op: dec, victims
// consumed so far, u after the op.
//
// Every op depends on the (u, z, victim cursor) the ops before it leave,
// and the make-space loop is not associative, so one thread carries that
// state in registers over the whole window (the TPU walked blocks of ops
// in order with it in SMEM). The block's 256 threads only move data: they
// stage each tile of 256 rows into shared memory with 16-byte loads,
// neighbouring threads on neighbouring addresses, and write the tile's
// outputs back the same way. The victim queue is read monotonically by
// the scanning thread.
//
// Arithmetic is 64-bit, so nothing wraps; the wrapper refuses a capacity
// whose largest insert would not fit the int32 outputs. n_evict rounds
// toward -inf, as the reference's // does (C++ / truncates toward zero).
//
// Bound on an H100 SXM: latency, not bytes or operations. Per op 32 B of
// row read and 12 B of outputs written, plus 4 B per victim consumed, over
// 3.35 TB/s: about 0.007 us for a 512-op window. One thread runs the
// dependent scan: on an H100 SXM (700 W) its loop takes about 137 ns an
// op even over neutral rows, so a 512-op window (about 79 us) costs far
// more than its launch.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;            // rows staged per step; block size
constexpr int64_t kShortcut = 32;     // SHORTCUT_BYTES

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(kTile)
    cache_transition_kernel(const int4* __restrict__ ops, int64_t n,
                            const int32_t* __restrict__ victims, int64_t nv,
                            int64_t used0, int64_t z0, int64_t cap,
                            int32_t* __restrict__ dec,
                            int32_t* __restrict__ nvic,
                            int32_t* __restrict__ used) {
  // one row is 8 int32 lanes = two int4: (code, rm, vb, zhit), (zfill, -)
  __shared__ int4 rows[2 * kTile];
  __shared__ int32_t out_dec[kTile];
  __shared__ int32_t out_nvic[kTile];
  __shared__ int32_t out_used[kTile];
  int64_t u = used0, z = z0, vi = 0;  // live in thread 0 only
  for (int64_t base = 0; base < n; base += kTile) {
    const int count =
        n - base < kTile ? static_cast<int>(n - base) : kTile;
    for (int i = threadIdx.x; i < 2 * count; i += blockDim.x) {
      rows[i] = ops[2 * base + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < count; ++j) {
        const int4 r = rows[2 * j];
        const int64_t code = r.x, rm = r.y, vb = r.z;
        int64_t ins = 0;
        int32_t d = 0;
        if (code == 1) {                       // promote (Eq. 1)
          z -= r.w;
          const int64_t room = cap - u;
          const int64_t need = vb - kShortcut;
          if (room >= need || z >= -floor_div(room - need, kShortcut)) {
            d = 1;
            u -= kShortcut;
            ins = vb;
          }
        } else if (code == 2) {                // fill
          u -= rm;
          if (u + vb <= cap) {
            d = 1;
            ins = vb;
          } else {
            z += rows[2 * j + 1].x;            // zfill
            ins = kShortcut;
          }
        } else if (code == 3) {                // delete
          u -= rm;
        }
        while (u + ins > cap && vi < nv) {     // make space
          u -= victims[vi];
          ++vi;
          if (u + kShortcut + ins <= cap) u += kShortcut;
        }
        u += ins;
        out_dec[j] = d;
        out_nvic[j] = static_cast<int32_t>(vi);
        out_used[j] = static_cast<int32_t>(u);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      dec[base + i] = out_dec[i];
      nvic[base + i] = out_nvic[i];
      used[base + i] = out_used[i];
    }
    __syncthreads();                           // the tile is free again
  }
}

}  // namespace

extern "C" int cache_transition_launch(const int32_t* ops, int64_t n,
                                       const int32_t* victims, int64_t nv,
                                       int64_t used0, int64_t z0, int64_t cap,
                                       int32_t* dec, int32_t* nvic,
                                       int32_t* used, cudaStream_t stream) {
  if (n <= 0) return 0;
  cache_transition_kernel<<<1, kTile, 0, stream>>>(
      reinterpret_cast<const int4*>(ops), n, victims, nv, used0, z0, cap, dec,
      nvic, used);
  return static_cast<int>(cudaGetLastError());
}
