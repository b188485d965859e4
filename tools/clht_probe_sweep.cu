// A trial build of kernel A (src/repro_torch/csrc/clht_probe.cu) with its
// launch shape as arguments, for tools/ab_kernels.py's sweep: each warp
// takes KPP groups of 32 keys a pass (1, 2, 4 or 8) and issues all their
// key and bucket-id loads, then all their line loads, before it compares;
// a block has `threads` threads. At KPP 1 it is the shipped kernel. Not
// part of the package.
#include "clht_common.cuh"

namespace {

template <int KPP>
__global__ void clht_probe_kernel(const int32_t* __restrict__ lines,
                                  int64_t total,
                                  const int32_t* __restrict__ bucket_ids,
                                  const int32_t* __restrict__ keys, int64_t n,
                                  int32_t* __restrict__ ptrs,
                                  int32_t* __restrict__ found) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int half = lane & 1;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int4* line4 = reinterpret_cast<const int4*>(lines);
  // every thread runs the same passes, so the shuffles see full warps
  for (int64_t base = 0; base < n; base += warps * 32 * KPP) {
    int64_t idx[KPP];
    int32_t key[KPP], bid[KPP];
#pragma unroll
    for (int j = 0; j < KPP; ++j) {
      idx[j] = base + (j * warps + warp) * 32 + lane;
      key[j] = dinomo::EMPTY;
      bid[j] = 0;
      if (idx[j] < n) {
        key[j] = __ldg(keys + idx[j]);
        bid[j] = __ldg(bucket_ids + idx[j]);
      }
    }
    // the pair (2p, 2p + 1) reads the lines of keys p and p + 16
    int4 h[KPP][2];
#pragma unroll
    for (int j = 0; j < KPP; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int32_t b =
            __shfl_sync(kAll, bid[j], (lane >> 1) + 16 * r);
        h[j][r] = __ldg(line4 + dinomo::clamp_row(b, total) * 2 + half);
      }
#pragma unroll
    for (int j = 0; j < KPP; ++j) {
      int32_t mine = dinomo::EMPTY;
      int hit_mine = 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int32_t k = __shfl_sync(kAll, key[j], (lane >> 1) + 16 * r);
        // the even lane receives lanes 4 and 5 of the line
        const int32_t p1 = __shfl_xor_sync(kAll, h[j][r].x, 1);
        const int32_t p2 = __shfl_xor_sync(kAll, h[j][r].y, 1);
        const bool h0 = k >= 0 && h[j][r].x == k;
        const bool h1 = k >= 0 && h[j][r].y == k;
        const bool h2 = k >= 0 && h[j][r].z == k;
        const uint32_t sum = (h0 ? static_cast<uint32_t>(h[j][r].w) : 0u) +
                             (h1 ? static_cast<uint32_t>(p1) : 0u) +
                             (h2 ? static_cast<uint32_t>(p2) : 0u);
        const int hit = h0 || h1 || h2;
        // lane q of the half r takes the even lane 2q's result
        const int from = 2 * (lane & 15);
        const int32_t got = __shfl_sync(kAll, static_cast<int32_t>(sum),
                                        from);
        const int got_hit = __shfl_sync(kAll, hit, from);
        if ((lane >> 4) == r) {
          mine = got_hit ? got : dinomo::EMPTY;
          hit_mine = got_hit;
        }
      }
      if (idx[j] < n) {
        ptrs[idx[j]] = mine;
        found[idx[j]] = hit_mine;
      }
    }
  }
}

template <int KPP>
int launch_probe(const int32_t* lines, int64_t total,
                 const int32_t* bucket_ids, const int32_t* keys, int64_t n,
                 int32_t* ptrs, int32_t* found, int threads,
                 cudaStream_t stream) {
  // blocks the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, clht_probe_kernel<KPP>, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  const int64_t per_block = static_cast<int64_t>(threads) * KPP;
  const int64_t need = (n + per_block - 1) / per_block;
  const unsigned blocks =
      static_cast<unsigned>(need < cap ? need : static_cast<int64_t>(cap));
  clht_probe_kernel<KPP><<<blocks, threads, 0, stream>>>(
      lines, total, bucket_ids, keys, n, ptrs, found);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int clht_probe_sweep_launch(const int32_t* lines, int64_t total,
                                       const int32_t* bucket_ids,
                                       const int32_t* keys, int64_t n,
                                       int32_t* ptrs, int32_t* found,
                                       int64_t keys_per_thread,
                                       int64_t threads, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (threads < 64 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t = static_cast<int>(threads);
  switch (keys_per_thread) {
    case 1:
      return launch_probe<1>(lines, total, bucket_ids, keys, n, ptrs, found,
                             t, stream);
    case 2:
      return launch_probe<2>(lines, total, bucket_ids, keys, n, ptrs, found,
                             t, stream);
    case 4:
      return launch_probe<4>(lines, total, bucket_ids, keys, n, ptrs, found,
                             t, stream);
    case 8:
      return launch_probe<8>(lines, total, bucket_ids, keys, n, ptrs, found,
                             t, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
