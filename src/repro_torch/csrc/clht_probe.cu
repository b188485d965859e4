// Kernels A and B of the DPM read path.
//
// A. clht_probe replaces the Pallas kernel
//    src/repro/kernels/clht_probe/clht_probe.py:clht_probe (_probe_kernel):
//    for each key, (ptr, found) of a match in its primary bucket line
//    only. The line is one 32-byte sector: lanes 0-3 hold the slot keys
//    and slot 0's pointer, lanes 4-7 slots 1-2's pointers, the chain link
//    and the pad. The pointer returned is the sum of the matching slots'
//    pointers (wrapping in 32 bits), as the plain version computes it; a
//    table built by the inserts holds a key at most once, so that is the
//    one match. A negative key never matches; a bucket id out of range
//    clamps into the table.
//    Bound on an H100 SXM: bytes. Per key 4 B key + 4 B bucket id read,
//    4 B ptr + 4 B found written, plus one 32-byte sector per distinct
//    bucket touched, over 3.35 TB/s. The sectors are scattered over the
//    table, and scattered 32-byte reads do not reach that rate. What the
//    design does about it:
//    - keys, bucket ids and results move one per lane, 32 to a warp
//      instruction (128 coalesced bytes);
//    - each line is read by a pair of neighbouring lanes, one 16-byte
//      half each, through the read-only path, so a warp's load asks for
//      16 lines as 16 whole sectors, one request each: the pair of lanes
//      2p, 2p+1 reads the lines of the warp's keys p and p + 16, whose
//      bucket ids and keys come to it by shuffles; two more shuffles
//      bring slots 1-2's pointers to the even lane, which compares, and
//      one round of shuffles hands each result to the lane that owns the
//      key;
//    - the grid is at most the blocks of 256 threads the card holds at
//      once, and walks the batch in passes of 32 keys a warp: no tail
//      wave on part of the card. (A sweep of 1-8 keys a lane a pass and
//      64-1024 threads a block, tools/clht_probe_sweep.cu, found nothing
//      faster.)
//
// B. kvs_lookup_fused replaces the Pallas kernel
//    src/repro/kernels/clht_probe/clht_probe.py:kvs_lookup_fused
//    (_kvs_lookup_kernel): the same probe plus the gather of the value row
//    from the heap in the same kernel, zero rows where absent. One warp
//    per key: every lane reads the (broadcast) line, then the lanes copy
//    the row as 16-byte vectors, neighbouring lanes on neighbouring
//    addresses. Bound: bytes, per key the probe's bytes plus the value row
//    read once per distinct row found and written once (1 KB each at the
//    main path's width of 256 int32).
#include <atomic>

#include "clht_common.cuh"

namespace {

using dinomo::LINE;

constexpr int kProbeThreads = 256;
constexpr int kMaxDevices = 64;

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
  for (int64_t base = 0; base < n; base += warps * 32) {
    const int64_t idx = base + warp * 32 + lane;
    int32_t key = dinomo::EMPTY, bid = 0;
    if (idx < n) {
      key = __ldg(keys + idx);
      bid = __ldg(bucket_ids + idx);
    }
    // the pair (2p, 2p + 1) reads the lines of keys p and p + 16
    int4 h[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int32_t b = __shfl_sync(kAll, bid, (lane >> 1) + 16 * r);
      h[r] = __ldg(line4 + dinomo::clamp_row(b, total) * 2 + half);
    }
    int32_t mine = dinomo::EMPTY;
    int hit_mine = 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int32_t k = __shfl_sync(kAll, key, (lane >> 1) + 16 * r);
      // the even lane receives lanes 4 and 5 of the line
      const int32_t p1 = __shfl_xor_sync(kAll, h[r].x, 1);
      const int32_t p2 = __shfl_xor_sync(kAll, h[r].y, 1);
      const bool h0 = k >= 0 && h[r].x == k;
      const bool h1 = k >= 0 && h[r].y == k;
      const bool h2 = k >= 0 && h[r].z == k;
      const uint32_t sum = (h0 ? static_cast<uint32_t>(h[r].w) : 0u) +
                           (h1 ? static_cast<uint32_t>(p1) : 0u) +
                           (h2 ? static_cast<uint32_t>(p2) : 0u);
      const int hit = h0 || h1 || h2;
      // lane q of the half r takes the even lane 2q's result
      const int from = 2 * (lane & 15);
      const int32_t got = __shfl_sync(kAll, static_cast<int32_t>(sum), from);
      const int got_hit = __shfl_sync(kAll, hit, from);
      if ((lane >> 4) == r) {
        mine = got_hit ? got : dinomo::EMPTY;
        hit_mine = got_hit;
      }
    }
    if (idx < n) {
      ptrs[idx] = mine;
      found[idx] = hit_mine;
    }
  }
}

// blocks of kProbeThreads the device holds at once, asked once per device
cudaError_t probe_grid_cap(int dev, int* cap) {
  static std::atomic<int> resident[kMaxDevices];
  if (dev >= 0 && dev < kMaxDevices) {
    *cap = resident[dev].load(std::memory_order_relaxed);
    if (*cap > 0) return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, clht_probe_kernel, kProbeThreads, 0);
  if (err != cudaSuccess) return err;
  *cap = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kMaxDevices)
    resident[dev].store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

constexpr int kWarpsPerBlock = 8;

__global__ void kvs_lookup_kernel(const int32_t* __restrict__ lines,
                                  int64_t total,
                                  const int32_t* __restrict__ heap,
                                  int64_t heap_rows, int64_t width, bool vec,
                                  const int32_t* __restrict__ bucket_ids,
                                  const int32_t* __restrict__ keys, int64_t n,
                                  int32_t* __restrict__ vals,
                                  int32_t* __restrict__ ptrs,
                                  int32_t* __restrict__ found) {
  const int lane = threadIdx.x & 31;
  const int64_t i = blockIdx.x * static_cast<int64_t>(kWarpsPerBlock) +
                    (threadIdx.x >> 5);
  if (i >= n) return;
  int32_t v[LINE];
  dinomo::load_line(lines, dinomo::clamp_row(bucket_ids[i], total), v);
  const int s = dinomo::probe_line(v, keys[i]);
  const int32_t ptr = s >= 0 ? dinomo::slot_ptr(v, s) : dinomo::EMPTY;
  if (lane == 0) {
    ptrs[i] = ptr;
    found[i] = s >= 0;
  }
  // rows of absent keys (and of a stored negative pointer, as in the
  // Pallas kernel) are zero; a pointer past the heap reads its last row,
  // as the JAX gather clamps
  const bool take = ptr >= 0;
  const int32_t* src = heap + dinomo::clamp_row(ptr, heap_rows) * width;
  int32_t* dst = vals + i * width;
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int64_t w4 = width >> 2;
    for (int64_t j = lane; j < w4; j += 32)
      d4[j] = take ? __ldg(s4 + j) : make_int4(0, 0, 0, 0);
  } else {
    for (int64_t j = lane; j < width; j += 32) dst[j] = take ? src[j] : 0;
  }
}

}  // namespace

extern "C" int clht_probe_launch(const int32_t* lines, int64_t total,
                                 const int32_t* bucket_ids,
                                 const int32_t* keys, int64_t n,
                                 int32_t* ptrs, int32_t* found,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = probe_grid_cap(dev, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (n + kProbeThreads - 1) / kProbeThreads;
  const unsigned blocks =
      static_cast<unsigned>(need < cap ? need : static_cast<int64_t>(cap));
  clht_probe_kernel<<<blocks, kProbeThreads, 0, stream>>>(
      lines, total, bucket_ids, keys, n, ptrs, found);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kvs_lookup_fused_launch(const int32_t* lines, int64_t total,
                                       const int32_t* heap, int64_t heap_rows,
                                       int64_t width,
                                       const int32_t* bucket_ids,
                                       const int32_t* keys, int64_t n,
                                       int32_t* vals, int32_t* ptrs,
                                       int32_t* found, cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  // 16-byte row copies need 16-byte aligned rows
  const bool vec = (width & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(heap) |
                     reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
  kvs_lookup_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      lines, total, heap, heap_rows, width, vec, bucket_ids, keys, n, vals,
      ptrs, found);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dinomo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
