// Kernels A and B of the DPM read path.
//
// A. clht_probe replaces the Pallas kernel
//    src/repro/kernels/clht_probe/clht_probe.py:clht_probe (_probe_kernel):
//    one thread per key reads the key's primary bucket line (one 32-byte
//    sector) and returns (ptr, found) for a match in that line only.
//    Bound on an H100 SXM: bytes. Per key 4 B key + 4 B bucket id read,
//    4 B ptr + 4 B found written, plus one 32-byte sector per distinct
//    bucket touched, over 3.35 TB/s. The sector read is random, so the
//    design issues it as two 16-byte loads from one thread and keeps
//    every other access coalesced.
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
#include "clht_common.cuh"

namespace {

using dinomo::LINE;

__global__ void clht_probe_kernel(const int32_t* __restrict__ lines,
                                  int64_t total,
                                  const int32_t* __restrict__ bucket_ids,
                                  const int32_t* __restrict__ keys, int64_t n,
                                  int32_t* __restrict__ ptrs,
                                  int32_t* __restrict__ found) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int32_t v[LINE];
  dinomo::load_line(lines, dinomo::clamp_row(bucket_ids[i], total), v);
  const int s = dinomo::probe_line(v, keys[i]);
  ptrs[i] = s >= 0 ? dinomo::slot_ptr(v, s) : dinomo::EMPTY;
  found[i] = s >= 0;
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
  constexpr int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  clht_probe_kernel<<<blocks, threads, 0, stream>>>(lines, total, bucket_ids,
                                                    keys, n, ptrs, found);
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
