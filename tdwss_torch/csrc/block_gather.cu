// Block gather for Hopper (sm_90a): kernel K7.
//
// Replaces the Pallas kernel of the reference package
//   K7  tdwss/ops/experimental/pallas_gather.py::dma_block_gather
//       (body _gather_kernel)
// and computes what it computes, not how a TPU computes it:
//
//   out[i, :] = src[clip(idx[i], 0, n - 1), :]      for i in [0, m)
//
// with src (n, row_bytes) and out (m, row_bytes) seen as bytes, so the
// kernel takes any element type: it copies rows, it does no arithmetic.
// The index is clipped, not masked: an index past either end reads the
// first or last row, as the reference's jnp.clip does.
//
// The TPU kernel keeps 16 asynchronous DMAs of (8, W) tiles in flight
// from one scalar core, 32 blocks per grid step, because the TPU's
// gather issues one slow descriptor per row.  None of that carries over:
// on Hopper every warp is its own issuer.  Design (a first, simple and
// correct kernel): one warp per output row; lane 0 reads and clips the
// row's index once and broadcasts it with a shuffle; the warp copies the
// row with vector loads and stores of V bytes (16 where the row's byte
// size and both pointers allow it, else 8, 4, 2 or 1), neighbouring
// lanes on neighbouring addresses.  Eight warps a block, and a
// grid-stride loop over the rows.
//
// Bound on an H100 SXM (3.35 TB/s): bytes / 3.35e12 with bytes =
// 2 * m * row_bytes + 4 * m (each gathered row read once, each output
// row written once, the index read once); no operations.  The kernel is
// memory-bound by nature.  Rows of the halo-face gather are 4 KiB, long
// enough for whole DRAM bursts; what is left is latency, which enough
// warps in flight hide.
//
// TMA bulk copies were built and measured on an H100 and not kept: one
// elected thread per block issuing cp.async.bulk loads into a ring of
// shared-memory stages (each with an mbarrier) and bulk stores out of it,
// rings of 8 to 32 stages at one to seven blocks per SM, and a split
// into a loading and a storing warp.  At the halo faces the best of them
// ran 0.1211-0.1265 ms against this kernel's 0.1139-0.1198 ms in the
// same runs, and 0.026 ms against 0.017 ms at 64 rows: both designs sit
// at the HBM's practical read + write rate for 4 KiB rows, so bulk copies
// save instructions, not bytes, and their one issuing thread per block
// adds latency.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename V>
__global__ void __launch_bounds__(kThreads) block_gather_kernel(
    const V* __restrict__ src, int64_t n, int64_t row_vecs,
    const int32_t* __restrict__ idx, int64_t m, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       i < m; i += warps) {
    int64_t j = 0;
    if (lane == 0) {
      j = idx[i];
      j = j < 0 ? 0 : (j >= n ? n - 1 : j);
    }
    j = __shfl_sync(0xffffffffu, j, 0);
    const V* s = src + j * row_vecs;
    V* d = out + i * row_vecs;
#pragma unroll 4
    for (int64_t t = lane; t < row_vecs; t += 32) d[t] = s[t];
  }
}

template <typename V>
int launch(const void* src, int64_t n, int64_t row_bytes, const void* idx,
           int64_t m, void* out, cudaStream_t stream) {
  int64_t blocks = (m + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  block_gather_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const V*>(src), n,
      row_bytes / static_cast<int64_t>(sizeof(V)),
      static_cast<const int32_t*>(idx), m, static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src (n, row_bytes) and out (m, row_bytes), idx (m,) int32, all on the
// device.  vec_bytes (16, 8, 4, 2 or 1) must divide row_bytes and both
// pointers' addresses; the caller picks it.  Returns cudaGetLastError()
// after the launch (0 on success; nothing is launched when m or
// row_bytes is 0).
int tdwss_block_gather(const void* src, int64_t n, int64_t row_bytes,
                       const void* idx, int64_t m, void* out, int vec_bytes,
                       void* stream) {
  if (m == 0 || row_bytes == 0) return 0;
  if (n <= 0 || vec_bytes <= 0 || row_bytes % vec_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch<uint4>(src, n, row_bytes, idx, m, out, s);
    case 8: return launch<uint2>(src, n, row_bytes, idx, m, out, s);
    case 4: return launch<uint32_t>(src, n, row_bytes, idx, m, out, s);
    case 2: return launch<uint16_t>(src, n, row_bytes, idx, m, out, s);
    case 1: return launch<uint8_t>(src, n, row_bytes, idx, m, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
