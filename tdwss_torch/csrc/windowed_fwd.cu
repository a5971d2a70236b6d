// Windowed gather-GEMM forward for Hopper (sm_90a): kernels K1 and K4.
//
// Replaces the Pallas kernels of the reference package
//   K1  tdwss/ops/pallas_subm.py::windowed_matmul_sub (body _sub_fwd_kernel)
//   K4  tdwss/ops/pallas_subm.py::windowed_matmul     (body _win_fwd_kernel)
// and computes what they compute, not how a TPU computes it:
//
//   out[v, :] = sum_a  x[src(v, a), :] @ w[a]          (f32 accumulation)
//   src(v, a) = starts[(v / tile) * nwin + a % nwin]
//             + soff[(v / sub) * nwin + a % nwin]       (K1, sub form only)
//             + rb[a, v]
//
// A local rb[a, v] outside [0, sentinel) (subwin for K1, window for K4),
// or a source outside [0, v_src), contributes nothing.  x is (v_src, c),
// w is (k, c, cout) (here with a row stride ldw >= cout), out is
// (v_out, cout), all in T; rb is addressed through two strides so that
// both the Pallas layout (k, v_out) and a transposed view of a (v_out, k)
// array are read without a copy.  K1 and K4 are one template: the flat
// form passes no soff.
//
// Two bodies; the element type selects one.
//
// * bf16: the tensor-core body described below, fwd_mma_kernel in
//   windowed_mma.cuh (K2's and K6's bf16 dfeats run it too).
// * f32: tdwss::gather_gemm_block (windowed_common.cuh; K2's f32 dfeats
//   runs it too), a 4 x 4 f32 micro-tile per thread on the CUDA cores.  TF32
//   products would break the f32 checks (1e-4 of max|plain|), so f32
//   keeps full-precision FMAs.  Its entry point takes f32 only (the
//   first design ran bf16 on it too; PERF.md keeps its times).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense).  At
// the bench UNet's level 0 (32 -> 32 bf16, V = 786,432 rows, 27 taps)
// the function needs 85 MB of rb (786,432 x 27 int32), 41 MB of distinct
// source rows (637,288 x 64 B) and 50 MB of output: 0.0527 ms of HBM
// time, and 2 x 32 x 32 flop per live (row, tap), ~0.002 ms of tensor
// cores.  Every live (row, tap) still reads its 64-byte source row once
// (~1.4 GB over the 27 taps, mostly from L2), so latency and L2 traffic,
// not flops, set the floor.  The identity unpools (8 taps of 640 x 640
// at Narrow's level 0) are the one place where the products weigh.
//
// What the first design (the f32 body) lost in bf16: products on
// the CUDA cores with 8 shared-memory loads per 16 FMAs; a fixed 64-column
// tile, so Cout = 32 idled half of each block and Cout = 640 re-resolved
// and re-gathered every source row in 10 column blocks; source rows read
// one 2-byte element at a time and widened to f32; one shared stage and
// two barriers per (tap, chunk), so every gather's latency was exposed.
//
// The bf16 body.  A block owns one column tile of N in {32, 64, 128, 256}
// columns, the narrowest that covers Cout (wider Couts take
// ceil(Cout / 256) tiles, the last one masked; the column tiles of a row
// tile are neighbours in the grid), and 128 output rows (16 warps) up to
// N = 64, else 64 rows (8 warps).  It
//   1. resolves src(v, a) of its rows and K taps once, in 32-bit
//      arithmetic, into shared memory: each thread issues the loads of
//      all its entries (local, window start, sub-window offset) before it
//      uses any, with the per-row window indices and the tap's window
//      slot read from small shared tables and e / K done by a multiply;
//      then it compacts the taps that some row uses with a ballot, in tap
//      order (no atomics, so the order of the sum is fixed: K1 and K4
//      give the same bits, and runs repeat);
//   2. walks the reduction as "items", the 8-channel pieces of the used
//      taps' rows in tap order, KI items per step (64 channels up to
//      N = 64, 32 above): a narrow row packs several taps into one step
//      (two at C = 32, eight at the stem's C = 3), which halves the steps
//      and with them the per-step barrier and issue costs that dominate
//      at the narrow levels.  A ring of 4 shared-memory stages holds the
//      steps: the 64 source rows' items are gathered by cp.async, 16
//      bytes per copy, 3 steps in flight (2 at N = 64) while the current
//      one is multiplied; a sentinel row, or an item past the used taps, is
//      zero-filled by the src-size-0 form of the copy, with no branch
//      around it.  Rows whose byte offsets are not 16-byte aligned (C not
//      a multiple of 8: the stem's C = 3) are staged by 2-byte loads and
//      zero-padded to the item instead;
//   3. streams each step's weight rows (8 per item, N columns) into the
//      same stage by cp.async.  Weights kept resident in shared memory
//      for a whole block (all taps of the column tile, 55 KB at the bench
//      level 0) were built and measured on the card: they cost a block
//      per SM and ran slower at the narrow levels, so every shape
//      streams;
//   4. multiplies on the tensor cores with mma.sync m16n8k16 (bf16 in,
//      f32 accumulate); each warp owns 16 rows x N/2 columns, its
//      operands loaded from shared memory by ldmatrix (B transposed).
//      Both operand tiles are stored XOR-swizzled in 16-byte chunks, so
//      the ldmatrix phases and the cp.async writes are free of bank
//      conflicts;
//   5. rounds each f32 sum to bf16 once and stores column pairs.
// Three blocks per SM up to N = 128 (registers capped for it), two at
// N = 256.  mma.sync and not wgmma: the level-0 kernel is bound by
// gathers and per-step costs, so the products only have to leave the
// critical path, and mma.sync's register fragments were checked against
// the plain version at every shape on the first try, where a wrong wgmma
// descriptor or swizzle mode would only show on the card.

#include "windowed_mma.cuh"

namespace {

using tdwss::BM;
using tdwss::BN;
using tdwss::KMAX;
using tdwss::NT;

// --------------------------------------------------------------------------
// f32 body
// --------------------------------------------------------------------------

template <typename T, bool SUB>
__global__ void __launch_bounds__(NT) windowed_fwd_kernel(
    const T* __restrict__ x, int64_t v_src, int c,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ soff,
    const int32_t* __restrict__ rb, int64_t rb_stride_k, int64_t rb_stride_v,
    const T* __restrict__ w, int k, int cout, T* __restrict__ out,
    int64_t v_out, int tile, int nwin, int sub, int sentinel) {
  __shared__ tdwss::GemmSmem sm;
  tdwss::gather_gemm_block<T, SUB>(
      sm, x, v_src, c, starts, soff, rb, rb_stride_k, rb_stride_v, w, k,
      cout, out, v_out, tile, nwin, sub, sentinel,
      static_cast<int64_t>(blockIdx.x) * BM, blockIdx.y * BN);
}

template <typename T>
int launch(const void* x, int64_t v_src, int c, const void* starts,
           const void* soff, const void* rb, int64_t rb_stride_k,
           int64_t rb_stride_v, const void* w, int k, int cout, void* out,
           int64_t v_out, int tile, int nwin, int sub, int sentinel,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((v_out + BM - 1) / BM),
                  static_cast<unsigned>((cout + BN - 1) / BN));
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* so = static_cast<const int32_t*>(soff);
  const int32_t* rp = static_cast<const int32_t*>(rb);
  if (soff != nullptr)
    windowed_fwd_kernel<T, true><<<grid, NT, 0, stream>>>(
        xp, v_src, c, st, so, rp, rb_stride_k, rb_stride_v, wp, k, cout, op,
        v_out, tile, nwin, sub, sentinel);
  else
    windowed_fwd_kernel<T, false><<<grid, NT, 0, stream>>>(
        xp, v_src, c, st, so, rp, rb_stride_k, rb_stride_v, wp, k, cout, op,
        v_out, tile, nwin, sub, sentinel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest tap count the kernels accept.
int tdwss_windowed_fwd_kmax(void) { return KMAX; }

// The CUDA-core body, f32 only.  soff == NULL
// selects the flat form (K4, sentinel = window); otherwise the sub form
// (K1, sentinel = subwin).  Returns cudaGetLastError() after the launch
// (0 on success).
int tdwss_windowed_fwd(const void* x, int64_t v_src, int c,
                       const void* starts, const void* soff, const void* rb,
                       int64_t rb_stride_k, int64_t rb_stride_v,
                       const void* w, int k, int cout, void* out,
                       int64_t v_out, int tile, int nwin, int sub,
                       int sentinel, void* stream) {
  if (v_out == 0 || cout == 0) return 0;
  if (k > KMAX || k <= 0 || nwin <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(x, v_src, c, starts, soff, rb, rb_stride_k,
                       rb_stride_v, w, k, cout, out, v_out, tile, nwin, sub,
                       sentinel, static_cast<cudaStream_t>(stream));
}

// The tensor-core body, bf16 only (tdwss::windowed_fwd_mma in
// windowed_mma.cuh states the contract).  Returns cudaGetLastError() after
// the launch (0 on success).
int tdwss_windowed_fwd_mma(const void* x, int64_t v_src, int c,
                           const void* starts, const void* soff,
                           const void* rb, int64_t rb_stride_k,
                           int64_t rb_stride_v, const void* w, int ldw, int k,
                           int cout, void* out, int64_t v_out, int tile,
                           int nwin, int sub, int sentinel, int n_tile,
                           void* stream) {
  return tdwss::windowed_fwd_mma(x, v_src, c, starts, soff, rb, rb_stride_k,
                                 rb_stride_v, w, ldw, k, cout, out, v_out,
                                 tile, nwin, sub, sentinel, n_tile,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
