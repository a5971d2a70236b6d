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
// A local rb[a, v] >= sentinel (subwin for K1, window for K4) contributes
// nothing.  x is (v_src, c) in T, w is (k, c, cout) in T, out is
// (v_out, cout) in T; rb is addressed through two strides so that both
// the Pallas layout (k, v_out) and a transposed view of a (v_out, k)
// array are read without a copy.
//
// Design (a first, simple and correct kernel).  One block owns BM = 64
// output rows and BN = 64 output columns.  It resolves the source row of
// every (tap, row) itself into shared memory from its starts, offsets and
// locals, skips a tap that no row of the block uses, gathers the BM
// source rows of a tap KC channels at a time into shared memory, stages
// the matching KC x BN slice of w[a], and accumulates a 4 x 4 micro-tile
// per thread in f32 registers on the CUDA cores (the block body,
// tdwss::gather_gemm_block, lives in windowed_common.cuh: K2's dfeats
// runs it too).  The TPU's one-hot matmul, lane packing and window DMAs
// have no counterpart: on Hopper a gather is a gather.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the larger of
//   bytes / 3.35e12  with bytes = distinct source rows * c * sizeof(T)
//       + rb + starts + offsets (4 B each) + w + out
//   2 * (valid entries) * c * cout / 989e12.
// At the bench widths (c, cout <= 448) both terms are tens of
// microseconds and the bytes term dominates: the kernel is memory-bound
// in principle.  This version reads w once per block from L2 and runs
// its products on the CUDA cores, so it is compute-bound far above that
// bound; moving the inner product to wgmma and the gathers to
// cp.async/TMA pipelines is the work of a later change.

#include "windowed_common.cuh"

namespace {

using tdwss::BM;
using tdwss::BN;
using tdwss::KMAX;
using tdwss::NT;

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

// Largest tap count the kernel accepts.
int tdwss_windowed_fwd_kmax(void) { return KMAX; }

// dtype: 0 = float32, 1 = bfloat16.  soff == NULL selects the flat form
// (K4, sentinel = window); otherwise the sub form (K1, sentinel = subwin).
// Returns cudaGetLastError() after the launch (0 on success).
int tdwss_windowed_fwd(const void* x, int64_t v_src, int c,
                       const void* starts, const void* soff, const void* rb,
                       int64_t rb_stride_k, int64_t rb_stride_v,
                       const void* w, int k, int cout, void* out,
                       int64_t v_out, int tile, int nwin, int sub,
                       int sentinel, int dtype, void* stream) {
  if (v_out == 0 || cout == 0) return 0;
  if (k > KMAX || k <= 0 || nwin <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, v_src, c, starts, soff, rb, rb_stride_k,
                         rb_stride_v, w, k, cout, out, v_out, tile, nwin,
                         sub, sentinel, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, v_src, c, starts, soff, rb, rb_stride_k,
                                 rb_stride_v, w, k, cout, out, v_out, tile,
                                 nwin, sub, sentinel, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
