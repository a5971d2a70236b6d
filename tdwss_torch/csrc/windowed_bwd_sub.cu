// Fused windowed backward of a 27-tap submanifold conv for Hopper
// (sm_90a): kernel K6.
//
// Replaces the Pallas kernel of the reference package
//   K6  tdwss/ops/pallas_subm.py::windowed_bwd_sub (_sub_bwd_kernel)
// and computes what it computes, with src(v, a) as in windowed_common.cuh
// (sub form, sentinel = subwin):
//
//   dfeats[v] = sum_a dout[src(v, a)] @ wt[a]          (in T)
//   dW[a]     = sum_v feats[src(v, a)]^T (x) dout[v]   f32
//
// with wt[a] = W[k - 1 - a]^T (k, cout, cin).  The reference reads one
// lane-padded concat [feats | dout] per window and a zero-padded wt; here
// feats and dout stay apart and dW is (k, cin, cout).  feats, dout and wt
// are in T (f32 or bf16); every product is accumulated in f32.
//
// Two bodies; the element type selects one, and the caller names the
// tiles (tdwss_torch/ops/windowed.py, bwd_tile).
//
// * bf16, the tensor-core body (windowed_mma.cuh), two launches and the
//   reduction:
//   - dfeats is K1's function with the cotangent as the gathered source
//     and wt as the weights: K1's body, fwd_mma_kernel<N>, whose output
//     tile stays in registers over all taps and is rounded once (Cin up to
//     384 takes column tiles of 256, the last one masked);
//   - dW runs dw_mma_kernel with feats gathered and the cotangent dense:
//     per block a chunk of rows and a TM x TN tile of (Cin, Cout) in
//     {32, 64}^2, live entries ballot-compacted per tap and 128 rows,
//     16-byte cp.async gathers into a two-stage ring, mma.sync from
//     ldmatrix.trans fragments;
//   - reduce_partials sums the per-chunk partials in chunk order (no
//     atomics: both results repeat bit for bit).
//   Each product resolves the sources itself; a fused form sharing them
//   was not built.
// * f32, the first design on the CUDA cores (TF32 would break the f32
//   checks, 1e-4 of max|plain|): one block per (chunk of output rows, 32
//   input channels), every output channel in slabs of up to 256; for each
//   tap the chunk's live (row v, source s) entries are compacted in row
//   order and each serves both products: the dW tile in f32 registers,
//   and dfeats added into row v of dfeats itself, which is the f32
//   accumulator (the rows of a chunk and its 32 columns belong to one
//   block, so the adds need no atomics and run in a fixed order).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the larger of
//   bytes / 3.35e12 with bytes = each distinct gathered feats row, each
//       dout row that is gathered or has a live entry, rb, starts,
//       offsets, wt, dfeats and dW once, and
//   2 products * 2 * (live entries) * cin * cout / 989e12.
// At the deep UNet levels (384 -> 192) the operations term bounds it; at
// Narrow's 256 -> 256 the bytes.  What the first design lost in bf16
// (2.62 ms at the UNet's 384 -> 192, 11.40 ms at Narrow's 256 -> 256):
// both products on the CUDA cores from 2-byte loads widened to f32, the
// dfeats sum read and written in device memory once per live entry (an
// f32 scratch of V_out x Cin and a pass converting it), and wt[a]
// re-staged for every tap and every 256-column slab.

#include "windowed_mma.cuh"

namespace {

using tdwss::NT;

constexpr int TM = 32;   // input channels per block
constexpr int BK = 32;   // live entries per shared stage

template <int SLAB>
struct SubSmem {
  int32_t lrow[NT];      // source row s of each compacted entry
  int32_t rrow[NT];      // its output row v
  int warp_n[NT / 32];
  float l[BK][TM];       // feats[s, c0 + cc]
  float r[BK][SLAB];     // dout[v, o0 + o]
  float g[BK][SLAB];     // dout[s, o0 + o]
  float wt[SLAB][TM];    // wt[a][o0 + o][c0 + cc]
};

template <typename T, int SLAB>
__global__ void __launch_bounds__(NT) windowed_bwd_sub_kernel(
    const T* __restrict__ feats, const T* __restrict__ dout, int64_t v_src,
    int cin, int cout, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ soff, const int32_t* __restrict__ rb,
    int64_t rsk, int64_t rsv, int k, const T* __restrict__ wt,
    float* __restrict__ dx, int64_t v_out, int tile, int nwin, int sub,
    int sentinel, int64_t rows, int ct, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SubSmem<SLAB>& sm = *reinterpret_cast<SubSmem<SLAB>*>(smem_raw);
  constexpr int MI = TM / 16;
  constexpr int MJ = SLAB / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int chunk = blockIdx.x / ct;
  const int c0 = (blockIdx.x % ct) * TM;
  const int64_t r0 = chunk * rows;
  const int64_t r1 = r0 + rows < v_out ? r0 + rows : v_out;
  float* pchunk = part + static_cast<int64_t>(chunk) * k * cin * cout;

  for (int o0 = 0; o0 < cout; o0 += SLAB) {
    const int olim = min(SLAB, cout - o0);
    for (int a = 0; a < k; ++a) {
      // wt[a][o0 : o0 + SLAB, c0 : c0 + TM] for the dfeats product; read
      // after the first barrier below
      if (dx != nullptr) {
        const T* wa = wt + static_cast<int64_t>(a) * cout * cin;
        for (int e = tid; e < SLAB * TM; e += NT) {
          const int o = e / TM;
          const int cc = e % TM;
          float val = 0.f;
          if (o < olim && c0 + cc < cin)
            val = tdwss::to_f(wa[static_cast<int64_t>(o0 + o) * cin + c0 + cc]);
          sm.wt[o][cc] = val;
        }
      }
      float acc[MI][MJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;

      for (int64_t seg = r0; seg < r1; seg += NT) {
        // 1. live entries of this segment, compacted in row order; the
        //    source row is resolved here, once for both products
        const int64_t v = seg + tid;
        int32_t s = -1;
        if (v < r1)
          s = tdwss::source_row<true>(starts, soff, rb[a * rsk + v * rsv], v,
                                      a, tile, nwin, sub, sentinel, v_src);
        const bool live = s >= 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, live);
        if (lane == 0) sm.warp_n[warp] = __popc(ballot);
        __syncthreads();
        int off = 0, total = 0;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) {
          const int n = sm.warp_n[w];
          off += w < warp ? n : 0;
          total += n;
        }
        if (live) {
          const int idx = off + __popc(ballot & ((1u << lane) - 1u));
          sm.lrow[idx] = s;
          sm.rrow[idx] = static_cast<int32_t>(v);
        }
        __syncthreads();

        // 2. BK entries at a time: stage the gathered and dense rows
        for (int b0 = 0; b0 < total; b0 += BK) {
          const int nb = min(BK, total - b0);
          for (int e = tid; e < BK * TM; e += NT) {
            const int kk = e / TM;
            const int cc = e % TM;
            float val = 0.f;
            if (kk < nb && c0 + cc < cin)
              val = tdwss::to_f(
                  feats[static_cast<int64_t>(sm.lrow[b0 + kk]) * cin + c0 + cc]);
            sm.l[kk][cc] = val;
          }
          for (int e = tid; e < BK * SLAB; e += NT) {
            const int kk = e / SLAB;
            const int o = e % SLAB;
            float rv = 0.f, gv = 0.f;
            if (kk < nb && o < olim) {
              rv = tdwss::to_f(
                  dout[static_cast<int64_t>(sm.rrow[b0 + kk]) * cout + o0 + o]);
              gv = tdwss::to_f(
                  dout[static_cast<int64_t>(sm.lrow[b0 + kk]) * cout + o0 + o]);
            }
            sm.r[kk][o] = rv;
            sm.g[kk][o] = gv;
          }
          __syncthreads();

          // 3a. dW tile: acc[c][o] += feats[s, c] * dout[v, o]
          for (int kk = 0; kk < nb; ++kk) {
            float lv[MI], rv[MJ];
#pragma unroll
            for (int i = 0; i < MI; ++i) lv[i] = sm.l[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < MJ; ++j) rv[j] = sm.r[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
              for (int j = 0; j < MJ; ++j)
                acc[i][j] = fmaf(lv[i], rv[j], acc[i][j]);
          }
          // 3b. dfeats: row v, columns c0..c0+TM, += dout[s, :] @ wt[a]
          if (dx != nullptr) {
            for (int e = tid; e < nb * TM; e += NT) {
              const int kk = e / TM;
              const int cc = e % TM;
              if (c0 + cc >= cin) continue;
              float sum = 0.f;
              for (int o = 0; o < olim; ++o)
                sum = fmaf(sm.g[kk][o], sm.wt[o][cc], sum);
              dx[static_cast<int64_t>(sm.rrow[b0 + kk]) * cin + c0 + cc] += sum;
            }
          }
          __syncthreads();
        }
      }

      // 4. this chunk's partial of dW[a] (zeros where no entry was live)
      float* pa = pchunk + static_cast<int64_t>(a) * cin * cout;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int c = c0 + ty + 16 * i;
        if (c >= cin) continue;
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          const int o = tx + 16 * j;
          if (o < olim) pa[static_cast<int64_t>(c) * cout + o0 + o] = acc[i][j];
        }
      }
      __syncthreads();      // sm.wt is restaged for the next tap
    }
  }
}

// The f32 body: dfeats (f32, NULL skips it) is its own accumulator.
template <int SLAB>
int launch_f32(const void* feats, const void* dout, int64_t v_src, int cin,
               int cout, const void* starts, const void* soff, const void* rb,
               int64_t rsk, int64_t rsv, int k, const void* wt, float* dx,
               int64_t v_out, int tile, int nwin, int sub, int sentinel,
               int nchunk, float* part, float* dw, cudaStream_t stream) {
  auto kernel = windowed_bwd_sub_kernel<float, SLAB>;
  const int smem = static_cast<int>(sizeof(SubSmem<SLAB>));
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  if (dx != nullptr) {
    err = static_cast<int>(cudaMemsetAsync(
        dx, 0, static_cast<size_t>(v_out) * cin * sizeof(float), stream));
    if (err != 0) return err;
  }
  const int ct = (cin + TM - 1) / TM;
  const int64_t rows = (v_out + nchunk - 1) / nchunk;
  kernel<<<static_cast<unsigned>(nchunk) * ct, NT, smem, stream>>>(
      static_cast<const float*>(feats), static_cast<const float*>(dout),
      v_src, cin, cout, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(soff), static_cast<const int32_t*>(rb), rsk,
      rsv, k, static_cast<const float*>(wt), dx, v_out, tile, nwin, sub,
      sentinel, rows, ct, part);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return tdwss::reduce_partials(part, nchunk, k,
                                static_cast<int64_t>(cin) * cout, 0, dw,
                                stream);
}

}  // namespace

extern "C" {

// K6 (sub form, sentinel = subwin): dw (k, cin, cout) f32 and, unless
// dfeats is NULL, dfeats (v_out, cin) in dtype (0 = float32, 1 =
// bfloat16), from feats (v_src, cin), dout (v_src, cout) and wt
// (k, cout, ldw), all in dtype.  part is f32 scratch of
// nchunk * k * cin * cout.  The tiles: bf16 takes the tensor-core body
// with (tm, tn) in {32, 64}^2 for dW and n_tile for dfeats (ldw a
// multiple of 8 >= cin, wt 16-byte aligned); f32 the CUDA-core body with
// tm = 32 input channels per block and tn = the output-channel slab, 64,
// 128 or 256 (ldw = cin, n_tile unused).  Returns the first CUDA error
// (0 on success).
int tdwss_windowed_bwd_sub(const void* feats, const void* dout,
                           int64_t v_src, int cin, int cout,
                           const void* starts, const void* soff,
                           const void* rb, int64_t rb_stride_k,
                           int64_t rb_stride_v, int k, const void* wt,
                           int ldw, void* dfeats, int64_t v_out, int tile,
                           int nwin, int sub, int sentinel, int nchunk,
                           void* part, void* dw, int dtype, int tm, int tn,
                           int n_tile, void* stream) {
  if (v_out <= 0 || v_out > v_src || k <= 0 || k > tdwss::KMAX ||
      nwin <= 0 || nchunk <= 0 || nchunk > v_out || soff == nullptr ||
      cin <= 0 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  float* dp = static_cast<float*>(dw);
  if (dtype == 1) {
    if (dfeats != nullptr) {
      const int err = tdwss::windowed_fwd_mma(
          dout, v_src, cout, starts, soff, rb, rb_stride_k, rb_stride_v, wt,
          ldw, k, cin, dfeats, v_out, tile, nwin, sub, sentinel, n_tile, s);
      if (err != 0) return err;
    }
    const int err = tdwss::dw_mma(
        feats, cin, dout, cout, starts, soff, rb, rb_stride_k, rb_stride_v,
        k, v_src, v_out, tile, nwin, sub, sentinel, nchunk, tm, tn, 1, pp, s);
    if (err != 0) return err;
    return tdwss::reduce_partials(pp, nchunk, k,
                                  static_cast<int64_t>(cin) * cout, 0, dp, s);
  }
  if (dtype != 0 || ldw != cin || tm != TM)
    return static_cast<int>(cudaErrorInvalidValue);
  float* dx = static_cast<float*>(dfeats);
#define TDWSS_K6_SLAB(S)                                                     \
  if (tn == S)                                                               \
    return launch_f32<S>(feats, dout, v_src, cin, cout, starts, soff, rb,    \
                         rb_stride_k, rb_stride_v, k, wt, dx, v_out, tile,   \
                         nwin, sub, sentinel, nchunk, pp, dp, s);
  TDWSS_K6_SLAB(64)
  TDWSS_K6_SLAB(128)
  TDWSS_K6_SLAB(256)
#undef TDWSS_K6_SLAB
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
