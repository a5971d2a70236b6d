// Windowed gather-GEMM backward for Hopper (sm_90a): kernels K2, K3, K5.
//
// Replaces the Pallas kernels of the reference package
//   K2  tdwss/ops/pallas_subm.py::windowed_bwd_gather (_sub_bwd_gather_kernel)
//   K3  tdwss/ops/pallas_subm.py::windowed_dw_sub     (_sub_dw_kernel)
//   K5  tdwss/ops/pallas_subm.py::windowed_dw         (_win_dw_kernel)
// and computes what they compute, with src(v, a) as in windowed_common.cuh:
//
//   K3/K5  dW[a]    = sum_v  x[src(v, a)]^T (x) dout[v]             f32
//   K2     dfeats[v] = sum_a dout[src(v, a)] @ wt[a]          (in T)
//          dW[tau(a)] = sum_v feats[v]^T (x) dout[src(v, a)]         f32
//          tau(a) = k - 1 - a (flip, submanifold) or a (cross-level)
//
// K5 is K3 with flat locals (soff == NULL, sentinel = window), as K4 is
// K1's flat form.  x, dout, feats and wt are in T (f32 or bf16); every
// product is accumulated in f32.
//
// Design (a first, simple and correct kernel).
// - dW is a reduction over all rows, and blocks run in no order.  Each
//   block owns one chunk of rows and one TM x TN tile of (C, Cout); for
//   each tap it compacts the chunk's live (row, source) entries into
//   shared memory (warp ballots, in row order), stages BK entries' rows
//   of both operands in shared memory, and accumulates an f32 micro-tile
//   per thread.  Taps with no live entry cost one scan of the locals.
//   The block writes its per-chunk partial dW (no atomics); a second
//   kernel sums the partials over chunks in a fixed order.  dW is
//   therefore bitwise reproducible run to run.
// - K2's dfeats is K1's gather-GEMM block (windowed_common.cuh) on the
//   cotangent with the transposed weights.  K2 is one launch whose first
//   blocks compute dfeats tiles and whose other blocks compute the dW
//   partials, followed by the reduction; dfeats can be skipped (a NULL
//   output) when the caller needs dW only (the stem's input has no
//   gradient).
// - The TPU kernel shares one window DMA and one transposed one-hot
//   between the two products; here the two block roles read the
//   gathered cotangent rows separately (the second read mostly hits L2).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the larger of
//   bytes / 3.35e12 with bytes = each distinct gathered row, each dense
//       row, rb, starts, offsets, wt and both outputs once, and
//   (2 per product) * (live entries) * c * cout / 989e12.
// At the bench widths the bytes term dominates.  This version runs its
// products on the CUDA cores and re-reads the locals once per tap, so
// it is compute- and L2-bound far above that bound; wgmma for the
// products and cp.async/TMA for the gathers are later work.

#include "windowed_common.cuh"

namespace {

using tdwss::BK;
using tdwss::BM;
using tdwss::BN;
using tdwss::KMAX;
using tdwss::NT;

template <int TM, int TN>
struct DwSmem {
  int32_t lrow[NT];
  int32_t rrow[NT];
  int warp_n[NT / 32];
  float l[BK][TM];
  float r[BK][TN];
};

template <int TM, int TN>
union BwdGatherSmem {
  tdwss::GemmSmem gemm;
  DwSmem<TM, TN> dw;
};

// Partial dW of one chunk of output rows [r0, r1) for one TM x TN tile
// at (c0, o0) of the (cl, cr) product, every tap:
//   part[a][c][o] = sum_{v in chunk, live} left[lrow][c] * right[rrow][o]
// GATHER_LEFT (K3/K5): lrow = src(v, a), rrow = v.
// otherwise   (K2):    lrow = v,         rrow = src(v, a).
template <typename T, bool SUB, bool GATHER_LEFT, int TM, int TN>
__device__ void dw_block(
    DwSmem<TM, TN>& sm, const T* __restrict__ left, int cl,
    const T* __restrict__ right, int cr,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ soff,
    const int32_t* __restrict__ rb, int64_t rb_stride_k,
    int64_t rb_stride_v, int k, int64_t v_src, int tile, int nwin, int sub,
    int sentinel, int64_t r0, int64_t r1, int c0, int o0,
    float* __restrict__ part) {
  constexpr int MI = TM / 16;
  constexpr int MJ = TN / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int a = 0; a < k; ++a) {
    float acc[MI][MJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;

    for (int64_t seg = r0; seg < r1; seg += NT) {
      // 1. live entries of this segment, compacted in row order
      const int64_t v = seg + tid;
      int32_t s = -1;
      if (v < r1)
        s = tdwss::source_row<SUB>(
            starts, soff, rb[a * rb_stride_k + v * rb_stride_v], v, a, tile,
            nwin, sub, sentinel, v_src);
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
        sm.lrow[idx] = GATHER_LEFT ? s : static_cast<int32_t>(v);
        sm.rrow[idx] = GATHER_LEFT ? static_cast<int32_t>(v) : s;
      }
      __syncthreads();

      // 2. BK entries at a time: stage both operands, accumulate
      for (int b0 = 0; b0 < total; b0 += BK) {
        const int nb = min(BK, total - b0);
        for (int e = tid; e < BK * TM; e += NT) {
          const int kk = e / TM;
          const int cc = e % TM;
          float val = 0.f;
          if (kk < nb && c0 + cc < cl)
            val = tdwss::to_f(
                left[static_cast<int64_t>(sm.lrow[b0 + kk]) * cl + c0 + cc]);
          sm.l[kk][cc] = val;
        }
        for (int e = tid; e < BK * TN; e += NT) {
          const int kk = e / TN;
          const int oo = e % TN;
          float val = 0.f;
          if (kk < nb && o0 + oo < cr)
            val = tdwss::to_f(
                right[static_cast<int64_t>(sm.rrow[b0 + kk]) * cr + o0 + oo]);
          sm.r[kk][oo] = val;
        }
        __syncthreads();
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
        __syncthreads();
      }
    }

    // 3. this chunk's partial for tap a (zeros where no entry was live)
    float* pa = part + static_cast<int64_t>(a) * cl * cr;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int c = c0 + ty + 16 * i;
      if (c >= cl) continue;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int o = o0 + tx + 16 * j;
        if (o < cr) pa[static_cast<int64_t>(c) * cr + o] = acc[i][j];
      }
    }
  }
}

// Geometry of the dW blocks: chunk-major, then (c, o) tiles.
struct DwGrid {
  int nchunk;
  int64_t rows;      // rows per chunk
  int ct, ot;        // tiles along c and o
  __host__ __device__ int blocks() const { return nchunk * ct * ot; }
};

template <typename T, bool SUB, bool GATHER_LEFT, int TM, int TN>
__device__ __forceinline__ void dw_role(
    DwSmem<TM, TN>& sm, int b, DwGrid g, const T* left, int cl,
    const T* right, int cr, const int32_t* starts, const int32_t* soff,
    const int32_t* rb, int64_t rsk, int64_t rsv, int k, int64_t v_src,
    int64_t v_out, int tile, int nwin, int sub, int sentinel, float* part) {
  const int chunk = b / (g.ct * g.ot);
  const int rem = b % (g.ct * g.ot);
  const int64_t r0 = chunk * g.rows;
  const int64_t r1 = r0 + g.rows < v_out ? r0 + g.rows : v_out;
  dw_block<T, SUB, GATHER_LEFT, TM, TN>(
      sm, left, cl, right, cr, starts, soff, rb, rsk, rsv, k, v_src, tile,
      nwin, sub, sentinel, r0, r1, (rem / g.ot) * TM, (rem % g.ot) * TN,
      part + static_cast<int64_t>(chunk) * k * cl * cr);
}

// K3 / K5: dW partials, x gathered on the left.
template <typename T, bool SUB, int TM, int TN>
__global__ void __launch_bounds__(NT) windowed_dw_kernel(
    const T* __restrict__ x, int64_t v_src, int c,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ soff,
    const int32_t* __restrict__ rb, int64_t rsk, int64_t rsv, int k,
    const T* __restrict__ dout, int cout, int64_t v_out, int tile, int nwin,
    int sub, int sentinel, DwGrid g, float* __restrict__ part) {
  __shared__ DwSmem<TM, TN> sm;
  dw_role<T, SUB, true, TM, TN>(sm, blockIdx.x, g, x, c, dout, cout, starts,
                                soff, rb, rsk, rsv, k, v_src, v_out, tile,
                                nwin, sub, sentinel, part);
}

// K2: blocks [0, n_dx) compute dfeats tiles, the rest dW partials with
// the cotangent gathered on the right.
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(NT) windowed_bwd_gather_kernel(
    const T* __restrict__ dout, int64_t v_src, int cout,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ soff,
    const int32_t* __restrict__ rb, int64_t rsk, int64_t rsv, int k,
    const T* __restrict__ wt, const T* __restrict__ feats, int cin,
    T* __restrict__ dfeats, int64_t v_out, int tile, int nwin, int sub,
    int sentinel, int n_dx, DwGrid g, float* __restrict__ part) {
  __shared__ BwdGatherSmem<TM, TN> sm;
  const int b = blockIdx.x;
  if (b < n_dx) {
    const int col_blocks = (cin + BN - 1) / BN;
    tdwss::gather_gemm_block<T, true>(
        sm.gemm, dout, v_src, cout, starts, soff, rb, rsk, rsv, wt, k, cin,
        dfeats, v_out, tile, nwin, sub, sentinel,
        static_cast<int64_t>(b / col_blocks) * BM, (b % col_blocks) * BN);
    return;
  }
  dw_role<T, true, false, TM, TN>(sm.dw, b - n_dx, g, feats, cin, dout,
                                  cout, starts, soff, rb, rsk, rsv, k, v_src,
                                  v_out, tile, nwin, sub, sentinel, part);
}

// dw[slot(a)] = sum over chunks of part[chunk][a], in chunk order.
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       int nchunk, int k, int64_t per_tap,
                                       int flip, float* __restrict__ dw) {
  const int64_t n = static_cast<int64_t>(k) * per_tap;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < nchunk; ++i) s += part[i * n + e];
    const int64_t a = e / per_tap;
    const int64_t slot = flip ? k - 1 - a : a;
    dw[slot * per_tap + e % per_tap] = s;
  }
}

DwGrid dw_grid(int nchunk, int64_t v_out, int cl, int cr, int tm, int tn) {
  DwGrid g;
  g.nchunk = nchunk;
  g.rows = (v_out + nchunk - 1) / nchunk;
  g.ct = (cl + tm - 1) / tm;
  g.ot = (cr + tn - 1) / tn;
  return g;
}

int reduce(const float* part, int nchunk, int k, int64_t per_tap, int flip,
           float* dw, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(k) * per_tap;
  const int64_t blocks = (n + NT - 1) / NT;
  reduce_partials_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks
                                                                : 65535),
                           NT, 0, stream>>>(part, nchunk, k, per_tap, flip,
                                            dw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SUB, int TM, int TN>
int launch_dw(const void* x, int64_t v_src, int c, const void* starts,
              const void* soff, const void* rb, int64_t rsk, int64_t rsv,
              int k, const void* dout, int cout, int64_t v_out, int tile,
              int nwin, int sub, int sentinel, int nchunk, float* part,
              float* dw, cudaStream_t stream) {
  const DwGrid g = dw_grid(nchunk, v_out, c, cout, TM, TN);
  windowed_dw_kernel<T, SUB, TM, TN><<<g.blocks(), NT, 0, stream>>>(
      static_cast<const T*>(x), v_src, c, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(soff), static_cast<const int32_t*>(rb), rsk,
      rsv, k, static_cast<const T*>(dout), cout, v_out, tile, nwin, sub,
      sentinel, g, part);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return reduce(part, nchunk, k, static_cast<int64_t>(c) * cout, 0, dw,
                stream);
}

template <typename T, bool SUB>
int dispatch_dw(const void* x, int64_t v_src, int c, const void* starts,
                const void* soff, const void* rb, int64_t rsk, int64_t rsv,
                int k, const void* dout, int cout, int64_t v_out, int tile,
                int nwin, int sub, int sentinel, int nchunk, float* part,
                float* dw, cudaStream_t stream) {
  if (c <= 32 && cout <= 32)
    return launch_dw<T, SUB, 32, 32>(x, v_src, c, starts, soff, rb, rsk, rsv,
                                     k, dout, cout, v_out, tile, nwin, sub,
                                     sentinel, nchunk, part, dw, stream);
  return launch_dw<T, SUB, 64, 64>(x, v_src, c, starts, soff, rb, rsk, rsv, k,
                                   dout, cout, v_out, tile, nwin, sub,
                                   sentinel, nchunk, part, dw, stream);
}

template <typename T, int TM, int TN>
int launch_bwd_gather(const void* dout, int64_t v_src, int cout,
                      const void* starts, const void* soff, const void* rb,
                      int64_t rsk, int64_t rsv, int k, const void* wt,
                      const void* feats, int cin, void* dfeats, int64_t v_out,
                      int tile, int nwin, int sub, int sentinel, int flip,
                      int nchunk, float* part, float* dw,
                      cudaStream_t stream) {
  const DwGrid g = dw_grid(nchunk, v_out, cin, cout, TM, TN);
  const int64_t n_dx =
      dfeats == nullptr ? 0
                        : ((v_out + BM - 1) / BM) * ((cin + BN - 1) / BN);
  windowed_bwd_gather_kernel<T, TM, TN>
      <<<static_cast<unsigned>(n_dx + g.blocks()), NT, 0, stream>>>(
          static_cast<const T*>(dout), v_src, cout,
          static_cast<const int32_t*>(starts),
          static_cast<const int32_t*>(soff), static_cast<const int32_t*>(rb),
          rsk, rsv, k, static_cast<const T*>(wt), static_cast<const T*>(feats),
          cin, static_cast<T*>(dfeats), v_out, tile, nwin, sub, sentinel,
          static_cast<int>(n_dx), g, part);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return reduce(part, nchunk, k, static_cast<int64_t>(cin) * cout, flip, dw,
                stream);
}

template <typename T>
int dispatch_bwd_gather(const void* dout, int64_t v_src, int cout,
                        const void* starts, const void* soff, const void* rb,
                        int64_t rsk, int64_t rsv, int k, const void* wt,
                        const void* feats, int cin, void* dfeats,
                        int64_t v_out, int tile, int nwin, int sub,
                        int sentinel, int flip, int nchunk, float* part,
                        float* dw, cudaStream_t stream) {
  if (cin <= 32 && cout <= 32)
    return launch_bwd_gather<T, 32, 32>(
        dout, v_src, cout, starts, soff, rb, rsk, rsv, k, wt, feats, cin,
        dfeats, v_out, tile, nwin, sub, sentinel, flip, nchunk, part, dw,
        stream);
  return launch_bwd_gather<T, 64, 64>(
      dout, v_src, cout, starts, soff, rb, rsk, rsv, k, wt, feats, cin,
      dfeats, v_out, tile, nwin, sub, sentinel, flip, nchunk, part, dw,
      stream);
}

bool bad_args(int64_t v_out, int k, int nwin, int nchunk) {
  return v_out <= 0 || k > KMAX || k <= 0 || nwin <= 0 || nchunk <= 0 ||
         nchunk > v_out;
}

}  // namespace

extern "C" {

// K3 (soff != NULL, sentinel = subwin) / K5 (soff == NULL, sentinel =
// window): dw (k, c, cout) f32 from x (v_src, c) and dout (v_out, cout),
// both in dtype (0 = float32, 1 = bfloat16).  part is f32 scratch of
// nchunk * k * c * cout elements.  Returns cudaGetLastError() after the
// launches (0 on success).
int tdwss_windowed_dw(const void* x, int64_t v_src, int c, const void* starts,
                      const void* soff, const void* rb, int64_t rb_stride_k,
                      int64_t rb_stride_v, int k, const void* dout, int cout,
                      int64_t v_out, int tile, int nwin, int sub,
                      int sentinel, int nchunk, void* part, void* dw,
                      int dtype, void* stream) {
  if (bad_args(v_out, k, nwin, nchunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  float* dp = static_cast<float*>(dw);
  const bool sub_form = soff != nullptr;
  if (dtype == 0)
    return sub_form
               ? dispatch_dw<float, true>(x, v_src, c, starts, soff, rb,
                                          rb_stride_k, rb_stride_v, k, dout,
                                          cout, v_out, tile, nwin, sub,
                                          sentinel, nchunk, pp, dp, s)
               : dispatch_dw<float, false>(x, v_src, c, starts, soff, rb,
                                           rb_stride_k, rb_stride_v, k, dout,
                                           cout, v_out, tile, nwin, sub,
                                           sentinel, nchunk, pp, dp, s);
  if (dtype == 1)
    return sub_form
               ? dispatch_dw<__nv_bfloat16, true>(
                     x, v_src, c, starts, soff, rb, rb_stride_k, rb_stride_v,
                     k, dout, cout, v_out, tile, nwin, sub, sentinel, nchunk,
                     pp, dp, s)
               : dispatch_dw<__nv_bfloat16, false>(
                     x, v_src, c, starts, soff, rb, rb_stride_k, rb_stride_v,
                     k, dout, cout, v_out, tile, nwin, sub, sentinel, nchunk,
                     pp, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2 (sub form, sentinel = subwin): dfeats (v_out, cin) in dtype (NULL
// skips it) and dw (k, cin, cout) f32 from dout (v_src, cout), wt
// (k, cout, cin) and feats (v_out, cin), all in dtype.  flip != 0 sends
// tap a's product to dw[k - 1 - a].  part as for tdwss_windowed_dw.
int tdwss_windowed_bwd_gather(const void* dout, int64_t v_src, int cout,
                              const void* starts, const void* soff,
                              const void* rb, int64_t rb_stride_k,
                              int64_t rb_stride_v, int k, const void* wt,
                              const void* feats, int cin, void* dfeats,
                              int64_t v_out, int tile, int nwin, int sub,
                              int sentinel, int flip, int nchunk, void* part,
                              void* dw, int dtype, void* stream) {
  if (bad_args(v_out, k, nwin, nchunk) || soff == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  float* dp = static_cast<float*>(dw);
  if (dtype == 0)
    return dispatch_bwd_gather<float>(
        dout, v_src, cout, starts, soff, rb, rb_stride_k, rb_stride_v, k, wt,
        feats, cin, dfeats, v_out, tile, nwin, sub, sentinel, flip, nchunk,
        pp, dp, s);
  if (dtype == 1)
    return dispatch_bwd_gather<__nv_bfloat16>(
        dout, v_src, cout, starts, soff, rb, rb_stride_k, rb_stride_v, k, wt,
        feats, cin, dfeats, v_out, tile, nwin, sub, sentinel, flip, nchunk,
        pp, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
