// Device code shared by the windowed gather-GEMM kernels for Hopper
// (windowed_fwd.cu: K1/K4; windowed_bwd.cu: K2, K3/K5).
//
// Every kernel addresses its rows the way the Pallas kernels of
// tdwss/ops/pallas_subm.py do:
//
//   src(v, a) = starts[(v / tile) * nwin + a % nwin]
//             + soff[(v / sub) * nwin + a % nwin]     (sub form only)
//             + rb[a, v]
//
// where a local rb[a, v] outside [0, sentinel) (sentinel = subwin in the
// sub form, window in the flat form), or a source outside [0, v_src),
// contributes nothing.  rb is read through two strides, so the Pallas
// layout (k, v_out) and a transposed view of a (v_out, k) array are both
// read without a copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdwss {

constexpr int BM = 64;     // gather-GEMM: output rows per block
constexpr int BN = 64;     // gather-GEMM: output columns per block
constexpr int KC = 32;     // gather-GEMM: input channels per shared stage
constexpr int NT = 256;    // threads per block (16 x 16)
constexpr int KMAX = 32;   // most taps a rulebook may have (27 subm, 8 cross)
constexpr int BK = 32;     // dW: rulebook entries per shared stage

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Source row of output row v at tap a, or -1 for "no contribution".
template <bool SUB>
__device__ __forceinline__ int32_t source_row(
    const int32_t* __restrict__ starts, const int32_t* __restrict__ soff,
    int32_t loc, int64_t v, int a, int tile, int nwin, int sub, int sentinel,
    int64_t v_src) {
  if (loc < 0 || loc >= sentinel) return -1;
  const int g = a % nwin;
  int64_t s = static_cast<int64_t>(starts[(v / tile) * nwin + g]) + loc;
  if (SUB) s += soff[(v / sub) * nwin + g];
  return (s >= 0 && s < v_src) ? static_cast<int32_t>(s) : -1;
}

struct GemmSmem {
  int32_t src[KMAX][BM];
  int used[KMAX];
  float x[BM][KC + 1];
  float w[KC][BN];
};

// One block of the gather-GEMM (K1/K4, and K2's dfeats):
//   out[v, n] = sum_a x[src(v, a), :] @ w[a][:, n]   (f32 accumulation)
// for v in [row0, row0 + BM), n in [col0, col0 + BN).  x is (v_src, c),
// w is (k, c, cout), out is (v_out, cout), all in T.
//
// The block resolves the source row of every (tap, row) into shared
// memory, skips a tap that no row of the block uses, gathers the BM
// source rows of a tap KC channels at a time into shared memory, stages
// the matching KC x BN slice of w[a], and accumulates a 4 x 4 micro-tile
// per thread in f32 registers on the CUDA cores.
template <typename T, bool SUB>
__device__ void gather_gemm_block(
    GemmSmem& sm, const T* __restrict__ x, int64_t v_src, int c,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ soff,
    const int32_t* __restrict__ rb, int64_t rb_stride_k,
    int64_t rb_stride_v, const T* __restrict__ w, int k, int cout,
    T* __restrict__ out, int64_t v_out, int tile, int nwin, int sub,
    int sentinel, int64_t row0, int col0) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  if (tid < KMAX) sm.used[tid] = 0;
  __syncthreads();

  // 1. Source row of every (tap, row) of this block; -1 reads zeros.
  //    The traversal follows rb's memory order so the loads coalesce.
  const bool tap_major = rb_stride_v == 1;
  for (int e = tid; e < k * BM; e += NT) {
    const int a = tap_major ? e / BM : e % k;
    const int r = tap_major ? e % BM : e / k;
    const int64_t v = row0 + r;
    int32_t src = -1;
    if (v < v_out) {
      src = source_row<SUB>(starts, soff, rb[a * rb_stride_k + v * rb_stride_v],
                            v, a, tile, nwin, sub, sentinel, v_src);
      if (src >= 0) sm.used[a] = 1;
    }
    sm.src[a][r] = src;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int a = 0; a < k; ++a) {
    if (!sm.used[a]) continue;           // uniform across the block
    const T* wa = w + static_cast<int64_t>(a) * c * cout;
    for (int c0 = 0; c0 < c; c0 += KC) {
      // 2. gather BM source rows, channels [c0, c0 + KC)
      for (int e = tid; e < BM * KC; e += NT) {
        const int r = e / KC;
        const int cc = e % KC;
        const int32_t s = sm.src[a][r];
        float val = 0.f;
        if (s >= 0 && c0 + cc < c)
          val = to_f(x[static_cast<int64_t>(s) * c + c0 + cc]);
        sm.x[r][cc] = val;
      }
      // 3. stage w[a][c0 : c0 + KC, col0 : col0 + BN]
      for (int e = tid; e < KC * BN; e += NT) {
        const int kk = e / BN;
        const int n = e % BN;
        float val = 0.f;
        if (c0 + kk < c && col0 + n < cout)
          val = to_f(wa[static_cast<int64_t>(c0 + kk) * cout + col0 + n]);
        sm.w[kk][n] = val;
      }
      __syncthreads();
      const int kmax = min(KC, c - c0);
      for (int kk = 0; kk < kmax; ++kk) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sm.x[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = sm.w[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // 4. one rounding to T per output element
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t v = row0 + ty + 16 * i;
    if (v >= v_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n < cout) store(out + v * cout + n, acc[i][j]);
    }
  }
}

}  // namespace tdwss
