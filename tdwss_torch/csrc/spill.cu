// Spill kernels for Hopper (sm_90a): K8 (spill apply) and K9 (spill dW).
//
// A windowed plan's spill tiers are the rulebook entries (owner, tap, src)
// that its windows miss (tdwss_torch/ops/plan.py, SpillOrder).  The
// reference evaluates them in plain jnp (tdwss/ops/sparse_conv.py,
// _res_all_apply and _res_all_dw), with a 27-fold tap-masked product per
// tier and a scatter; no TPU kernel is replaced.  In PyTorch that plain
// form issued some 33 thousand of the 39 thousand device operations of a
// bench UNet training step on an H100, each from the host: these two
// kernels take one launch per pass instead.
//
//   K8  out[o, :] += T( sum_e  x[src_e, :] @ w[tap_e] )
//       over the entries e of owner o, in the plan's order (tier by tier,
//       entry order within a tier), summed in f32 and rounded to T once,
//       then added to out in T (T(out + T(sum)), the windowed result's one
//       add).  w == NULL is the identity (unpools): the entry's row itself.
//   K9  dw[slot(a)] += sum over the chunks of tap a of part[chunk],
//       part[chunk] = sum_{e in chunk} left[l_e, :]^T (x) right[r_e, :]
//       with (l, r) = (src, owner), or (owner, src) flipped; slot(a) =
//       k - 1 - a with flip_taps, else a.  A chunk is a run of at most 512
//       entries of one tap and tier; a tap's chunks are summed tier by
//       tier in chunk order and the tiers' sums added in tier order.
//
// No atomics: every output element is summed by one thread in an order
// the plan fixes, so results repeat bit for bit.  An entry whose source
// (or, in K9, either row) is out of range, or whose tap is not below k,
// adds nothing.  x, w, left, right and out are in T (f32 or bf16), the
// sums and dw in f32.
//
// Design.  At the bench UNet's level 0 a pass holds some 150 thousand
// entries of 32 -> 32 channels: ~0.3 GFLOP, microseconds of the card at
// any design, so the launch count sets the cost, and both kernels run on
// the CUDA cores in full f32 FMAs.
// * K8: one warp per owner, four warps a block; lane j owns output
//   columns col0 + j + 32 i, i < NJ (NJ in {1, 2, 4, 8} the narrowest that
//   covers Cout, wider Couts in ceil(Cout / 256) column blocks).  Per
//   entry the warp stages the source row in shared memory as f32 and each
//   lane takes the dot products of its columns with w[tap] (rows read from
//   L1/L2: w is at most a few MB), each entry's product summed alone and
//   then added to the owner's sum, as the plain version does.
// * K9: a first launch makes one block per (chunk, 32 x 32 tile of (C,
//   Cout)); 32 entries at a time, both operands' rows are staged in shared
//   memory as f32 and each of 256 threads accumulates 4 outputs over the
//   entries in order.  A second launch sums each tap's chunk partials into
//   its slot of dw, tier by tier (the fixed-order reduction).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the larger of
// bytes / 3.35e12 (each distinct source row, each owner row read and
// written, the entry lists and w once; K9: each distinct row of both
// operands, the entry lists and dw read and written once) and 2 * entries
// * C * Cout / 989e12.  At level 0 (146,513 entries, 32 -> 32, bf16; an
// H100 80GB HBM3 at 700 W) K8 took 0.150 ms against a bound of 0.004 ms
// and K9 0.064 ms against 0.003 ms.  K8 reads each entry's weight slice
// again (from L1 or L2), which weighs at the wider levels; a tap-grouped
// form (a gather-GEMM per chunk of the by-tap layout into a scratch, then
// the owner sums) would read it once a block.

#include "windowed_common.cuh"

namespace {

using tdwss::store;
using tdwss::to_f;

constexpr int kApplyWarps = 4;
constexpr int kDwTile = 32;       // K9: (C, Cout) tile side
constexpr int kDwStage = 32;      // K9: entries per shared stage
constexpr int kDwThreads = 256;

__device__ __forceinline__ float rounded(float v, const float*) { return v; }
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int NJ>
__global__ void __launch_bounds__(32 * kApplyWarps) spill_apply_kernel(
    const T* __restrict__ x, int64_t n_src, int cin,
    const int32_t* __restrict__ owner, const int32_t* __restrict__ start,
    const int32_t* __restrict__ entry, int64_t n_owner,
    const T* __restrict__ w, int k, int cout, T* __restrict__ out,
    int64_t v_out) {
  extern __shared__ float xs_all[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* xs = xs_all + warp * cin;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kApplyWarps + warp;
  if (g >= n_owner) return;                // whole warps; no block barrier
  const int64_t o = owner[g];
  if (o < 0 || o >= v_out) return;
  const int col0 = blockIdx.y * 32 * NJ + lane;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  const int64_t e1 = start[g + 1];
  for (int64_t e = start[g]; e < e1; ++e) {
    const int64_t s = entry[2 * e];
    const int a = entry[2 * e + 1];
    if (s < 0 || s >= n_src || a < 0 || a >= k) continue;   // warp-uniform
    __syncwarp();
    for (int c = lane; c < cin; c += 32) xs[c] = to_f(x[s * cin + c]);
    __syncwarp();
    float part[NJ];
    if (w == nullptr) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = col0 + 32 * j;
        part[j] = col < cin ? xs[col] : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j) part[j] = 0.f;
      const T* wa = w + static_cast<int64_t>(a) * cin * cout;
      for (int c = 0; c < cin; ++c) {
        const float xv = xs[c];
        const T* wr = wa + static_cast<int64_t>(c) * cout;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = col0 + 32 * j;
          if (col < cout) part[j] = fmaf(xv, to_f(wr[col]), part[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] += part[j];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = col0 + 32 * j;
    if (col < cout) {
      T* p = out + o * cout + col;
      store(p, to_f(*p) + rounded(acc[j], p));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads) spill_dw_part_kernel(
    const T* __restrict__ left, int64_t n_left, int cl,
    const T* __restrict__ right, int64_t n_right, int cr,
    const int32_t* __restrict__ rows, int lcol,
    const int32_t* __restrict__ chunk, float* __restrict__ part) {
  __shared__ float ls[kDwStage][kDwTile + 1];
  __shared__ float rs[kDwStage][kDwTile];
  __shared__ int32_t lrow[kDwStage];
  __shared__ int32_t rrow[kDwStage];
  const int tid = threadIdx.x;
  const int tx = tid % 32;
  const int ty = tid / 32;                 // 0..7: rows ty + 8 i of the tile
  const int64_t j = blockIdx.x;
  const int c0 = blockIdx.y * kDwTile;
  const int o0 = blockIdx.z * kDwTile;
  const int64_t e0 = chunk[2 * j];
  const int64_t e1 = chunk[2 * j + 2];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t b = e0; b < e1; b += kDwStage) {
    const int nb = e1 - b < kDwStage ? static_cast<int>(e1 - b) : kDwStage;
    if (tid < kDwStage) {
      int32_t l = -1, r = -1;
      if (tid < nb) {
        l = rows[2 * (b + tid) + lcol];
        r = rows[2 * (b + tid) + 1 - lcol];
        if (l < 0 || l >= n_left || r < 0 || r >= n_right) l = r = -1;
      }
      lrow[tid] = l;
      rrow[tid] = r;
    }
    __syncthreads();
    for (int i = tid; i < kDwStage * kDwTile; i += kDwThreads) {
      const int e = i / kDwTile;
      const int c = i % kDwTile;
      const int32_t l = lrow[e];
      const int32_t r = rrow[e];
      ls[e][c] = (l >= 0 && c0 + c < cl)
                     ? to_f(left[static_cast<int64_t>(l) * cl + c0 + c])
                     : 0.f;
      rs[e][c] = (r >= 0 && o0 + c < cr)
                     ? to_f(right[static_cast<int64_t>(r) * cr + o0 + c])
                     : 0.f;
    }
    __syncthreads();
    for (int e = 0; e < nb; ++e) {
      const float rv = rs[e][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(ls[e][ty + 8 * i], rv, acc[i]);
    }
    __syncthreads();
  }
  const int o = o0 + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 8 * i;
    if (c < cl && o < cr)
      part[(j * cl + c) * cr + o] = acc[i];
  }
}

__global__ void spill_dw_reduce_kernel(const float* __restrict__ part,
                                       const int32_t* __restrict__ chunk,
                                       const int32_t* __restrict__ tap_chunk,
                                       int k, int64_t per_tap, int flip_taps,
                                       float* __restrict__ dw) {
  const int64_t n = static_cast<int64_t>(k) * per_tap;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int slot = static_cast<int>(e / per_tap);
    const int64_t x = e % per_tap;
    const int a = flip_taps ? k - 1 - slot : slot;
    const int j0 = tap_chunk[a];
    const int j1 = tap_chunk[a + 1];
    if (j0 == j1) continue;
    float total = 0.f, tier_sum = 0.f;
    int tier = chunk[2 * j0 + 1];
    for (int j = j0; j < j1; ++j) {
      const int t = chunk[2 * j + 1];
      if (t != tier) {
        total += tier_sum;
        tier_sum = 0.f;
        tier = t;
      }
      tier_sum += part[j * per_tap + x];
    }
    dw[e] += total + tier_sum;
  }
}

template <typename T, int NJ>
int launch_apply(const void* x, int64_t n_src, int cin, const int32_t* owner,
                 const int32_t* start, const int32_t* entry, int64_t n_owner,
                 const void* w, int k, int cout, void* out, int64_t v_out,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_owner + kApplyWarps - 1) /
                                        kApplyWarps),
                  static_cast<unsigned>((cout + 32 * NJ - 1) / (32 * NJ)));
  const size_t smem = sizeof(float) * kApplyWarps * cin;
  spill_apply_kernel<T, NJ><<<grid, 32 * kApplyWarps, smem, stream>>>(
      static_cast<const T*>(x), n_src, cin, owner, start, entry, n_owner,
      static_cast<const T*>(w), k, cout, static_cast<T*>(out), v_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply_cols(const void* x, int64_t n_src, int cin, const int32_t* owner,
               const int32_t* start, const int32_t* entry, int64_t n_owner,
               const void* w, int k, int cout, void* out, int64_t v_out,
               cudaStream_t stream) {
  if (cout <= 32)
    return launch_apply<T, 1>(x, n_src, cin, owner, start, entry, n_owner, w,
                              k, cout, out, v_out, stream);
  if (cout <= 64)
    return launch_apply<T, 2>(x, n_src, cin, owner, start, entry, n_owner, w,
                              k, cout, out, v_out, stream);
  if (cout <= 128)
    return launch_apply<T, 4>(x, n_src, cin, owner, start, entry, n_owner, w,
                              k, cout, out, v_out, stream);
  return launch_apply<T, 8>(x, n_src, cin, owner, start, entry, n_owner, w, k,
                            cout, out, v_out, stream);
}

template <typename T>
int launch_dw(const void* left, int64_t n_left, int cl, const void* right,
              int64_t n_right, int cr, const int32_t* rows, int lcol,
              const int32_t* chunk, int nchunk, float* part,
              cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(nchunk),
                  static_cast<unsigned>((cl + kDwTile - 1) / kDwTile),
                  static_cast<unsigned>((cr + kDwTile - 1) / kDwTile));
  spill_dw_part_kernel<T><<<grid, kDwThreads, 0, stream>>>(
      static_cast<const T*>(left), n_left, cl, static_cast<const T*>(right),
      n_right, cr, rows, lcol, chunk, part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Most input channels K8 stages (four warps' rows of f32 in the default
// 48 KB of shared memory).
int tdwss_spill_apply_max_cin(void) { return 3072; }

// K8.  x (n_src, cin) and out (v_out, cout) in T (dtype 0: f32, 1: bf16),
// w (k, cin, cout) in T or NULL (identity, cin == cout); owner (n_owner,),
// start (n_owner + 1,), entry (E, 2) [src, tap], int32.  out is updated in
// place.  Returns cudaGetLastError() after the launch (0 on success).
int tdwss_spill_apply(const void* x, int64_t n_src, int cin,
                      const void* owner, const void* start, const void* entry,
                      int64_t n_owner, const void* w, int k, int cout,
                      void* out, int64_t v_out, int dtype, void* stream) {
  if (n_owner == 0 || cout == 0) return 0;
  if (cin <= 0 || cin > tdwss_spill_apply_max_cin())
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* o = static_cast<const int32_t*>(owner);
  const auto* s = static_cast<const int32_t*>(start);
  const auto* e = static_cast<const int32_t*>(entry);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return apply_cols<__nv_bfloat16>(x, n_src, cin, o, s, e, n_owner, w, k,
                                     cout, out, v_out, st);
  return apply_cols<float>(x, n_src, cin, o, s, e, n_owner, w, k, cout, out,
                           v_out, st);
}

// K9.  left (n_left, cl) and right (n_right, cr) in T; rows (E, 2) [src,
// owner] int32, lcol the column of the left operand's row (0, or 1
// flipped); chunk (nchunk + 1, 2) [first row, tier] and tap_chunk (k + 1,)
// int32; part (nchunk, cl, cr) f32 scratch; dw (k, cl, cr) f32, updated in
// place.  Two launches; returns cudaGetLastError() after them.
int tdwss_spill_dw(const void* left, int64_t n_left, int cl,
                   const void* right, int64_t n_right, int cr,
                   const void* rows, int lcol, const void* chunk, int nchunk,
                   const void* tap_chunk, int k, int flip_taps, void* part,
                   void* dw, int dtype, void* stream) {
  if (nchunk == 0 || cl == 0 || cr == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* c = static_cast<const int32_t*>(chunk);
  auto* p = static_cast<float*>(part);
  const int err =
      dtype == 1
          ? launch_dw<__nv_bfloat16>(left, n_left, cl, right, n_right, cr, r,
                                     lcol, c, nchunk, p, st)
          : launch_dw<float>(left, n_left, cl, right, n_right, cr, r, lcol,
                             c, nchunk, p, st);
  if (err != 0) return err;
  const int64_t per_tap = static_cast<int64_t>(cl) * cr;
  const int64_t n = k * per_tap;
  const int64_t blocks = (n + kDwThreads - 1) / kDwThreads;
  spill_dw_reduce_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks
                                                                : 65535),
                           kDwThreads, 0, st>>>(
      p, c, static_cast<const int32_t*>(tap_chunk), k, per_tap, flip_taps,
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
