// Tensor-core bodies shared by the windowed kernels for Hopper (sm_90a),
// bf16 in, f32 accumulation:
//
// * fwd_mma_kernel, the gather-GEMM
//     out[v, :] = sum_a x[src(v, a), :] @ w[a]
//   of K1/K4 (windowed_fwd.cu), and the dfeats product of K2
//   (windowed_bwd.cu) and K6 (windowed_bwd_sub.cu), which is the same
//   function with the cotangent as x and the transposed weights as w;
//   launched through windowed_fwd_mma();
// * dw_mma_kernel, the weight gradient over compacted live entries of K2
//   and K6 (their bf16 dW) and the whole of K3/K5 in bf16, launched
//   through dw_mma().
//
// The design of each is described above its kernel; windowed_fwd.cu's
// header note gives the forward's in full.

#pragma once

#include "windowed_common.cuh"

namespace tdwss {
// Internal linkage: each library that includes this header (one per .cu)
// keeps its own kernels, host stubs and launch state, so no symbol of one
// library can bind to another's copy when both are loaded in one process.
namespace {

// --------------------------------------------------------------------------
// The gather-GEMM: cp.async ring, mma.sync on the tensor cores
// --------------------------------------------------------------------------

constexpr int MAX_SMEM = 227 << 10;

// Ring depth: 4 stages (3 steps in flight), 3 at N = 64, where a stage of
// 128 rows and 64 weight columns is the largest.
__host__ __device__ constexpr int mma_stages(int n) { return n == 64 ? 3 : 4; }

// Rows per block: 128 for the narrow column tiles (N <= 64), which halves
// the per-row share of each step's weight rows, barrier and issue work,
// else 64.  Four threads per row: warps of 16 rows x N/2 columns.
__host__ __device__ constexpr int mma_rows(int n) { return n <= 64 ? 128 : 64; }
__host__ __device__ constexpr int mma_threads(int n) {
  return 4 * mma_rows(n);
}

// Blocks per SM the register budget is set for: two of 512 threads for
// the narrow tiles, three of 256 at N = 128, two at N = 256.
__host__ __device__ constexpr int mma_min_blocks(int n) {
  return n == 128 ? 3 : 2;
}

// The reduction runs over "items": 8-channel pieces of a used tap's row,
// CH8 = ceil(C / 8) per tap, in tap order.  A step takes KI items (64
// channels for the narrow column tiles, where per-step costs dominate;
// 32 for the wide ones, where the streamed weights fill the stage), so
// one step may hold several taps of a narrow row (two taps at C = 32,
// eight at the stem's C = 3).
__host__ __device__ constexpr int mma_items(int n) { return n <= 64 ? 8 : 4; }

// Shared tables beside the ring: src [KMAX][rows], flag / list [KMAX],
// the used-tap count (+3 spare), per-row window and sub-window bases
// [rows] each, and tap -> window slot [KMAX].
__host__ __device__ constexpr int mma_table_bytes(int n) {
  return KMAX * mma_rows(n) * 4 + (2 * KMAX + 4) * 4 + 2 * mma_rows(n) * 4 +
         KMAX * 4;
}

// A stage holds a step's gathered rows (rows x KI items of 16 bytes) and
// its weight rows (8 * KI x N).
__host__ __device__ constexpr int mma_smem_bytes(int n) {
  return mma_stages(n) *
             (mma_rows(n) * mma_items(n) * 16 + 16 * mma_items(n) * n) +
         mma_table_bytes(n);
}

// Each tile's shared memory fits a block and leaves room for the blocks
// per SM its registers are set for (an H100 SM: 228 KB, 1 KB of it
// reserved per block).
constexpr bool mma_fits(int n) {
  return mma_smem_bytes(n) <= MAX_SMEM &&
         mma_min_blocks(n) * (mma_smem_bytes(n) + 1024) <= (228 << 10);
}
static_assert(mma_fits(32) && mma_fits(64) && mma_fits(128) &&
                  mma_fits(256),
              "a column tile's ring and tables exceed its shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk q of row r in a tile whose rows are
// `chunks` 16-byte chunks long (4: a 64-byte row; a multiple of 8
// otherwise).  The XOR puts the 8 rows that one ldmatrix phase reads in
// 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int r, int q, int chunks) {
  const int p = chunks == 4 ? (q ^ ((r >> 1) & 3)) : (q ^ (r & 7));
  return static_cast<uint32_t>((r * chunks + p) * 16);
}

// 16 bytes global -> shared; nbytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct MmaArgs {
  const __nv_bfloat16* x;
  int v_src, c;
  const int32_t* starts;
  const int32_t* soff;   // nullptr: the flat form (K4)
  const int32_t* rb;
  int rb_stride_k, rb_stride_v;
  const __nv_bfloat16* w;
  int ldw, k, cout;
  __nv_bfloat16* out;
  int v_out, tile, nwin, sub, sentinel;
  int avec;
};

// Item f of the used-tap list -> (tap, first channel); ti = f / ch8 by a
// multiply-high with inv = ceil(2^32 / ch8) (exact for f < 2^16), or f
// itself when ch8 = 1.
struct ItemMap {
  const int* list;
  int ch8;
  uint32_t inv;
  __device__ __forceinline__ void at(int f, int& a, int& ch) const {
    const int ti = ch8 == 1 ? f
                            : static_cast<int>(__umulhi(
                                  static_cast<uint32_t>(f), inv));
    a = list[ti];
    ch = (f - ti * ch8) * 8;
  }
};

// Weight rows of items [f0, f0 + KI) (8 rows each: w[a][ch + j][col0:])
// into a swizzled 8*KI x N tile; rows past C or items past `items` are
// zero.
template <int N, int KI, int THREADS>
__device__ __forceinline__ void load_w_step(const MmaArgs& p,
                                            const ItemMap& im, uint32_t dst,
                                            int f0, int items, int col0) {
  constexpr int CH = N / 8;
  for (int e = threadIdx.x; e < 8 * KI * CH; e += THREADS) {
    const int kr = e / CH;
    const int q = e % CH;
    const int f = f0 + kr / 8;
    const int col = col0 + q * 8;
    bool ok = f < items && col < p.ldw;
    const __nv_bfloat16* g = p.w;
    if (ok) {
      int a, ch;
      im.at(f, a, ch);
      const int row = ch + (kr & 7);
      ok = row < p.c;
      g = p.w + (static_cast<int64_t>(a) * p.c + row) * p.ldw + col;
    }
    cp_async16(dst + swz(kr, q, CH), ok ? g : p.w, ok ? 16 : 0);
  }
}

template <int N>
__global__ void __launch_bounds__(mma_threads(N), mma_min_blocks(N))
    fwd_mma_kernel(const MmaArgs p) {
  constexpr int NS = mma_stages(N);
  constexpr int KI = mma_items(N);
  constexpr int BM = mma_rows(N);
  constexpr int THREADS = mma_threads(N);
  constexpr int WMW = BM / 16;     // warps along rows
  constexpr int A_BYTES = BM * KI * 16;
  constexpr int WN = N / 2;        // columns per warp
  constexpr int NT8 = WN / 8;      // n8 tiles per warp
  constexpr int BCH = N / 8;       // 16-byte chunks per weight row
  constexpr int PER = KMAX * BM / THREADS;   // (tap, row) per thread
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WMW;
  const int wn = warp / WMW;
  const int ch8 = (p.c + 7) / 8;
  constexpr int STAGE_BYTES = A_BYTES + 16 * KI * N;
  // blocks in row-tile order, the column tiles of a row tile adjacent (they
  // gather the same source rows, so the second and third find them in L2)
  const int col_tiles = (p.cout + N - 1) / N;
  const int col0 = static_cast<int>(blockIdx.x % col_tiles) * N;
  const int row0 = static_cast<int>(blockIdx.x / col_tiles) * BM;

  int32_t* src = reinterpret_cast<int32_t*>(smem + NS * STAGE_BYTES);
  int* flag = src + KMAX * BM;                            // [KMAX]
  int* list = flag + KMAX;                                // [KMAX]
  int* nused = list + KMAX;                               // [4]
  int* row_t = nused + 4;                                 // [BM]
  int* row_s = row_t + BM;                                // [BM]
  int* slot = row_s + BM;                                 // [KMAX]
  const uint32_t ring = smem_u32(smem);
  const ItemMap im{list, ch8,
                   ch8 == 1 ? 0u
                            : static_cast<uint32_t>(
                                  ((1ull << 32) + ch8 - 1) / ch8)};
  // e / k for e < KMAX * BM by a multiply and shift (exact: see below)
  const uint32_t inv_k = ((1u << 20) + p.k - 1) / p.k;

  if (tid < KMAX) {
    slot[tid] = tid % p.nwin;
    flag[tid] = 0;
  }
  if (tid < BM) {
    const int v = row0 + tid;
    row_t[tid] = (v / p.tile) * p.nwin;
    row_s[tid] = p.soff != nullptr ? (v / p.sub) * p.nwin : 0;
  }
  const bool tap_major = p.rb_stride_v == 1;
  __syncthreads();

  // 1. source rows of every (tap, row); -1 reads zeros.  Each thread
  //    owns up to PER entries and issues all their loads (local, start,
  //    offset: independent addresses) before it uses any, so a row tile
  //    waits for one round of global latency, not one per entry.  The
  //    traversal follows rb's memory order so the loads coalesce; for
  //    e < 2^12 and k <= 32, (e * ceil(2^20 / k)) >> 20 is e / k.
  int loc[PER], base[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS;
    const int q = static_cast<int>((static_cast<uint32_t>(e) * inv_k) >> 20);
    const int a = tap_major ? e / BM : e - q * p.k;
    const int r = tap_major ? e % BM : q;
    const int v = row0 + r;
    const bool in = e < p.k * BM && v < p.v_out;
    loc[i] = in ? __ldg(p.rb + a * p.rb_stride_k + v * p.rb_stride_v) : -1;
    base[i] = 0;
    if (in) {
      const int g = slot[a];
      base[i] = __ldg(p.starts + row_t[r] + g);
      if (p.soff != nullptr) base[i] += __ldg(p.soff + row_s[r] + g);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS;
    if (e < p.k * BM) {
      const int q =
          static_cast<int>((static_cast<uint32_t>(e) * inv_k) >> 20);
      const int a = tap_major ? e / BM : e - q * p.k;
      const int r = tap_major ? e % BM : q;
      const int s = base[i] + loc[i];
      const bool ok = loc[i] >= 0 && loc[i] < p.sentinel && s >= 0 &&
                      s < p.v_src;
      src[a * BM + r] = ok ? s : -1;
      if (ok) flag[a] = 1;
    }
  }
  __syncthreads();
  // compact the used taps in tap order
  if (warp == 0) {
    const bool f = lane < p.k && flag[lane];
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (f) list[__popc(m & ((1u << lane) - 1u))] = lane;
    if (lane == 0) *nused = __popc(m);
  }
  __syncthreads();
  const int items = *nused * ch8;
  const int steps = (items + KI - 1) / KI;

  // 2. gathers of step t (items [t * KI, t * KI + KI)) into stage t % NS
  auto issue = [&](int t) {
    const uint32_t stage = ring + (t % NS) * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < BM * KI / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / KI;
      const int q = e % KI;
      const int f = t * KI + q;
      int s = -1, ch = 0;
      if (f < items) {
        int a;
        im.at(f, a, ch);
        s = src[a * BM + r];
      }
      const uint32_t dst = stage + swz(r, q, KI);
      if (p.avec) {
        const bool ok = s >= 0;
        cp_async16(dst, ok ? p.x + static_cast<int64_t>(s) * p.c + ch : p.x,
                   ok ? 16 : 0);
      } else {
        uint16_t h[8];
        const uint16_t* xs = reinterpret_cast<const uint16_t*>(p.x);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          h[j] = (s >= 0 && ch + j < p.c)
                     ? xs[static_cast<int64_t>(s) * p.c + ch + j]
                     : uint16_t(0);
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         dst),
                     "r"(h[0] | (uint32_t(h[1]) << 16)),
                     "r"(h[2] | (uint32_t(h[3]) << 16)),
                     "r"(h[4] | (uint32_t(h[5]) << 16)),
                     "r"(h[6] | (uint32_t(h[7]) << 16))
                     : "memory");
      }
    }
    load_w_step<N, KI, THREADS>(p, im, stage + A_BYTES, t * KI, items,
                                col0);
  };

  float acc[NT8][4];
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();     // step t landed; stage (t - 1) % NS is free
    if (t + NS - 1 < steps) issue(t + NS - 1);
    cp_async_commit();

    // 4. products of step t, k16 by k16 over its live items
    const uint32_t a_tile = ring + (t % NS) * STAGE_BYTES;
    const int live = min(KI, items - t * KI);
#pragma unroll
    for (int kk = 0; kk < KI / 2; ++kk) {
      if (2 * kk < live) {
        uint32_t af[4];
        ldmatrix_x4(af, a_tile + swz(wm * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8,
                                     kk * 2 + (lane >> 4), KI));
        const int kr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j2 = 0; j2 < NT8 / 2; ++j2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, a_tile + A_BYTES +
                      swz(kr, wn * (WN / 8) + j2 * 2 + (lane >> 4), BCH));
          mma_bf16(acc[2 * j2], af, bf[0], bf[1]);
          mma_bf16(acc[2 * j2 + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // 5. one rounding to bf16 per element, column pairs stored together
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    const int n = col0 + wn * WN + j * 8 + t4 * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = row0 + wm * 16 + g + h * 8;
      if (v >= p.v_out || n >= p.cout) continue;
      __nv_bfloat16* o = p.out + static_cast<int64_t>(v) * p.cout + n;
      if ((p.cout & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        o[0] = __float2bfloat16(acc[j][2 * h]);
        if (n + 1 < p.cout) o[1] = __float2bfloat16(acc[j][2 * h + 1]);
      }
    }
  }
}

template <int N>
int launch_mma(const MmaArgs& p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_mma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  constexpr int smem = mma_smem_bytes(N);
  constexpr int rows = mma_rows(N);
  const int64_t blocks = static_cast<int64_t>((p.v_out + rows - 1) / rows) *
                         ((p.cout + N - 1) / N);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fwd_mma_kernel<N><<<static_cast<unsigned>(blocks), mma_threads(N), smem,
                      stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The gather-GEMM on the tensor cores, bf16 only.  w is (k, c, ldw) with
// ldw a multiple of 8 >= cout and a 16-byte aligned base; n_tile in
// {32, 64, 128, 256} (the rest of the tiling follows from it).  Row
// counts and rb's indices must fit in 32 bits.  Returns
// cudaGetLastError() after the launch (0 on success).
inline int windowed_fwd_mma(const void* x, int64_t v_src, int c,
                            const void* starts, const void* soff,
                            const void* rb, int64_t rb_stride_k,
                            int64_t rb_stride_v, const void* w, int ldw,
                            int k, int cout, void* out, int64_t v_out,
                            int tile, int nwin, int sub, int sentinel,
                            int n_tile, cudaStream_t stream) {
  if (v_out == 0 || cout == 0) return 0;
  if (k > KMAX || k <= 0 || nwin <= 0 || c <= 0 || ldw % 8 != 0 ||
      ldw < cout || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      v_out > INT32_MAX || v_src > INT32_MAX ||
      (k - 1) * rb_stride_k + (v_out - 1) * rb_stride_v > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  MmaArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.v_src = static_cast<int>(v_src);
  p.c = c;
  p.starts = static_cast<const int32_t*>(starts);
  p.soff = static_cast<const int32_t*>(soff);
  p.rb = static_cast<const int32_t*>(rb);
  p.rb_stride_k = static_cast<int>(rb_stride_k);
  p.rb_stride_v = static_cast<int>(rb_stride_v);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.ldw = ldw;
  p.k = k;
  p.cout = cout;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.v_out = static_cast<int>(v_out);
  p.tile = tile;
  p.nwin = nwin;
  p.sub = sub;
  p.sentinel = sentinel;
  p.avec = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (n_tile) {
    case 32: return launch_mma<32>(p, stream);
    case 64: return launch_mma<64>(p, stream);
    case 128: return launch_mma<128>(p, stream);
    case 256: return launch_mma<256>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --------------------------------------------------------------------------
// Weight gradient on the tensor cores (the bf16 dW of K2, K3/K5 and K6)
// --------------------------------------------------------------------------
//
//   part[chunk][a][c][o] = sum over the chunk's live (v, a) of
//                          left[lrow][c] * right[rrow][o]
//   K2 (GATHER_LEFT false): lrow = v, rrow = src(v, a) (feats dense, the
//       cotangent gathered);
//   K3/K5, K6 (GATHER_LEFT true): lrow = src(v, a), rrow = v (the primal
//       rows gathered, the cotangent dense).
// SUB selects the sub form (src = starts + soff + local, sentinel subwin;
// K2, K3, K6) or the flat form (src = starts + local, sentinel window;
// K5), as K1's body does for K4; the flat form is instantiated with the
// source gathered on the left only.
//
// A block owns one chunk of rows and one TM x TN tile of (cl, cr), TM and
// TN in {32, 64}, with 4 warps.  It walks "steps", each one tap over 128
// rows of the chunk (taps in order, then rows): every thread resolves one
// row's source, the live entries are compacted in row order by ballots,
// and their two operand rows (TM and TN channels) are gathered by 16-byte
// cp.async into a stage, entry-major and XOR-swizzled; only the last
// 16-entry group of a step is zero-filled.  A ring of DW_STAGES stages: a
// step's gathers are issued before the step before it is multiplied, and
// the rulebook loads of the step after are issued before that.  Products:
// mma.sync m16n8k16 with (cl x 16 entries) from ldmatrix.trans of the
// left rows and (16 x cr) from ldmatrix.trans of the right rows; each
// warp owns a 32 x 32 tile, and where the block tile has fewer than four
// of them the warps split the groups of a step (KS ways) and add their
// sums at each tap's end in warp order.  No atomics: the sums' order is
// fixed, so dW repeats bit for bit, and the per-chunk partials go to
// reduce_partials.
//
// Measured on an H100 (tdwss_torch/tools/dw_variants.py; PERF.md): three
// stages were 30% slower at level 0 (fewer blocks fit an SM) and no
// faster elsewhere; 256 threads gained 2-17% at the wider shapes and lost
// up to 3% at level 0; rulebook loads two steps ahead were tried and were
// no faster.  With the products or
// the gathers cut out, a level-0 dW keeps 60% of its time in the step
// skeleton (source resolution, compaction, barriers, partials), and at
// 128 -> 64 the gathers take the largest part: every live entry reads
// both operand rows once per tile, the dense side once per live tap.

constexpr int DW_THREADS = 128;
constexpr int DW_SEG = DW_THREADS;   // rows per step, one per thread
constexpr int DW_STAGES = 2;         // steps in the ring

__host__ __device__ constexpr int dw_warp_tiles(int tm, int tn) {
  return (tm / 32) * (tn / 32);
}
// ways the warps split a step's groups (the warps past the tiles' count
// times this idle in the products)
__host__ __device__ constexpr int dw_ks(int tm, int tn) {
  return (DW_THREADS / 32) / dw_warp_tiles(tm, tn);
}
__host__ __device__ constexpr int dw_stage_bytes(int tm, int tn) {
  return DW_SEG * (tm + tn) * 2;
}
// the ring, the k-split sums, the compacted (lrow, rrow) and live count
// of each stage, and the per-warp live counts
__host__ __device__ constexpr int dw_smem_bytes(int tm, int tn) {
  return DW_STAGES * dw_stage_bytes(tm, tn) +
         (dw_ks(tm, tn) - 1) * tm * tn * 4 +
         DW_STAGES * (2 * DW_SEG + 1) * 4 + (DW_THREADS / 32) * 4;
}
static_assert(dw_smem_bytes(64, 64) <= MAX_SMEM &&
                  dw_smem_bytes(32, 32) <= MAX_SMEM &&
                  dw_smem_bytes(64, 32) <= MAX_SMEM,
              "a dW tile's stages exceed its shared memory");

struct DwMmaArgs {
  const __nv_bfloat16* left;     // (rows, cl)
  const __nv_bfloat16* right;    // (rows, cr)
  int cl, cr;
  const int32_t* starts;
  const int32_t* soff;           // nullptr: the flat form (K5)
  const int32_t* rb;
  int rb_stride_k, rb_stride_v;
  int k, v_src, v_out, tile, nwin, sub, sentinel;
  int rows;                      // rows per chunk
  int ct, ot;                    // tiles along cl and cr
  int lvec, rvec;                // 16-byte copies allowed per side
  float* part;                   // (nchunk, k, cl, cr)
};

// Channels [ch, ch + 8) of row `row` of a (rows, width) array into the 16
// shared bytes at dst; row < 0 or channels past `width` read zeros.  vec:
// one cp.async (width % 8 == 0, 16-byte aligned base); else 2-byte loads.
__device__ __forceinline__ void stage_chunk(uint32_t dst,
                                            const __nv_bfloat16* base,
                                            int row, int ch, int width,
                                            int vec) {
  if (vec) {
    const bool ok = row >= 0 && ch < width;
    cp_async16(dst, ok ? base + static_cast<int64_t>(row) * width + ch : base,
               ok ? 16 : 0);
    return;
  }
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(base);
  uint16_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    h[j] = (row >= 0 && ch + j < width)
               ? xs[static_cast<int64_t>(row) * width + ch + j]
               : uint16_t(0);
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(h[0] | (uint32_t(h[1]) << 16)),
               "r"(h[2] | (uint32_t(h[3]) << 16)),
               "r"(h[4] | (uint32_t(h[5]) << 16)),
               "r"(h[6] | (uint32_t(h[7]) << 16))
               : "memory");
}

template <int TM, int TN, bool GATHER_LEFT, bool SUB>
__global__ void __launch_bounds__(DW_THREADS)
    dw_mma_kernel(const DwMmaArgs p) {
  constexpr int NS = DW_STAGES;
  constexpr int WT = dw_warp_tiles(TM, TN);
  constexpr int KS = dw_ks(TM, TN);
  constexpr int WTN = TN / 32;
  constexpr int LCH = TM / 8;             // 16-byte chunks per staged row
  constexpr int RCH = TN / 8;
  constexpr int CH = LCH + RCH;
  constexpr int L_BYTES = DW_SEG * TM * 2;
  constexpr int STAGE = dw_stage_bytes(TM, TN);
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + NS * STAGE);
  int32_t* ent = reinterpret_cast<int32_t*>(smem + NS * STAGE +
                                            (KS - 1) * TM * TN * 4);
  int* count = ent + NS * 2 * DW_SEG;     // [NS] live entries per stage
  int* warp_n = count + NS;               // [DW_THREADS / 32]
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wt = warp % WT;               // this warp's 32 x 32 tile
  const int ks = warp / WT;               // and its share of the groups
  const int m0 = (wt / WTN) * 32;
  const int n0 = (wt % WTN) * 32;
  const int chunk = static_cast<int>(blockIdx.x) / (p.ct * p.ot);
  const int rem = static_cast<int>(blockIdx.x) % (p.ct * p.ot);
  const int c0 = (rem / p.ot) * TM;
  const int o0 = (rem % p.ot) * TN;
  const int r0 = chunk * p.rows;
  const int r1 = min(r0 + p.rows, p.v_out);
  const int nseg = max(1, (r1 - r0 + DW_SEG - 1) / DW_SEG);
  const int steps = p.k * nseg;
  float* part = p.part + static_cast<int64_t>(chunk) * p.k * p.cl * p.cr;

  // rulebook loads of step u (tap u / nseg, segment u % nseg) for this
  // thread's row; consumed a step later, so their latency is hidden
  struct Pre {
    int loc, base;
  };
  auto load = [&](int u) {
    Pre q{-1, 0};
    if (u < steps) {
      const int a = u / nseg;
      const int v = r0 + (u - a * nseg) * DW_SEG + tid;
      if (v < r1) {
        const int g = a % p.nwin;
        q.loc = __ldg(p.rb + a * p.rb_stride_k + v * p.rb_stride_v);
        q.base = __ldg(p.starts + (v / p.tile) * p.nwin + g);
        if (SUB) q.base += __ldg(p.soff + (v / p.sub) * p.nwin + g);
      }
    }
    return q;
  };
  // step u: compact its live entries in row order into stage u % NS's
  // tables, then gather both operands' rows of its whole 16-entry groups
  auto stage_step = [&](const Pre& q, int u) {
    const int buf = u % NS;
    const int v = r0 + (u % nseg) * DW_SEG + tid;
    const int s = q.base + q.loc;
    const bool live = q.loc >= 0 && q.loc < p.sentinel && s >= 0 &&
                      s < p.v_src;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < DW_THREADS / 32; ++w) {
      const int c = warp_n[w];
      off += w < warp ? c : 0;
      n += c;
    }
    int32_t* lr = ent + buf * 2 * DW_SEG;
    int32_t* rr = lr + DW_SEG;
    if (live) {
      const int i = off + __popc(m & ((1u << lane) - 1u));
      lr[i] = GATHER_LEFT ? s : v;
      rr[i] = GATHER_LEFT ? v : s;
    }
    if (tid == 0) count[buf] = n;
    __syncthreads();
    const uint32_t stage = ring + buf * STAGE;
    const int slots = ((n + 15) / 16) * 16 * CH;
    for (int i = tid; i < slots; i += DW_THREADS) {
      const int e = i / CH;
      const int c = i % CH;
      if (c < LCH)
        stage_chunk(stage + swz(e, c, LCH), p.left, e < n ? lr[e] : -1,
                    c0 + c * 8, p.cl, p.lvec);
      else
        stage_chunk(stage + L_BYTES + swz(e, c - LCH, RCH), p.right,
                    e < n ? rr[e] : -1, o0 + (c - LCH) * 8, p.cr, p.rvec);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // the first NS - 1 steps staged, the next one's rulebook loads issued
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < steps) stage_step(load(u), u);
    cp_async_commit();
  }
  Pre pre = load(NS - 1);
  for (int t = 0; t < steps; ++t) {
    const int u = t + NS - 1;
    if (u < steps) {
      stage_step(pre, u);
      pre = load(u + 1);
    }
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();                     // step t landed in stage t % NS

    const uint32_t lt = ring + (t % NS) * STAGE;
    const uint32_t rt = lt + L_BYTES;
    const int groups = (count[t % NS] + 15) / 16;
    for (int gi = ks; gi < groups; gi += KS) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi],
                          lt + swz(gi * 16 + (lane & 7) + (lane >> 4) * 8,
                                   (m0 + mi * 16) / 8 + ((lane >> 3) & 1),
                                   LCH));
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, rt + swz(gi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                         n0 / 8 + j2 * 2 + (lane >> 4), RCH));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * j2], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * j2 + 1], af[mi], bf[2], bf[3]);
        }
      }
    }

    const int a = t / nseg;
    if (t - a * nseg == nseg - 1) {
      // tap a's partial: the k-split warps' sums added in warp order
      if (KS > 1) {
        if (ks > 0) {
          float* dst = red + ((ks - 1) * WT + wt) * 32 * 32;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                dst[((i * 4 + j) * 4 + r) * 32 + lane] = acc[i][j][r];
        }
        __syncthreads();
        if (ks == 0) {
          for (int o = 1; o < KS; ++o) {
            const float* src = red + ((o - 1) * WT + wt) * 32 * 32;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  acc[i][j][r] += src[((i * 4 + j) * 4 + r) * 32 + lane];
          }
        }
      }
      if (ks == 0) {
        float* pa = part + static_cast<int64_t>(a) * p.cl * p.cr;
        const int g = lane >> 2;
        const int t4 = lane & 3;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = c0 + m0 + i * 16 + g + h * 8;
            if (c >= p.cl) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int o = o0 + n0 + j * 8 + t4 * 2 + e;
                if (o < p.cr)
                  pa[static_cast<int64_t>(c) * p.cr + o] = acc[i][j][2 * h + e];
              }
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }
  cp_async_wait<0>();
}

template <int TM, int TN, bool GATHER_LEFT, bool SUB>
int launch_dw_mma_tile(const DwMmaArgs& p, int nchunk, cudaStream_t stream) {
  static bool attr_set = false;
  constexpr int smem = dw_smem_bytes(TM, TN);
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_mma_kernel<TM, TN, GATHER_LEFT, SUB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int64_t blocks = static_cast<int64_t>(nchunk) * p.ct * p.ot;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dw_mma_kernel<TM, TN, GATHER_LEFT, SUB>
      <<<static_cast<unsigned>(blocks), DW_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core dW partials, both operands bf16, for the (tm, tn) tile,
// into part (nchunk, k, cl, cr) f32:
// * gather_left = 0, K2: left = feats (v_out, cl) dense, right = dout
//   (v_src, cr) gathered; sub form only;
// * gather_left = 1, K3/K5 and K6: left = the primal rows (v_src, cl)
//   gathered, right = dout (>= v_out, cr) dense; the sub form where soff
//   != NULL (K3, K6), else the flat form (K5: sentinel = window).
// Returns cudaGetLastError() after the launch (0 on success).
inline int dw_mma(const void* left, int cl, const void* right, int cr,
                  const void* starts, const void* soff, const void* rb,
                  int64_t rb_stride_k, int64_t rb_stride_v, int k,
                  int64_t v_src, int64_t v_out, int tile, int nwin, int sub,
                  int sentinel, int nchunk, int tm, int tn, int gather_left,
                  float* part, cudaStream_t stream) {
  const bool sub_form = soff != nullptr;
  if ((!sub_form && !gather_left) || cl <= 0 || cr <= 0 ||
      v_out > INT32_MAX || v_src > INT32_MAX ||
      (k - 1) * rb_stride_k + (v_out - 1) * rb_stride_v > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  DwMmaArgs p;
  p.left = static_cast<const __nv_bfloat16*>(left);
  p.right = static_cast<const __nv_bfloat16*>(right);
  p.cl = cl;
  p.cr = cr;
  p.starts = static_cast<const int32_t*>(starts);
  p.soff = static_cast<const int32_t*>(soff);
  p.rb = static_cast<const int32_t*>(rb);
  p.rb_stride_k = static_cast<int>(rb_stride_k);
  p.rb_stride_v = static_cast<int>(rb_stride_v);
  p.k = k;
  p.v_src = static_cast<int>(v_src);
  p.v_out = static_cast<int>(v_out);
  p.tile = tile;
  p.nwin = nwin;
  p.sub = sub;
  p.sentinel = sentinel;
  p.rows = static_cast<int>((v_out + nchunk - 1) / nchunk);
  p.ct = (cl + tm - 1) / tm;
  p.ot = (cr + tn - 1) / tn;
  p.lvec = cl % 8 == 0 && reinterpret_cast<uintptr_t>(left) % 16 == 0;
  p.rvec = cr % 8 == 0 && reinterpret_cast<uintptr_t>(right) % 16 == 0;
  p.part = part;
#define TDWSS_DW_TILE(TM_, TN_)                                          \
  if (tm == TM_ && tn == TN_) {                                          \
    if (!gather_left)                                                    \
      return launch_dw_mma_tile<TM_, TN_, false, true>(p, nchunk, stream); \
    return sub_form                                                      \
               ? launch_dw_mma_tile<TM_, TN_, true, true>(p, nchunk, stream) \
               : launch_dw_mma_tile<TM_, TN_, true, false>(p, nchunk,   \
                                                           stream);     \
  }
  TDWSS_DW_TILE(32, 32)
  TDWSS_DW_TILE(32, 64)
  TDWSS_DW_TILE(64, 32)
  TDWSS_DW_TILE(64, 64)
#undef TDWSS_DW_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace tdwss
