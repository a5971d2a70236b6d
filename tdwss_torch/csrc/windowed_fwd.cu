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
// * bf16: the tensor-core body below (fwd_mma_kernel).
// * f32: tdwss::gather_gemm_block (windowed_common.cuh; K2's dfeats runs
//   it too), a 4 x 4 f32 micro-tile per thread on the CUDA cores.  TF32
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

#include "windowed_common.cuh"

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

// --------------------------------------------------------------------------
// bf16 body: cp.async ring, mma.sync on the tensor cores
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

// The tensor-core body, bf16 only.  w is (k, c, ldw) with ldw a multiple
// of 8 >= cout and a 16-byte aligned base; n_tile in {32, 64, 128, 256}
// (the rest of the tiling follows from it).  Row counts and rb's indices
// must fit in 32 bits.  Returns
// cudaGetLastError() after the launch (0 on success).
int tdwss_windowed_fwd_mma(const void* x, int64_t v_src, int c,
                           const void* starts, const void* soff,
                           const void* rb, int64_t rb_stride_k,
                           int64_t rb_stride_v, const void* w, int ldw, int k,
                           int cout, void* out, int64_t v_out, int tile,
                           int nwin, int sub, int sentinel, int n_tile,
                           void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tile) {
    case 32: return launch_mma<32>(p, s);
    case 64: return launch_mma<64>(p, s);
    case 128: return launch_mma<128>(p, s);
    case 256: return launch_mma<256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
