// Flash attention forward on Hopper's tensor cores: bf16 q, k, v with head
// dim 64, 128 or 256, online softmax over kv tiles, causal (top-left, rows
// >= cols) or full, optionally local (row r sees cols c with r - c <
// window, flash_attention_xla's mask), fp32 accumulation, bf16 output.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) for bf16 at D 64, 128 and 256, the head
// dims of the repo's full-width configs (256: recurrentgemma-2b's local
// attention); csrc/flash_attention.cu keeps fp32 and D 16/32.  It computes
// what _flash_kernel computes: per kv tile
//
//   s  = q . k^T * sm_scale, masked to -1e30 (causal, padded kv tail)
//   m' = max(m, max_j s);  a = exp(m - m');  l = l a + sum_j exp(s - m')
//   acc = acc a + exp(s - m') . v;  m = m'          (m starts at -1e30)
//   out = acc / max(l, 1e-30)
//
// with exp(x) taken as exp2(x log2 e), the scale sm_scale * log2 e folded
// into one fma with the max.  Where a tile needs the mask, the scores are
// scaled first and the masked ones set to -1e30, as in _flash_kernel; m
// starts at -1e30, so exp2(m - m') never sees inf - inf.  P is rounded to
// bf16 for the P.V product on the tensor cores (the reference keeps it in
// fp32: a relative error of about 2^-9 per weight, inside the 2e-2 bf16
// tolerance).
//
// What bounds it on an H100.  At the serving path's prefill shape (B 4,
// T 1000, Hq 32, Hkv 8, D 64, causal) the work is 16.4 GFLOP against 41 MB
// of q, k, v and o, about 400 operations per byte: the tensor cores' 989
// TFLOP/s bound it (17 us).  At D 64 the softmax is nearly as costly: one
// exp2 per score on the 16-per-clock MUFU units takes about as long as the
// score's 4 D multiply-adds on the tensor cores, and the P V product
// (m64n64k16 with P from registers) runs at about half the tensor rate.
// At T 1000 a q tile has at most 8 kv tiles, so each tile's fixed costs
// (q load, S_0 and its softmax alone, the last P V alone, the store) weigh
// as much as the steady state.  The design, after FA3:
//
// * a persistent grid, one block per SM; block c takes work tiles c,
//   c + grid, ... where a work tile is one 128-row q tile of one (q head,
//   batch), the latest q tiles (heaviest under the causal mask) first;
//   3 warpgroups: two consumers, each owning 64 q rows (the M of one
//   wgmma), and a producer whose single thread issues TMA loads
//   (setmaxnreg gives the producer 24 registers and the consumers 240);
// * the producer loads a work tile's q once it is free, and k and v tiles
//   of 128 rows into a ring of 2 shared-memory stages that runs on across
//   work tiles, so the next tile's q, k and v arrive while the consumers
//   finish the last one; q, k and v each have a full barrier (TMA bytes)
//   and an empty barrier (the consumers' release) per stage, so a k tile
//   is reloaded as soon as S no longer needs it.  TMA takes the tensors by
//   (batch, time, head) strides (both layouts, strided views), zero-fills
//   rows past T and writes the 128-byte swizzle that wgmma reads; D 128 is
//   two boxes of 64 columns (a 128-byte swizzled box is at most 128 bytes
//   wide);
// * S = Q K^T is one wgmma chain, m64n128k16 over D/16 steps, both operands
//   from shared memory (K-major); O += P V a second chain, P as the
//   register A operand (the m64n128 accumulator's layout is the A
//   fragment's for each 16-column slice), V read MN-major (transpose bit);
// * a consumer issues S_i and P_{i-1} V_{i-1} together and runs the
//   softmax of S_i while P V is on the tensor cores; the two consumers
//   overlap each other's softmax with their products;
// * kv tiles wholly past a q tile's last row, or (under a window) wholly
//   below its first row's window, are never loaded; the mask runs only on
//   the tiles at the window's lower edge, the diagonal tile and the ragged
//   kv tail: the loop is masked tiles, plain tiles, masked tiles.  No row
//   is fully masked under causal plus window (the diagonal is visible), so
//   the -1e30 of a row's masked first tile is rescaled away once its
//   visible columns come.  A q tile's work under a window grows with its
//   row up to about window + 128 columns and then stays there, so the
//   latest-first order is still heaviest-first;
// * the output goes through shared memory and a TMA store, which skips
//   the rows past Tq.
//
// D 256 (recurrentgemma-2b: B 4, T 4096, Hq 10 on one kv head, window
// 2048) is the same design with what the head dim forces.  Its work there
// is 2.6e11 FLOP against 0.19 GB: the tensor cores bound it (0.26 ms).
// * kv tiles of 64 rows: q (64 KB) and a 2-stage ring of 64-row k and v
//   tiles (4 x 32 KB) fill 192 KB of the 227 KB a block may take, so no
//   output buffer fits; each consumer stages its 64 output rows in its own
//   half of the q tile once its last product is done, and the q tile is
//   released to the producer only after the store has read them.
// * S is 64 x 64 per consumer (m64n64k16, 16 k-steps over the 4 boxes of
//   D); O += P V is m64n256k16 with a 128-register fp32 accumulator, V's
//   four boxes 64 rows apart (the descriptor's leading offset).  The
//   accumulator (128), S (32) and packed P (16) registers a thread leave
//   room under setmaxnreg's 240 for the same S / P V overlap as at D 128.
// * MQA: the 10 q heads of one (q tile, batch) are consecutive work
//   tiles, so they read one kv head's tiles from L2 at about the same
//   time.
//
// Training (grad on) also asks for each row's log-sum-exp, which the
// backward kernels read instead of computing it again: lse = m + log2(l)
// in base 2 of the scaled scores (the units the kernel keeps m and l in),
// fp32 (B, Hq, Tq), written by the epilogue of a row's tile when the
// launcher is given a buffer; serving passes none and nothing is written.
//
// C interface, bound with ctypes from repro_torch/kernels/flash_attention.py,
// which computes each tensor's TMA geometry (and checks its alignment);
// the maps themselves are encoded here per call with libcuda's
// cuTensorMapEncodeTiled, looked up at first use (sm90_ptx.cuh).

#include <type_traits>

#include "sm90_ptx.cuh"

namespace {

constexpr float kNegInf = -1e30f;     // _flash_kernel's NEG_INF
constexpr float kDenomMin = 1e-30f;   // _flash_kernel's denominator clamp
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockQ = 128;          // q rows per block: 2 consumers x 64
constexpr int kStages = 2;            // k/v ring depth
constexpr int kBoxCols = 64;          // bf16 columns per 128-byte TMA box
constexpr int kThreads = 384;         // 2 consumer + 1 producer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may take

template <int D>
struct Smem {
  static constexpr int kBoxes = D / kBoxCols;          // 1, 2 or 4
  static constexpr int kBlockK = D == 256 ? 64 : 128;  // kv rows per tile
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;    // one k or v tile
  // D 256: no room for an output buffer; the consumers stage their rows in
  // their own halves of the q tile
  static constexpr bool kOutInQ = D == 256;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kO = kOutInQ ? kQ : kV + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes + (kOutInQ ? 0 : kQBytes);
  // barriers: full and empty for q, then for k and for v, kStages each
  static constexpr int kBytes = kBars + 8 * (2 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;         // room to align
  static_assert(kAlloc <= kMaxSmem, "shared memory of one block");
};

// S = Q K^T for one consumer: D/16 k-steps, each 32 bytes further along
// the 128-byte rows of a box, into the next box after 4 (D 128: 2 boxes,
// D 256: 4); S is 64 x kBlockK (m64n128k16, or m64n64k16 at D 256).
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[Smem<D>::kBlockK / 2],
                                        uint32_t q_rows, uint32_t k_tile) {
  constexpr int BK = Smem<D>::kBlockK;
  const uint64_t da = smem_desc(q_rows, 16, 1024);
  const uint64_t db = smem_desc(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t a = da + (((kk / 4) * kBlockQ * 128 + off) >> 4);
    const uint64_t b = db + (((kk / 4) * BK * 128 + off) >> 4);
    if constexpr (BK == 64) wgmma_m64n64k16_ss(sc, a, b, kk > 0);
    else wgmma_m64n128k16_ss(sc, a, b, kk > 0);
  }
}

// O += P V: kBlockK/16 k-steps of 16 kv rows (2048 bytes) each; V's boxes
// of 64 columns are kBlockK rows apart
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[D / 2], const uint32_t (&p)[Smem<D>::kBlockK / 16][4],
    uint32_t v_tile) {
  constexpr int BK = Smem<D>::kBlockK;
  const uint64_t db = smem_desc(v_tile, BK * 128, 1024);
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
    if constexpr (D == 64) wgmma_m64n64k16_rs(acc, p[t], db + t * 128);
    else if constexpr (D == 128) wgmma_m64n128k16_rs(acc, p[t], db + t * 128);
    else wgmma_m64n256k16_rs(acc, p[t], db + t * 128);
  }
}

// The online softmax of one consumer thread: rows r0 and r0 + 8, its two
// columns in each group of 8 of the kv tile (N = kBlockK / 2 scores).
struct Softmax {
  float m_a = kNegInf, m_b = kNegInf;   // running max (log2 units)
  float l_a = 0.f, l_b = 0.f;           // this thread's share of the sums
  float alpha_a = 0.f, alpha_b = 0.f;   // rescale of this tile

  // Scores of kv tile n0 -> exp2(s - m) in place, with the new max, the
  // rescale alpha and the sums.  kMask: the tile holds cols past Tk or
  // (causal) cols above some row.  There the scores are scaled, then the
  // masked ones set to -1e30, as in _flash_kernel.  Elsewhere the max is
  // taken on the raw scores (the scale is positive, and rounding is
  // monotonic, so scale * max(s) is max(scale * s) exactly) and the scale
  // folds into one fma with the max: exp2(s * scale - m).
  template <bool kMask, int N>
  __device__ __forceinline__ void tile(float (&sc)[N], int r0,
                                       int c0, int n0, int Tk, int causal,
                                       int window, float scale_log2) {
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};  // 2 per row: ILP
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if (kMask) {
          const int col = n0 + 8 * j + c0 + (e & 1);
          const int row = e < 2 ? r0 : r0 + 8;
          x = (col >= Tk || (causal && row < col) || row - col >= window)
                  ? kNegInf : x * scale_log2;
          sc[4 * j + e] = x;
        }
        mx[(e & 2) | (j & 1)] = fmaxf(mx[(e & 2) | (j & 1)], x);
      }
    }
    float new_a = quad_max(fmaxf(mx[0], mx[1]));
    float new_b = quad_max(fmaxf(mx[2], mx[3]));
    if (!kMask) {
      new_a *= scale_log2;
      new_b *= scale_log2;
    }
    new_a = fmaxf(m_a, new_a);
    new_b = fmaxf(m_b, new_b);
    alpha_a = ex2(m_a - new_a);
    alpha_b = ex2(m_b - new_b);
    m_a = new_a;
    m_b = new_b;
    const float scale = kMask ? 1.f : scale_log2;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = ex2(fmaf(sc[4 * j + e], scale,
                                 -(e < 2 ? new_a : new_b)));
        sc[4 * j + e] = x;
        sum[(e & 2) | (j & 1)] += x;
      }
    }
    l_a = l_a * alpha_a + (sum[0] + sum[1]);
    l_b = l_b * alpha_b + (sum[2] + sum[3]);
  }

  template <int N>
  __device__ __forceinline__ void rescale(float (&acc)[N]) const {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      acc[4 * j + 0] *= alpha_a;
      acc[4 * j + 1] *= alpha_a;
      acc[4 * j + 2] *= alpha_b;
      acc[4 * j + 3] *= alpha_b;
    }
  }
};

// P as bf16 A fragments: slice t holds columns 16t..16t+15, registers
// (r0, c), (r0+8, c), (r0, c+8), (r0+8, c+8) -- the S accumulator's
// elements 8t..8t+7 in order.
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N],
                                       uint32_t (&p)[N / 8][4]) {
#pragma unroll
  for (int t = 0; t < N / 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[t][r] = pack_bf16(sc[8 * t + 2 * r], sc[8 * t + 2 * r + 1]);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmap_q,
                      const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v,
                      const __grid_constant__ CUtensorMap tmap_o,
                      float* __restrict__ lse, int B, int Hq, int Hkv,
                      int Tq, int Tk, int causal, int window,
                      float scale_log2) {
  using L = Smem<D>;
  constexpr int kBlockK = L::kBlockK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle atoms
  const uint32_t sq = base + L::kQ;
  const uint32_t full_q = base + L::kBars;
  const uint32_t empty_q = full_q + 8;
  const uint32_t full_k = empty_q + 8;           // [kStages] each
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  auto k_tile = [&](int s) { return base + L::kK + s * L::kKVBytes; };
  auto v_tile = [&](int s) { return base + L::kV + s * L::kKVBytes; };

  // Persistent: block c takes work tiles c, c + gridDim.x, ...  A work
  // tile is a 128-row q tile of one (q head, batch); they are numbered
  // latest q tile (heaviest under the causal mask) first, all heads and
  // batches of one q tile together.  kv tile j of the block's whole run
  // uses ring stage j % kStages in round j / kStages.
  const int n_qt = (Tq + kBlockQ - 1) / kBlockQ;
  const int n_work = n_qt * Hq * B;
  // A work tile walks kv tiles [lo, n_tiles).
  auto work = [&](int w, int& m0, int& h, int& b, int& lo, int& n_tiles) {
    const int hb = w % (Hq * B);
    h = hb % Hq;
    b = hb / Hq;
    m0 = (n_qt - 1 - w / (Hq * B)) * kBlockQ;
    // causal: kv tiles starting after the q tile's last row are skipped
    n_tiles = ((causal ? min(Tk, m0 + kBlockQ) : Tk) + kBlockK - 1)
              / kBlockK;
    // the window: kv tiles ending before the first row's window too (at
    // least one tile is walked: the consumers' prologue needs one, even
    // for a q tile whose rows all lie past Tk + window)
    lo = min(max(0, m0 - (window - 1)) / kBlockK, n_tiles - 1);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerThreads);
      mbar_init(empty_v + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform in a way ptxas can see, for setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load ---------
    // Each wait is for the consumers' release of the round before (the
    // first round passes at once).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int j = 0;                           // kv tiles loaded so far
      for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
        int m0, h, b, lo, n_tiles;
        work(w, m0, h, b, lo, n_tiles);
        const int hk = h / (Hq / Hkv);
        mbar_wait(empty_q, (n & 1) ^ 1);
        mbar_expect_tx(full_q, L::kQBytes);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(sq + x * kBlockQ * 128, &tmap_q, full_q, x * kBoxCols, m0,
                   h, b);
        for (int i = lo; i < n_tiles; ++i, ++j) {
          const int s = j % kStages;
          const uint32_t phase = ((j / kStages) & 1) ^ 1;
          mbar_wait(empty_k + 8 * s, phase);
          mbar_expect_tx(full_k + 8 * s, L::kKVBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(k_tile(s) + x * kBlockK * 128, &tmap_k, full_k + 8 * s,
                     x * kBoxCols, i * kBlockK, hk, b);
          mbar_wait(empty_v + 8 * s, phase);
          mbar_expect_tx(full_v + 8 * s, L::kKVBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(v_tile(s) + x * kBlockK * 128, &tmap_v, full_v + 8 * s,
                     x * kBoxCols, i * kBlockK, hk, b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 q rows each --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int row = wg * 64 + warp * 16 + lane / 4;  // + m0: rows r0, r0 + 8
    const int c0 = 2 * (lane % 4);        // its first column in each 8
    const uint32_t q_rows = sq + wg * 64 * 128;
    float acc[D / 2];
    float sc[kBlockK / 2];
    uint32_t p[kBlockK / 16][4];

    int j0 = 0;                            // ring position of the tile's kv lo
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      int m0, h, b, lo, n_tiles;
      work(w, m0, h, b, lo, n_tiles);
      const int r0 = m0 + row;
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
      Softmax sm;
      // kv tiles in [lo_plain, n_plain) need no mask; the mask, when
      // needed, is on the first ones (the window's lower edge: a tile is
      // plain once every row sees its first col, n0 >= m0 + 128 - window)
      // and on the last one or two (the diagonal tile, the ragged kv tail)
      const int n_plain = min(min(n_tiles, Tk / kBlockK),
                              causal ? m0 / kBlockK : n_tiles);
      const int lo_plain =
          (max(0, m0 + kBlockQ - window) + kBlockK - 1) / kBlockK;
      auto plain = [&](int i) { return i >= lo_plain && i < n_plain; };
      // One step of the main loop: S_i and P_{i-1} V_{i-1} issued
      // together, the softmax of S_i while P V is on the tensor cores.  No
      // branch holds a wgmma, a commit or a wait, so ptxas keeps the
      // products asynchronous.
      auto step = [&](int i, auto mask) {
        const int j = j0 + i - lo;
        const int s = j % kStages, sp = (j - 1) % kStages;
        mbar_wait(full_k + 8 * s, (j / kStages) & 1);
        mbar_wait(full_v + 8 * sp, ((j - 1) / kStages) & 1);
        fence_regs(acc);
        wgmma_fence();
        issue_s<D>(sc, q_rows, k_tile(s));
        wgmma_commit();
        issue_pv<D>(acc, p, v_tile(sp));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        mbar_arrive(empty_k + 8 * s);
        sm.tile<decltype(mask)::value>(sc, r0, c0, i * kBlockK, Tk, causal,
                                       window, scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty_v + 8 * sp);
        sm.rescale(acc);
        pack_p(sc, p);
      };

      // prologue: S_lo alone
      mbar_wait(full_q, n & 1);
      const int s0 = j0 % kStages;
      mbar_wait(full_k + 8 * s0, (j0 / kStages) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_s<D>(sc, q_rows, k_tile(s0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k + 8 * s0);
      if (plain(lo))
        sm.tile<false>(sc, r0, c0, lo * kBlockK, Tk, causal, window,
                       scale_log2);
      else
        sm.tile<true>(sc, r0, c0, lo * kBlockK, Tk, causal, window,
                      scale_log2);
      pack_p(sc, p);
      // main loop: masked tiles at the window's edge, plain tiles, masked
      // tiles at the diagonal and the kv tail
      int i = lo + 1;
      for (const int e = min(lo_plain, n_tiles); i < e; ++i)
        step(i, std::true_type{});
      for (; i < n_plain; ++i) step(i, std::false_type{});
      for (; i < n_tiles; ++i) step(i, std::true_type{});
      // every S is done: the producer may load the next q tile (at D 256
      // only once the output staged in it is stored, below)
      if constexpr (!L::kOutInQ) mbar_arrive(empty_q);
      // the last P V alone
      {
        const int j = j0 + n_tiles - lo - 1;
        const int sp = j % kStages;
        mbar_wait(full_v + 8 * sp, (j / kStages) & 1);
        fence_regs(acc);
        wgmma_fence();
        issue_pv<D>(acc, p, v_tile(sp));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty_v + 8 * sp);
      }
      j0 += n_tiles - lo;

      // Divide by the clamped row sums, round to bf16 and stage the rows in
      // shared memory in the 128-byte swizzle of the output map (at D 256
      // in this consumer's half of the q tile, which its last S has read);
      // one thread stores them with TMA, which skips rows past Tq.  The
      // buffer is rewritten only once the previous tile's store has read
      // it.
      const float l_a = quad_sum(sm.l_a), l_b = quad_sum(sm.l_b);
      const float inv_a = 1.f / fmaxf(l_a, kDenomMin);
      const float inv_b = 1.f / fmaxf(l_b, kDenomMin);
      if (lse != nullptr && c0 == 0) {
        // the rows' log-sum-exp for the backward (training only)
        float* out = lse + (static_cast<long long>(b) * Hq + h) * Tq;
        if (r0 < Tq) out[r0] = sm.m_a + __log2f(l_a);
        if (r0 + 8 < Tq) out[r0 + 8] = sm.m_b + __log2f(l_b);
      }
      const bool leader = threadIdx.x % 128 == 0;
      if (leader)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      wg_sync(wg);
      const uint32_t so = base + L::kO;
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        // 8 columns x: box x / 8, 16-byte chunk x % 8 of a 128-byte row
        const uint32_t box = so + (x / 8) * kBlockQ * 128;
        const int ra = row, rb = row + 8;
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(
            box + ra * 128 + (((x % 8) ^ (ra % 8)) * 16) + c0 * 2),
            "r"(pack_bf16(acc[4 * x] * inv_a, acc[4 * x + 1] * inv_a))
            : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(
            box + rb * 128 + (((x % 8) ^ (rb % 8)) * 16) + c0 * 2),
            "r"(pack_bf16(acc[4 * x + 2] * inv_b, acc[4 * x + 3] * inv_b))
            : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
      if (leader) {
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_store(&tmap_o, so + x * kBlockQ * 128 + wg * 64 * 128,
                    x * kBoxCols, m0 + wg * 64, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if constexpr (L::kOutInQ) {
        // the rows were staged in this consumer's half of the q tile: it
        // is free for the next q tile once the store has read them
        if (leader)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        wg_sync(wg);
        mbar_arrive(empty_q);
      }
    }
    if (threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <int D>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const CUtensorMap& mo, float* lse, int B,
           int Hq, int Hkv, int Tq, int Tk, int causal, int window,
           float sm_scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::kAlloc);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int n_sm = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  // persistent: one block per SM, or fewer when there is less work
  const long long n_work =
      static_cast<long long>((Tq + kBlockQ - 1) / kBlockQ) * Hq * B;
  if (n_work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_work < n_sm ? n_work : n_sm);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, Smem<D>::kAlloc, stream>>>(
      mq, mk, mv, mo, lse, B, Hq, Hkv, Tq, Tk, causal, window,
      sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, o; head_dim 64, 128 or 256.  geom: 8 values (see encode)
// for each of q, k, v and o in turn (k and v boxes of Smem<D>::kBlockK
// rows).  window: row r sees cols c with r - c <
// window (a value above every r - c for none).  lse: an fp32 (B, Hq, Tq)
// buffer for the rows' log-sum-exp (base 2 of the scaled scores), or null.
// Returns 0, a cudaError_t, 1000 + a CUresult of the map encoding, or -1
// when libcuda has no cuTensorMapEncodeTiled.
extern "C" int flash_sm90_launch(
    int head_dim, const void* q, const void* k, const void* v, void* o,
    void* lse, int B, int Hq, int Hkv, int Tq, int Tk,
    const unsigned long long* geom, int causal, int window, float sm_scale,
    void* stream) {
  // the box heights the kernel's barriers expect (a TMA load of another
  // size would never complete them)
  const unsigned long long kv_rows =
      head_dim == 256 ? Smem<256>::kBlockK : Smem<128>::kBlockK;
  if (geom[7] != kBlockQ || geom[15] != kv_rows || geom[23] != kv_rows
      || geom[31] != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mo;
  int rc;
  if ((rc = make_context_current()) || (rc = encode(&mq, q, geom, geom[7]))
      || (rc = encode(&mk, k, geom + 8, geom[15]))
      || (rc = encode(&mv, v, geom + 16, geom[23]))
      || (rc = encode(&mo, o, geom + 24, geom[31])))
    return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const out_lse = static_cast<float*>(lse);
  switch (head_dim) {
    case 64: return launch<64>(mq, mk, mv, mo, out_lse, B, Hq, Hkv, Tq, Tk, causal,
                               window, sm_scale, st);
    case 128: return launch<128>(mq, mk, mv, mo, out_lse, B, Hq, Hkv, Tq, Tk, causal,
                                 window, sm_scale, st);
    case 256: return launch<256>(mq, mk, mv, mo, out_lse, B, Hq, Hkv, Tq, Tk, causal,
                                 window, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_sm90_error_string(int code) {
  if (code == -1) return "libcuda has no cuTensorMapEncodeTiled";
  if (code >= 1000) return "cuTensorMapEncodeTiled refused the geometry";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
