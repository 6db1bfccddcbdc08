// Flash attention backward on Hopper's tensor cores: (dQ, dK, dV) of the
// forward flash_attention_sm90.cu computes, bf16 in and out with fp32
// accumulation, head dim 64, 128 or 256, causal (top-left) or full,
// optionally local (row r sees cols c with r - c < window), GQA and MQA (a
// kv head's dK and dV sum over the query heads that share it), Tq == Tk,
// both layouts and any strides TMA can read.
//
// Replaces no Pallas kernel: the reference's Pallas flash kernel
// (src/repro/kernels/flash_attention.py::flash_attention) has no backward,
// and its model gets the attention gradient from jax.grad of
// src/repro/models/layers.py::flash_attention_xla.  It computes what
// repro_torch/kernels/flash_attention.py::attention_backward_plain does:
//
//   P  = exp2(S * sm_scale * log2 e - lse)        (lse: the forward's, base 2)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dO * O)),
//   dQ = dS K * sm_scale,  dK = dS^T Q * sm_scale
//
// with P and dS rounded to bf16 for the second products (as the forward
// rounds P for P V).
//
// What bounds it on an H100.  At llama3.2-1b's training shape (B 4, T 1024,
// Hq 32, Hkv 8, D 64, causal) the five products of the visible (q, k)
// pairs are 4.30e10 FLOP, 0.0435 ms at 989 TFLOP/s, against 84 MB of q,
// k, v, o, dO read and dq, dk, dv written (0.025 ms at 3.35 TB/s); at
// recurrentgemma-2b's (B 1, T 4096, Hq 10
// on one kv head, D 256, window 2048) 1.61e11 FLOP (0.163 ms) against 92
// MB (0.028 ms).  The tensor cores bound both.  The design follows the
// forward's (wgmma from shared memory fed by a TMA ring, persistent grids,
// heaviest work tiles first, a producer warp and two consumer warpgroups)
// and keeps runs deterministic: no atomics, every sum in a fixed order.
// Three or four launches on the caller's stream make one call:
//
// * prep: delta = rowsum(dO * O) and a copy of the forward's lse, both
//   fp32 in (B, Hq, Tpad) buffers, Tpad = T rounded up to 128; padded rows
//   get lse = +inf, so their P is 0 whatever their (zero-filled) q row;
// * dK/dV (one work tile per kv tile, kv head, batch and head split): K
//   and V stay in shared memory; the producer streams the 64-row q and dO
//   tiles of every query head of the split that sees the kv tile, with
//   their 64 lse and delta values (1-d bulk copies), through a ring.  At D
//   64 and 128 a kv tile is 128 rows, 64 per consumer, and each consumer
//   makes S^T = K Q^T, dP^T = V dO^T, P^T, dS^T, dV += P^T dO and dK +=
//   dS^T Q for its rows (3-stage ring; the 128-row tile halves the q and
//   dO traffic of 64-row tiles).  At D 256 two 64 x 256 fp32 accumulators
//   (256 registers a thread) do not fit, so a kv tile is 64 rows, consumer
//   0 makes S^T, P^T and dV, consumer 1 dP^T, dS^T and dK, and consumer 0
//   hands P^T to consumer 1 through shared memory (each thread's 32
//   values, its accumulator layout being the other's) behind a full and
//   an empty mbarrier (2-stage ring: 209 KB of shared memory).  4
//   products;
// * dQ (one work tile per 128-row q tile, q head, batch; the latest q
//   tiles first): Q and dO stay in shared memory; the producer streams K
//   and V tiles through a 3-stage ring.  Each consumer owns 64 q rows: S
//   = Q K^T and dP = dO V^T, dS, dQ += dS K, software-pipelined as the
//   forward's S and P V are: tile i's S and dP are issued with tile i-1's
//   dQ product, and dS_i is made while that product runs.  kv tiles of
//   128 rows at D 64, 64 at D 128 and 32 at D 256, where the 128-row q
//   and dO tiles take 128 KB (225 KB in all).  3 products;
// * reduce (only with a head split): under MQA the (kv tile, kv head,
//   batch) tiles are too few for the card (recurrentgemma-2b: 64 for 132
//   SMs), so the group's query heads are split over work tiles that write
//   fp32 partial dK and dV; this pass sums them in split order.
//
// So 7 products in all (FlashAttention-3's single pass needs 5, but its dQ
// is accumulated with atomics in whatever order blocks finish, and a run
// would not be bit-equal to the next).  Each score's P is recomputed in
// both kernels: one ex2 per score on the 16-per-clock MUFU units takes
// about as long as its products at D 64.  The S-type products read both
// operands from shared memory (K-major); the second products take P or dS
// from registers (the m64nN accumulator's layout is the A fragment's for
// each 16-column slice) and read dO, Q or K MN-major (transpose bit), in
// the 128-byte swizzle TMA writes.  Tiles wholly masked by the causal mask
// or the window are never loaded; the mask runs only on the tiles at the
// diagonal, the window's edge and the ragged tails.  A P computed for a
// masked pair is replaced by 0 before it is used.  Pipelining the dK/dV
// kernel as the dQ kernel is did not pay: 7% slower at D 64, and at D 128
// its six live fragment sets spilled and serialised the wgmma.
//
// C interface, bound with ctypes from repro_torch/kernels/flash_attention.py,
// which computes the TMA geometry of q, k, v and dO (and checks their
// alignment), the head split, and allocates the outputs and the scratch.

#include <math.h>

#include "sm90_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;             // q rows of the dK/dV kernel's q tiles
constexpr int kBlockQ = 128;          // q rows of a dQ work tile: 2 consumers x 64
constexpr int kPadRows = 128;         // lse and delta rows padded to a multiple
constexpr int kThreads = 384;         // 2 consumer + 1 producer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may take

struct Strides {
  long long b, t, h;                  // elements; D has stride 1
};

// dK/dV kernel: K, V, a ring of (q, dO) tiles, P^T (D 256), the ring's lse
// and delta values, barriers.  At D 64 and 128 a work tile is 128 kv rows,
// 64 per consumer, and each consumer makes all four products for its rows;
// at D 256 two 64 x 256 fp32 accumulators do not fit one thread's
// registers, so a work tile is 64 kv rows, consumer 0 makes dV and
// consumer 1 dK, and P^T is handed from 0 to 1 through shared memory.
template <int D>
struct KVSmem {
  static constexpr bool kHandOff = D == 256;
  static constexpr int kBlockK = kHandOff ? 64 : 128;  // kv rows per work tile
  static constexpr int kStages = kHandOff ? 2 : 3;     // (q, dO) ring depth
  static constexpr int kBoxes = D / kTmaBoxCols;
  static constexpr int kKVTile = kBlockK * D * 2;
  static constexpr int kQTile = kRows * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKVTile;
  static constexpr int kQ = 2 * kKVTile;               // + s * 2 kQTile; dO + kQTile
  static constexpr int kP = kQ + kStages * 2 * kQTile; // 32 floats x 128 threads
  static constexpr int kVals = kP + (kHandOff ? 32 * 128 * 4 : 0);
  static constexpr int kBars = kVals + kStages * 2 * kRows * 4;  // 64 lse, 64 delta
  // full and empty: kv, then the ring's kStages each, then P^T
  static constexpr int kBytes = kBars + 8 * (4 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;         // room to align
  static_assert(kAlloc <= kMaxSmem, "shared memory of one block");
};

// dQ kernel: q and dO tiles of 128 rows, a ring of (k, v) tiles, barriers.
template <int D>
struct QSmem {
  static constexpr int kBoxes = D / kTmaBoxCols;
  // kv rows per tile: the S and dP accumulators, dQ's and the packed dS
  // share a thread's registers
  static constexpr int kBlockK = D == 64 ? 128 : D == 128 ? 64 : 32;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;               // + s * 2 kKVBytes; v + kKVBytes
  static constexpr int kBars = kK + kStages * 2 * kKVBytes;
  // full and empty: q, then the ring's kStages each
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= kMaxSmem, "shared memory of one block");
};

__device__ __forceinline__ bool visible(int row, int col, int T, int causal,
                                        int window) {
  return row < T && col < T && (!causal || row >= col) && row - col < window;
}

// acc (64 x N) = A . B^T over D: A 64 rows and B N rows of K-major tiles
// whose 64-column boxes lie ABox and BBox bytes apart; each k-step is 32
// bytes further along the 128-byte rows of a box, into the next box after
// 4.
template <int D, int N, int ABox, int BBox>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a,
                                         uint32_t b) {
  const uint64_t da = smem_desc(a, 16, 1024);
  const uint64_t db = smem_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t x = da + (((kk / 4) * ABox + off) >> 4);
    const uint64_t y = db + (((kk / 4) * BBox + off) >> 4);
    if constexpr (N == 32) wgmma_m64n32k16_ss(acc, x, y, kk > 0);
    else if constexpr (N == 64) wgmma_m64n64k16_ss(acc, x, y, kk > 0);
    else wgmma_m64n128k16_ss(acc, x, y, kk > 0);
  }
}

// acc (64 x D) += A . B: A (64 x R) from registers, R / 16 slices; B the R
// rows of a tile read MN-major (its 64-column boxes R * 128 bytes apart),
// 16 rows (2048 bytes) per k-step.
template <int D, int R>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[R / 16][4],
                                         uint32_t b) {
  const uint64_t db = smem_desc(b, R * 128, 1024);
#pragma unroll
  for (int t = 0; t < R / 16; ++t) {
    if constexpr (D == 64) wgmma_m64n64k16_rs(acc, a[t], db + t * 128);
    else if constexpr (D == 128) wgmma_m64n128k16_rs(acc, a[t], db + t * 128);
    else wgmma_m64n256k16_rs(acc, a[t], db + t * 128);
  }
}

// An accumulator as bf16 A fragments: slice t holds columns 16t..16t+15,
// the accumulator's elements 8t..8t+7 in order.
template <int N>
__device__ __forceinline__ void pack(const float (&x)[N],
                                     uint32_t (&p)[N / 8][4]) {
#pragma unroll
  for (int t = 0; t < N / 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[t][r] = pack_bf16(x[8 * t + 2 * r], x[8 * t + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// A consumer thread's rows `row` and `row + 8` of a 64 x N accumulator
// (its columns 8x + cl, + 1) times `scale`, into a bf16 tensor (rows at
// or past T skipped) or, with `part`, into an fp32 (T, D) partial.
template <int N>
__device__ __forceinline__ void store_rows(bf16* out, long long st,
                                           float* part, int row, int cl,
                                           int T, const float (&acc)[N],
                                           float scale) {
#pragma unroll
  for (int x = 0; x < N / 4; ++x)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= T) continue;
      const float lo = acc[4 * x + 2 * half], hi = acc[4 * x + 2 * half + 1];
      const int col = 8 * x + cl;
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + static_cast<long long>(r) * (2 * N)
                                   + col) = make_float2(lo, hi);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + r * st + col) =
            __floats2bfloat162_rn(lo * scale, hi * scale);
    }
}

// ---------------------------------------------------------------------------
// prep: delta = rowsum(dO * O) and the forward's lse, padded to Tpad rows
// ---------------------------------------------------------------------------

// D / 8 threads per row, 8 columns (16 bytes) each: every row of o and dO
// starts on 16 bytes (the wrapper checks o; TMA's plan checks dO).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse_pad,
                      float* __restrict__ delta, int Hq, int T, int Tpad,
                      Strides so, Strides sdo) {
  constexpr int G = D / 8;                 // threads per row
  const int r = blockIdx.x * (256 / G) + threadIdx.x / G, g = threadIdx.x % G;
  const int h = blockIdx.y, b = blockIdx.z;
  float part = 0.f;
  if (r < T) {
    const bf16* po = o + b * so.b + r * so.t + h * so.h + 8 * g;
    const bf16* pd = dout + b * sdo.b + r * sdo.t + h * sdo.h + 8 * g;
    const uint4 x = *reinterpret_cast<const uint4*>(po);
    const uint4 y = *reinterpret_cast<const uint4*>(pd);
    const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yd = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(xo[i]);
      const float2 c = __bfloat1622float2(yd[i]);
      part = fmaf(a.x, c.x, fmaf(a.y, c.y, part));
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (g == 0 && r < Tpad) {
    const long long row = static_cast<long long>(b) * Hq + h;
    delta[row * Tpad + r] = part;
    lse_pad[row * Tpad + r] = r < T ? lse[row * T + r] : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one kv tile (KVSmem::kBlockK rows) of one kv head, batch and head
// split
// ---------------------------------------------------------------------------

// P^T = exp2(S^T scale - lse of its column), 0 for a masked pair, for a
// consumer thread's kv rows kv, kv + 8 and its columns (q rows q0 + 8 jj +
// cl, + 1); dP^T -> dS^T = P^T (dP^T - delta of its column) in place when
// given.
template <bool kMask, bool kDS>
__device__ __forceinline__ void p_tile(float (&st)[32], float (&dpt)[32],
                                       const float* vals, int kv, int q0,
                                       int cl, int T, int causal, int window,
                                       float scale_log2) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 l = *reinterpret_cast<const float2*>(vals + 8 * jj + cl);
    const float2 dl =
        *reinterpret_cast<const float2*>(vals + kRows + 8 * jj + cl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(st[4 * jj + e], scale_log2, -((e & 1) ? l.y : l.x)));
      if (kMask && !visible(q0 + 8 * jj + cl + (e & 1), kv + (e < 2 ? 0 : 8),
                            T, causal, window))
        p = 0.f;
      st[4 * jj + e] = p;
      if (kDS)
        dpt[4 * jj + e] = p * (dpt[4 * jj + e] - ((e & 1) ? dl.y : dl.x));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tmap_q,
                      const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v,
                      const __grid_constant__ CUtensorMap tmap_do,
                      const float* __restrict__ lse_pad,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ part,
                      Strides sdk, Strides sdv, int split, int B, int Hq,
                      int Hkv, int T, int Tpad, int causal, int window,
                      float scale_log2, float sm_scale) {
  using L = KVSmem<D>;
  constexpr int BK = L::kBlockK, S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle atoms
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full_kv = base + L::kBars, empty_kv = full_kv + 8;
  const uint32_t full_q = empty_kv + 8;          // [S] each
  const uint32_t empty_q = full_q + 8 * S;
  const uint32_t full_p = empty_q + 8 * S, empty_p = full_p + 8;

  // Work tile w: kv tile w / (Hkv B split) (the earliest, heaviest under
  // the causal mask, first), then its splits, kv heads and batches; it
  // walks 64-row q tiles [u0, u1) of query heads [h0, h1).
  const int rep = Hq / Hkv;
  const int n_work = (T + BK - 1) / BK * Hkv * B * split;
  auto work = [&](int w, int& c0, int& hk, int& b, int& s, int& h0, int& h1,
                  int& u0, int& u1) {
    const int per = Hkv * B * split;
    c0 = w / per * BK;
    s = w % per % split;
    hk = w % per / split % Hkv;
    b = w % per / split / Hkv;
    h0 = hk * rep + s * rep / split;
    h1 = hk * rep + (s + 1) * rep / split;
    // causal: q rows from c0; the window: rows below c0 + BK - 1 + window
    u0 = causal ? c0 / kRows : 0;
    u1 = (min(T, c0 + BK - 1 + window) + kRows - 1) / kRows;
  };

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, kConsumerThreads);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_q + 8 * s, 1);
      mbar_init(empty_q + 8 * s, kConsumerThreads);
    }
    mbar_init(full_p, 128);
    mbar_init(empty_p, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---------------- producer: one thread issues every load ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int j = 0;                           // q tiles loaded so far
      for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
        int c0, hk, b, s, h0, h1, u0, u1;
        work(w, c0, hk, b, s, h0, h1, u0, u1);
        mbar_wait(empty_kv, (n & 1) ^ 1);
        mbar_expect_tx(full_kv, 2 * L::kKVTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(base + L::kK + x * BK * 128, &tmap_k, full_kv,
                   x * kTmaBoxCols, c0, hk, b);
          tma_load(base + L::kV + x * BK * 128, &tmap_v, full_kv,
                   x * kTmaBoxCols, c0, hk, b);
        }
        for (int h = h0; h < h1; ++h)
          for (int u = u0; u < u1; ++u, ++j) {
            const int st = j % S;
            mbar_wait(empty_q + 8 * st, ((j / S) & 1) ^ 1);
            mbar_expect_tx(full_q + 8 * st, 2 * L::kQTile + 2 * kRows * 4);
            const uint32_t qt = base + L::kQ + st * 2 * L::kQTile;
#pragma unroll
            for (int x = 0; x < L::kBoxes; ++x) {
              tma_load(qt + x * kRows * 128, &tmap_q, full_q + 8 * st,
                       x * kTmaBoxCols, u * kRows, h, b);
              tma_load(qt + L::kQTile + x * kRows * 128, &tmap_do,
                       full_q + 8 * st, x * kTmaBoxCols, u * kRows, h, b);
            }
            const long long row =
                (static_cast<long long>(b) * Hq + h) * Tpad + u * kRows;
            const uint32_t vals = base + L::kVals + st * 2 * kRows * 4;
            bulk_load(vals, lse_pad + row, kRows * 4, full_q + 8 * st);
            bulk_load(vals + kRows * 4, delta + row, kRows * 4,
                      full_q + 8 * st);
          }
      }
    }
  } else {
    // ---------------- consumers ------------------------------------------
    // D 64 / 128: consumer wg makes S^T, dP^T, dV and dK of kv rows
    // 64 wg .. 64 wg + 63; D 256: both take the tile's 64 rows, consumer 0
    // S^T, P^T and dV, consumer 1 dP^T, dS^T (with consumer 0's P^T) and
    // dK.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128, lane = threadIdx.x % 32;
    const int cl = 2 * (lane % 4);            // its first column in each 8
    constexpr bool kHandOff = L::kHandOff;
    const int kv_off = kHandOff ? 0 : 64 * wg;  // this consumer's kv rows
    const int row = kv_off + t / 32 * 16 + lane / 4;   // rows row, row + 8
    float* const pbuf = reinterpret_cast<float*>(gbase + L::kP);
    float acc[D / 2];                         // dV (D 256: consumer 1 dK)
    float acc2[kHandOff ? 1 : D / 2];         // dK (D 64 / 128)
    float st[32], dpt[32];                    // S^T / P^T, dP^T / dS^T
    uint32_t ap[4][4], as[4][4];              // P^T, dS^T as A operands
    int j = 0;                                // q tiles consumed so far
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      int c0, hk, b, s, h0, h1, u0, u1;
      work(w, c0, hk, b, s, h0, h1, u0, u1);
      const int kv0 = c0 + kv_off;
      zero(acc);
      zero(acc2);
      mbar_wait(full_kv, n & 1);
      for (int h = h0; h < h1; ++h)
        for (int u = u0; u < u1; ++u, ++j) {
          const int sq = j % S;
          mbar_wait(full_q + 8 * sq, (j / S) & 1);
          const uint32_t qt = base + L::kQ + sq * 2 * L::kQTile;
          const uint32_t dot = qt + L::kQTile;
          const float* vals =
              reinterpret_cast<const float*>(gbase + L::kVals
                                             + sq * 2 * kRows * 4);
          const int q0 = u * kRows;
          const bool masked = kv0 + kRows > T || q0 + kRows > T
                              || (causal && q0 < kv0 + kRows - 1)
                              || q0 + kRows - 1 - kv0 >= window;
          if constexpr (!kHandOff) {
            // S^T = K Q^T and dP^T = V dO^T for this consumer's rows
            fence_regs(st);
            fence_regs(dpt);
            wgmma_fence();
            issue_ss<D, 64, BK * 128, kRows * 128>(
                st, base + L::kK + kv_off * 128, qt);
            issue_ss<D, 64, BK * 128, kRows * 128>(
                dpt, base + L::kV + kv_off * 128, dot);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);
            if (masked)
              p_tile<true, true>(st, dpt, vals, c0 + row, q0, cl, T, causal,
                                 window, scale_log2);
            else
              p_tile<false, true>(st, dpt, vals, c0 + row, q0, cl, T, causal,
                                  window, scale_log2);
            pack(st, ap);
            pack(dpt, as);
            // dV += P^T dO, dK += dS^T Q
            fence_regs(acc);
            fence_regs(acc2);
            wgmma_fence();
            issue_rs<D, kRows>(acc, ap, dot);
            issue_rs<D, kRows>(acc2, as, qt);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(acc2);
          } else {
            // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1)
            fence_regs(st);
            wgmma_fence();
            issue_ss<D, 64, BK * 128, kRows * 128>(
                st, base + (wg == 0 ? L::kK : L::kV), wg == 0 ? qt : dot);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            if (wg == 0) {
              if (masked)
                p_tile<true, false>(st, dpt, vals, c0 + row, q0, cl, T,
                                    causal, window, scale_log2);
              else
                p_tile<false, false>(st, dpt, vals, c0 + row, q0, cl, T,
                                     causal, window, scale_log2);
              mbar_wait(empty_p, (j & 1) ^ 1);
#pragma unroll
              for (int i = 0; i < 32; ++i) pbuf[i * 128 + t] = st[i];
              mbar_arrive(full_p);
            } else {
              // dS^T = P^T (dP^T - delta of its column)
              mbar_wait(full_p, j & 1);
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) {
                const float2 dl = *reinterpret_cast<const float2*>(
                    vals + kRows + 8 * jj + cl);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  st[4 * jj + e] = pbuf[(4 * jj + e) * 128 + t]
                                   * (st[4 * jj + e]
                                      - ((e & 1) ? dl.y : dl.x));
              }
              mbar_arrive(empty_p);
            }
            pack(st, ap);
            // dV += P^T dO (consumer 0) or dK += dS^T Q (consumer 1)
            fence_regs(acc);
            wgmma_fence();
            issue_rs<D, kRows>(acc, ap, wg == 0 ? dot : qt);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
          }
          mbar_arrive(empty_q + 8 * sq);
        }
      // K and V may be replaced by the next work tile's
      mbar_arrive(empty_kv);
      // this consumer's rows: dV from acc (D 256: consumer 1's acc is dK),
      // dK from acc2
      const long long slab = static_cast<long long>(T) * D;
      auto partial = [&](int which) {
        return split > 1 ? part + (((2LL * s + which) * B + b) * Hkv + hk)
                                      * slab + static_cast<long long>(kv0) * D
                         : nullptr;
      };
      bf16* const dv0 = dv + b * sdv.b + hk * sdv.h + kv0 * sdv.t;
      bf16* const dk0 = dk + b * sdk.b + hk * sdk.h + kv0 * sdk.t;
      const int r = row - kv_off;
      if (kHandOff && wg == 1)
        store_rows<D / 2>(dk0, sdk.t, partial(0), r, cl, T - kv0, acc,
                          sm_scale);
      else
        store_rows<D / 2>(dv0, sdv.t, partial(1), r, cl, T - kv0, acc, 1.f);
      if constexpr (!kHandOff)
        store_rows<D / 2>(dk0, sdk.t, partial(0), r, cl, T - kv0, acc2,
                          sm_scale);
    }
  }
}

// dS = P (dP - delta) in place of S for a dQ consumer thread's rows r0,
// r0 + 8 (lse, delta: theirs) and its columns n0 + 8 jj + cl, + 1; P =
// exp2(S scale - lse), 0 for a masked pair.
template <bool kMask, int N>
__device__ __forceinline__ void ds_rows(float (&sc)[N], const float (&dp)[N],
                                        int r0, int n0, int cl, float lse_a,
                                        float lse_b, float dl_a, float dl_b,
                                        int T, int causal, int window,
                                        float scale_log2) {
#pragma unroll
  for (int jj = 0; jj < N / 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool top = e < 2;
      float p = ex2(fmaf(sc[4 * jj + e], scale_log2, -(top ? lse_a : lse_b)));
      if (kMask && !visible(top ? r0 : r0 + 8, n0 + 8 * jj + cl + (e & 1), T,
                            causal, window))
        p = 0.f;
      sc[4 * jj + e] = p * (dp[4 * jj + e] - (top ? dl_a : dl_b));
    }
}

// ---------------------------------------------------------------------------
// dQ: one 128-row q tile of one q head and batch
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmap_q,
                    const __grid_constant__ CUtensorMap tmap_k,
                    const __grid_constant__ CUtensorMap tmap_v,
                    const __grid_constant__ CUtensorMap tmap_do,
                    const float* __restrict__ lse_pad,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Strides sdq, int B, int Hq, int Hkv, int T, int Tpad,
                    int causal, int window, float scale_log2,
                    float sm_scale) {
  using L = QSmem<D>;
  constexpr int BK = L::kBlockK, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full_q = base + L::kBars, empty_q = full_q + 8;
  const uint32_t full_kv = empty_q + 8;          // [kStages] each
  const uint32_t empty_kv = full_kv + 8 * kStages;
  auto k_tile = [&](int s) { return base + L::kK + s * 2 * L::kKVBytes; };

  // Work tile w: q tile (latest, heaviest under the causal mask, first),
  // then q head and batch; it walks kv tiles [lo, n_tiles).
  const int n_qt = (T + kBlockQ - 1) / kBlockQ;
  const int n_work = n_qt * Hq * B;
  auto work = [&](int w, int& m0, int& h, int& b, int& lo, int& n_tiles) {
    const int hb = w % (Hq * B);
    h = hb % Hq;
    b = hb / Hq;
    m0 = (n_qt - 1 - w / (Hq * B)) * kBlockQ;
    n_tiles = ((causal ? min(T, m0 + kBlockQ) : T) + BK - 1) / BK;
    lo = min(max(0, m0 - (window - 1)) / BK, n_tiles - 1);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_kv + 8 * s, 1);
      mbar_init(empty_kv + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int j = 0;                           // kv tiles loaded so far
      for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
        int m0, h, b, lo, n_tiles;
        work(w, m0, h, b, lo, n_tiles);
        const int hk = h / (Hq / Hkv);
        mbar_wait(empty_q, (n & 1) ^ 1);
        mbar_expect_tx(full_q, 2 * L::kQBytes);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(base + L::kQ + x * kBlockQ * 128, &tmap_q, full_q,
                   x * kTmaBoxCols, m0, h, b);
          tma_load(base + L::kDO + x * kBlockQ * 128, &tmap_do, full_q,
                   x * kTmaBoxCols, m0, h, b);
        }
        for (int i = lo; i < n_tiles; ++i, ++j) {
          const int s = j % kStages;
          mbar_wait(empty_kv + 8 * s, ((j / kStages) & 1) ^ 1);
          mbar_expect_tx(full_kv + 8 * s, 2 * L::kKVBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x) {
            tma_load(k_tile(s) + x * BK * 128, &tmap_k, full_kv + 8 * s,
                     x * kTmaBoxCols, i * BK, hk, b);
            tma_load(k_tile(s) + L::kKVBytes + x * BK * 128, &tmap_v,
                     full_kv + 8 * s, x * kTmaBoxCols, i * BK, hk, b);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: 64 q rows each --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32;
    const int row = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int cl = 2 * (lane % 4);
    const uint32_t q_rows = base + L::kQ + wg * 64 * 128;
    const uint32_t do_rows = base + L::kDO + wg * 64 * 128;
    float acc[D / 2];
    float sc[BK / 2], dp[BK / 2];
    uint32_t a[BK / 16][4];
    int j = 0;                             // ring position of the next kv tile
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      int m0, h, b, lo, n_tiles;
      work(w, m0, h, b, lo, n_tiles);
      const int r0 = m0 + row;
      const long long vrow = (static_cast<long long>(b) * Hq + h) * Tpad;
      const float lse_a = lse_pad[vrow + r0], lse_b = lse_pad[vrow + r0 + 8];
      const float dl_a = delta[vrow + r0], dl_b = delta[vrow + r0 + 8];
      // dS = P (dP - delta), P = exp2(S scale - lse), masked pairs 0, for
      // kv tile i
      auto ds = [&](int i) {
        const int n0 = i * BK;
        if (n0 + BK > T || (causal && n0 + BK - 1 > m0)
            || m0 + kBlockQ - 1 - n0 >= window)
          ds_rows<true>(sc, dp, r0, n0, cl, lse_a, lse_b, dl_a, dl_b, T,
                        causal, window, scale_log2);
        else
          ds_rows<false>(sc, dp, r0, n0, cl, lse_a, lse_b, dl_a, dl_b, T,
                         causal, window, scale_log2);
      };
      // S and dP of the kv tile in ring stage s
      auto issue_s = [&](int s) {
        issue_ss<D, BK, kBlockQ * 128, BK * 128>(sc, q_rows, k_tile(s));
        issue_ss<D, BK, kBlockQ * 128, BK * 128>(dp, do_rows,
                                                 k_tile(s) + L::kKVBytes);
      };
      zero(acc);
      mbar_wait(full_q, n & 1);
      // prologue: S_lo and dP_lo alone
      mbar_wait(full_kv + 8 * (j % kStages), (j / kStages) & 1);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      issue_s(j % kStages);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      ds(lo);
      pack(sc, a);
      // main loop: S_i and dP_i issued with dQ_{i-1} += dS_{i-1} K_{i-1},
      // dS_i made while that product runs.  No branch holds a wgmma, a
      // commit or a wait.
      for (int i = lo + 1; i < n_tiles; ++i) {
        ++j;
        const int s = j % kStages, sp = (j - 1) % kStages;
        mbar_wait(full_kv + 8 * s, (j / kStages) & 1);
        fence_regs(sc);
        fence_regs(dp);
        fence_regs(acc);
        wgmma_fence();
        issue_s(s);
        wgmma_commit();
        issue_rs<D, BK>(acc, a, k_tile(sp));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        fence_regs(dp);
        ds(i);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty_kv + 8 * sp);
        pack(sc, a);
      }
      // the last dQ product alone
      fence_regs(acc);
      wgmma_fence();
      issue_rs<D, BK>(acc, a, k_tile(j % kStages));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty_kv + 8 * (j % kStages));
      ++j;
      mbar_arrive(empty_q);
      store_rows<D / 2>(dq + b * sdq.b + h * sdq.h, sdq.t, nullptr, r0, cl,
                        T, acc, sm_scale);
    }
  }
}

// ---------------------------------------------------------------------------
// reduce: dK and dV from the head splits' fp32 partials, in split order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int split, int B, int Hkv,
                        int T, int D, Strides sdk, Strides sdv,
                        float sm_scale) {
  const long long n = static_cast<long long>(B) * Hkv * T * D;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < 2 * n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int which = i >= n;              // 0: dK, 1: dV
    const long long e = i - which * n;
    float sum = 0.f;
    for (int s = 0; s < split; ++s) sum += part[(2LL * s + which) * n + e];
    const int d = static_cast<int>(e % D);
    const int t = static_cast<int>(e / D % T);
    const int hk = static_cast<int>(e / D / T % Hkv);
    const int b = static_cast<int>(e / D / T / Hkv);
    const Strides st = which ? sdv : sdk;
    (which ? dv : dk)[b * st.b + t * st.t + hk * st.h + d] =
        __float2bfloat16(which ? sum : sum * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Args {
  const bf16 *o, *dout;
  bf16 *dq, *dk, *dv;
  const float* lse;
  float *lse_pad, *delta, *part;
  int split, B, Hq, Hkv, T, causal, window;
  float sm_scale;
  Strides so, sdo, sdq, sdk, sdv;
};

int n_sm() {
  static const int n = [] {
    int dev = 0, m = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    return m;
  }();
  return n;
}

template <int D>
int launch(const Args& a, const unsigned long long* geom, const void* q,
           const void* k, const void* v, cudaStream_t st) {
  using KV = KVSmem<D>;
  using Q = QSmem<D>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KV::kAlloc);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Q::kAlloc);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // q and dO in boxes of 128 rows (dQ) and 64 (dK/dV); k and v in each
  // kernel's kv tiles
  CUtensorMap q128, do128, kq, vq, q64, do64, kkv, vkv;
  int rc;
  if ((rc = make_context_current()) || (rc = encode(&q128, q, geom, kBlockQ))
      || (rc = encode(&do128, a.dout, geom + 24, kBlockQ))
      || (rc = encode(&kq, k, geom + 8, Q::kBlockK))
      || (rc = encode(&vq, v, geom + 16, Q::kBlockK))
      || (rc = encode(&q64, q, geom, kRows))
      || (rc = encode(&do64, a.dout, geom + 24, kRows))
      || (rc = encode(&kkv, k, geom + 8, KV::kBlockK))
      || (rc = encode(&vkv, v, geom + 16, KV::kBlockK)))
    return rc;
  const int T = a.T;
  const int Tpad = (T + kPadRows - 1) / kPadRows * kPadRows;
  const float scale_log2 = a.sm_scale * kLog2e;
  const dim3 prep_grid(Tpad / (256 / (D / 8)), a.Hq, a.B);
  flash_bwd_prep_kernel<D><<<prep_grid, 256, 0, st>>>(
      a.o, a.dout, a.lse, a.lse_pad, a.delta, a.Hq, T, Tpad, a.so, a.sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_dq = static_cast<long long>((T + kBlockQ - 1) / kBlockQ)
                         * a.Hq * a.B;
  const long long n_kv =
      static_cast<long long>((T + KV::kBlockK - 1) / KV::kBlockK) * a.Hkv
      * a.B * a.split;
  if (n_dq > 0x7fffffffLL || n_kv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // persistent: one block per SM, or fewer when there is less work
  flash_bwd_dq_kernel<D><<<static_cast<int>(n_dq < n_sm() ? n_dq : n_sm()),
                           kThreads, Q::kAlloc, st>>>(
      q128, kq, vq, do128, a.lse_pad, a.delta, a.dq, a.sdq, a.B, a.Hq, a.Hkv,
      T, Tpad, a.causal, a.window, scale_log2, a.sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<D><<<static_cast<int>(n_kv < n_sm() ? n_kv : n_sm()),
                             kThreads, KV::kAlloc, st>>>(
      q64, kkv, vkv, do64, a.lse_pad, a.delta, a.dk, a.dv, a.part, a.sdk,
      a.sdv, a.split, a.B, a.Hq, a.Hkv, T, Tpad, a.causal, a.window,
      scale_log2, a.sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (a.split > 1) {
    flash_bwd_reduce_kernel<<<4 * n_sm(), 256, 0, st>>>(
        a.part, a.dk, a.dv, a.split, a.B, a.Hkv, T, D, a.sdk, a.sdv,
        a.sm_scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// bf16 q, k, v, o, dO (read) and dq, dk, dv (written), (B, T, H, D) in any
// order of the outer axes; head_dim 64, 128 or 256; T = Tq = Tk.  lse: the
// forward's fp32 (B, Hq, T) log-sum-exp (base 2 of the scaled scores);
// lse_pad and delta: fp32 (B, Hq, Tpad) scratch, Tpad = T rounded up to
// 128; part: fp32 (split, 2, B, Hkv, T, D) scratch when split > 1 (each
// kv head's query heads in `split` groups), else unused.  geom: 8 values
// (see encode; the box rows are chosen here) for each of q, k, v and dO.
// strides: (batch, time, head) in elements for o, dO, dq, dk and dv; every
// row of o and dO starts on 16 bytes.
// window: row r sees cols c with r - c < window (a value above every r - c
// for none).  Returns 0, a cudaError_t, 1000 + a CUresult of the map
// encoding, or -1 when libcuda has no cuTensorMapEncodeTiled.
extern "C" int flash_bwd_sm90_launch(
    int head_dim, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* lse_pad, void* delta, void* part, int split, int B, int Hq,
    int Hkv, int T, const unsigned long long* geom, const long long* strides,
    int causal, int window, float sm_scale, void* stream) {
  const long long* s = strides;
  const Args a{static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
               static_cast<bf16*>(dq), static_cast<bf16*>(dk),
               static_cast<bf16*>(dv), static_cast<const float*>(lse),
               static_cast<float*>(lse_pad), static_cast<float*>(delta),
               static_cast<float*>(part), split, B, Hq, Hkv, T, causal,
               window, sm_scale,
               Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
               Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]},
               Strides{s[12], s[13], s[14]}};
  if (split < 1 || split > Hq / Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(a, geom, q, k, v, st);
    case 128: return launch<128>(a, geom, q, k, v, st);
    case 256: return launch<256>(a, geom, q, k, v, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_bwd_sm90_error_string(int code) {
  if (code == -1) return "libcuda has no cuTensorMapEncodeTiled";
  if (code >= 1000) return "cuTensorMapEncodeTiled refused the geometry";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
