// Flash attention backward for the shapes the tensor-core (sm90) backward
// kernel does not take: bf16 at head dim 16 and 32 on the tensor cores
// (mma.sync), and fp32 at head dim 16-128 on the CUDA cores.  (dQ, dK, dV)
// of the forward flash_attention.cu computes, fp32 accumulation, outputs
// in the input dtype, causal (top-left) or full, optionally local (row r
// sees cols c with r - c < window), GQA (a kv head's dK and dV sum over the
// query heads that share it), Tq == Tk.
//
// Replaces no Pallas kernel: the reference's Pallas flash kernel
// (src/repro/kernels/flash_attention.py::flash_attention) has no backward,
// and its model gets the attention gradient from jax.grad of
// src/repro/models/layers.py::flash_attention_xla.  The port's model runs
// the hand-written forward kernels, so its training step needs this one.
//
// FlashAttention-2's backward in ONE launch whose grid holds blocks of two
// roles side by side, P recomputed from the forward's log-sum-exp (lse,
// base 2 of the scaled scores, (B, Hq, Tq) fp32):
//
//   dQ role   (an "own" tile of q rows of one q head): over the kv tiles
//             it sees, P = exp2(S - lse), dP = dO V^T, dS = P * (dP -
//             delta), dQ += dS K.
//   dK/dV role (an own tile of kv rows of one kv head): over each query
//             head of the group and each q tile that sees it, P^T, dP^T =
//             V dO^T, dV += P^T dO, dK += dS^T Q.
//
// Every block computes delta = rowsum(dO * O) of the q rows it touches
// from dO and O it stages itself (the dK/dV role stages O beside dO), so
// no block waits on another and no delta buffer goes to memory.  No
// atomics: a run is deterministic.  Blocks run heaviest first: block i is
// level i / (B (Hq + Hkv)), a level's dK/dV blocks before its dQ blocks;
// level 0 is, under the causal mask, the bottom q tile and the top kv
// tile (with only a window the reverse), as
// flash_attention.bwd_core_block computes on the host.
//
// bf16, D 16/32 (32 own rows, other tiles of 64 rows, 128 threads).
// What bounds it on an H100 is latency, not either roof: the reduced
// models' (4, 256, 2, 2, 32) is 0.3 us of bytes, and a block's chain of
// tile steps is the kernel's time.  So one launch with 32-row own tiles
// (128 blocks there on 132 SMs); four warps a block, warp w taking own
// rows 16 (w & 1) .. + 15 against the other tile's rows 32 (w >> 1) .. +
// 31, the two halves' sums added in a fixed order at the end, so a step
// is half a warp's work; every operand staged by cp.async (a double
// buffer over the other side's tiles, lse too: a plain load would hold
// the thread) and read by ldmatrix into mma.sync.m16n8k16 fragments (bf16
// in, fp32 accumulate), a product's loads issued before its mmas; P and
// dS rounded to bf16 for the second products as the forward rounds P;
// steps whose tile holds no masked pair skip the masks.
//
// fp32, D 16-128 (CUDA cores: tensor-core TF32 keeps about three digits
// and would miss fp32's 1e-4).  What bounds it is the FMA issue rate and
// the shared-memory reads that feed it: at llama3.2-1b's (4, 1024, 32, 8,
// 64) the 7 products of the two roles are 3.2e10 FMAs, 0.90 ms at 67
// TFLOP/s.  So the products are register-tiled outer products as in an
// SGEMM: 256 threads, 64 own rows (128 at D 64), a 64 x 64 score tile a
// step (128 x 64 at D 64, 64 x 32 at D 128), each thread a 4 x 4 micro-
// tile of S and dP (8 x 4 at D 64, 4 x 2 at D 128) whose operands are
// 16-byte vectors along D from padded row-major tiles (rows D + 4 floats
// apart: the 4 or 8 distinct rows a warp reads land in distinct banks),
// 128 FMAs for 12 vector loads at D 64.  P and dS go to shared memory
// once, other-major ([other row][own row]), for the dQ / dV / dK
// products, micro-tiled the same way (a thread owns OR contiguous own
// rows x 4 NV dims).  One exp2 (ex2.approx) per score, the masks only on
// steps that hold a masked pair.  The other side's q / dO or k / v tiles
// come through a 2-stage cp.async double buffer (the dK/dV role's o
// through one stage, refilled once delta is read); D 64 and 128 take
// dynamic shared memory past 48 KB (one block an SM, 225 KB at D 64).
//
// Layout: every tensor is (B, T, H, D) in whatever order of the three
// outer axes the caller has; the wrapper passes each tensor's (batch,
// time, head) strides in elements, D is contiguous, and the rows of q, k,
// v, o and dO start on 16 bytes.
//
// C interface, bound with ctypes from repro_torch/kernels/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, t, h;                     // elements; D has stride 1
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;
  int B, Hq, Hkv, Tq, Tk;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int causal, window;
  float scale2;                          // sm_scale * log2(e)
  float sm_scale;
  int n_tiles;                           // own tiles a head: ceil(T / rows)
};

// A block's work: its role, own tile, head (q head in the dQ role, kv head
// in the dK/dV role) and batch.
struct Work {
  bool dq;
  int tile, head, b;
};

__device__ __forceinline__ Work decode(const Args& a) {
  const int per_level = a.B * (a.Hq + a.Hkv);
  const int level = static_cast<int>(blockIdx.x) / per_level;
  int r = static_cast<int>(blockIdx.x) - level * per_level;
  Work w;
  w.dq = r >= a.B * a.Hkv;
  if (w.dq) r -= a.B * a.Hkv;
  const int H = w.dq ? a.Hq : a.Hkv;
  w.head = r % H;
  w.b = r / H;
  // the dK/dV tiles at the top and the dQ tiles at the bottom see the most
  // under the causal mask; with only a window, the reverse
  const bool top_first = (a.causal != 0) != w.dq;
  w.tile = top_first ? level : a.n_tiles - 1 - level;
  return w;
}

__device__ __forceinline__ bool visible(int row, int col, int Tk, int causal,
                                        int window) {
  return col < Tk && (!causal || row >= col) && row - col < window;
}

// Every (q row, kv col) of [q0, q0 + nq) x [k0, k0 + nk) is visible: the
// step can skip the masks
__device__ __forceinline__ bool all_visible(const Args& a, int q0, int nq,
                                            int k0, int nk) {
  return q0 + nq <= a.Tq && k0 + nk <= a.Tk &&
         (!a.causal || q0 >= k0 + nk - 1) && q0 + nq - 1 - k0 < a.window;
}

// 2^x on the SFU (relative error ~2^-22; 0 below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The other side's range of a block's own tile [r0, r0 + rows): the kv
// cols its q rows see (dQ role) or the q rows that see its kv cols (dK/dV
// role), as [lo, hi).
__device__ __forceinline__ void other_range(const Args& a, bool dq, int r0,
                                            int rows, int& lo, int& hi) {
  if (dq) {
    lo = max(0, r0 - (a.window - 1));
    hi = a.causal ? min(a.Tk, r0 + rows) : a.Tk;
  } else {
    lo = a.causal ? r0 : 0;
    hi = min(a.Tq, r0 + rows - 1 + a.window);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage rows [r0, r0 + ROWS) of one head (row stride st elements, every
// row starting on 16 bytes) into s (rows LD elements apart) by 16-byte
// cp.async, all in flight at once; rows at or past n are zeros.
template <typename T, int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void stage(T* s, const T* g, long long st, int r0,
                                      int n) {
  constexpr int E = 16 / sizeof(T);      // elements per 16 bytes
  constexpr int CH = D / E, N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * NT;
    if (N % NT != 0 && e >= N) break;
    const int j = e / CH, c = (e % CH) * E;
    T* dst = s + j * LD + c;
    const int r = r0 + j;
    if (r >= n)
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    else
      cp_async16(dst, g + r * st + c);
  }
}

// Stage lse values [r0, r0 + N) of one (batch, head) row g into s by 4-byte
// cp.async (a plain load would hold the thread until it returns); past n
// zeros.
template <int N, int NT>
__device__ __forceinline__ void stage_lse(float* s, const float* g, int r0,
                                          int n) {
  for (int e = threadIdx.x; e < N; e += NT) {
    if (r0 + e < n)
      cp_async4(s + e, g + r0 + e);
    else
      s[e] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16, D 16/32: mma.sync
// ---------------------------------------------------------------------------

// Four warps: warp w takes own rows 16 (w & 1) .. + 15 against the other
// tile's rows 32 (w >> 1) .. + 31, and the two column halves' sums are
// added in a fixed order at the end.
constexpr int kBfRows = 32;              // own rows: two 16-row groups
constexpr int kBfThreads = 128;
constexpr int kBfOther = 64;             // the other side's tile rows
constexpr int kBfHalf = kBfOther / 2;    // the other rows a warp takes

template <int D>
struct Bf {
  static constexpr int LD = D + 8;       // padded smem row (ldmatrix)
  // dQ role: own q, dO, O; k, v x 2 buffers
  static constexpr int kDqBytes = (3 * kBfRows + 4 * kBfOther) * LD * 2;
  // dK/dV role: own k, v; q, dO, O x 2; lse x 2; each warp's delta
  static constexpr int kDkdvBytes = (2 * kBfRows + 6 * kBfOther) * LD * 2 +
                                    2 * kBfOther * 4 + 4 * kBfHalf * 4;
  static constexpr int kBytes = kDqBytes > kDkdvBytes ? kDqBytes : kDkdvBytes;
  // one accumulator's column-half sums: [D / 8 x 4][row group][lane]
  static constexpr int kRedFloats = D / 2 * 2 * 32;
  static_assert(kRedFloats * 4 <= 4 * kBfOther * LD, "dQ's fits in k, v");
  static_assert(2 * kRedFloats * 4 <= 4 * kBfOther * LD, "dK, dV's in q, dO");
};

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr,
                                                  uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments of rows [row0, row0 + 16) of s, one per 16-col chunk
template <int LD, int KD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KD][4],
                                       const bf16 (*s)[LD], int row0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(smem_u32(&s[row0 + (mi & 1) * 8 + rr][kk * 16 + (mi >> 1) * 8]),
                a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
}

// acc[n] += a . y^T for the NT n8 tiles of y (y stored [n][k] in s, its
// rows the product's columns), a as KD A fragments
template <int NT, int KD, int LD>
__device__ __forceinline__ void product_nt(float (&acc)[NT][4],
                                           const bf16 (*y)[LD],
                                           const uint32_t (&a)[KD][4]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
  uint32_t b[KD][NT / 2][4];             // every load before the products
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int n = 0; n < NT; n += 2)
      ldmatrix_x4(smem_u32(&y[(n + (mi >> 1)) * 8 + rr]
                             [kk * 16 + (mi & 1) * 8]),
                  b[kk][n / 2][0], b[kk][n / 2][1], b[kk][n / 2][2],
                  b[kk][n / 2][3]);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      mma_bf16(acc[n], a[kk], b[kk][n / 2][0], b[kk][n / 2][1]);
      mma_bf16(acc[n + 1], a[kk], b[kk][n / 2][2], b[kk][n / 2][3]);
    }
}

// acc[j] += p . y for the D/8 n8 tiles of y (stored [k][d] in s: K rows),
// p the warp's fp32 C tiles over the K axis (NT of them), rounded to bf16
template <int DT, int NT, int LD>
__device__ __forceinline__ void product_pv(float (&acc)[DT][4],
                                           const float (&p)[NT][4],
                                           const bf16 (*y)[LD]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
  uint32_t b[NT / 2][DT / 2][4];         // every load before the products
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
    for (int j = 0; j < DT; j += 2)
      ldmatrix_x4_trans(smem_u32(&y[kk * 16 + (mi & 1) * 8 + rr]
                                   [(j + (mi >> 1)) * 8]),
                        b[kk][j / 2][0], b[kk][j / 2][1], b[kk][j / 2][2],
                        b[kk][j / 2][3]);
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      mma_bf16(acc[j], a, b[kk][j / 2][0], b[kk][j / 2][1]);
      mma_bf16(acc[j + 1], a, b[kk][j / 2][2], b[kk][j / 2][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// sum over cols [0, N) of x[c] * y[c], two smem bf16 rows, N a
// multiple of 8 (16-byte loads)
template <int N>
__device__ __forceinline__ float dot_bf16(const bf16* x, const bf16* y) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < N; c += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(x + c);
    const uint4 w = *reinterpret_cast<const uint4*>(y + c);
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&u);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
      s = fmaf(fa.x, fb.x, s);
      s = fmaf(fa.y, fb.y, s);
    }
  }
  return s;
}

// out[rows[i]][j * 8 + 2 t4 + e] = acc[j][2 i + e] * scale, rows below n
template <int DT>
__device__ __forceinline__ void store_rows(bf16* base, long long st,
                                           const int (&rows)[2], int n,
                                           const float (&acc)[DT][4],
                                           float scale) {
  const int t4 = (threadIdx.x & 31) & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= n) continue;
    bf16* p = base + rows[i] * st + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// Adds the second column half's sums of acc into the first's (the warps of
// column half 0 end with the total; every thread of the block calls it;
// red: kRedFloats free floats).
template <int DT>
__device__ __forceinline__ void add_halves(float (&acc)[DT][4], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* slot = red + (warp & 1) * 32 + lane;
  if (warp >> 1) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) slot[(j * 4 + e) * 64] = acc[j][e];
  }
  __syncthreads();
  if (!(warp >> 1)) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += slot[(j * 4 + e) * 64];
  }
}

// dS of a dQ-role step in place of s: P = 2^(S scale2 - lse) of the rows
// (g, g + 8 of the warp), cols col0 + n 8 + 2 t4 + (e & 1), masked if MASK
template <bool MASK, int NT>
__device__ __forceinline__ void ds_rows(float (&s)[NT][4],
                                        const float (&dp)[NT][4],
                                        const Args& a, const int (&rows)[2],
                                        int col0, const float (&lse)[2],
                                        const float (&dl)[2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(s[n][e] * a.scale2 - lse[e >> 1]);
      if (MASK && !visible(rows[e >> 1], col0 + n * 8 + 2 * t4 + (e & 1),
                           a.Tk, a.causal, a.window))
        p = 0.f;
      s[n][e] = p * (dp[n][e] - dl[e >> 1]);
    }
}

// P^T and dS^T of a dK/dV-role step in place of st and dpt: kv rows (g,
// g + 8 of the warp), q cols row0 + j, j = n 8 + 2 t4 + (e & 1), their lse
// and delta ls[j], dl[j]; masked if MASK
template <bool MASK, int NT>
__device__ __forceinline__ void ds_cols(float (&st)[NT][4], float (&dpt)[NT][4],
                                        const Args& a, const int (&kvrows)[2],
                                        int row0, const float* ls,
                                        const float* dl) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = n * 8 + 2 * t4 + (e & 1);
      float p = ex2(st[n][e] * a.scale2 - ls[j]);
      if (MASK && !(row0 + j < a.Tq && visible(row0 + j, kvrows[e >> 1],
                                               a.Tk, a.causal, a.window)))
        p = 0.f;
      st[n][e] = p;                                   // P^T
      dpt[n][e] = p * (dpt[n][e] - dl[j]);            // dS^T
    }
}

// dQ role: dQ of 32 q rows
template <int D>
__device__ __forceinline__ void bf16_dq(const Args& a, const Work& wk,
                                        unsigned char* smem) {
  constexpr int LD = Bf<D>::LD, C = kBfOther, H2 = kBfHalf;
  constexpr int NT = H2 / 8, DT = D / 8, KD = D / 16;
  bf16(*qs)[LD] = reinterpret_cast<bf16(*)[LD]>(smem);
  bf16(*dos)[LD] = qs + kBfRows;
  bf16(*os)[LD] = dos + kBfRows;
  bf16(*ks)[LD] = os + kBfRows;          // [2 * C]: two buffers
  bf16(*vs)[LD] = ks + 2 * C;

  const int h = wk.head, b = wk.b, hk = h / (a.Hq / a.Hkv);
  const int row0 = wk.tile * kBfRows;
  int lo, hi;
  other_range(a, true, row0, kBfRows, lo, hi);
  const int t_begin = lo / C, t_end = (hi + C - 1) / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp & 1, half = warp >> 1;
  const int g = lane >> 2;
  const int rows[2] = {row0 + rg * 16 + g, row0 + rg * 16 + g + 8};

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const long long lrow = (static_cast<long long>(b) * a.Hq + h) * a.Tq;
  stage<bf16, D, LD, kBfRows, kBfThreads>(
      qs[0], static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.t,
      row0, a.Tq);
  stage<bf16, D, LD, kBfRows, kBfThreads>(
      dos[0], static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h,
      a.sdo.t, row0, a.Tq);
  stage<bf16, D, LD, kBfRows, kBfThreads>(
      os[0], static_cast<const bf16*>(a.o) + b * a.so.b + h * a.so.h, a.so.t,
      row0, a.Tq);
  auto stage_kv = [&](int t, int buf) {
    stage<bf16, D, LD, C, kBfThreads>(ks[buf * C], kb, a.sk.t, t * C, a.Tk);
    stage<bf16, D, LD, C, kBfThreads>(vs[buf * C], vb, a.sv.t, t * C, a.Tk);
  };
  if (t_begin < t_end) stage_kv(t_begin, 0);
  commit();
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lse[i] = rows[i] < a.Tq ? a.lse[lrow + rows[i]] : 0.f;
  wait_all();
  __syncthreads();

  // delta of the warp's 16 rows: two lanes a row, then to rows g, g + 8
  float dl[2];
  {
    const int r = rg * 16 + (lane >> 1), c = (lane & 1) * (D / 2);
    float part = dot_bf16<D / 2>(&dos[r][c], &os[r][c]);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    dl[0] = __shfl_sync(0xffffffffu, part, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, part, 2 * g + 16);
  }
  uint32_t qf[KD][4], df[KD][4];
  load_a<LD, KD>(qf, qs, rg * 16);
  load_a<LD, KD>(df, dos, rg * 16);

  float acc[DT][4];
  zero(acc);
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t > t_begin) {
      wait_all();
      __syncthreads();                   // tile t is in; t - 1 is consumed
    }
    if (t + 1 < t_end) {
      stage_kv(t + 1, buf ^ 1);
      commit();
    }
    const bf16(*kt)[LD] = ks + buf * C + half * H2;
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    product_nt<NT, KD, LD>(s, kt, qf);
    product_nt<NT, KD, LD>(dp, vs + buf * C + half * H2, df);
    const int col0 = t * C + half * H2;
    if (all_visible(a, row0, kBfRows, col0, H2))
      ds_rows<false>(s, dp, a, rows, col0, lse, dl);
    else
      ds_rows<true>(s, dp, a, rows, col0, lse, dl);
    product_pv<DT, NT, LD>(acc, s, kt);
  }
  __syncthreads();                       // k and v are consumed
  add_halves(acc, reinterpret_cast<float*>(ks));
  if (!half)
    store_rows<DT>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h,
                   a.sdq.t, rows, a.Tq, acc, a.sm_scale);
}

// dK/dV role: dK and dV of 32 kv rows over the group's q heads
template <int D>
__device__ __forceinline__ void bf16_dkdv(const Args& a, const Work& wk,
                                          unsigned char* smem) {
  constexpr int LD = Bf<D>::LD, C = kBfOther, H2 = kBfHalf;
  constexpr int NT = H2 / 8, DT = D / 8, KD = D / 16;
  bf16(*ks)[LD] = reinterpret_cast<bf16(*)[LD]>(smem);
  bf16(*vs)[LD] = ks + kBfRows;
  bf16(*qs)[LD] = vs + kBfRows;          // [2 * C]: two buffers
  bf16(*dos)[LD] = qs + 2 * C;
  bf16(*os)[LD] = dos + 2 * C;
  float* lse_s = reinterpret_cast<float*>(os + 2 * C);  // [2][C]
  float* dl_s = lse_s + 2 * C;                           // [warp][H2]

  const int hk = wk.head, b = wk.b, rep = a.Hq / a.Hkv;
  const int c0 = wk.tile * kBfRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp & 1, half = warp >> 1;
  const int g = lane >> 2;
  const int kvrows[2] = {c0 + rg * 16 + g, c0 + rg * 16 + g + 8};
  int lo, hi;
  other_range(a, false, c0, kBfRows, lo, hi);
  const int u_begin = lo / C;
  const int n_u = max(0, (hi + C - 1) / C - u_begin);
  const int total = rep * n_u;           // (q head, q tile) pairs

  stage<bf16, D, LD, kBfRows, kBfThreads>(
      ks[0], static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h,
      a.sk.t, c0, a.Tk);
  stage<bf16, D, LD, kBfRows, kBfThreads>(
      vs[0], static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h,
      a.sv.t, c0, a.Tk);
  auto stage_q = [&](int it, int buf) {
    const int h = hk * rep + it / n_u, u0 = (u_begin + it % n_u) * C;
    stage<bf16, D, LD, C, kBfThreads>(
        qs[buf * C], static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h,
        a.sq.t, u0, a.Tq);
    stage<bf16, D, LD, C, kBfThreads>(
        dos[buf * C],
        static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h,
        a.sdo.t, u0, a.Tq);
    stage<bf16, D, LD, C, kBfThreads>(
        os[buf * C], static_cast<const bf16*>(a.o) + b * a.so.b + h * a.so.h,
        a.so.t, u0, a.Tq);
    stage_lse<C, kBfThreads>(
        lse_s + buf * C,
        a.lse + (static_cast<long long>(b) * a.Hq + h) * a.Tq, u0, a.Tq);
  };
  if (total > 0) stage_q(0, 0);
  commit();
  wait_all();
  __syncthreads();
  uint32_t kf[KD][4], vf[KD][4];
  load_a<LD, KD>(kf, ks, rg * 16);
  load_a<LD, KD>(vf, vs, rg * 16);

  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);
  float* dlw = dl_s + warp * H2;
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    const int row0 = (u_begin + it % n_u) * C + half * H2;
    if (it > 0) {
      wait_all();
      __syncthreads();                   // tile it is in; it - 1 consumed
    }
    if (it + 1 < total) {
      stage_q(it + 1, buf ^ 1);
      commit();
    }
    const bf16(*qt)[LD] = qs + buf * C + half * H2;
    const bf16(*dot)[LD] = dos + buf * C + half * H2;
    const bf16(*ot)[LD] = os + buf * C + half * H2;
    // delta of the warp's 32 q rows: a row a lane
    dlw[lane] = dot_bf16<D>(dot[lane], ot[lane]);
    __syncwarp();
    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 kv rows x 32 q cols
    float st[NT][4], dpt[NT][4];
    zero(st);
    zero(dpt);
    product_nt<NT, KD, LD>(st, qt, kf);
    product_nt<NT, KD, LD>(dpt, dot, vf);
    const float* ls = lse_s + buf * C + half * H2;
    if (all_visible(a, row0, H2, c0, kBfRows))
      ds_cols<false>(st, dpt, a, kvrows, row0, ls, dlw);
    else
      ds_cols<true>(st, dpt, a, kvrows, row0, ls, dlw);
    product_pv<DT, NT, LD>(dv, st, dot);
    product_pv<DT, NT, LD>(dk, dpt, qt);
  }
  __syncthreads();                       // q and dO are consumed
  float* red = reinterpret_cast<float*>(qs);
  add_halves(dk, red);
  add_halves(dv, red + Bf<D>::kRedFloats);
  if (!half) {
    store_rows<DT>(static_cast<bf16*>(a.dk) + b * a.sdk.b + hk * a.sdk.h,
                   a.sdk.t, kvrows, a.Tk, dk, a.sm_scale);
    store_rows<DT>(static_cast<bf16*>(a.dv) + b * a.sdv.b + hk * a.sdv.h,
                   a.sdv.t, kvrows, a.Tk, dv, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kBfThreads) flash_bwd_bf16_kernel(Args a) {
  __shared__ __align__(16) unsigned char smem[Bf<D>::kBytes];
  const Work w = decode(a);
  if (w.dq)
    bf16_dq<D>(a, w, smem);
  else
    bf16_dkdv<D>(a, w, smem);
}

// ---------------------------------------------------------------------------
// fp32, D 16-128: register-tiled outer products on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct F32 {
  static constexpr int kThreads = 256;
  // own rows (128 at D 64: 8 x 4 score micro-tiles, the most a thread's
  // registers and a block's 227 KB hold), other rows a step
  static constexpr int R = D == 64 ? 128 : 64;
  static constexpr int C = D == 128 ? 32 : 64;
  static constexpr int LD = D + 4;                   // padded row (floats)
  static constexpr int LW = R + 4;                   // P, dS: [other][own]
  // a thread's scores: own rows ti + 16 m, other rows tj + 16 n
  static constexpr int MR = R / 16, MC = C / 16;
  // a thread's outputs: OR contiguous own rows x NV float4s of a row, the
  // float4s OC apart
  static constexpr int D4 = D / 4;
  static constexpr int OC = D4 < 16 ? D4 : 16;
  static constexpr int NV = D4 / OC;
  static constexpr int OR = R * OC / kThreads;
  // dQ role: own q, dO, O; k, v x 2 stages; dS; lse, delta
  static constexpr int kDqFloats = 3 * R * LD + 4 * C * LD + C * LW + 2 * R;
  // dK/dV role: own k, v; q, dO x 2 stages and o; P, dS; lse x 2, delta
  static constexpr int kDkdvFloats =
      2 * R * LD + 5 * C * LD + 2 * C * LW + 3 * C;
  static constexpr int kBytes =
      4 * (kDqFloats > kDkdvFloats ? kDqFloats : kDkdvFloats);
};

// out[r] = x[r] . y[r] for ROWS smem rows (LD floats apart) of D floats,
// NT / ROWS consecutive threads a row
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void row_dots(const float* x, const float* y,
                                         float* out) {
  constexpr int TPR = NT / ROWS, FPT = D / TPR;
  static_assert(FPT % 4 == 0, "whole float4s a thread");
  const int r = threadIdx.x / TPR, c = (threadIdx.x % TPR) * FPT;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < FPT; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(x + r * LD + c + i);
    const float4 w = *reinterpret_cast<const float4*>(y + r * LD + c + i);
    s = fmaf(u.x, w.x, fmaf(u.y, w.y, fmaf(u.z, w.z, fmaf(u.w, w.w, s))));
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x % TPR == 0) out[r] = s;
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// acc[m][n] += a[own ti + 16 m] . b[other tj + 16 n] over D: float4 vectors
// along D, 4 MR MC FMAs for MR + MC loads
template <int D, int LD, int MR, int MC>
__device__ __forceinline__ void scores(float (&acc)[MR][MC], const float* a,
                                       const float* b) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[MR], bv[MC];
#pragma unroll
    for (int m = 0; m < MR; ++m)
      av[m] = *reinterpret_cast<const float4*>(a + 16 * m * LD + d);
#pragma unroll
    for (int n = 0; n < MC; ++n)
      bv[n] = *reinterpret_cast<const float4*>(b + 16 * n * LD + d);
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < MC; ++n) {
        float s = acc[m][n];
        s = fmaf(av[m].x, bv[n].x, s);
        s = fmaf(av[m].y, bv[n].y, s);
        s = fmaf(av[m].z, bv[n].z, s);
        s = fmaf(av[m].w, bv[n].w, s);
        acc[m][n] = s;
      }
  }
}

// out[r][v] += sum over the C other rows j of w[j][own r] * b[j][dims v]:
// the outer product of a P / dS column slice and a row slice of the other
// tile, OR + 4 NV loads for 4 OR NV FMAs a step
template <int C, int LD, int LW, int OR, int NV, int OC>
__device__ __forceinline__ void outer(float (&out)[OR][NV][4], const float* w,
                                      const float* b) {
#pragma unroll 8
  for (int j = 0; j < C; ++j) {
    float wv[OR];
    load_vec<OR>(w + j * LW, wv);
    float4 bv[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v)
      bv[v] = *reinterpret_cast<const float4*>(b + j * LD + 4 * OC * v);
#pragma unroll
    for (int r = 0; r < OR; ++r)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        out[r][v][0] = fmaf(wv[r], bv[v].x, out[r][v][0]);
        out[r][v][1] = fmaf(wv[r], bv[v].y, out[r][v][1]);
        out[r][v][2] = fmaf(wv[r], bv[v].z, out[r][v][2]);
        out[r][v][3] = fmaf(wv[r], bv[v].w, out[r][v][3]);
      }
  }
}

// One role of one block.  Own: a1, a2 (q, dO in the dQ role; k, v in the
// dK/dV role) and, in the dQ role, o.  Other, two stages of b1, b2 (k, v;
// q, dO) and, in the dK/dV role, one of o: it is read for delta before
// the step's middle barrier and refilled after it.  x = a1 . b1 (S), y =
// a2 . b2 (dP); the dQ role stores dS as w2 and takes dQ = dS K from w2
// and b1; the dK/dV role stores P as w1 and dS as w2 and takes dV = P^T
// dO from w1 and b2, dK = dS^T Q from w2 and b1.
template <int D, bool DQ>
__device__ __forceinline__ void f32_role(const Args& a, const Work& wk,
                                         float* sm) {
  using K = F32<D>;
  constexpr int NTH = K::kThreads, R = K::R, C = K::C, LD = K::LD,
                LW = K::LW, MR = K::MR, MC = K::MC, OR = K::OR, NV = K::NV,
                OC = K::OC;
  constexpr int SB = 2 * C * LD;                     // floats a stage
  float* a1 = sm;
  float* a2 = a1 + R * LD;
  float* own_o = a2 + R * LD;                        // dQ role only
  float* other = DQ ? own_o + R * LD : own_o;        // [2][SB]
  float* oth_o = other + 2 * SB;                     // dK/dV role only
  float* w1 = DQ ? oth_o : oth_o + C * LD;           // dK/dV role only
  float* w2 = DQ ? w1 : w1 + C * LW;
  float* lse_s = w2 + C * LW;                        // dQ [R]; dK/dV [2][C]
  float* dl_s = lse_s + (DQ ? R : 2 * C);            // dQ [R]; dK/dV [C]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ti = (lane & 3) + 4 * (warp & 3);        // score micro-tile
  const int tj = (lane >> 2) + 8 * (warp >> 2);
  constexpr int WC = OC < 8 ? OC : 8, WR = 32 / WC;  // output micro-tile
  const int od = lane % WC + WC * (warp % (OC / WC));
  const int oi = lane / WC + WR * (warp / (OC / WC));

  const int b = wk.b, rep = a.Hq / a.Hkv;
  const int hk = DQ ? wk.head / rep : wk.head;
  const int r0 = wk.tile * R;
  int lo, hi;
  other_range(a, DQ, r0, R, lo, hi);
  const int u_begin = lo / C;
  const int n_u = max(0, (hi + C - 1) / C - u_begin);
  const int total = DQ ? n_u : rep * n_u;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* o = static_cast<const float*>(a.o);
  const float* dout = static_cast<const float*>(a.dout);
  const int n_own = DQ ? a.Tq : a.Tk;
  if (DQ) {
    const int h = wk.head;
    stage<float, D, LD, R, NTH>(a1, q + b * a.sq.b + h * a.sq.h, a.sq.t, r0,
                                a.Tq);
    stage<float, D, LD, R, NTH>(a2, dout + b * a.sdo.b + h * a.sdo.h,
                                a.sdo.t, r0, a.Tq);
    stage<float, D, LD, R, NTH>(own_o, o + b * a.so.b + h * a.so.h, a.so.t,
                                r0, a.Tq);
  } else {
    stage<float, D, LD, R, NTH>(a1, k + b * a.sk.b + hk * a.sk.h, a.sk.t, r0,
                                a.Tk);
    stage<float, D, LD, R, NTH>(a2, v + b * a.sv.b + hk * a.sv.h, a.sv.t, r0,
                                a.Tk);
  }
  // the other tile of step it: its first row and (dK/dV role) q head
  auto other_at = [&](int it, int& row0, int& h) {
    row0 = (u_begin + it % n_u) * C;
    h = DQ ? wk.head : hk * rep + it / n_u;
  };
  auto stage_other = [&](int it, int s) {
    int row0, h;
    other_at(it, row0, h);
    float* b1 = other + s * SB;
    if (DQ) {
      stage<float, D, LD, C, NTH>(b1, k + b * a.sk.b + hk * a.sk.h, a.sk.t,
                                  row0, a.Tk);
      stage<float, D, LD, C, NTH>(b1 + C * LD, v + b * a.sv.b + hk * a.sv.h,
                                  a.sv.t, row0, a.Tk);
    } else {
      stage<float, D, LD, C, NTH>(b1, q + b * a.sq.b + h * a.sq.h, a.sq.t,
                                  row0, a.Tq);
      stage<float, D, LD, C, NTH>(b1 + C * LD,
                                  dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t,
                                  row0, a.Tq);
      stage_lse<C, NTH>(lse_s + s * C,
                        a.lse + (static_cast<long long>(b) * a.Hq + h) * a.Tq,
                        row0, a.Tq);
    }
  };
  auto stage_o = [&](int it) {           // dK/dV role: o of step it
    int row0, h;
    other_at(it, row0, h);
    stage<float, D, LD, C, NTH>(oth_o, o + b * a.so.b + h * a.so.h, a.so.t,
                                row0, a.Tq);
  };
  if (total > 0) {
    stage_other(0, 0);
    if (!DQ) stage_o(0);
  }
  commit();
  float lse_r[MR], dl_r[MR];                         // dQ role: own rows
  if (DQ) {
    stage_lse<R, NTH>(
        lse_s, a.lse + (static_cast<long long>(b) * a.Hq + wk.head) * a.Tq,
        r0, a.Tq);
    commit();
  }
  wait_all();
  __syncthreads();
  if (DQ) {
    row_dots<D, LD, R, NTH>(a2, own_o, dl_s);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      lse_r[m] = lse_s[ti + 16 * m];
      dl_r[m] = dl_s[ti + 16 * m];
    }
  }

  float o1[OR][NV][4], o2[OR][NV][4];                // dV / dK, or dQ (o2)
#pragma unroll
  for (int r = 0; r < OR; ++r)
#pragma unroll
    for (int vv = 0; vv < NV; ++vv)
#pragma unroll
      for (int c = 0; c < 4; ++c) o1[r][vv][c] = o2[r][vv][c] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int s = it & 1;
    if (it > 0) {
      wait_all();
      __syncthreads();                   // step it is in; it - 1 consumed
    }
    if (it + 1 < total) {
      stage_other(it + 1, s ^ 1);
      commit();
    }
    int row0, h;
    other_at(it, row0, h);
    const float* b1 = other + s * SB;
    const float* b2 = b1 + C * LD;
    if (!DQ) row_dots<D, LD, C, NTH>(b2, oth_o, dl_s);
    float x[MR][MC], y[MR][MC];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < MC; ++n) x[m][n] = y[m][n] = 0.f;
    scores<D, LD, MR, MC>(x, a1 + ti * LD, b1 + tj * LD);
    scores<D, LD, MR, MC>(y, a2 + ti * LD, b2 + tj * LD);
    if (!DQ) {
      __syncthreads();                   // delta is in; o is read
      if (it + 1 < total) {
        stage_o(it + 1);
        commit();
      }
    }
    // P and dS to shared memory; the masks only where the step's tile
    // holds a masked pair
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int n = 0; n < MC; ++n) {
          const float lse = DQ ? lse_r[m] : lse_s[s * C + tj + 16 * n];
          const float dl = DQ ? dl_r[m] : dl_s[tj + 16 * n];
          float p = ex2(x[m][n] * a.scale2 - lse);
          if (decltype(masked)::value) {
            const int own = r0 + ti + 16 * m, oth = row0 + tj + 16 * n;
            const int qrow = DQ ? own : oth, kcol = DQ ? oth : own;
            if (!(qrow < a.Tq &&
                  visible(qrow, kcol, a.Tk, a.causal, a.window)))
              p = 0.f;
          }
          const int at = (tj + 16 * n) * LW + ti + 16 * m;
          w2[at] = p * (y[m][n] - dl);               // dS
          if (!DQ) w1[at] = p;                       // P
        }
    };
    if (DQ ? all_visible(a, r0, R, row0, C) : all_visible(a, row0, C, r0, R))
      p_ds(std::false_type());
    else
      p_ds(std::true_type());
    __syncthreads();                     // P and dS are in
    outer<C, LD, LW, OR, NV, OC>(o2, w2 + oi * OR, b1 + 4 * od);
    if (!DQ) outer<C, LD, LW, OR, NV, OC>(o1, w1 + oi * OR, b2 + 4 * od);
  }

  // own rows oi OR + r, dims 4 (od + OC v) .. + 3
  auto store = [&](void* dst, const Strides& st, int h, float scale,
                   const float(&acc)[OR][NV][4]) {
    float* base = static_cast<float*>(dst) + b * st.b + h * st.h;
#pragma unroll
    for (int r = 0; r < OR; ++r) {
      const int row = r0 + oi * OR + r;
      if (row >= n_own) continue;
#pragma unroll
      for (int vv = 0; vv < NV; ++vv)
        *reinterpret_cast<float4*>(base + row * st.t + 4 * (od + OC * vv)) =
            make_float4(acc[r][vv][0] * scale, acc[r][vv][1] * scale,
                        acc[r][vv][2] * scale, acc[r][vv][3] * scale);
    }
  };
  if (DQ) {
    store(a.dq, a.sdq, wk.head, a.sm_scale, o2);
  } else {
    store(a.dk, a.sdk, hk, a.sm_scale, o2);
    store(a.dv, a.sdv, hk, 1.f, o1);
  }
}

template <int D>
__global__ void __launch_bounds__(F32<D>::kThreads, 1)
flash_bwd_f32_kernel(Args a) {
  extern __shared__ __align__(16) float fsm[];
  const Work w = decode(a);
  if (w.dq)
    f32_role<D, true>(a, w, fsm);
  else
    f32_role<D, false>(a, w, fsm);
}

template <int D>
cudaError_t launch_bf16(const Args& a, int n_blocks, cudaStream_t st) {
  flash_bwd_bf16_kernel<D><<<n_blocks, kBfThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a, int n_blocks, cudaStream_t st) {
  constexpr int smem = F32<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  flash_bwd_f32_kernel<D><<<n_blocks, F32<D>::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores, D 16/32/64/128), 1 = bfloat16 (tensor
// cores, D 16/32).  Pointers: q, k, v, o, dO (read), dq, dk, dv (written),
// all in dtype; lse, the forward's fp32 (B, Hq, Tq) log-sum-exp (base 2
// of the scaled scores).  strides: 24 values, (batch, time, head) in
// elements for q, k, v, o, dO, dq, dk, dv in that order.  window: row r
// sees cols c with r - c < window (a value above every r - c for none).
// q, k, v, o and dO rows start on 16 bytes.  rows and n_blocks: the
// wrapper's launch plan (own-tile rows of the dtype and head dim,
// ceil(T / rows) B (Hq + Hkv) blocks), refused unless they are this
// source's.  Returns the
// launch's cudaError_t.
extern "C" int flash_bwd_launch(int dtype, int head_dim, const void* q,
                                const void* k, const void* v, const void* o,
                                const void* dout, void* dq, void* dk,
                                void* dv, const void* lse, int B, int Hq,
                                int Hkv, int Tq, int Tk,
                                const long long* strides, int causal,
                                int window, float sm_scale, int rows,
                                int n_blocks, void* stream) {
  const long long* s = strides;
  const int want_rows = dtype == 1        ? kBfRows
                        : head_dim == 16  ? F32<16>::R
                        : head_dim == 32  ? F32<32>::R
                        : head_dim == 64  ? F32<64>::R
                                          : F32<128>::R;
  const int n_tiles = (Tq + want_rows - 1) / want_rows;
  if (Tq != Tk || rows != want_rows ||
      static_cast<long long>(n_blocks) !=
          static_cast<long long>(n_tiles) * B * (Hq + Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, dq, dk, dv, static_cast<const float*>(lse),
         B, Hq, Hkv, Tq, Tk,
         Strides{s[0], s[1], s[2]},      Strides{s[3], s[4], s[5]},
         Strides{s[6], s[7], s[8]},      Strides{s[9], s[10], s[11]},
         Strides{s[12], s[13], s[14]},   Strides{s[15], s[16], s[17]},
         Strides{s[18], s[19], s[20]},   Strides{s[21], s[22], s[23]},
         causal, window,
         static_cast<float>(sm_scale * 1.4426950408889634), sm_scale,
         n_tiles};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && head_dim == 16)
    err = launch_bf16<16>(a, n_blocks, st);
  else if (dtype == 1 && head_dim == 32)
    err = launch_bf16<32>(a, n_blocks, st);
  else if (dtype == 0 && head_dim == 16)
    err = launch_f32<16>(a, n_blocks, st);
  else if (dtype == 0 && head_dim == 32)
    err = launch_f32<32>(a, n_blocks, st);
  else if (dtype == 0 && head_dim == 64)
    err = launch_f32<64>(a, n_blocks, st);
  else if (dtype == 0 && head_dim == 128)
    err = launch_f32<128>(a, n_blocks, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
