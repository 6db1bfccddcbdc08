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
// FlashAttention-2's backward in two kernels of this source, launched one
// after the other on the caller's stream, P recomputed from the forward's
// log-sum-exp (lse, base 2 of the scaled scores, (B, Hq, Tq) fp32):
//
//   dq pass   (one block per 64-row q tile, q head, batch; heaviest tiles
//             first): rowsum(dO * O) -> delta; then over the visible kv
//             tiles P = exp2(S - lse), dP = dO V^T, dS = P * (dP - delta),
//             dQ += dS K.  Writes dQ and delta.
//   dk/dv pass (one block per 64-row kv tile, kv head, batch): for each
//             query head of the group and each q tile that sees the kv
//             tile, P^T and dP^T = V dO^T, dV += P^T dO,
//             dK += dS^T Q, in registers.  No atomics: a run is
//             deterministic.
//
// bf16, D 16/32: each warp owns 16 rows (q rows in the dq pass, kv rows in
// the dk/dv pass); the products are mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), P and dS rounded to bf16 for the second products as the
// forward rounds P.  Tiles of the other side (64 rows) are staged with
// cp.async into a double buffer (rows padded by 16 bytes for ldmatrix).
// fp32, D 16-128: tensor-core TF32 would miss fp32's tolerance, so the
// CUDA cores in fp32 FMAs, as the fp32 forward: D/16 threads per row, each
// with 16 interleaved dims of its row's vectors and accumulators in
// registers, the other side's tiles (64 rows, 32 at D 128) staged with
// cp.async and read by broadcast, each dot product finished with warp
// shuffles.  The masks skip fully masked tiles (causal, window) and mask
// the padded tails.
//
// What bounds it on an H100: these are the reduced models' shapes (B 2, T
// 32-80, D 32), microseconds of work at either roof, so latency: the
// launches and each block's serial chain over its tiles.  In fp32 at
// llama3.2-1b's attention shape (4, 1024, 32, 8, 64) the five products are
// 4.30e10 FLOP, 0.64 ms at the CUDA cores' 67 TFLOP/s.
//
// Layout: every tensor is (B, T, H, D) in whatever order of the three
// outer axes the caller has; the wrapper passes each tensor's (batch,
// time, head) strides in elements, D is contiguous.  lse is the forward's;
// delta an fp32 (B, Hq, Tq) scratch buffer the wrapper allocates.
//
// C interface, bound with ctypes from repro_torch/kernels/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpRows = 16;            // rows per warp (the mma's M)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * kWarpRows;   // 64

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, t, h;                     // elements; D has stride 1
};

// The other side's tile rows (kv rows in the dq pass, q rows in the dk/dv
// pass) and the padded shared-memory row of the bf16 kernels.
template <int D>
struct Tile {
  static constexpr int kCols = 64;
  static constexpr int kLd = D + 8;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;
  float* delta;
  int B, Hq, Hkv, Tq, Tk;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int causal, window;
  float scale2;                          // sm_scale * log2(e)
  float sm_scale;
};

__device__ __forceinline__ bool visible(int row, int col, int Tk, int causal,
                                        int window) {
  return col < Tk && (!causal || row >= col) && row - col < window;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  const uint32_t l = *reinterpret_cast<const unsigned short*>(&lo);
  const uint32_t h = *reinterpret_cast<const unsigned short*>(&hi);
  return l | (h << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + ROWS) of one head (row stride st, every row
// starting on 16 bytes) into s by cp.async; rows at or past n are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(bf16 (*s)[D + 8], const bf16* base,
                                           long long st, int r0, int n) {
  constexpr int CH = D / 8;              // 16-byte chunks per row
  for (int e = threadIdx.x; e < ROWS * CH; e += blockDim.x) {
    const int j = e / CH, c = (e - j * CH) * 8;
    const int r = r0 + j;
    if (r >= n) {
      *reinterpret_cast<uint4*>(&s[j][c]) = make_uint4(0, 0, 0, 0);
    } else {
      cp_async16(&s[j][c], base + r * st + c);
    }
  }
}

// A fragment of rows [row0, row0 + 16), cols [col0, col0 + 16) of s
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16 (*s)[LD],
                                       int row0, int col0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
  ldmatrix_x4(smem_u32(&s[row0 + (mi & 1) * 8 + rr][col0 + (mi >> 1) * 8]),
              a[0], a[1], a[2], a[3]);
}

// acc[n] += a_rows . y^T for the NT n8 tiles of y (y stored [n][k] in s,
// its rows the product's columns), a given as KD A fragments per k chunk
// by get_a(kk, frag)
template <int NT, int KD, int LD, typename GetA>
__device__ __forceinline__ void product_nt(float (&acc)[NT][4],
                                           const bf16 (*y)[LD], GetA get_a) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t a[4];
    get_a(kk, a);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(smem_u32(&y[(n + (mi >> 1)) * 8 + rr]
                             [kk * 16 + (mi & 1) * 8]),
                  b0, b1, b2, b3);
      mma_bf16(acc[n], a, b0, b1);
      mma_bf16(acc[n + 1], a, b2, b3);
    }
  }
}

// acc[j] += p . y for the D/8 n8 tiles of y (stored [k][d] in s: K rows),
// p the warp's fp32 C tiles over the K axis (NT of them), rounded to bf16
template <int DT, int NT, int LD>
__device__ __forceinline__ void product_pv(float (&acc)[DT][4],
                                           const float (&p)[NT][4],
                                           const bf16 (*y)[LD]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(smem_u32(&y[kk * 16 + (mi & 1) * 8 + rr]
                                   [(j + (mi >> 1)) * 8]),
                        b0, b1, b2, b3);
      mma_bf16(acc[j], a, b0, b1);
      mma_bf16(acc[j + 1], a, b2, b3);
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
    for (int j = 0; j < DT; ++j) {
      p[j * 8] = __float2bfloat16(acc[j][2 * i] * scale);
      p[j * 8 + 1] = __float2bfloat16(acc[j][2 * i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dq pass: delta and dQ of one 64-row q tile
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int BK = Tile<D>::kCols, LD = Tile<D>::kLd;
  constexpr int NT = BK / 8, DT = D / 8, KD = D / 16;
  __shared__ __align__(16) bf16 ks[2][BK][LD];
  __shared__ __align__(16) bf16 vs[2][BK][LD];
  __shared__ float delta_s[kBlockRows];

  const int n_qt = (a.Tq + kBlockRows - 1) / kBlockRows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  const int row0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockRows;
  const int kv_end = a.causal ? min(a.Tk, row0 + kBlockRows) : a.Tk;
  const int t_end = (kv_end + BK - 1) / BK;
  const int t_begin = max(0, row0 - (a.window - 1)) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = row0 + warp * kWarpRows;
  const int rows[2] = {wrow + g, wrow + g + 8};

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.so.b + h * a.so.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const long long lrow = (static_cast<long long>(b) * a.Hq + h) * a.Tq;

  // q and dO as A fragments (rows g / g + 8, k pairs 2 t4 / 2 t4 + 8)
  uint32_t qf[KD][4], df[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(rows[i & 1], a.Tq - 1);
      const int c = kk * 16 + 2 * t4 + (i >> 1) * 8;
      const bf16* pq = qb + r * a.sq.t + c;
      const bf16* pd = dob + r * a.sdo.t + c;
      qf[kk][i] = pack_bf16(pq[0], pq[1]);
      df[kk][i] = pack_bf16(pd[0], pd[1]);
    }

  // delta = rowsum(dO * O): two lanes per row of the warp
  {
    const int r = wrow + (lane >> 1);
    float part = 0.f;
    if (r < a.Tq) {
      const bf16* pd = dob + r * a.sdo.t + (lane & 1) * (D / 2);
      const bf16* po = ob + r * a.so.t + (lane & 1) * (D / 2);
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c)
        part += __bfloat162float(pd[c]) * __bfloat162float(po[c]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0) {
      delta_s[warp * kWarpRows + (lane >> 1)] = part;
      if (r < a.Tq) a.delta[lrow + r] = part;
    }
    __syncwarp();
  }
  const float dl[2] = {delta_s[warp * kWarpRows + g],
                       delta_s[warp * kWarpRows + g + 8]};

  auto q_a = [&](int kk, uint32_t(&f)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = qf[kk][i];
  };
  auto do_a = [&](int kk, uint32_t(&f)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = df[kk][i];
  };

  // the forward's log-sum-exp of the rows (base 2)
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lse[i] = rows[i] < a.Tq ? a.lse[lrow + rows[i]] : 0.f;

  // dQ = sum over kv tiles of dS K
  float acc[DT][4];
  zero(acc);
  if (t_begin < t_end) {
    stage_rows<D, BK>(ks[0], kb, a.sk.t, t_begin * BK, a.Tk);
    stage_rows<D, BK>(vs[0], vb, a.sv.t, t_begin * BK, a.Tk);
  }
  commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      stage_rows<D, BK>(ks[buf ^ 1], kb, a.sk.t, (t + 1) * BK, a.Tk);
      stage_rows<D, BK>(vs[buf ^ 1], vb, a.sv.t, (t + 1) * BK, a.Tk);
    }
    commit();
    wait_group<1>();
    __syncthreads();
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    product_nt<NT, KD, LD>(s, ks[buf], q_a);
    product_nt<NT, KD, LD>(dp, vs[buf], do_a);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * BK + n * 8 + 2 * t4 + (e & 1);
        const bool ok = visible(rows[e >> 1], col, a.Tk, a.causal, a.window);
        const float p = ok ? exp2f(s[n][e] * a.scale2 - lse[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[e >> 1]);       // dS
      }
    product_pv<DT, NT, LD>(acc, s, ks[buf]);
    __syncthreads();
  }
  wait_group<0>();
  store_rows<DT>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h,
                 a.sdq.t, rows, a.Tq, acc, a.sm_scale);
}

// ---------------------------------------------------------------------------
// bf16 dk/dv pass: dK and dV of one 64-row kv tile, over the group's q
// heads
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kBlockRows + 4 * Tile<D>::kCols) * Tile<D>::kLd * 2 +
         4 * Tile<D>::kCols * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  constexpr int BQ = Tile<D>::kCols, LD = Tile<D>::kLd;
  constexpr int NT = BQ / 8, DT = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*ks)[LD] = reinterpret_cast<bf16(*)[LD]>(smem);
  bf16(*vs)[LD] = ks + kBlockRows;
  bf16(*qs)[LD] = vs + kBlockRows;       // [2 * BQ]: two buffers
  bf16(*dos)[LD] = qs + 2 * BQ;
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ);   // [2 * BQ]
  float* dl_s = lse_s + 2 * BQ;

  const int c0 = blockIdx.x * kBlockRows;
  const int hk = blockIdx.y, b = blockIdx.z, rep = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvrows[2] = {c0 + warp * kWarpRows + g,
                         c0 + warp * kWarpRows + g + 8};
  // the q rows that see a col of [c0, c0 + 64): from c0 under the causal
  // mask, below c0 + 63 + window
  const int q_begin = a.causal ? c0 : 0;
  const int q_end = min(a.Tq, c0 + kBlockRows - 1 + a.window);
  const int u_begin = q_begin / BQ;
  const int n_u = max(0, (q_end + BQ - 1) / BQ - u_begin);
  const int total = rep * n_u;           // (q head, q tile) pairs

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  stage_rows<D, kBlockRows>(
      ks, static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h, a.sk.t,
      c0, a.Tk);
  stage_rows<D, kBlockRows>(
      vs, static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h, a.sv.t,
      c0, a.Tk);
  auto stage_q = [&](int it, int buf) {
    const int h = hk * rep + it / n_u, u0 = (u_begin + it % n_u) * BQ;
    stage_rows<D, BQ>(qs + buf * BQ, q + b * a.sq.b + h * a.sq.h, a.sq.t,
                      u0, a.Tq);
    stage_rows<D, BQ>(dos + buf * BQ, dout + b * a.sdo.b + h * a.sdo.h,
                      a.sdo.t, u0, a.Tq);
    const long long lrow = (static_cast<long long>(b) * a.Hq + h) * a.Tq;
    for (int e = threadIdx.x; e < BQ; e += blockDim.x) {
      const int r = u0 + e;
      lse_s[buf * BQ + e] = r < a.Tq ? a.lse[lrow + r] : 0.f;
      dl_s[buf * BQ + e] = r < a.Tq ? a.delta[lrow + r] : 0.f;
    }
  };
  if (total > 0) stage_q(0, 0);
  commit();

  auto k_a = [&](int kk, uint32_t(&f)[4]) {
    load_a<LD>(f, ks, warp * kWarpRows, kk * 16);
  };
  auto v_a = [&](int kk, uint32_t(&f)[4]) {
    load_a<LD>(f, vs, warp * kWarpRows, kk * 16);
  };

  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    const int u0 = (u_begin + it % n_u) * BQ;
    if (it + 1 < total) stage_q(it + 1, buf ^ 1);
    commit();
    wait_group<1>();
    __syncthreads();
    const bf16(*qt)[LD] = qs + buf * BQ;
    const bf16(*dot)[LD] = dos + buf * BQ;
    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 kv rows x BQ q cols
    float st[NT][4], dpt[NT][4];
    zero(st);
    zero(dpt);
    product_nt<NT, KD, LD>(st, qt, k_a);
    product_nt<NT, KD, LD>(dpt, dot, v_a);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t4 + (e & 1), qrow = u0 + j;
        const bool ok = qrow < a.Tq && visible(qrow, kvrows[e >> 1], a.Tk,
                                               a.causal, a.window);
        const float p =
            ok ? exp2f(st[n][e] * a.scale2 - lse_s[buf * BQ + j]) : 0.f;
        st[n][e] = p;                                      // P^T
        dpt[n][e] = p * (dpt[n][e] - dl_s[buf * BQ + j]);  // dS^T
      }
    product_pv<DT, NT, LD>(dv, st, dot);
    product_pv<DT, NT, LD>(dk, dpt, qt);
    __syncthreads();                     // this buffer may be refilled
  }
  wait_group<0>();
  store_rows<DT>(static_cast<bf16*>(a.dk) + b * a.sdk.b + hk * a.sdk.h,
                 a.sdk.t, kvrows, a.Tk, dk, a.sm_scale);
  store_rows<DT>(static_cast<bf16*>(a.dv) + b * a.sdv.b + hk * a.sdv.h,
                 a.sdv.t, kvrows, a.Tk, dv, 1.f);
}

// ---------------------------------------------------------------------------
// fp32, D 16-128: the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct Core {
  static constexpr int kGroup = D / 16;              // threads per row
  static constexpr int kDims = 16;                   // dims per thread: g + G i
  static constexpr int kTile = D == 128 ? 32 : 64;   // the other side's rows
  static constexpr int kThreads = kBlockRows * kGroup;
};

// The sum over a row's G threads (consecutive lanes).
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [r0, r0 + ROWS) of one head (row stride st, every row on 16
// bytes) into s by 16-byte cp.async, all in flight at once; rows at or
// past n are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage_f32(float (*s)[D], const float* base,
                                          long long st, int r0, int n) {
  constexpr int CH = D / 4;
  for (int e = threadIdx.x; e < ROWS * CH; e += blockDim.x) {
    const int j = e / CH, c = (e - j * CH) * 4;
    const int r = r0 + j;
    if (r >= n)
      *reinterpret_cast<float4*>(&s[j][c]) = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      cp_async16(&s[j][c], base + r * st + c);
  }
}

// dq pass: delta and dQ of one 64-row q tile; thread g of a row's group
// holds its dims g + G i of q, dO and the dQ accumulator.
template <int D>
__global__ void __launch_bounds__(Core<D>::kThreads)
flash_bwd_dq_f32_kernel(Args a) {
  constexpr int G = Core<D>::kGroup, DPT = Core<D>::kDims;
  constexpr int BK = Core<D>::kTile;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int n_qt = (a.Tq + kBlockRows - 1) / kBlockRows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  const int row0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockRows;
  const int kv_end = a.causal ? min(a.Tk, row0 + kBlockRows) : a.Tk;
  const int t_end = (kv_end + BK - 1) / BK;
  const int t_begin = max(0, row0 - (a.window - 1)) / BK;
  const int g = threadIdx.x % G, row = row0 + threadIdx.x / G;
  const bool live = row < a.Tq;
  const int r = min(row, a.Tq - 1);
  const long long lrow = (static_cast<long long>(b) * a.Hq + h) * a.Tq;

  const float* qr = static_cast<const float*>(a.q) + b * a.sq.b + r * a.sq.t
                    + h * a.sq.h;
  const float* orow = static_cast<const float*>(a.o) + b * a.so.b
                      + r * a.so.t + h * a.so.h;
  const float* dor = static_cast<const float*>(a.dout) + b * a.sdo.b
                     + r * a.sdo.t + h * a.sdo.h;
  float qv[DPT], dov[DPT], acc[DPT];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qv[i] = qr[g + G * i];
    dov[i] = dor[g + G * i];
    part = fmaf(dov[i], orow[g + G * i], part);
    acc[i] = 0.f;
  }
  const float delta = group_sum<G>(part);
  if (live && g == 0) a.delta[lrow + row] = delta;
  const float lse = a.lse[lrow + r];

  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b
                    + hk * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b
                    + hk * a.sv.h;
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();                     // the previous tile is consumed
    stage_f32<D, BK>(ks, kb, a.sk.t, t * BK, a.Tk);
    stage_f32<D, BK>(vs, vb, a.sv.t, t * BK, a.Tk);
    commit();
    wait_group<0>();
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        s = fmaf(qv[i], ks[j][g + G * i], s);
        dp = fmaf(dov[i], vs[j][g + G * i], dp);
      }
      s = group_sum<G>(s);
      dp = group_sum<G>(dp);
      const bool ok = visible(row, t * BK + j, a.Tk, a.causal, a.window);
      const float p = ok ? exp2f(s * a.scale2 - lse) : 0.f;
      const float ds = p * (dp - delta);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(ds, ks[j][g + G * i], acc[i]);
    }
  }
  if (live) {
    float* out = static_cast<float*>(a.dq) + b * a.sdq.b + row * a.sdq.t
                 + h * a.sdq.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[g + G * i] = acc[i] * a.sm_scale;
  }
}

// dk/dv pass: dK and dV of one 64-row kv tile over the group's q heads;
// thread g of a kv row's group holds its dims g + G i of k, v and both
// accumulators.
template <int D>
__global__ void __launch_bounds__(Core<D>::kThreads)
flash_bwd_dkdv_f32_kernel(Args a) {
  constexpr int G = Core<D>::kGroup, DPT = Core<D>::kDims;
  constexpr int BQ = Core<D>::kTile;
  __shared__ __align__(16) float qs[BQ][D];
  __shared__ __align__(16) float dos[BQ][D];
  __shared__ float lse_s[BQ], dl_s[BQ];

  const int c0 = blockIdx.x * kBlockRows;
  const int hk = blockIdx.y, b = blockIdx.z, rep = a.Hq / a.Hkv;
  const int g = threadIdx.x % G, kvrow = c0 + threadIdx.x / G;
  const bool live = kvrow < a.Tk;
  const int r = min(kvrow, a.Tk - 1);
  // the q rows that see a col of [c0, c0 + 64): from c0 under the causal
  // mask, below c0 + 63 + window
  const int q_begin = a.causal ? c0 : 0;
  const int q_end = min(a.Tq, c0 + kBlockRows - 1 + a.window);
  const int u_begin = q_begin / BQ;
  const int n_u = max(0, (q_end + BQ - 1) / BQ - u_begin);

  const float* kr = static_cast<const float*>(a.k) + b * a.sk.b + r * a.sk.t
                    + hk * a.sk.h;
  const float* vr = static_cast<const float*>(a.v) + b * a.sv.b + r * a.sv.t
                    + hk * a.sv.h;
  float kv[DPT], vv[DPT], dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kv[i] = kr[g + G * i];
    vv[i] = vr[g + G * i];
    dk[i] = dv[i] = 0.f;
  }
  for (int it = 0; it < rep * n_u; ++it) {
    const int h = hk * rep + it / n_u, u0 = (u_begin + it % n_u) * BQ;
    const long long lrow = (static_cast<long long>(b) * a.Hq + h) * a.Tq;
    __syncthreads();                     // the previous tile is consumed
    stage_f32<D, BQ>(qs, static_cast<const float*>(a.q) + b * a.sq.b
                             + h * a.sq.h, a.sq.t, u0, a.Tq);
    stage_f32<D, BQ>(dos, static_cast<const float*>(a.dout) + b * a.sdo.b
                              + h * a.sdo.h, a.sdo.t, u0, a.Tq);
    for (int e = threadIdx.x; e < BQ; e += blockDim.x) {
      lse_s[e] = u0 + e < a.Tq ? a.lse[lrow + u0 + e] : 0.f;
      dl_s[e] = u0 + e < a.Tq ? a.delta[lrow + u0 + e] : 0.f;
    }
    commit();
    wait_group<0>();
    __syncthreads();
    for (int i = 0; i < BQ; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        s = fmaf(kv[d], qs[i][g + G * d], s);
        dp = fmaf(vv[d], dos[i][g + G * d], dp);
      }
      s = group_sum<G>(s);
      dp = group_sum<G>(dp);
      const int qrow = u0 + i;
      const bool ok = qrow < a.Tq
                      && visible(qrow, kvrow, a.Tk, a.causal, a.window);
      const float p = ok ? exp2f(s * a.scale2 - lse_s[i]) : 0.f;
      const float ds = p * (dp - dl_s[i]);
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        dv[d] = fmaf(p, dos[i][g + G * d], dv[d]);
        dk[d] = fmaf(ds, qs[i][g + G * d], dk[d]);
      }
    }
  }
  if (live) {
    float* odk = static_cast<float*>(a.dk) + b * a.sdk.b + kvrow * a.sdk.t
                 + hk * a.sdk.h;
    float* ov = static_cast<float*>(a.dv) + b * a.sdv.b + kvrow * a.sdv.t
                + hk * a.sdv.h;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      odk[g + G * d] = dk[d] * a.sm_scale;
      ov[g + G * d] = dv[d];
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const dim3 grid_q((a.Tq + kBlockRows - 1) / kBlockRows, a.Hq, a.B);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.Tk + kBlockRows - 1) / kBlockRows, a.Hkv, a.B);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t st) {
  const dim3 grid_q((a.Tq + kBlockRows - 1) / kBlockRows, a.Hq, a.B);
  flash_bwd_dq_f32_kernel<D><<<grid_q, Core<D>::kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.Tk + kBlockRows - 1) / kBlockRows, a.Hkv, a.B);
  flash_bwd_dkdv_f32_kernel<D><<<grid_kv, Core<D>::kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores, D 16/32/64/128), 1 = bfloat16 (tensor
// cores, D 16/32).  Pointers: q, k, v, o, dO (read), dq, dk, dv (written),
// all in dtype; lse, the forward's fp32 (B, Hq, Tq) log-sum-exp (base 2
// of the scaled scores); delta, fp32 (B, Hq, Tq) scratch.  strides: 24
// values, (batch, time, head) in elements for q, k, v, o, dO, dq, dk, dv
// in that order.  window: row r sees cols c with r - c < window (a value
// above every r - c for none).  q, k, v and dO rows start on 16 bytes.
// Returns the launches' cudaError_t.
extern "C" int flash_bwd_launch(int dtype, int head_dim, const void* q,
                                const void* k, const void* v, const void* o,
                                const void* dout, void* dq, void* dk,
                                void* dv, const void* lse, void* delta,
                                int B, int Hq, int Hkv, int Tq, int Tk,
                                const long long* strides, int causal,
                                int window, float sm_scale, void* stream) {
  const long long* s = strides;
  Args a{q, k, v, o, dout, dq, dk, dv, static_cast<const float*>(lse),
         static_cast<float*>(delta),
         B, Hq, Hkv, Tq, Tk,
         Strides{s[0], s[1], s[2]},      Strides{s[3], s[4], s[5]},
         Strides{s[6], s[7], s[8]},      Strides{s[9], s[10], s[11]},
         Strides{s[12], s[13], s[14]},   Strides{s[15], s[16], s[17]},
         Strides{s[18], s[19], s[20]},   Strides{s[21], s[22], s[23]},
         causal, window,
         static_cast<float>(sm_scale * 1.4426950408889634), sm_scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && head_dim == 16)
    err = launch<16>(a, st);
  else if (dtype == 1 && head_dim == 32)
    err = launch<32>(a, st);
  else if (dtype == 0 && head_dim == 16)
    err = launch_f32<16>(a, st);
  else if (dtype == 0 && head_dim == 32)
    err = launch_f32<32>(a, st);
  else if (dtype == 0 && head_dim == 64)
    err = launch_f32<64>(a, st);
  else if (dtype == 0 && head_dim == 128)
    err = launch_f32<128>(a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
