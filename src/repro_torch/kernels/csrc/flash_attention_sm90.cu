// Flash attention forward on Hopper's tensor cores: bf16 q, k, v with head
// dim 64 or 128, online softmax over kv tiles, causal (top-left, rows >=
// cols) or full, fp32 accumulation, bf16 output.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) for bf16 at D 64 and 128, the head dims of
// the repo's configs; csrc/flash_attention.cu (CUDA cores) keeps fp32 and
// D 16/32.  It computes what _flash_kernel computes: per kv tile
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
// * kv tiles wholly past a q tile's last row are never loaded; the mask
//   runs only on the diagonal tile and the ragged kv tail;
// * the output goes through shared memory and a TMA store, which skips
//   the rows past Tq.
//
// C interface, bound with ctypes from repro_torch/kernels/flash_attention.py,
// which computes each tensor's TMA geometry (and checks its alignment);
// the maps themselves are encoded here per call with libcuda's
// cuTensorMapEncodeTiled, looked up at first use.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;     // _flash_kernel's NEG_INF
constexpr float kDenomMin = 1e-30f;   // _flash_kernel's denominator clamp
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockQ = 128;          // q rows per block: 2 consumers x 64
constexpr int kBlockK = 128;          // kv rows per tile
constexpr int kStages = 2;            // k/v ring depth
constexpr int kBoxCols = 64;          // bf16 columns per 128-byte TMA box
constexpr int kThreads = 384;         // 2 consumer + 1 producer warpgroups
constexpr int kConsumerThreads = 256;

template <int D>
struct Smem {
  static constexpr int kBoxes = D / kBoxCols;          // 1 or 2
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;    // one k or v tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kO = kV + kStages * kKVBytes;  // output staging
  static constexpr int kBars = kO + kQBytes;
  // barriers: full and empty for q, then for k and for v, kStages each
  static constexpr int kBytes = kBars + 8 * (2 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;         // room to align
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase with this parity.  (No
// timeout: a trap path shared by the warp roles makes ptxas serialise the
// consumers' wgmma at D 128 for want of registers.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// 4-d tile load (d, t, h, b) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(t), "r"(h), "r"(b)
      : "memory");
}

// 4-d tile store (d, t, h, b) from shared memory; rows past the tensor's
// end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int d, int t, int h,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(d), "r"(t),
         "r"(h), "r"(b)
      : "memory");
}

// Named barrier 1 + wg: the 128 threads of one consumer warpgroup (0 is
// __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands: SBO
// is the 1024 bytes between groups of 8 rows, LBO unused.  MN-major V: SBO
// is the 1024 bytes between groups of 8 kv rows, LBO the distance between
// the 64-column boxes of D.
// A tile's descriptors differ only in the start address (the low 14
// bits), so a chain adds byte offsets / 16 to one base.  The base passes
// through an empty asm: otherwise the compiler hoists every descriptor of
// every stage out of the loop and runs out of registers.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  asm volatile("" : "+r"(addr));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// D[64 x 128] (+)= A[64 x 16] (shared, K-major) . B[16 x 128] (shared, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] (registers) . B[16 x 128] (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Keep the accumulator in place across an asynchronous wgmma: the compiler
// may not move reads or writes of `x` over this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// S = Q K^T for one consumer: D/16 k-steps, each 32 bytes further along
// the 128-byte rows of a box; D 128 steps into the second box after 4.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[kBlockK / 2],
                                        uint32_t q_rows, uint32_t k_tile) {
  const uint64_t da = smem_desc(q_rows, 16, 1024);
  const uint64_t db = smem_desc(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_m64n128k16_ss(sc, da + (((kk / 4) * kBlockQ * 128 + off) >> 4),
                        db + (((kk / 4) * kBlockK * 128 + off) >> 4), kk > 0);
  }
}

// O += P V: kBlockK/16 k-steps of 16 kv rows (2048 bytes) each
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[kBlockK / 16][4],
                                         uint32_t v_tile) {
  const uint64_t db = smem_desc(v_tile, kBlockK * 128, 1024);
#pragma unroll
  for (int t = 0; t < kBlockK / 16; ++t) {
    if constexpr (D == 64) wgmma_m64n64k16_rs(acc, p[t], db + t * 128);
    else wgmma_m64n128k16_rs(acc, p[t], db + t * 128);
  }
}

// The online softmax of one consumer thread: rows r0 and r0 + 8, its two
// columns in each group of 8 of the 128-column tile.
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
  template <bool kMask>
  __device__ __forceinline__ void tile(float (&sc)[kBlockK / 2], int r0,
                                       int c0, int n0, int Tk, int causal,
                                       float scale_log2) {
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};  // 2 per row: ILP
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if (kMask) {
          const int col = n0 + 8 * j + c0 + (e & 1);
          const int row = e < 2 ? r0 : r0 + 8;
          x = (col >= Tk || (causal && row < col)) ? kNegInf
                                                   : x * scale_log2;
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
    for (int j = 0; j < kBlockK / 8; ++j) {
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
// (r0, c), (r0+8, c), (r0, c+8), (r0+8, c+8) -- the m64n128 accumulator's
// elements 8t..8t+7 in order.
__device__ __forceinline__ void pack_p(const float (&sc)[kBlockK / 2],
                                       uint32_t (&p)[kBlockK / 16][4]) {
#pragma unroll
  for (int t = 0; t < kBlockK / 16; ++t)
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
                      const __grid_constant__ CUtensorMap tmap_o, int B,
                      int Hq, int Hkv, int Tq, int Tk, int causal,
                      float scale_log2) {
  using L = Smem<D>;
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
  auto work = [&](int w, int& m0, int& h, int& b, int& n_tiles) {
    const int hb = w % (Hq * B);
    h = hb % Hq;
    b = hb / Hq;
    m0 = (n_qt - 1 - w / (Hq * B)) * kBlockQ;
    // causal: kv tiles starting after the q tile's last row are skipped
    n_tiles = ((causal ? min(Tk, m0 + kBlockQ) : Tk) + kBlockK - 1)
              / kBlockK;
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
        int m0, h, b, n_tiles;
        work(w, m0, h, b, n_tiles);
        const int hk = h / (Hq / Hkv);
        mbar_wait(empty_q, (n & 1) ^ 1);
        mbar_expect_tx(full_q, L::kQBytes);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(sq + x * kBlockQ * 128, &tmap_q, full_q, x * kBoxCols, m0,
                   h, b);
        for (int i = 0; i < n_tiles; ++i, ++j) {
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

    int j0 = 0;                            // ring position of the tile's kv 0
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      int m0, h, b, n_tiles;
      work(w, m0, h, b, n_tiles);
      const int r0 = m0 + row;
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
      Softmax sm;
      // kv tiles below n_plain need no mask; the mask, when needed, is on
      // the last one or two (the diagonal tile, the ragged kv tail)
      const int n_plain = min(min(n_tiles, Tk / kBlockK),
                              causal ? m0 / kBlockK : n_tiles);
      // One step of the main loop: S_i and P_{i-1} V_{i-1} issued
      // together, the softmax of S_i while P V is on the tensor cores.  No
      // branch holds a wgmma, a commit or a wait, so ptxas keeps the
      // products asynchronous.
      auto step = [&](int i, auto mask) {
        const int j = j0 + i;
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
                                       scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty_v + 8 * sp);
        sm.rescale(acc);
        pack_p(sc, p);
      };

      // prologue: S_0 alone
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
      if (n_plain > 0)
        sm.tile<false>(sc, r0, c0, 0, Tk, causal, scale_log2);
      else
        sm.tile<true>(sc, r0, c0, 0, Tk, causal, scale_log2);
      pack_p(sc, p);
      // main loop, unmasked kv tiles then masked ones
      int i = 1;
      for (; i < n_plain; ++i) step(i, std::false_type{});
      for (; i < n_tiles; ++i) step(i, std::true_type{});
      // every S is done: the producer may load the next q tile
      mbar_arrive(empty_q);
      // the last P V alone
      {
        const int j = j0 + n_tiles - 1;
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
      j0 += n_tiles;

      // Divide by the clamped row sums, round to bf16 and stage the rows in
      // shared memory in the 128-byte swizzle of the output map; one thread
      // stores them with TMA, which skips rows past Tq.  The buffer is
      // rewritten only once the previous tile's store has read it.
      const float inv_a = 1.f / fmaxf(quad_sum(sm.l_a), kDenomMin);
      const float inv_b = 1.f / fmaxf(quad_sum(sm.l_b), kDenomMin);
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
    }
    if (threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, from libcuda (loaded by the CUDA runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// geom: global dims (d, t, h, b), byte strides (t, h, b), box rows
int encode(CUtensorMap* map, const void* ptr, const unsigned long long* geom) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return -1;
  const cuuint64_t dims[4] = {geom[0], geom[1], geom[2], geom[3]};
  const cuuint64_t strides[3] = {geom[4], geom[5], geom[6]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBoxCols),
                             static_cast<cuuint32_t>(geom[7]), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int D>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const CUtensorMap& mo, int B, int Hq,
           int Hkv, int Tq, int Tk, int causal, float sm_scale,
           cudaStream_t stream) {
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
      mq, mk, mv, mo, B, Hq, Hkv, Tq, Tk, causal, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, o; head_dim 64 or 128.  geom: 8 values (see encode) for
// each of q, k, v and o in turn.  Returns 0, a cudaError_t, 1000 + a
// CUresult of the map encoding, or -1 when libcuda has no
// cuTensorMapEncodeTiled.
extern "C" int flash_sm90_launch(
    int head_dim, const void* q, const void* k, const void* v, void* o,
    int B, int Hq, int Hkv, int Tq, int Tk, const unsigned long long* geom,
    int causal, float sm_scale, void* stream) {
  CUtensorMap mq, mk, mv, mo;
  int rc;
  if ((rc = encode(&mq, q, geom)) || (rc = encode(&mk, k, geom + 8))
      || (rc = encode(&mv, v, geom + 16))
      || (rc = encode(&mo, o, geom + 24)))
    return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(mq, mk, mv, mo, B, Hq, Hkv, Tq, Tk, causal,
                               sm_scale, st);
    case 128: return launch<128>(mq, mk, mv, mo, B, Hq, Hkv, Tq, Tk, causal,
                                 sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_sm90_error_string(int code) {
  if (code == -1) return "libcuda has no cuTensorMapEncodeTiled";
  if (code >= 1000) return "cuTensorMapEncodeTiled refused the geometry";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
