// Flash attention forward for the shapes the tensor-core (sm90) kernel does
// not take: bf16 at head dim 16 and 32 on the tensor cores (mma.sync), and
// fp32 at any head dim on the CUDA cores.  Online softmax over kv tiles,
// causal (top-left, rows >= cols) or full, fp32 accumulation, output in the
// input dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): grid (B*H, q blocks, kv blocks) with the
// running (m, l, acc) state in VMEM scratch across the sequential kv axis,
// causal blocks above the diagonal skipped, the padded kv tail masked with
// -1e30 and the denominator clamped at 1e-30.  Here the kv axis is a loop
// inside the block, the state lives in registers:
//
//   for each kv tile:  s = (q . k^T) * sm_scale        (masked to -1e30)
//                      m' = max(m, max_j s);  a = exp(m - m')
//                      l  = l * a + sum_j exp(s - m')
//                      acc = acc * a + sum_j exp(s - m') v_j;   m = m'
//   out = acc / max(l, 1e-30)
//
// in base 2: the scores carry sm_scale * log2(e), and exp2 (one ex2 per
// element) stands for exp; the softmax is the same.
//
// What bounds it on an H100.  These shapes are small: the reduced model's
// prefill (B 4, T 256, H 2, D 32, bf16, causal) is 17 MFLOP against 0.26
// MB, well under a microsecond at either roof, so the time goes to latency:
// the launch, global loads, and the serial chain of each block over its kv
// tiles.  The first draft ran each block's chain in scalar fp32 (bf16 too)
// with synchronous loads.  So the design shortens the chains:
//
// * one block per (64-row q tile, head, batch): 4 warps share each staged
//   k/v tile; the latest (heaviest, under the causal mask) q tiles start
//   first.  At the reduced prefill that is 32 blocks on 132 SMs, and each
//   walks at most 4 kv tiles.
// * bf16, D 16/32: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) for
//   q . k^T and p . v.  Each warp owns 16 q rows and keeps the online
//   softmax state per row in the mma accumulator layout (a thread holds
//   rows g and g + 8 of its quad, reduced with two shuffles); p is rounded
//   to bf16 for the second product, as flash_attention_sm90.cu does.  k/v
//   tiles of 64 rows are staged with cp.async into a double buffer (rows
//   padded by 16 bytes, so ldmatrix reads them without bank conflicts), the
//   B operands come from ldmatrix (.trans for v).
// * fp32, any D: tensor-core TF32 would miss fp32's 2e-5, so the CUDA
//   cores: D/16 threads per q row, each with 16 interleaved dims of q and
//   acc in registers, k/v tiles staged with cp.async (every load of a tile
//   in flight at once: a 16-row tile has as few as 32 threads) and read
//   by broadcast, the row's dot product finished with warp shuffles.
//
// Layout: q, o are (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D) in whatever
// order of the three outer axes the caller has: the wrapper passes each
// tensor's (batch, time, head) strides in elements, D is contiguous.  GQA:
// q head h reads kv head h / (Hq / Hkv) in place.
//
// C interface, bound with ctypes from repro_torch/kernels/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;     // _flash_kernel's NEG_INF
constexpr float kDenomMin = 1e-30f;   // _flash_kernel's denominator clamp
constexpr int kWarpRows = 16;         // q rows per warp (the mma's M)
constexpr int kBlockQ = 64;           // q rows per block: 4 warps share k/v

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, t, h;                  // elements; the D axis has stride 1
};

// The block's work: head, batch, kv head, first q row, and the kv tiles
// it walks, [0, n_kv).
struct Work {
  int h, b, hk, row0, n_kv;
};

__device__ __forceinline__ Work block_work(int block_k, int Hq, int Hkv,
                                           int Tq, int Tk, int causal) {
  Work w;
  const int n_qt = (Tq + kBlockQ - 1) / kBlockQ;
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.hk = w.h / (Hq / Hkv);
  w.row0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int kv_end = causal ? min(Tk, w.row0 + kBlockQ) : Tk;
  w.n_kv = (kv_end + block_k - 1) / block_k;
  return w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);           // round to nearest even
}

// out[row, col] = acc / max(l, 1e-30) for a thread's rows below Tq
template <typename T, int NR, int NV>
__device__ __forceinline__ void finish(void* o_, Strides so, const Work& w,
                                       int Tq, const int (&rows)[NR],
                                       const int (&cols)[NV],
                                       const float (&acc)[NR][NV],
                                       const float (&l)[NR]) {
  T* o = static_cast<T*>(o_) + w.b * so.b + w.h * so.h;
#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (rows[r] < Tq)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        store(o + (long long)rows[r] * so.t + cols[v],
              acc[r][v] / fmaxf(l[r], kDenomMin));
}

// ---------------------------------------------------------------------------
// bf16, D 16 / 32: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

template <int D>
struct Mma {
  static constexpr int kBlockK = 64;  // kv rows per tile
  static constexpr int kLd = D + 8;   // smem row, bf16: 16-byte padded
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
};

// Stage kv rows [k0, k0 + 64) of k and v into one buffer: cp.async when
// every row is 16-byte aligned, else through registers; rows past Tk are
// zeros.
template <int D>
__device__ __forceinline__ void stage_kv(bf16 (*ks)[Mma<D>::kLd],
                                         bf16 (*vs)[Mma<D>::kLd],
                                         const bf16* kb, const bf16* vb,
                                         Strides sk, Strides sv, int k0,
                                         int Tk, int aligned) {
  constexpr int BK = Mma<D>::kBlockK, CH = Mma<D>::kChunks;
  for (int e = threadIdx.x; e < BK * CH; e += blockDim.x) {
    const int j = e / CH, c = (e - j * CH) * 8;
    const int col = k0 + j;
    if (col >= Tk) {
      *reinterpret_cast<uint4*>(&ks[j][c]) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&vs[j][c]) = make_uint4(0, 0, 0, 0);
    } else if (aligned) {
      cp_async16(&ks[j][c], kb + col * sk.t + c);
      cp_async16(&vs[j][c], vb + col * sv.t + c);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ks[j][c + i] = kb[col * sk.t + c + i];
        vs[j][c + i] = vb[col * sv.t + c + i];
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int D>
__global__ void __launch_bounds__(kBlockQ / kWarpRows * 32)
flash_core_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int Hq, int Hkv, int Tq, int Tk, Strides sq, Strides sk,
                      Strides sv, Strides so, int causal, float sm_scale,
                      int aligned) {
  constexpr int BK = Mma<D>::kBlockK, LD = Mma<D>::kLd;
  constexpr int NT = BK / 8;          // n8 tiles of s per kv tile
  constexpr int DT = D / 8;           // n8 tiles of the output
  __shared__ __align__(16) bf16 ks[2][BK][LD];
  __shared__ __align__(16) bf16 vs[2][BK][LD];

  const Work w = block_work(BK, Hq, Hkv, Tq, Tk, causal);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = w.row0 + warp * kWarpRows;   // this warp's first row
  const int rows[2] = {wrow + g, wrow + g + 8};

  // q as A fragments (rows g / g + 8, k-pairs 2 t4 / 2 t4 + 8), in place
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(rows[i & 1], Tq - 1);
      const int c = kk * 16 + 2 * t4 + (i >> 1) * 8;
      const bf16* p = q + w.b * sq.b + (long long)r * sq.t + w.h * sq.h + c;
      qf[kk][i] = pack_bf16(p[0], p[1]);
    }
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's

  const bf16* kb = k + w.b * sk.b + w.hk * sk.h;
  const bf16* vb = v + w.b * sv.b + w.hk * sv.h;
  if (w.n_kv > 0)
    stage_kv<D>(ks[0], vs[0], kb, vb, sk, sv, 0, Tk, aligned);
  for (int t = 0; t < w.n_kv; ++t) {
    const int buf = t & 1;
    if (t + 1 < w.n_kv)
      stage_kv<D>(ks[buf ^ 1], vs[buf ^ 1], kb, vb, sk, sv, (t + 1) * BK, Tk,
                  aligned);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // s = q . k^T: 16 x 64 per warp
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(smem_u32(&ks[buf][(n + (mi >> 1)) * 8 + rr]
                                [kk * 16 + (mi & 1) * 8]),
                    b0, b1, b2, b3);
        mma_bf16(s[n], qf[kk], b0, b1);
        mma_bf16(s[n + 1], qf[kk], b2, b3);
      }
    }
    // scale, mask, the rows' maxima (over the quad: shuffles 1 and 2)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * BK + n * 8 + 2 * t4 + (e & 1);
        const int row = rows[e >> 1];
        const bool ok = col < Tk && (!causal || row >= col);
        s[n][e] = ok ? s[n][e] * sm_scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    // p = exp(s - m) in place; p . v with p rounded to bf16
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(smem_u32(&vs[buf][kk * 16 + (mi & 1) * 8 + rr]
                                      [(j + (mi >> 1)) * 8]),
                          b0, b1, b2, b3);
        mma_bf16(acc[j], a, b0, b1);
        mma_bf16(acc[j + 1], a, b2, b3);
      }
    }
    __syncthreads();                  // this buffer may be refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  int cols[2 * DT];
  float res[2][2 * DT];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cols[2 * j + e] = j * 8 + 2 * t4 + e;
#pragma unroll
      for (int i = 0; i < 2; ++i) res[i][2 * j + e] = acc[j][2 * i + e];
    }
  finish<bf16>(o, so, w, Tq, rows, cols, res, l);
}

// ---------------------------------------------------------------------------
// fp32, any D: the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct Core {
  static constexpr int kGroup = D / 16;              // threads per q row
  static constexpr int kDims = D / kGroup;           // dims per thread: 16
  static constexpr int kBlockK = D == 128 ? 32 : 64;  // kv rows per tile
  static constexpr int kThreads = kBlockQ * kGroup;
};

// Stage kv rows [k0, k0 + BK) of k and v into shared memory with cp.async
// (16-byte pieces when every row is 16-byte aligned, else 4-byte ones), so
// all of a tile's loads are in flight at once; rows past Tk are zeros.
template <int D, int BK>
__device__ __forceinline__ void stage_kv_f32(float (*ks)[D], float (*vs)[D],
                                             const float* kb,
                                             const float* vb, Strides sk,
                                             Strides sv, int k0, int Tk,
                                             int aligned) {
  const int vec = aligned ? 4 : 1, per_row = D / vec;
  for (int e = threadIdx.x; e < BK * per_row; e += blockDim.x) {
    const int j = e / per_row, d = (e - j * per_row) * vec;
    const int col = k0 + j;
    if (col >= Tk) {
      for (int i = 0; i < vec; ++i) ks[j][d + i] = vs[j][d + i] = 0.f;
    } else if (aligned) {
      cp_async16(&ks[j][d], kb + col * sk.t + d);
      cp_async16(&vs[j][d], vb + col * sv.t + d);
    } else {
      cp_async4(&ks[j][d], kb + col * sk.t + d);
      cp_async4(&vs[j][d], vb + col * sv.t + d);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int D>
__global__ void __launch_bounds__(Core<D>::kThreads)
flash_core_fp32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Hq, int Hkv, int Tq, int Tk, Strides sq,
                       Strides sk, Strides sv, Strides so, int causal,
                       float sm_scale, int aligned) {
  constexpr int G = Core<D>::kGroup;
  constexpr int DPT = Core<D>::kDims;
  constexpr int BK = Core<D>::kBlockK;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const Work w = block_work(BK, Hq, Hkv, Tq, Tk, causal);
  const int tid = threadIdx.x;
  const int g = tid % G;                        // this thread's dims: g + G*i
  const int row = w.row0 + tid / G;
  const bool live = row < Tq;                   // ragged q rows: no store

  // q row, pre-scaled, and the output accumulator, in registers
  float qv[DPT], acc[DPT];
  const float* qrow = q + w.b * sq.b + (long long)min(row, Tq - 1) * sq.t
                      + w.h * sq.h;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qv[i] = live ? qrow[g + G * i] * sm_scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const float* kb = k + w.b * sk.b + w.hk * sk.h;
  const float* vb = v + w.b * sv.b + w.hk * sv.h;
  for (int t = 0; t < w.n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();                            // previous tile consumed
    stage_kv_f32<D, BK>(ks, vs, kb, vb, sk, sv, k0, Tk, aligned);
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qv[i], ks[j][g + G * i], part);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int col = k0 + j;
      const bool ok = col < Tk && (!causal || row >= col);
      s[j] = ok ? part : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j][g + G * i], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  const int rows[1] = {row};
  int cols[DPT];
  float res[1][DPT];
  const float ls[1] = {l};
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    cols[i] = g + G * i;
    res[0][i] = acc[i];
  }
  finish<float>(o, so, w, Tq, rows, cols, res, ls);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Hq, Hkv, Tq, Tk;
  Strides sq, sk, sv, so;
  int causal;
  float sm_scale;
  int aligned;
};

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t st) {
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
  flash_core_mma_kernel<D><<<grid, kBlockQ / kWarpRows * 32, 0, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.Hq, a.Hkv,
      a.Tq, a.Tk, a.sq, a.sk, a.sv, a.so, a.causal, a.sm_scale, a.aligned);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const Args& a, cudaStream_t st) {
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
  flash_core_fp32_kernel<D><<<grid, Core<D>::kThreads, 0, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Hq, a.Hkv,
      a.Tq, a.Tk, a.sq, a.sk, a.sv, a.so, a.causal, a.sm_scale, a.aligned);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores, D 16/32/64/128), 1 = bfloat16 (tensor
// cores, D 16/32).  Strides in elements, (batch, time, head) for each of
// q, k, v, o.  aligned: every k/v row starts on 16 bytes (16-byte
// cp.async).
// Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, int B, int Hq, int Hkv, int Tq, int Tk, long long qsb,
    long long qst, long long qsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh,
    long long osb, long long ost, long long osh, int causal, float sm_scale,
    int aligned, void* stream) {
  // scores in base 2: exp(x * sm_scale) = exp2(x * sm_scale * log2(e))
  sm_scale = static_cast<float>(sm_scale * 1.4426950408889634);
  const Args a{q, k, v, o, B, Hq, Hkv, Tq, Tk,
               Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh},
               Strides{vsb, vst, vsh}, Strides{osb, ost, osh}, causal,
               sm_scale, aligned};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && head_dim == 16)
    err = launch_mma<16>(a, st);
  else if (dtype == 1 && head_dim == 32)
    err = launch_mma<32>(a, st);
  else if (dtype == 0 && head_dim == 16)
    err = launch_fp32<16>(a, st);
  else if (dtype == 0 && head_dim == 32)
    err = launch_fp32<32>(a, st);
  else if (dtype == 0 && head_dim == 64)
    err = launch_fp32<64>(a, st);
  else if (dtype == 0 && head_dim == 128)
    err = launch_fp32<128>(a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
