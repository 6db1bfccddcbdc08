// (max,+) product tiles for Hopper, shared by the kernels of readiness.cu:
//
//   out[q, c] = max(init, max_k T[q, k] + A[k, c])
//
// The routines work on operands staged in shared memory k-major (Ts[k][q],
// As[k][c]), so a thread reads a short run of its rows and of its columns
// with one vector load each and keeps a TM x TN register micro-tile of
// outputs.  One (max,+) step is
//   int32: __viaddmax_s32(t, a, acc) = max(t + a, acc), a Hopper DPX
//          instruction (one issue slot for the add and the max); the add
//          wraps modulo 2^32 as int32 tensors add in PyTorch;
//   fp32:  max.NaN(acc, t + a): an IEEE add and a max that propagates NaN,
//          exactly jnp.maximum(acc, t + a) of the Pallas kernel (built
//          without fast math, so the add is never contracted or flushed).
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace maxplus {

__device__ __forceinline__ int step(int acc, int t, int a) {
  return __viaddmax_s32(t, a, acc);
}

__device__ __forceinline__ float step(float acc, float t, float a) {
  const float x = __fadd_rn(t, a);
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(x));
  return r;
}

// the identity of a padded k: lowest(T) + 0 never raises a maximum
// (int32: INT_MIN + 0 = INT_MIN; fp32: -inf + 0 = -inf)
template <typename T> __device__ __forceinline__ T pad_t();
template <> __device__ __forceinline__ int pad_t<int>() { return INT_MIN; }
template <> __device__ __forceinline__ float pad_t<float>() {
  return __uint_as_float(0xff800000u);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// acc[i][j] = step over k < kn of Ts[k * ldt + row_i] and As[k * lda + col_j]
//
// Rows: r0 + g * rstride + v for g < TM / VM and v < VM (VM = min(TM, 4)),
// read VM at a time; columns likewise from c0 with cstride.  Each vector
// must be VM- (VN-) element aligned in shared memory.
template <typename T, int TM, int TN>
__device__ __forceinline__ void micro_tile(const T* Ts, int ldt, const T* As,
                                           int lda, int kn, int r0,
                                           int rstride, int c0, int cstride,
                                           T (&acc)[TM][TN]) {
  constexpr int VM = TM < 4 ? TM : 4;
  constexpr int VN = TN < 4 ? TN : 4;
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    T t[TM], a[TN];
#pragma unroll
    for (int g = 0; g < TM / VM; ++g) {
      const Vec<T, VM> x = *reinterpret_cast<const Vec<T, VM>*>(
          Ts + k * ldt + r0 + g * rstride);
#pragma unroll
      for (int v = 0; v < VM; ++v) t[g * VM + v] = x.v[v];
    }
#pragma unroll
    for (int g = 0; g < TN / VN; ++g) {
      const Vec<T, VN> y = *reinterpret_cast<const Vec<T, VN>*>(
          As + k * lda + c0 + g * cstride);
#pragma unroll
      for (int v = 0; v < VN; ++v) a[g * VN + v] = y.v[v];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = step(acc[i][j], t[i], a[j]);
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The tiled product for shapes that fill the card: a block owns a BQ x BC
// output tile, and walks K in chunks of BK staged with cp.async into a
// double buffer (chunk k + 1 in flight while chunk k is consumed).  T
// (row-major (Q, K) in global memory) is transposed on the way in, one
// 4-byte copy per element; A rows go in 16-byte copies when ``vec_a``
// (C % 4 == 0 and a 16-byte aligned base).  Elements past Q, K or C are
// stored as the pads: pad_t for T, 0 for A.
template <typename T, int BQ, int BC, int BK, int TM, int TN>
struct Tiled {
  static constexpr int kThreads = (BQ / TM) * (BC / TN);
  static constexpr int LDT = BQ + 4;
  static constexpr int LDA = BC + 4;
};

template <typename T, int BQ, int BC, int BK, int TM, int TN>
__global__ void __launch_bounds__((Tiled<T, BQ, BC, BK, TM, TN>::kThreads))
tiled_kernel(const T* __restrict__ Tg, const T* __restrict__ Ag,
             T* __restrict__ out, int Q, int K, int C, T init, int vec_a) {
  using P = Tiled<T, BQ, BC, BK, TM, TN>;
  constexpr int NT = P::kThreads, LDT = P::LDT, LDA = P::LDA;
  constexpr int VM = TM < 4 ? TM : 4, VN = TN < 4 ? TN : 4;
  __shared__ __align__(16) T Ts[2][BK][LDT];
  __shared__ __align__(16) T As[2][BK][LDA];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * BQ, c0 = blockIdx.x * BC;
  const int tx = tid % (BC / TN), ty = tid / (BC / TN);

  auto stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    // T: consecutive threads take consecutive k of one row (coalesced)
#pragma unroll
    for (int e = tid; e < BQ * BK; e += NT) {
      const int r = e / BK, kk = e - r * BK;
      const int q = q0 + r, k = k0 + kk;
      if (q < Q && k < K)
        cp_async4(&Ts[buf][kk][r], Tg + (long long)q * K + k);
      else
        Ts[buf][kk][r] = pad_t<T>();
    }
    if (vec_a) {
#pragma unroll
      for (int e = tid; e < BK * BC / 4; e += NT) {
        const int kk = e / (BC / 4), cc = 4 * (e - kk * (BC / 4));
        const int k = k0 + kk, c = c0 + cc;
        if (k < K && c < C) {       // C % 4 == 0: the 4 columns are in
          cp_async16(&As[buf][kk][cc], Ag + (long long)k * C + c);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) As[buf][kk][cc + v] = T(0);
        }
      }
    } else {
#pragma unroll
      for (int e = tid; e < BK * BC; e += NT) {
        const int kk = e / BC, cc = e - kk * BC;
        const int k = k0 + kk, c = c0 + cc;
        if (k < K && c < C)
          cp_async4(&As[buf][kk][cc], Ag + (long long)k * C + c);
        else
          As[buf][kk][cc] = T(0);
      }
    }
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = init;

  const int nk = (K + BK - 1) / BK;
  const int r0 = ty * VM, rstride = BQ / (TM / VM);
  const int cb = tx * VN, cstride = BC / (TN / VN);
  if (nk > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();              // possibly empty: keeps the count
    cp_async_wait<1>();             // chunk kt has landed
    __syncthreads();
    micro_tile<T, TM, TN>(&Ts[kt & 1][0][0], LDT, &As[kt & 1][0][0], LDA,
                          BK, r0, rstride, cb, cstride, acc);
    __syncthreads();                // chunk kt's buffer may be refilled
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = q0 + r0 + (i / VM) * rstride + i % VM;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + cb + (j / VN) * cstride + j % VN;
      if (c < C) out[(long long)q * C + c] = acc[i][j];
    }
  }
}

// The product for shapes that fit one block: one cooperative load of all
// of T (transposed) and A into shared memory (coalesced along k and c, a
// single round of global latency), then one output cell per thread and
// step, block-stride.  Dynamic shared memory: (Q * K + K * C) elements.
template <typename T>
__global__ void small_kernel(const T* __restrict__ Tg,
                             const T* __restrict__ Ag, T* __restrict__ out,
                             int Q, int K, int C, T init) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ts = reinterpret_cast<T*>(smem_raw);       // [K][Q]
  T* As = Ts + (long long)K * Q;                // [K][C]
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < Q * K; i += nt) {
    const int q = i / K;
    Ts[(i - q * K) * Q + q] = Tg[i];
  }
  for (int i = tid; i < K * C; i += nt) As[i] = Ag[i];
  __syncthreads();
  for (int cell = tid; cell < Q * C; cell += nt) {
    const int q = cell / C, c = cell - q * C;
    T acc[1][1] = {{init}};
    micro_tile<T, 1, 1>(Ts, Q, As, C, K, q, 0, c, 0, acc);
    out[cell] = acc[0][0];
  }
}

}  // namespace maxplus
