// Flash attention forward: online softmax over kv tiles, causal (top-left,
// rows >= cols) or full, fp32 accumulation, output in the input dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): grid (B*H, q blocks, kv blocks) with the
// running (m, l, acc) state in VMEM scratch across the sequential kv axis,
// causal blocks above the diagonal skipped, the padded kv tail masked with
// -1e30 and the denominator clamped at 1e-30.  Here the sequential kv axis
// is a loop inside the block, and the state lives in registers:
//
//   for each kv tile:  s = (q * sm_scale) . k^T       (masked to -1e30)
//                      m' = max(m, max_j s);  a = exp(m - m')
//                      l  = l * a + sum_j exp(s - m')
//                      acc = acc * a + sum_j exp(s - m') v_j;   m = m'
//   out = acc / max(l, 1e-30)
//
// The scale multiplies q once as it is loaded (as models/layers.py::
// flash_attention_xla does), not the scores (as _flash_kernel does); both
// are fp32 and agree to rounding.
//
// Layout: q, o are (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D) in whatever
// order of the three outer axes the caller has: the wrapper passes each
// tensor's (batch, time, head) strides in elements, D is contiguous.  So
// one kernel serves the Pallas kernel's (B, H, T, D) layout and the
// model's (B, T, H, D) layout.  GQA: q head h reads kv head h / (Hq / Hkv)
// in place; kv is never repeated in memory.
//
// What bounds it on an H100.  At the serving path's prefill shape
// (B 4, T 1000, Hq 32, Hkv 8, D 64, bf16, causal) the work is 2 B H T^2 D
// = 16.4 GFLOP against 41 MB of q, k, v and o: about 400 operations per
// byte, above the card's ~295, so the bound is the tensor cores' 989
// TFLOP/s (17 us).  This first kernel does not reach for that bound: it
// runs on the CUDA cores (67 TFLOP/s fp32), so its floor is ~0.25 ms, and
// its real limit is shared-memory bandwidth (each k and v value read from
// shared memory feeds one FMA per q row group).  The design is the simple
// right one: one block per (q tile of 64 rows, q head, batch); kv tiles
// staged in shared memory as fp32 and read by broadcast; D/16 threads per
// q row, each holding 16 interleaved dims of q and acc in registers
// (conflict-free shared reads), the row's dot product finished with warp
// shuffles; the tile's scores in registers; kv tiles wholly above the
// diagonal skipped; q tiles scheduled latest (heaviest) first.  bf16 at
// D 64 and 128 (the serving path) goes to the tensor-core kernel,
// csrc/flash_attention_sm90.cu; this one keeps fp32 (TF32 tensor cores
// would miss fp32's 2e-5) and bf16 at D 16 and 32.
//
// C interface, bound with ctypes from repro_torch/kernels/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;     // _flash_kernel's NEG_INF
constexpr float kDenomMin = 1e-30f;   // _flash_kernel's denominator clamp
constexpr int kBlockQ = 64;           // q rows per block

struct Strides {
  long long b, t, h;                  // elements; the D axis has stride 1
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);           // round to nearest even
}

template <int D>
struct Tile {
  static constexpr int kGroup = D / 16;              // threads per q row
  static constexpr int kDims = D / kGroup;           // dims per thread: 16
  static constexpr int kBlockK = D == 128 ? 32 : 64;  // kv rows per tile
  static constexpr int kThreads = kBlockQ * kGroup;
};

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq,
                 int Hkv, int Tq, int Tk, Strides sq, Strides sk,
                 Strides sv, Strides so, int causal, float sm_scale) {
  constexpr int G = Tile<D>::kGroup;
  constexpr int DPT = Tile<D>::kDims;
  constexpr int BK = Tile<D>::kBlockK;
  constexpr int NT = Tile<D>::kThreads;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int qt = gridDim.x - 1 - blockIdx.x;   // latest q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int g = tid % G;                        // this thread's dims: g + G*i
  const int row = qt * kBlockQ + tid / G;
  const bool live = row < Tq;                   // ragged q rows: no store

  // q row, pre-scaled, and the output accumulator, in registers
  float qv[DPT], acc[DPT];
  const T* qrow = q + b * sq.b + (long long)min(row, Tq - 1) * sq.t
                  + h * sq.h;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qv[i] = live ? load_f32(qrow + g + G * i) * sm_scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  // causal: kv tiles starting after the tile's last row are skipped
  const int kv_end = causal ? min(Tk, qt * kBlockQ + kBlockQ) : Tk;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                            // previous tile consumed
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx - (idx / D) * D;
      const int col = k0 + j;
      float kx = 0.f, vx = 0.f;                 // padded kv tail: zeros
      if (col < Tk) {
        kx = load_f32(kb + col * sk.t + d);
        vx = load_f32(vb + col * sv.t + d);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
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
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j][g + G * i], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (live) {
    const float denom = fmaxf(l, kDenomMin);
    T* orow = o + b * so.b + (long long)row * so.t + h * so.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store_f32(orow + g + G * i, acc[i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Tq, int Tk, Strides sq,
                   Strides sk, Strides sv, Strides so, int causal,
                   float sm_scale, cudaStream_t stream) {
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, Tile<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Tq, Tk, sq, sk,
      sv, so, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int Hq, int Hkv, int Tq, int Tk,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int causal, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Tq, Tk, sq, sk, sv,
                                  so, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Tq, Tk, sq, sk, sv,
                                  so, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, sq, sk, sv,
                                  so, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, sq, sk,
                                    sv, so, causal, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements, (batch, time,
// head) for each of q, k, v, o.  Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, int B, int Hq, int Hkv, int Tq, int Tk, long long qsb,
    long long qst, long long qsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh,
    long long osb, long long ost, long long osh, int causal, float sm_scale,
    void* stream) {
  const Strides sq{qsb, qst, qsh}, sk{ksb, kst, ksh}, sv{vsb, vst, vsh},
      so{osb, ost, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(head_dim, q, k, v, o, B, Hq, Hkv, Tq, Tk, sq, sk,
                            sv, so, causal, sm_scale, st);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(head_dim, q, k, v, o, B, Hq, Hkv, Tq, Tk,
                                    sq, sk, sv, so, causal, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
