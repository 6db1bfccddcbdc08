// The two elementwise passes of the LM loss head on Hopper, around its
// three cuBLAS products (repro_torch/kernels/loss_head.py, LossHeadFn).
// For a chunk of R rows of fp32 logits lg (R, V), row-major, labels (R,)
// (int32 or int64; below 0: no loss):
//
// * xent_fwd_launch: lse[r] = log sum_j exp(lg[r, j]) and nll[r] =
//   lse[r] - lg[r, label[r]], 0 where label[r] < 0.  It takes the place of
//   logsumexp, the label's gather and the mask's where.
// * xent_bwd_launch: the gradient of nll at the logits,
//
//     d[r, j] = g_r * exp(lg[r, j] - lse[r]) - (j == label[r] ? g_r : 0),
//     g_r = label[r] >= 0 ? g[r * g_stride] : 0
//
//   (autograd's arithmetic for logsumexp, gather and where: the product,
//   then the label's subtraction, each rounded once), written exactly as
//   three bf16 terms stacked in out (3R, V):
//
//     hi = bf16(d), mid = bf16(d - hi), lo = bf16(d - hi - mid)
//
//   (round to nearest even; both differences are exact in fp32).  For
//   every d of magnitude 2^-110 up to bf16's largest finite value, and 0,
//   hi + mid + lo == d exactly: hi keeps 8 significant bits, d - hi fits
//   in 16 and its remainder in 8, each a multiple of ulp(d) >= 2^-133,
//   bf16's subnormal step.  Below 2^-110 the bits under 2^-133 are lost
//   (an error of at most 2^-134 an entry).  So the backward's products
//   [hi; mid; lo] W^T and [x; x; x]^T [hi; mid; lo] in bf16 with fp32
//   accumulation form exact bf16 x bf16 partial products of d, as the
//   reference's fp32 product forms d * w.
//
// Replaces no Pallas kernel: the reference computes the head in XLA
// (src/repro/models/model.py::_xent, an fp32 einsum, logsumexp and
// take_along_axis), and the port's fp32 version of it ran the three
// products on the CUDA cores (66.9 TFLOP/s); on the tensor cores they need
// the logits' two passes as kernels of their own.
//
// What bounds both on an H100: bytes.  Forward: 4 B read per logit and
// nothing else of size (R * V * 4 = 0.62 GB at glm4-9b's chunk, 1,024 x
// 151,552: 0.19 ms at 3.35 TB/s); backward: 4 B read and 6 B written per
// logit (1.55 GB, 0.46 ms).  One exp per logit, some 40 instructions,
// stays under the bytes.  So each pass reads the logits once: the forward
// keeps an online (max, sum) pair per thread (a rescale only when the
// maximum rises) and combines the pairs across the block, so no second
// read for the maximum; the backward reads each logit once and writes the
// three terms from registers.  One block of 256 threads per row (1,024
// blocks at that chunk), 16-byte loads, four of them in flight before their
// arithmetic, 8-byte stores of four bf16; streaming loads
// (ld.global.cs): nothing reads the logits again.  A ragged vocab (V not a
// multiple of 4) takes scalar loads and stores.
//
// C interface, bound with ctypes from repro_torch/kernels/loss_head.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct MaxSum {
  float m, s;       // running maximum and sum of exp(x - m)
};

__device__ __forceinline__ MaxSum combine(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, 0.f};
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

__device__ __forceinline__ void update4(MaxSum& t, float4 v) {
  const float mx = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  if (mx > t.m) {
    t.s *= expf(t.m - mx);
    t.m = mx;
  }
  t.s += (expf(v.x - t.m) + expf(v.y - t.m)) +
         (expf(v.z - t.m) + expf(v.w - t.m));
}

__device__ __forceinline__ void update1(MaxSum& t, float v) {
  if (v > t.m) {
    t.s *= expf(t.m - v);
    t.m = v;
  }
  t.s += expf(v - t.m);
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const float* __restrict__ lg, const L* __restrict__ labels,
                float* __restrict__ lse, float* __restrict__ nll, int V) {
  __shared__ MaxSum part[kWarps];
  const long long r = blockIdx.x;
  const float* row = lg + r * V;
  const int tid = threadIdx.x;
  MaxSum t = {-INFINITY, 0.f};
  if ((V & 3) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = V >> 2;
    int i = tid;
    for (; i + 3 * kThreads < n4; i += 4 * kThreads) {
      const float4 a = __ldcs(row4 + i);
      const float4 b = __ldcs(row4 + i + kThreads);
      const float4 c = __ldcs(row4 + i + 2 * kThreads);
      const float4 d = __ldcs(row4 + i + 3 * kThreads);
      update4(t, a);
      update4(t, b);
      update4(t, c);
      update4(t, d);
    }
    for (; i < n4; i += kThreads) update4(t, __ldcs(row4 + i));
  } else {
    for (int j = tid; j < V; j += kThreads) update1(t, __ldcs(row + j));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const MaxSum u = {__shfl_xor_sync(0xffffffffu, t.m, o),
                      __shfl_xor_sync(0xffffffffu, t.s, o)};
    t = combine(t, u);
  }
  if ((tid & 31) == 0) part[tid >> 5] = t;
  __syncthreads();
  if (tid == 0) {
    MaxSum all = part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) all = combine(all, part[w]);
    const float l = all.m + logf(all.s);
    const long long lab = static_cast<long long>(labels[r]);
    lse[r] = l;
    // a label past the vocabulary reads as NaN, never out of bounds
    nll[r] = lab < 0 ? 0.f : lab < V ? __fsub_rn(l, row[lab]) : NAN;
  }
}

__device__ __forceinline__ float grad_at(float x, float l, float g,
                                         bool at_label) {
  const float p = __fmul_rn(g, expf(__fsub_rn(x, l)));
  return at_label ? __fsub_rn(p, g) : p;
}

// d = hi + mid + lo, each round to nearest even; both differences exact
__device__ __forceinline__ void split3(float d, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(d);
  const float r = __fsub_rn(d, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  const __nv_bfloat162 v = __halves2bfloat162(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const float* __restrict__ lg, const float* __restrict__ lse,
                const L* __restrict__ labels, const float* __restrict__ g,
                long long g_stride, __nv_bfloat16* __restrict__ out, int R,
                int V) {
  const long long r = blockIdx.x;
  const float* row = lg + r * V;
  const long long lab = static_cast<long long>(labels[r]);
  const float l = lse[r];
  const float gr = lab >= 0 ? g[r * g_stride] : 0.f;
  __nv_bfloat16* hi_row = out + r * V;
  __nv_bfloat16* mid_row = hi_row + static_cast<long long>(R) * V;
  __nv_bfloat16* lo_row = mid_row + static_cast<long long>(R) * V;
  const int tid = threadIdx.x;
  if ((V & 3) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = V >> 2;
    auto one = [&](int i, float4 v) {
      const int j = i << 2;
      const float e[4] = {v.x, v.y, v.z, v.w};
      __nv_bfloat16 h[4], m[4], o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split3(grad_at(e[k], l, gr, j + k == lab), h[k], m[k], o[k]);
      reinterpret_cast<uint2*>(hi_row)[i] =
          make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
      reinterpret_cast<uint2*>(mid_row)[i] =
          make_uint2(pack2(m[0], m[1]), pack2(m[2], m[3]));
      reinterpret_cast<uint2*>(lo_row)[i] =
          make_uint2(pack2(o[0], o[1]), pack2(o[2], o[3]));
    };
    int i = tid;
    for (; i + 3 * kThreads < n4; i += 4 * kThreads) {
      const float4 a = __ldcs(row4 + i);
      const float4 b = __ldcs(row4 + i + kThreads);
      const float4 c = __ldcs(row4 + i + 2 * kThreads);
      const float4 d = __ldcs(row4 + i + 3 * kThreads);
      one(i, a);
      one(i + kThreads, b);
      one(i + 2 * kThreads, c);
      one(i + 3 * kThreads, d);
    }
    for (; i < n4; i += kThreads) one(i, __ldcs(row4 + i));
  } else {
    for (int j = tid; j < V; j += kThreads) {
      __nv_bfloat16 h, m, o;
      split3(grad_at(__ldcs(row + j), l, gr, j == lab), h, m, o);
      hi_row[j] = h;
      mid_row[j] = m;
      lo_row[j] = o;
    }
  }
}

}  // namespace

// label_bytes: 4 (int32) or 8 (int64).  Returns the launch's cudaError_t.
extern "C" int xent_fwd_launch(const float* lg, const void* labels,
                               int label_bytes, float* lse, float* nll,
                               int R, int V, void* stream) {
  if (R <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (label_bytes == 4)
    xent_fwd_kernel<int32_t><<<R, kThreads, 0, st>>>(
        lg, static_cast<const int32_t*>(labels), lse, nll, V);
  else if (label_bytes == 8)
    xent_fwd_kernel<int64_t><<<R, kThreads, 0, st>>>(
        lg, static_cast<const int64_t*>(labels), lse, nll, V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xent_bwd_launch(const float* lg, const float* lse,
                               const void* labels, int label_bytes,
                               const float* g, long long g_stride, void* out,
                               int R, int V, void* stream) {
  if (R <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (label_bytes == 4)
    xent_bwd_kernel<int32_t><<<R, kThreads, 0, st>>>(
        lg, lse, static_cast<const int32_t*>(labels), g, g_stride, o, R, V);
  else if (label_bytes == 8)
    xent_bwd_kernel<int64_t><<<R, kThreads, 0, st>>>(
        lg, lse, static_cast<const int64_t*>(labels), g, g_stride, o, R, V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* loss_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
