// The (max,+) product of the timing-readiness check on Hopper, two
// kernels:
//
// * maxplus_launch: out[q, c] = max(init, max_k T[q, k] + A[k, c]) for
//   row-major T (Q, K) and A (K, C) in global memory, int32 or fp32, on
//   the tile routines of maxplus_tile.cuh — the TPU kernel
//   src/repro/kernels/timing_check.py::maxplus_matmul (_maxplus_kernel) on
//   arbitrary operands.  repro_torch/kernels/timing_check.py calls it in
//   fp32 with init -3e38 (the Pallas accumulator's start).
// * readiness_table_launch: the dense (C, n_cmds, n_banks) earliest-issue
//   table of repro.core.device.earliest_ready_table, bit for bit, exact in
//   int32: the same product with the masks of the timing check,
//
//     out[ch, f, b] = max_k  t_k(ch, b) > NEG && A[k, f] != ABSENT
//                              ? t_k(ch, b) + A[k, f] : NEG
//
//   over the timing keys k (NEG without keys), the sum wrapping modulo
//   2^32.  Its prologue gathers each key's timestamp per bank (node =
//   base_k + b / div_k, from the windowed ring or the dense last-issue
//   table, as readiness_keys.cuh reads it) into shared memory beside A,
//   then takes the masked maximum from there.  The masks are explicit,
//   so every timestamp and latency the state can hold is exact.
//
// What bounds it on an H100.  The table: per channel a few KB of
// last-issue table, ring and A in, at most 9 x 64 cells out, 16-20 keys per
// cell: bytes and operations take well under a nanosecond, so the launch
// and the latency of global memory do.  The first-draft kernel walked the
// keys per cell out of global memory, about K/4 dependent rounds; here one
// block per channel stages the key table and A in one round, gathers every
// (key, bank) timestamp in a second (each thread's loads independent), and
// runs the product from shared memory.  The general product: Q * K * C
// steps of one add and one max at the CUDA cores' issue rate, each operand
// read once; the tiled kernel keeps 8 x 8 outputs per thread on 128 x 128
// tiles, with cp.async double-buffered over K.  Shapes that fit one block
// take one coalesced load and the product from shared memory.
//
// C interface, bound with ctypes from repro_torch/kernels/readiness.py.

#include <cuda_runtime.h>

#include "maxplus_tile.cuh"
#include "readiness_keys.cuh"

namespace {

__global__ void readiness_table_kernel(const int* __restrict__ last_issue,
                                       const int* __restrict__ win_ring,
                                       const int* __restrict__ keys,
                                       const int* __restrict__ A,
                                       int* __restrict__ out,
                                       int num_nodes, int n_cmds,
                                       int n_ring_rows, int ring_depth,
                                       int n_keys, int n_banks) {
  extern __shared__ __align__(16) int smem[];
  const int K = n_keys, F = n_cmds, B = n_banks;
  int* Ts = smem;                       // [K][B] timestamps
  int* As = Ts + K * B;                 // [K][F] latencies
  int* kt = As + K * F;                 // [4][K] the key table
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ch = blockIdx.x;
  const int* li = last_issue + (long long)ch * num_nodes * n_cmds;
  const int* wr = win_ring + (long long)ch * n_ring_rows * ring_depth;

  // round 1: the key table and A
  for (int i = tid; i < 4 * K; i += nt) kt[i] = keys[i];
  for (int i = tid; i < K * F; i += nt) As[i] = A[i];
  __syncthreads();
  // round 2: every (key, bank) timestamp, loads independent of each other
  const int* key_ring = kt;
  const int* key_base = kt + K;
  const int* key_col = kt + 2 * K;
  const int* key_div = kt + 3 * K;
#pragma unroll 4
  for (int i = tid; i < K * B; i += nt) {
    const int k = i / B, b = i - k * B;
    const int node = key_base[k] + b / key_div[k];
    Ts[i] = key_ring[k] ? wr[node * ring_depth + key_col[k]]
                        : li[node * n_cmds + key_col[k]];
  }
  __syncthreads();

  // the product from shared memory: every key contributes its sum where
  // issued and present, else NEG (NEG without keys)
  int* o = out + (long long)ch * F * B;
  for (int cell = tid; cell < F * B; cell += nt) {
    const int f = cell / B, b = cell - f * B;
    int acc = K > 0 ? INT_MIN : readiness::kNeg;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int t = Ts[k * B + b], a = As[k * F + f];
      acc = max(acc, a != readiness::kAbsent && t > readiness::kNeg
                         ? readiness::wrap_add(t, a)
                         : readiness::kNeg);
    }
    o[cell] = acc;
  }
}

// tile configurations of the general product (repro_torch/kernels/
// readiness.py::maxplus_plan picks one): 0 one block, 1 32 x 32 tiles of 2 x 2,
// 2 128 x 128 tiles of 8 x 8
template <typename T>
cudaError_t maxplus_typed(int config, const void* Tg, const void* Ag,
                          void* out, int Q, int K, int C, T init,
                          cudaStream_t st) {
  const T* t = static_cast<const T*>(Tg);
  const T* a = static_cast<const T*>(Ag);
  T* o = static_cast<T*>(out);
  const int vec_a = C % 4 == 0 && reinterpret_cast<size_t>(Ag) % 16 == 0;
  if (config == 0) {
    const size_t smem = sizeof(T) * ((size_t)Q * K + (size_t)K * C);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    int threads = ((Q * C + 31) / 32) * 32;
    threads = threads > 1024 ? 1024 : (threads < 32 ? 32 : threads);
    maxplus::small_kernel<T><<<1, threads, smem, st>>>(t, a, o, Q, K, C,
                                                        init);
  } else if (config == 1) {
    using P = maxplus::Tiled<T, 32, 32, 64, 2, 2>;
    const dim3 grid((C + 31) / 32, (Q + 31) / 32);
    maxplus::tiled_kernel<T, 32, 32, 64, 2, 2><<<grid, P::kThreads, 0, st>>>(
        t, a, o, Q, K, C, init, vec_a);
  } else if (config == 2) {
    using P = maxplus::Tiled<T, 128, 128, 16, 8, 8>;
    const dim3 grid((C + 127) / 128, (Q + 127) / 128);
    maxplus::tiled_kernel<T, 128, 128, 16, 8, 8>
        <<<grid, P::kThreads, 0, st>>>(t, a, o, Q, K, C, init, vec_a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int readiness_table_launch(const int* last_issue,
                                      const int* win_ring, const int* keys,
                                      const int* A, int* out, int channels,
                                      int num_nodes, int n_cmds,
                                      int n_ring_rows, int ring_depth,
                                      int n_keys, int n_banks,
                                      void* stream) {
  const size_t smem = sizeof(int) * ((size_t)n_keys * n_banks
                                     + (size_t)n_keys * n_cmds
                                     + 4 * (size_t)n_keys);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int cells = n_cmds * n_banks;
  int threads = ((cells + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  readiness_table_kernel<<<channels, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      last_issue, win_ring, keys, A, out, num_nodes, n_cmds, n_ring_rows,
      ring_depth, n_keys, n_banks);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32 (init read from init_f32), 1 = int32 (init_i32).
// Returns the launch's cudaError_t.
extern "C" int maxplus_launch(int dtype, int config, const void* T,
                              const void* A, void* out, int Q, int K, int C,
                              float init_f32, int init_i32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = maxplus_typed<float>(config, T, A, out, Q, K, C, init_f32, st);
  else if (dtype == 1)
    err = maxplus_typed<int>(config, T, A, out, Q, K, C, init_i32, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* readiness_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
