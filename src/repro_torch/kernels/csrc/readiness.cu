// Timing-readiness table: the dense (n_cmds, n_banks) earliest-issue cycle
// of every command at every bank, per channel, in exact int32.
//
// Replaces the TPU kernel src/repro/kernels/timing_check.py::maxplus_matmul
// (_maxplus_kernel), the fp32 (max,+) product out[q,c] = max_k T[q,k] +
// A[k,c] that src/repro/kernels/ops.py feeds with gathered timestamps T and
// the constraint matrix A.  Here the gather is fused in and the result is
// the table that repro.core.device.earliest_ready_table builds, bit for
// bit, so the controller can consume it directly:
//
//   out[ch, f, b] = max(NEG, max_k  t_k(ch, b) > NEG ? t_k(ch, b) + A[k, f]
//                                                     : NEG)
//
// over the timing keys k (one per distinct (level, preceding command,
// window) of the reachable constraints), skipping A[k, f] == ABSENT.  t_k
// is read from the dense last-issue table for window-1 keys and from the
// windowed issue ring for deeper windows:
//
//   node = base_k + b / div_k     (div_k = banks per level-k node)
//   t_k  = ring_k ? win_ring[ch, node, col_k] : last_issue[ch, node, col_k]
//
// No additive -inf: with int32 timestamps NEG + lat stays above NEG, so the
// "never issued" mask is explicit (the fp32 TPU kernel padded with -3e38
// and was exact only below 2^24 cycles).
//
// What bounds it on an H100: the launch.  Per channel it reads at most
// 85 x 9 x 4 B of last_issue plus a small ring and writes at most
// 64 x 9 x 4 B, a few hundred nanoseconds of memory traffic and a few
// thousand integer operations.  So the design is the simplest right one:
// one block per channel, one thread per (cmd, bank) cell (block-stride
// loop if a spec ever has more cells than a block has threads), the key
// loop in registers, no shared memory.  The key loop itself lives in
// readiness_keys.cuh, which the fused controller step (controller_step.cu)
// runs on shared memory; the simulator's main path launches that kernel,
// and this one serves repro_torch.core.device.earliest_ready_table.
//
// C interface, bound with ctypes from repro_torch/kernels/readiness.py.

#include <cuda_runtime.h>

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
  const int ch = blockIdx.x;
  const int* li = last_issue + (long long)ch * num_nodes * n_cmds;
  const int* wr = win_ring + (long long)ch * n_ring_rows * ring_depth;
  int* o = out + (long long)ch * n_cmds * n_banks;
  const int cells = n_cmds * n_banks;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int f = idx / n_banks;
    o[idx] = readiness::cell(li, wr, keys, A, n_keys, n_cmds, ring_depth, f,
                             idx - f * n_banks);
  }
}

}  // namespace

extern "C" int readiness_table_launch(const int* last_issue,
                                      const int* win_ring, const int* keys,
                                      const int* A, int* out, int channels,
                                      int num_nodes, int n_cmds,
                                      int n_ring_rows, int ring_depth,
                                      int n_keys, int n_banks,
                                      void* stream) {
  const int cells = n_cmds * n_banks;
  int threads = ((cells + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  readiness_table_kernel<<<channels, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      last_issue, win_ring, keys, A, out, num_nodes, n_cmds, n_ring_rows,
      ring_depth, n_keys, n_banks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* readiness_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
