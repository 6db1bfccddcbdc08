// The key loop of the timing-readiness check, shared by readiness.cu (the
// dense table on its own) and controller_step.cu (the table inside the
// fused controller step), so the two cannot drift apart.
//
// One cell of the table: the earliest cycle at which command f may issue at
// flat bank b, given the channel's dense last-issue table li (num_nodes x
// n_cmds) and windowed issue ring wr (rows x ring_depth):
//
//   max(NEG, max_k  t_k(b) > NEG ? t_k(b) + A[k, f] : NEG)
//
// over the timing keys k with A[k, f] != ABSENT.  keys is the (4, n_keys)
// table [is_ring, base, col, div] of repro_torch/kernels/readiness.py:
// key k's timestamp for bank b sits at node base + b / div of the ring
// (column window - 1) or of the dense table (column prev).  The sum is taken
// modulo 2^32, as int32 tensors add in PyTorch; with timestamps below 2^30
// it never wraps.
#pragma once

#include <climits>

namespace readiness {

constexpr int kNeg = -(1 << 28);      // "never issued"
constexpr int kAbsent = INT_MIN;      // no constraint of key k targets cmd f

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int cell(const int* li, const int* wr,
                                    const int* keys, const int* A,
                                    int n_keys, int n_cmds, int ring_depth,
                                    int f, int b) {
  const int* key_ring = keys;
  const int* key_base = keys + n_keys;
  const int* key_col = keys + 2 * n_keys;
  const int* key_div = keys + 3 * n_keys;
  int acc = kNeg;
  // branch-free, so the loads of several keys are in flight together (every
  // key's node index is in range for every bank, constraint or not)
#pragma unroll 4
  for (int k = 0; k < n_keys; ++k) {
    const int lat = A[k * n_cmds + f];
    const int node = key_base[k] + b / key_div[k];
    const int t = key_ring[k] ? wr[node * ring_depth + key_col[k]]
                              : li[node * n_cmds + key_col[k]];
    const int allowed = lat != kAbsent && t > kNeg ? wrap_add(t, lat) : kNeg;
    acc = max(acc, allowed);
  }
  return acc;
}

}  // namespace readiness
