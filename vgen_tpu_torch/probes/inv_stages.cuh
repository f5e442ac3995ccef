// Kernel A cut by stage, for probes/sweep_inv_chain.py: the forward chains
// (each chain's total into an (8, T) array), the product trees with their
// inversions (those totals into their inverses), and the backward chains
// (from the inverses), each launched alone over all T chains, with the
// product's chains and tree warp (csrc/inv_block.cuh, scan_lanes.cuh).
// And one lane's inversion (fe_inv) R times in a row: its latency.
#pragma once

#include "inv_block.cuh"

namespace vg {

// kStage 0 forward, 1 trees, 2 backward.  The chains in blocks of 256, the
// trees a warp a round of kInvBlock.  leaf (8, T): the chain totals after
// 0, their inverses after 1.
enum InvStage { kStageForward, kStageTree, kStageBackward };

template <int kStage>
__global__ void __launch_bounds__(256)
    inv_stage_kernel(const uint32_t* __restrict__ bx,
                     const uint32_t* __restrict__ tx,
                     uint32_t* __restrict__ leaf,
                     uint32_t* __restrict__ out, uint32_t* __restrict__ scratch,
                     int B, long N, long T, int M, int G) {
  if constexpr (kStage == kStageTree) {
    // one warp a round of kInvBlock: the tree warp's work, its leaves
    // staged in
    constexpr int kTree = kInvBlock;
    __shared__ uint32_t leaves[8 * kTree], inner[8 * kTree];
    const long t0 = (long)blockIdx.x * kTree;
    for (int x = threadIdx.x; x < kTree; x += 32) {
      uint32_t a[8];
      if (t0 + x < T) fe_load(a, leaf, T, t0 + x);
      else fe_set_one(a);
      fe_store(leaves, kTree, x, a);
    }
    __syncwarp();
    InvTree{leaves, inner, kTree, G}.round(kTree / G, threadIdx.x, 32,
                                           [] { __syncwarp(); });
    for (int x = threadIdx.x; x < kTree && t0 + x < T; x += 32) {
      uint32_t a[8];
      fe_load(a, leaves, kTree, x);
      fe_store(leaf, T, t0 + x, a);
    }
  } else {
    const long t = (long)blockIdx.x * 256 + threadIdx.x;
    if (t >= T) return;
    const DxInput in(bx, tx, B, T);
    uint32_t acc[8];
    if constexpr (kStage == kStageForward) {
      inv_chain_forward(in, acc, Scratch{scratch}, M, t);
      fe_store(leaf, T, t, acc);
    } else {
      fe_load(acc, leaf, T, t);
      inv_chain_backward(in, acc, out, N, Scratch{scratch}, M, t);
    }
  }
}

// one thread: x = inv(x), reps times
__global__ void inv_lane_kernel(const uint32_t* __restrict__ a,
                                uint32_t* __restrict__ out, int reps) {
  uint32_t x[8];
  fe_load(x, a, 1, 0);
  for (int i = 0; i < reps; i++) fe_inv(x, x);
  fe_store(out, 1, 0, x);
}

}  // namespace vg
