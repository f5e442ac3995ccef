// The block-level batch inversion of kernels A (kernels.cu) and G
// (p2tr.cu): launch code, CUDA only.  The per-thread chain and the tree's
// per-node arithmetic are scan_lanes.cuh's, which also compile as plain
// C++.
//
// Geometry: T = N / M threads in blocks of kBlock, each thread a chain of
// M elements (inv_chain_forward / inv_chain_backward); groups of G
// consecutive threads of a block (G a power of two dividing kBlock) share
// one inversion through the product tree of scan_lanes.cuh (tree_up,
// tree_down) in shared memory.  Its up-sweep is G - 1 multiplies a group,
// its down-sweep 2G - 2; one thread of the group inverts the product
// while the others wait at the barrier.  G = 1 is the chain with one
// inversion per thread and no tree.  Threads past T join the barriers
// with a total of 1.  The prefix products stay in device memory (scratch,
// 32 bytes written and read back per element): M of them per thread would
// not fit in registers beside the chain.
#pragma once

#include "scan_lanes.cuh"

namespace vg {

constexpr int kMaxInvGroup = 512;

template <int kBlock, class Input>
__device__ __forceinline__ void inv_block(const Input& in, uint32_t* out,
                                          uint32_t* scratch, long N, long T,
                                          int M, int G) {
  // one (8, 2 kBlock) node array: the group of threads base .. base + G - 1
  // keeps its nodes 1 .. 2G - 1 at columns 2 base + i
  constexpr long kStride = 2 * kBlock;
  __shared__ uint32_t tree[8 * kStride];
  const long t = (long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = t < T;
  if (G == 1) {
    if (live) inv_chain_thread(in, out, scratch, N, T, M, t);
    return;
  }
  uint32_t acc[8];
  if (live) {
    inv_chain_forward(in, acc, scratch, N, T, M, t);
  } else {
    fe_set_one(acc);
  }
  const int r = threadIdx.x & (G - 1);
  const long base = 2 * (long)(threadIdx.x - r);
  fe_store(tree, kStride, base + G + r, acc);
  __syncthreads();
  for (int n = G >> 1; n >= 1; n >>= 1) {  // inner nodes n .. 2n - 1
    if (r < n) tree_up(tree, kStride, base, n + r);
    __syncthreads();
  }
  if (r == 0) {
    fe_load(acc, tree, kStride, base + 1);
    fe_inv(acc, acc);
    fe_store(tree, kStride, base + 1, acc);
  }
  __syncthreads();
  for (int n = 2; n <= G; n <<= 1) {  // nodes n .. 2n - 1 become inverses
    uint32_t v[8];
    if (r < n) tree_down(v, tree, kStride, base, n + r);
    __syncthreads();
    if (r < n) fe_store(tree, kStride, base + n + r, v);
    __syncthreads();
  }
  if (live) {
    fe_load(acc, tree, kStride, base + G + r);
    inv_chain_backward(in, acc, out, scratch, N, T, M, t);
  }
}

// A group the launchers take: a power of two up to kMaxInvGroup.  Their
// blocks are 256 threads, or G when G is larger.
inline bool inv_group_ok(int G) {
  return G >= 1 && G <= kMaxInvGroup && (G & (G - 1)) == 0;
}

}  // namespace vg
