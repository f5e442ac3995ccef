// The block-level batch inversion of kernels A (kernels.cu) and G
// (p2tr.cu): launch code, CUDA only.  The per-chain code, the product
// tree's steps and the schedule are scan_lanes.cuh's, which also compile as
// plain C++.
//
// Geometry: T = N / M chains of M elements (inv_chain_forward /
// inv_chain_backward); groups of G consecutive chains (G a power of two)
// share one inversion through a product tree in shared memory (InvTree).
// G = 1 is a chain with one inversion of its own and no tree.
//
// Schedule: persistent blocks, one an SM (inv_schedule), each walking
// rounds of kInvBlock chains, round s of block b being round b + s *
// gridDim.x.  A block is kInvBlock chain threads, a chain a thread, and
// kInvTreeWarps tree warps taking the rounds in turn.  The chain threads
// run a round's forward chains, leave their totals in the round's slot of
// leaves and go on to the next round's forward chains; meanwhile the
// round's tree warp builds its trees, inverts every group's product
// (divsteps, one lane a group) and turns the leaves into the inverses of
// the chain totals, which the chain threads take up for the round's
// backward chains.  With kInvDepth slots the chain threads run forward
// chains up to kInvDepth rounds ahead of their backward ones, so an SM
// keeps issuing multiplies while a group's product is inverted; a block of
// one round waits as a one-wave schedule does.  Named barriers (one pair a
// slot, bar.arrive by the producer, bar.sync by the consumer) hand each
// slot over; each warp converges (__syncwarp) before it reaches one, since
// chains past T, which join with a total of 1, leave a warp diverged.  One
// block of 512 an SM, and not two of 256: two blocks on an SM drifted
// apart, one ending a quarter later than the other, alone on the SM.  The
// prefix products stay in device memory (Scratch, 32 bytes written and
// read back per element): M of them a chain, for the rounds in flight, do
// not fit on chip.
#pragma once

#include <mutex>
#include <utility>
#include <vector>

#include "scan_lanes.cuh"

namespace vg {

constexpr int kMaxInvGroup = 512;

// The kernels' block: kInvBlock chain threads (one block an SM), kInvDepth
// slots of leaves in flight (the product's geometry walks two rounds a
// block) and kInvTreeWarps tree warps (round s is tree warp s %
// kInvTreeWarps's; the depth a multiple of the tree warps, so a slot keeps
// its warp).
constexpr int kInvBlock = kInvSmChains, kInvDepth = 2, kInvTreeWarps = 2;
static_assert(kInvDepth % kInvTreeWarps == 0, "a slot keeps its tree warp");
constexpr int kInvThreads = kInvBlock + 32 * kInvTreeWarps;
// the leaves' slots and the tree warps' inner nodes, (8, kInvBlock) each
constexpr int kInvSmemBytes = (kInvDepth + kInvTreeWarps) * 8 * kInvBlock * 4;

// a named barrier, the calling warp converged first
__device__ __forceinline__ void bar_sync(int id, int count) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <class Input>
__device__ __forceinline__ void inv_block(const Input& in, uint32_t* out,
                                          uint32_t* scratch, long N, long T,
                                          int M, int G) {
  constexpr int kBlock = kInvBlock;
  constexpr int kAll = kBlock + 32;  // a slot's barriers: chains, tree warp
  extern __shared__ __align__(16) uint32_t inv_smem[];
  uint32_t* const leaves = inv_smem;  // slot i at 8 kBlock i
  uint32_t* const inner = inv_smem + kInvDepth * 8 * kBlock;  // tree warp w's
  const Scratch prefixes{scratch};
  const long rounds = (T + kBlock - 1) / kBlock;
  const int P = (int)((rounds - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int x = threadIdx.x;
  auto chain = [&](int s) {
    return ((long)blockIdx.x + (long)s * gridDim.x) * kBlock + x;
  };
  if (G == 1) {
    for (int s = 0; x < kBlock && s < P; s++)
      if (chain(s) < T) inv_chain_thread(in, out, N, prefixes, M, chain(s));
    return;
  }
  const int D = P < kInvDepth ? P : kInvDepth;
  if (x >= kBlock) {  // a tree warp
    const int w = (x - kBlock) / 32, lane = (x - kBlock) % 32;
    for (int s = w; s < P; s += kInvTreeWarps) {
      const int slot = s % D;
      bar_sync(1 + slot, kAll);
      InvTree{leaves + slot * 8 * kBlock, inner + w * 8 * kBlock, kBlock, G}
          .round(kBlock / G, lane, 32, [] { __syncwarp(); });
      __threadfence_block();
      bar_arrive(1 + kInvDepth + slot, kAll);
    }
    return;
  }
  // forward chains of rounds 0 .. D - 1, then each round's backward chains
  // followed by the forward chains of the round D later
  for (int s = 0; s < P + D; s++) {
    uint32_t acc[8];
    if (s >= D) {
      const int slot = (s - D) % D;
      const long t = chain(s - D);
      bar_sync(1 + kInvDepth + slot, kAll);
      if (t < T) {
        fe_load(acc, leaves + slot * 8 * kBlock, kBlock, x);
        inv_chain_backward(in, acc, out, N, prefixes, M, t);
      }
    }
    if (s < P) {
      const int slot = s % D;
      const long t = chain(s);
      if (t < T) {
        inv_chain_forward(in, acc, prefixes, M, t);
      } else {
        fe_set_one(acc);
      }
      fe_store(leaves + slot * 8 * kBlock, kBlock, x, acc);
      __threadfence_block();
      bar_arrive(1 + slot, kAll);
    }
  }
}

// A group the launchers take: a power of two up to kMaxInvGroup.
inline bool inv_group_ok(int G) {
  return G >= 1 && G <= kMaxInvGroup && (G & (G - 1)) == 0;
}

// The launch's schedule on the current device: its SM count, read once a
// device, so the grid is the same at every launch (and inside a graph).
inline InvSchedule inv_launch_schedule(long T) {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return inv_schedule(T, kInvBlock, sms[dev] > 0 ? sms[dev] : 1);
}

// Let `kernel` take `bytes` of dynamic shared memory on the current device,
// once a kernel and device (the first launch is eager, before any graph
// captures one).
inline cudaError_t inv_allow_smem(const void* kernel, int bytes) {
  static std::mutex lock;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(lock);
  for (const auto& d : done)
    if (d.first == kernel && d.second == dev) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done.emplace_back(kernel, dev);
  return e;
}

// Launch a kernel of inv_block over the schedule of T chains, with args.
template <class Kernel, class... Args>
int inv_launch(Kernel kernel, long T, cudaStream_t s, Args... args) {
  if (T <= 0) return 0;
  const cudaError_t e = inv_allow_smem((const void*)kernel, kInvSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const InvSchedule sched = inv_launch_schedule(T);
  kernel<<<(unsigned)sched.blocks, kInvThreads, kInvSmemBytes, s>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace vg
