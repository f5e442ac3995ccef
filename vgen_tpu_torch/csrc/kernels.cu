// The kernels of the scan steps (interval and DFA, random and range), with a
// plain C interface for ctypes (vgen_tpu_torch/csrc/build.py builds this file with
// nvcc for sm_90a; vgen_tpu_torch/ops/fused.py wraps the entry points).
// Each launcher takes the caller's stream, launches without synchronising,
// and returns cudaGetLastError() (0 on success).
//
// Kernel A, batch_inverse_dx
//   Replaces vgen_tpu/ops/pallas_fused.py _inv_dx_calls (its fwd, inv and
//   bwd pallas_calls) as driven by batch_inverse_dx_pallas.
//   Computes: the canonical inverse of dx = tx[b] - bx[k] for all K*B lanes,
//   zero dx guarded to 1.
//   Bound: 32-bit integer multiply throughput.  About 3 field multiplies
//   per element (forward product, backward product, backward accumulate)
//   plus one inversion (divsteps) amortised over the M * G elements of a
//   group, and the product tree's 3 (G - 1) multiplies; the prefix scratch
//   adds 64 bytes written and read per element.
//   Design: the TPU ran one long chain as a sequential grid carrying the
//   running product in VMEM.  Here blocks run in no order, so every thread
//   owns its own chain of M elements strided by the chain count (loads
//   coalesce; the chain steps its window and lane by additions), and G
//   chains share one inversion through a product tree in shared memory
//   (inv_block.cuh).  The blocks are persistent, one an SM, and walk
//   rounds of 512 chains: while a block's tree warps build one round's
//   trees and invert their products, its chain threads run the next
//   rounds' forward chains, so no SM waits on a lane's inversion while
//   another round has chains to run.  The inversion is by divsteps
//   (field.cuh fe_inv), whose latency on one lane is about a sixth of
//   the addition chain a^(p-2)'s.  The three passes are one launch.  The
//   output is canonical, so the geometry (M, G) does not change the
//   result; (64, 1) is a chain of 64 with one inversion per chain.
//
// Kernels B to E serve the five hash formats, each a template on the format
// (match_kernels.cuh, per-lane bodies in scan_lanes.cuh), all instanced in
// this unit.  Every format hashes the lane's point into a 5-word value (scan_lanes.cuh value_words):
// hash160 of the compressed key (P2PKH, P2WPKH), of its redeem script
// (P2SH-P2WPKH), hash160 of 04 || x || y (uncompressed P2PKH), or the
// Ethereum account keccak256(x || y)[12:32].
//
// Kernel B, range_glv_match
//   Replaces vgen_tpu/ops/pallas_fused.py _make_range_glv_kernel (glv=True)
//   as called through fused_range_match_fn, and the per-window lax.scan of
//   _build_step: one launch covers all K windows.
//   Computes: per lane, the affine add (x only for the compressed-key
//   formats; x and y for the GLV_EXACT_Y formats, uncompressed and
//   Ethereum), x * beta, x * beta^2, the six variants' values, the
//   interval compare, and a 6-bit mask (bit 2v + pi: prefix 2 + pi of
//   beta^v x, or (beta^v x, +y) for pi = 0 and (beta^v x, -y) for pi = 1);
//   0 where dx == 0 or b >= remaining[k].
//   Bound: integer ALU.  Six hashes per lane (P2PKH: six SHA-256 +
//   RIPEMD-160 pairs, about 25k 32-bit logic/add instructions; P2SH-P2WPKH
//   and uncompressed: two compressions per variant; Ethereum: one
//   Keccak-f per variant) dominate the five field multiplies; it reads 96
//   bytes and writes 4 bytes per lane.
//   Design: one thread per lane keeps the whole hash state in registers;
//   the interval table (at most 8 slots) is staged in shared memory.  The
//   exact-y variant pair negates y in place (twice per beta power).
//
// Kernel C, range_match
//   Replaces vgen_tpu/ops/pallas_fused.py _make_range_kernel (glv=False) as
//   called through fused_range_match_fn, and the per-window lax.scan of
//   _build_step: one launch covers all K windows.
//   Computes: per lane, the full affine add with y canonical, the format's
//   value (the compressed prefix is 2 + (y & 1)), the interval compare ->
//   0/1; 0 where dx == 0 or b >= remaining[k].
//   Bound: integer ALU, one value and three field multiplies per key (a
//   sixth of kernel B's hashing per lane), 96 bytes read and 4 written per
//   lane.
//   Design: tiles of 256 lanes of one window (match_kernels.cuh
//   range_tile_kernel), one per block over a (tiles per window, K) grid:
//   k is the block's, so no lane divides by B, and a tile at or past
//   remaining[k] loads nothing.  A persistent loop over the tiles (as many
//   blocks as the SMs hold), with and without a cp.async prefetch of the
//   next lane's 96 bytes, ran 14% slower (NVIDIA H100 80GB HBM3, 700 W;
//   probes/profile_dfa.py) and is kept in the probe unit.  y is exact
//   (every field op returns a value < p), so its parity is the prefix
//   byte's.  The interval table stays in shared memory.
//
// Kernel D, dfa_match
//   Replaces _make_kernel (glv=False) as called through fused_match_fn.
//   Computes: per lane, the full finish and the value as in C, the address
//   symbols (Base58Check v0 or v5: SHA256d checksum, 7 rounds of division
//   by 58^5 on 7 words, the reference's leading-zero shift; bech32: 32
//   five-bit groups and the polymod checksum; EIP-55: 40 nibbles cased by
//   a second Keccak-f over their lowercase-hex ASCII), and the DFA walk of
//   T + 1 steps -> 0/1.
//   Bound: integer ALU (for P2PKH three SHA-256 compressions, one
//   RIPEMD-160 and 49 64-bit divisions by a constant) and T + 1 dependent
//   table loads.
//   Design: C's tiles.  The TPU walked the DFA as a one-hot (S, W) f32
//   matmul per symbol, exact only up to 256 states; here each thread
//   follows the table by index, so any state count works.  A table of up
//   to 16 KB in the narrow form (uint16 entries, uint8 accept flags, built
//   once per pattern by the scanner) is copied into shared memory per
//   block; any other is read as int32 through the read-only cache, a
//   second instance (fused.py dfa_form).  No symbol array: the seven
//   base-58^5 remainders of Base58Check stay in registers and the walk
//   splits them into digits as it steps, the leading-zero shift a
//   predicate (dfa.cuh base58check_walk); bech32 walks its groups as the
//   checksum takes them, EIP-55 its nibbles as it cases them (dfa.cuh
//   address_walk).  Format is a template parameter.
//
// Kernel E, glv_dfa_match
//   Replaces _make_glv_dfa_kernel (glv=True) as called through
//   fused_match_fn.
//   Computes: per lane, kernel B's finish and six variants, each variant's
//   value through the symbols and the DFA -> a 6-bit mask (kernel B's bit
//   layout).
//   Bound: six times kernel D's hashing, encoding and walk per lane, for
//   six keys.
//   Design: the symbols of base58check_symbols, bech32_p2wpkh_symbols or
//   eip55_symbols in a per-thread array and dfa_walk over the int32 table
//   (dfa.cuh address_matches), one thread per lane; the variant loops are
//   not unrolled, to bound the code size of the six inlined encoders.
//
// Kernel J, base_advance
//   No TPU counterpart: the JAX package computes every super-step's base
//   points on the host (vgen_tpu/scan/scanner.py).
//   Computes: the bases of the next R super-steps, (k_j + (m + 1) D) G for
//   m < R, from the K window bases k_j G and the host's cached (m + 1) D
//   G, one affine add a lane (m, j) (scan_lanes.cuh base_advance_lane);
//   the scanner copies one super-step's K bases from them at each step.
//   Bound: latency: one lane's inversion (divsteps, field.cuh fe_inv) and
//   five field operations, the R K lanes side by side.
//   Design: one thread a lane.  Computing R super-steps ahead in one
//   launch spreads a launch's latency over R of them.  The host holds the
//   scalars and keeps every lane off the doubling and the point at
//   infinity.

#include "inv_block.cuh"
#include "match_kernels.cuh"

#define VG_HASH_FORMATS                                                  \
  vg::kFmtP2PKH, vg::kFmtP2WPKH, vg::kFmtP2SHP2WPKH,                    \
      vg::kFmtP2PKHUncompressed, vg::kFmtEthereum

namespace {

__global__ void __launch_bounds__(vg::kInvThreads, 1)
    inv_dx_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ tx,
                  uint32_t* __restrict__ out, uint32_t* __restrict__ scratch,
                  int B, long N, long T, int M, int G) {
  vg::inv_block(vg::DxInput(bx, tx, B, T), out, scratch, N, T, M, G);
}

constexpr int kAdvanceThreads = 32;

__global__ void __launch_bounds__(kAdvanceThreads)
    base_advance_kernel(const uint32_t* __restrict__ bx,
                        const uint32_t* __restrict__ by,
                        const uint32_t* __restrict__ qs,
                        uint32_t* __restrict__ out, long K, long R) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < R * K) vg::base_advance_lane(bx, by, qs, out, K, e / K, e % K);
}

}  // namespace

extern "C" {

// bx (K, 8), tx (8, B) -> out (8, K*B); scratch (8, K*B); M divides K*B;
// groups of G chains share an inversion (inv_block.cuh).
int vgen_batch_inverse_dx(const void* bx, const void* tx, void* out,
                          void* scratch, int K, int B, int M, int G,
                          void* stream) {
  if (!vg::inv_group_ok(G)) return (int)cudaErrorInvalidValue;
  const long N = (long)K * B;
  const long T = N / M;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *bx_ = (const uint32_t*)bx, *tx_ = (const uint32_t*)tx;
  uint32_t *out_ = (uint32_t*)out, *scratch_ = (uint32_t*)scratch;
  return vg::inv_launch(inv_dx_kernel, T, s, bx_, tx_, out_, scratch_, B, N,
                        T, M, G);
}

// Kernel J: bx, by (K, 8), qs (R, 2, 8) -> out (R, 2, K, 8), lane (m, j)
// the base j plus the point m.
int vgen_base_advance(const void* bx, const void* by, const void* qs,
                      void* out, int K, int R, void* stream) {
  if (K < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const long n = (long)K * R;
  base_advance_kernel<<<(unsigned)((n + kAdvanceThreads - 1) /
                                   kAdvanceThreads),
                        kAdvanceThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)qs,
      (uint32_t*)out, (long)K, (long)R);
  return (int)cudaGetLastError();
}

// Kernels B (range_glv_match) and C (range_match) for fmt 0 = P2PKH,
// 1 = P2WPKH, 2 = P2SH-P2WPKH, 3 = uncompressed P2PKH, 4 = Ethereum
// (csrc/dfa.cuh); another fmt returns cudaErrorInvalidValue.  bx, by
// (K, 8); tx, ty (8, B); inv (8, K*B); lo, hi (n_slots, 5) with n_slots <= 8;
// remaining (K,) -> out (K, B): the 6-bit variant mask (B) or 0/1 (C).
int vgen_range_glv_match(int fmt, const void* bx, const void* by,
                         const void* tx, const void* ty, const void* inv,
                         const void* lo, const void* hi, int n_slots,
                         const void* remaining, void* out, int K, int B,
                         void* stream) {
  return vg::launch_interval<true, VG_HASH_FORMATS>(
      fmt, bx, by, tx, ty, inv, lo, hi, n_slots, remaining, out, K, B, stream);
}

int vgen_range_match(int fmt, const void* bx, const void* by, const void* tx,
                     const void* ty, const void* inv, const void* lo,
                     const void* hi, int n_slots, const void* remaining,
                     void* out, int K, int B, void* stream) {
  return vg::launch_range_tiles<VG_HASH_FORMATS>(
      fmt, bx, by, tx, ty, inv, lo, hi, n_slots, remaining, out, K, B, stream);
}

// Kernel D (dfa_match), fmt as for B and C.  shared = 1: table (n_states,
// width) uint16 and accept (n_states,) uint8, at most 32 KB together
// (vg::kDfaSharedMax), copied into shared memory; shared = 0: both
// int32, read through the read-only cache.  Other arguments as for E ->
// out (K, B) 0/1.
int vgen_dfa_match(int shared, const void* bx, const void* by,
                   const void* tx, const void* ty, const void* inv,
                   const void* table, const void* accept, int n_states,
                   int width, int start, int fmt, const void* remaining,
                   void* out, int K, int B, void* stream) {
  return vg::launch_dfa_tiles<VG_HASH_FORMATS>(
      fmt, shared, bx, by, tx, ty, inv, table, accept, n_states, width, start,
      remaining, out, K, B, stream);
}

// Kernel E (glv_dfa_match), fmt as for B and C.  bx, by (K, 8); tx, ty
// (8, B); inv (8, K*B); table (S, width) and accept (S,) int32; remaining
// (K,) -> out (K, B): the 6-bit mask.
int vgen_glv_dfa_match(const void* bx, const void* by, const void* tx,
                       const void* ty, const void* inv, const void* table,
                       const void* accept, int width, int start, int fmt,
                       const void* remaining, void* out, int K, int B,
                       void* stream) {
  return vg::launch_dfa<true, VG_HASH_FORMATS>(
      fmt, bx, by, tx, ty, inv, table, accept, width, start, remaining, out, K,
      B, stream);
}

}  // extern "C"
