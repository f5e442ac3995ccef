// Per-thread bodies of probe_p2tr_match's instances (probes.cu launches
// them; vgen_tpu_torch/probes/profile_p2tr_match.py is the tool): kernel
// I's lane over the product's tiles (p2tr_lanes.cuh p2tr_finish_tile) cut
// after a stage, and the walks the product does not take: the register
// walk with the polymod's checksum (this redesign's first form), and the
// symbols in a per-thread array walked after them (the per-lane walk).
// Each stage returns a word of what it computed, so nothing before the
// cut is dead code: the XOR of the output key's eight x words after qx,
// the bech32m checksum (its six symbols, 30 bits) after the checksum.
// The mode kPmLane is the per-lane kernel I whole (p2tr_dfa_lane, below,
// on the per-lane grid), kPmBounded the product's walk under a minimum of 4
// blocks per SM.  Like the headers in csrc/ this compiles as plain C++
// too.
#pragma once

#include "p2tr_lanes.cuh"

namespace vg {
namespace probe {

// probe_p2tr_match instances (profile_p2tr_match.py MODES): qx alone; qx
// and the bech32m checksum, no walk, by the product's table lookups and
// by the polymod; the register walk with the polymod's checksum; the
// product's walk under __launch_bounds__(256, 4); the symbols in an array
// and dfa_walk; the per-lane kernel I.  The walks but kPmLane take either
// table form.
enum P2trMatchMode {
  kPmQx, kPmChecksum, kPmPolymod, kPmPolymodWalk, kPmBounded, kPmArrays,
  kPmLane, kNumP2trMatchModes
};

// The bech32m checksum of x by the polymod: the chain of 52 groups' and 6
// zero steps of bech32m_p2tr_symbols, no symbols.
VG_FN uint32_t bech32m_p2tr_checksum_polymod(const uint32_t x[8]) {
  uint32_t chk = kBech32InitBcV1;
#pragma unroll
  for (int g = 0; g < 52; g++)
    chk = bech32_polymod_step(chk, bech32m_group(x, g));
#pragma unroll
  for (int i = 0; i < 6; i++) chk = bech32_polymod_step(chk, 0u);
  return chk ^ kBech32mConst;
}

// kPmQx, kPmChecksum and kPmPolymod: the stage's word of qx
template <int kMode>
struct P2trStage {
  VG_FN int32_t operator()(const uint32_t qx[8]) const {
    if constexpr (kMode == kPmQx) {
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 8; i++) w ^= qx[i];
      return (int32_t)w;
    } else if constexpr (kMode == kPmChecksum) {
      return (int32_t)bech32m_p2tr_checksum(qx);
    } else {
      return (int32_t)bech32m_p2tr_checksum_polymod(qx);
    }
  }
};

// kPmPolymodWalk: dfa.cuh bech32m_p2tr_walk with the polymod's checksum,
// its steps interleaved with the groups' DFA steps
template <class D>
struct Bech32mPolymodWalk {
  D dfa;
  VG_FN int32_t operator()(const uint32_t qx[8]) const {
    int s = dfa_step(dfa, dfa.start, 1);
    uint32_t chk = kBech32InitBcV1;
#pragma unroll
    for (int g = 0; g < 52; g++) {
      const uint32_t v = bech32m_group(qx, g);
      s = dfa_step(dfa, s, (int)v);
      chk = bech32_polymod_step(chk, v);
    }
#pragma unroll
    for (int i = 0; i < 6; i++) chk = bech32_polymod_step(chk, 0u);
    chk ^= kBech32mConst;
#pragma unroll
    for (int i = 0; i < 6; i++)
      s = dfa_step(dfa, s, (int)((chk >> (5 * (5 - i))) & 31u));
    s = dfa_step(dfa, s, dfa.width - 2);
    return dfa_accepts(dfa, s) ? 1 : 0;
  }
};

// kPmArrays: the per-lane walk, the 59 symbols in a per-thread array
// (encode.cuh bech32m_p2tr_symbols) walked after them (dfa_walk)
template <class D>
struct Bech32mArrays {
  D dfa;
  VG_FN int32_t operator()(const uint32_t qx[8]) const {
    uint8_t syms[kBech32mSyms];
    bech32m_p2tr_symbols(syms, qx);
    return dfa_walk(dfa, syms, kBech32mSyms, kBech32mSyms) ? 1 : 0;
  }
};

// The per-lane kernel I (kPmLane), lane e: 1 when the DFA accepts the
// bech32m address of the output key; 0 where ok is 0, Z is 0 or
// b >= remaining[k].  One thread per lane over N / 256 blocks (k = e / B),
// the symbols in a per-thread array walked after them.
VG_FN int32_t p2tr_dfa_lane(const uint32_t* X, const uint32_t* Z,
                            const uint32_t* zi, const int32_t* ok, const Dfa& dfa,
                            const int32_t* remaining, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t qx[8];
  if (!p2tr_qx(qx, X, Z, zi, ok, N, e)) return 0;
  return Bech32mArrays<Dfa>{dfa}(qx);
}

}  // namespace probe
}  // namespace vg
