// The DFA walk over address symbols, per thread: the gather form of
// vgen_tpu/ops/pipeline.py match_symbols_gather.  The table is the
// pattern's DeviceDFA (vgen_tpu/pattern/pattern.py), (S, W) int32 with
// W = n_digits + 2: symbol W - 2 is end-of-string, W - 1 is padding.
// Any state count works (the TPU's one-hot matmul kept S <= 256 only to
// stay exact in bf16).
#pragma once

#include "encode.cuh"

#ifdef __CUDACC__
#define VG_LDG(p) __ldg(p)
#else
#define VG_LDG(p) (*(p))
#endif

namespace vg {

// Address formats of kernels B to E (the values the wrappers pass,
// vgen_tpu_torch/ops/fused.py FMT_CODE), with the DFA width of each.
constexpr int kFmtP2PKH = 0;               // Base58Check v0, W = 60
constexpr int kFmtP2WPKH = 1;              // bech32, W = 34
constexpr int kFmtP2SHP2WPKH = 2;          // Base58Check v5, W = 60
constexpr int kFmtP2PKHUncompressed = 3;   // Base58Check v0, W = 60
constexpr int kFmtEthereum = 4;            // EIP-55 hex, W = 24

struct Dfa {
  const int32_t* table;   // (S, width), read through the read-only path
  const int32_t* accept;  // (S,), nonzero for accepting states
  int width;
  int start;
};

// One step: the state after state s reads symbol sym.
VG_FN int dfa_step(const Dfa& dfa, int s, int sym) {
  return VG_LDG(dfa.table + (long)s * dfa.width + sym);
}

// T + 1 steps: step j feeds syms[j] while j < length, end-of-string at
// j == length and padding after it; the result is accept[state].
VG_FN bool dfa_walk(const Dfa& dfa, const uint8_t* syms, int T, int length) {
  int s = dfa.start;
  for (int j = 0; j <= T; j++) {
    const int sym = j < length ? (int)syms[j]
                               : (j == length ? dfa.width - 2 : dfa.width - 1);
    s = dfa_step(dfa, s, sym);
  }
  return VG_LDG(dfa.accept + s) != 0;
}

// Whether the address of value h[5] (the format's hash, big-endian words)
// in format kFmt is accepted: its symbols, then a walk of T + 1 steps with
// T the format's symbol count (34, 39 or 40).
template <int kFmt>
VG_FN bool address_matches(const Dfa& dfa, const uint32_t h[5]) {
  if constexpr (kFmt == kFmtP2WPKH) {
    uint8_t syms[kBech32Syms];
    bech32_p2wpkh_symbols(syms, h);
    return dfa_walk(dfa, syms, kBech32Syms, kBech32Syms);
  } else if constexpr (kFmt == kFmtEthereum) {
    uint8_t syms[kEthSyms];
    eip55_symbols(syms, h);
    return dfa_walk(dfa, syms, kEthSyms, kEthSyms);
  } else {
    uint8_t syms[kBase58Syms];
    const int len =
        base58check_symbols(syms, kFmt == kFmtP2SHP2WPKH ? 5u : 0u, h);
    return dfa_walk(dfa, syms, kBase58Syms, len);
  }
}

}  // namespace vg
