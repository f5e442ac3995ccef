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

// Address formats of the DFA kernels (the values the wrappers pass).
constexpr int kFmtP2PKH = 0;   // Base58Check, W = 60
constexpr int kFmtP2WPKH = 1;  // bech32, W = 34

struct Dfa {
  const int32_t* table;   // (S, width), read through the read-only path
  const int32_t* accept;  // (S,), nonzero for accepting states
  int width;
  int start;
};

// T + 1 steps: step j feeds syms[j] while j < length, end-of-string at
// j == length and padding after it; the result is accept[state].
VG_FN bool dfa_walk(const Dfa& dfa, const uint8_t* syms, int T, int length) {
  int s = dfa.start;
  for (int j = 0; j <= T; j++) {
    const int sym = j < length ? (int)syms[j]
                               : (j == length ? dfa.width - 2 : dfa.width - 1);
    s = VG_LDG(dfa.table + (long)s * dfa.width + sym);
  }
  return VG_LDG(dfa.accept + s) != 0;
}

// Whether the address of hash160 h[5] in format kFmt is accepted.
template <int kFmt>
VG_FN bool h160_matches(const Dfa& dfa, const uint32_t h[5]) {
  if constexpr (kFmt == kFmtP2PKH) {
    uint8_t syms[kBase58Syms];
    const int len = base58check_symbols(syms, 0u, h);
    return dfa_walk(dfa, syms, kBase58Syms, len);
  } else {
    uint8_t syms[kBech32Syms];
    bech32_p2wpkh_symbols(syms, h);
    return dfa_walk(dfa, syms, kBech32Syms, kBech32Syms);
  }
}

}  // namespace vg
