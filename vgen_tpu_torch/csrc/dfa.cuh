// The DFA walk over address symbols, per thread: the gather form of
// vgen_tpu/ops/pipeline.py match_symbols_gather.  The table is the
// pattern's DeviceDFA (vgen_tpu/pattern/pattern.py), (S, W) int32 with
// W = n_digits + 2: symbol W - 2 is end-of-string, W - 1 is padding.
// Any state count works (the TPU's one-hot matmul kept S <= 256 only to
// stay exact in bf16).
#pragma once

#include "encode.cuh"

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

VG_FN bool dfa_accepts(const Dfa& dfa, int s) {
  return VG_LDG(dfa.accept + s) != 0;
}

// T + 1 steps: step j feeds syms[j] while j < length, end-of-string at
// j == length and padding after it; the result is accept[state].  D is
// Dfa or DfaPlain (below).
template <class D>
VG_FN bool dfa_walk(const D& dfa, const uint8_t* syms, int T, int length) {
  int s = dfa.start;
  for (int j = 0; j <= T; j++) {
    const int sym = j < length ? (int)syms[j]
                               : (j == length ? dfa.width - 2 : dfa.width - 1);
    s = dfa_step(dfa, s, sym);
  }
  return dfa_accepts(dfa, s);
}

// A DFA read by plain loads: kernels D and I keep their table in shared
// memory in the narrow form, uint16 entries and uint8 accept flags
// (vgen_tpu_torch/ops/fused.py narrow_dfa); T and A are any integer types.
template <class T, class A>
struct DfaPlain {
  const T* table;   // (S, width)
  const A* accept;  // (S,)
  int width;
  int start;
};

template <class T, class A>
VG_FN int dfa_step(const DfaPlain<T, A>& dfa, int s, int sym) {
  return (int)dfa.table[s * dfa.width + sym];
}

template <class T, class A>
VG_FN bool dfa_accepts(const DfaPlain<T, A>& dfa, int s) {
  return dfa.accept[s] != 0;
}

// Kernel D's and I's walks: dfa_walk of a format's symbols, T + 1 steps,
// with every symbol in registers and walked as it is made, so no array is
// indexed at run time.  D is Dfa (the int32 table through the read-only
// cache) or DfaPlain.
//
// Base58Check (version 0 or 5): the digits of base58check_limbs, most
// significant first; a digit before the first symbol (position above
// 33 - shift) leaves the state as it is; then the end-of-string step and
// shift padding steps: 34 - shift + 1 + shift = 35 steps.
template <class D>
VG_FN bool base58check_walk(const D& dfa, uint32_t version,
                            const uint32_t h[5]) {
  uint32_t r[7];
  const int shift = base58check_limbs(r, version, h);
  const int top = kBase58Syms - 1 - shift;
  int s = dfa.start;
#pragma unroll
  for (int l = 6; l >= 0; l--) {
    uint32_t rest = r[l];
#pragma unroll
    for (int j = 4; j >= 0; j--) {
      if (5 * l + j >= kBase58Syms) continue;  // digit 34 is 0
      const uint32_t d = j == 0 ? rest : rest / b58_pow(j);
      rest -= d * b58_pow(j);
      if (5 * l + j <= top) s = dfa_step(dfa, s, (int)d);
    }
  }
  s = dfa_step(dfa, s, dfa.width - 2);
  for (int i = 0; i < shift; i++) s = dfa_step(dfa, s, dfa.width - 1);
  return dfa_accepts(dfa, s);
}

// bech32 (P2WPKH): the witness version, the 32 groups as the polymod takes
// them, the 6 checksum symbols and the end-of-string step: 40 steps.
template <class D>
VG_FN bool bech32_p2wpkh_walk(const D& dfa, const uint32_t h[5]) {
  int s = dfa_step(dfa, dfa.start, 0);
  uint32_t chk = kBech32InitBcV0;
#pragma unroll
  for (int g = 0; g < 32; g++) {
    const int o = 5 * g, i = o >> 5, sh = o & 31;
    const unsigned long long two =
        ((unsigned long long)h[i] << 32) | (i + 1 < 5 ? h[i + 1] : 0u);
    const uint32_t v = (uint32_t)(two >> (59 - sh)) & 31u;
    s = dfa_step(dfa, s, (int)v);
    chk = bech32_polymod_step(chk, v);
  }
#pragma unroll
  for (int i = 0; i < 6; i++) chk = bech32_polymod_step(chk, 0u);
  chk ^= 1u;
#pragma unroll
  for (int i = 0; i < 6; i++)
    s = dfa_step(dfa, s, (int)((chk >> (5 * (5 - i))) & 31u));
  s = dfa_step(dfa, s, dfa.width - 2);
  return dfa_accepts(dfa, s);
}

// bech32m (P2TR, kernel I): the witness version 1, the 52 groups of x (8
// little-endian limbs) as the polymod takes them, the last padded with 4
// zero bits, the 6 checksum symbols and the end-of-string step: 60 steps.
// The checksum is bech32m_p2tr_checksum's 52 independent table lookups,
// not the polymod's chain of 58 dependent steps.
template <class D>
VG_FN bool bech32m_p2tr_walk(const D& dfa, const uint32_t x[8]) {
  int s = dfa_step(dfa, dfa.start, 1);
#pragma unroll
  for (int g = 0; g < 52; g++) s = dfa_step(dfa, s, (int)bech32m_group(x, g));
  const uint32_t chk = bech32m_p2tr_checksum(x);
#pragma unroll
  for (int i = 0; i < 6; i++)
    s = dfa_step(dfa, s, (int)((chk >> (5 * (5 - i))) & 31u));
  s = dfa_step(dfa, s, dfa.width - 2);
  return dfa_accepts(dfa, s);
}

// EIP-55 (Ethereum): the checksum hash first, then the 40 cased nibbles
// and the end-of-string step: 41 steps.
template <class D>
VG_FN bool eip55_walk(const D& dfa, const uint32_t h[5]) {
  uint64_t a[25];
  eip55_hash(a, h);
  int s = dfa.start;
#pragma unroll
  for (int i = 0; i < kEthSyms; i++) s = dfa_step(dfa, s, eip55_symbol(a, h, i));
  s = dfa_step(dfa, s, dfa.width - 2);
  return dfa_accepts(dfa, s);
}

// address_matches in registers: the walk of format kFmt's address of h
template <int kFmt, class D>
VG_FN bool address_walk(const D& dfa, const uint32_t h[5]) {
  if constexpr (kFmt == kFmtP2WPKH) {
    return bech32_p2wpkh_walk(dfa, h);
  } else if constexpr (kFmt == kFmtEthereum) {
    return eip55_walk(dfa, h);
  } else {
    return base58check_walk(dfa, kFmt == kFmtP2SHP2WPKH ? 5u : 0u, h);
  }
}

// Whether the address of value h[5] (the format's hash, big-endian words)
// in format kFmt is accepted: its symbols, then a walk of T + 1 steps with
// T the format's symbol count (34, 39 or 40).
template <int kFmt, class D>
VG_FN bool address_matches(const D& dfa, const uint32_t h[5]) {
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

// The largest narrow table (S * width uint16 entries and S uint8 accept
// flags) that the shared form of kernels D and I copies into shared
// memory: under the 48 KB a block takes without opting in.  Which form
// the product takes for a table is the wrapper's choice
// (vgen_tpu_torch/ops/fused.py dfa_form).
constexpr int kDfaSharedMax = 32768;

#ifdef __CUDACC__
// run(dfa) with the table as kernel D's and I's lanes read it.  kShared:
// the narrow form (uint16 table, uint8 accept; width even), which the
// block copies into s_table (n_states * width * 2 + n_states bytes of
// shared memory) -> a DfaPlain over the copy; else the int32 table and
// accept read through the read-only cache (Dfa).
template <bool kShared, class Run>
__device__ __forceinline__ void with_dfa_table(const void* table,
                                               const void* accept,
                                               int n_states, int width,
                                               int start, uint32_t* s_table,
                                               const Run& run) {
  if constexpr (kShared) {
    const int words = n_states * width / 2;
    const uint32_t* g_words = (const uint32_t*)table;
    for (int i = threadIdx.x; i < words; i += blockDim.x) s_table[i] = g_words[i];
    uint8_t* s_accept = (uint8_t*)(s_table + words);
    for (int i = threadIdx.x; i < n_states; i += blockDim.x)
      s_accept[i] = ((const uint8_t*)accept)[i];
    __syncthreads();
    run(DfaPlain<uint16_t, uint8_t>{(const uint16_t*)s_table, s_accept, width,
                                    start});
  } else {
    run(Dfa{(const int32_t*)table, (const int32_t*)accept, width, start});
  }
}
#endif

}  // namespace vg
