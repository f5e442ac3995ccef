// Address symbols, per thread, from a format's 5-word value: Base58Check
// for P2PKH and uncompressed P2PKH (version byte 0) and P2SH-P2WPKH
// (version 5), bech32 for P2WPKH (witness version 0), EIP-55 cased hex for
// Ethereum; and bech32m for P2TR (witness version 1) from the output key's
// x.  The symbols are digit values in the format's alphabet, the input of
// the DFA walk (dfa.cuh), as vgen_tpu/ops/encode.py emits them; ASCII is
// formed only for the EIP-55 checksum hash.
//
// Like the other headers this compiles as plain C++ too.
#pragma once

#include "keccak.cuh"
#include "sha256.cuh"

namespace vg {

constexpr int kBase58Syms = 34;  // symbols of a Base58Check address (version 0 or 5)
constexpr int kBech32Syms = 39;  // [witver] + 32 groups + 6 checksum symbols
constexpr int kBech32mSyms = 59;  // [witver 1] + 52 groups + 6 checksum symbols
constexpr int kEthSyms = 40;  // hex digits of an Ethereum account after "0x"
constexpr unsigned long long kB58Pow5 = 656356768ull;  // 58^5 < 2^32

// First big-endian word of SHA256d(version || h160): the four Base58Check
// checksum bytes.  h[5] is the hash160 as big-endian words.
VG_FN uint32_t base58check_checksum(uint32_t version, const uint32_t h[5]) {
  uint32_t w[16], st[8];
  w[0] = (version << 24) | (h[0] >> 8);
#pragma unroll
  for (int i = 1; i < 5; i++) w[i] = (h[i - 1] << 24) | (h[i] >> 8);
  w[5] = (h[4] << 24) | 0x00800000u;
#pragma unroll
  for (int i = 6; i < 15; i++) w[i] = 0u;
  w[15] = 168u;  // 21 bytes
  sha256_init(st);
  sha256_compress(st, w);
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = st[i];
  w[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; i++) w[i] = 0u;
  w[15] = 256u;
  sha256_init(st);
  sha256_compress(st, w);
  return st[0];
}

// Base58Check symbols of version || h160 || checksum, most significant
// first, with the reference's shift (vgen_tpu/ops/encode.py
// _base58_from_payload25): one digit 0 ('1') per leading zero byte of the
// 25-byte payload, then the significant digits, left-aligned and padded
// with 0.  Returns the length, 34 - (leading zero digits - leading zero
// bytes).
//
// The payload is a 200-bit number in 7 big-endian words (word 0 holds the
// version byte).  Each of 7 rounds divides it by 58^5 with 64-bit
// intermediates and splits the remainder into 5 digits; the 35th digit is
// 0 because the value is below 6 * 2^192 < 2^195 < 58^34 (58^34 > 2^199)
// for versions 0 and 5.  Version 5 has no leading zero byte (z = 0) and a
// value above 5 * 2^192 > 58^33, so every P2SH-P2WPKH address has 34
// symbols; version 0 keeps the variable length.
VG_FN int base58check_symbols(uint8_t syms[kBase58Syms], uint32_t version,
                              const uint32_t h[5]) {
  uint32_t n[7];
  n[0] = version;
#pragma unroll
  for (int i = 0; i < 5; i++) n[1 + i] = h[i];
  n[6] = base58check_checksum(version, h);
  // leading zero bytes of the payload (n[0] holds one byte)
  int z = 0;
  bool run = n[0] == 0u;
  z += run;
#pragma unroll
  for (int i = 1; i < 7; i++) {
#pragma unroll
    for (int sh = 24; sh >= 0; sh -= 8) {
      run = run && ((n[i] >> sh) & 0xFFu) == 0u;
      z += run;
    }
  }
  uint8_t d[35];  // least significant digit first
#pragma unroll
  for (int r = 0; r < 7; r++) {
    unsigned long long rem = 0;
#pragma unroll
    for (int i = 0; i < 7; i++) {
      const unsigned long long cur = (rem << 32) | n[i];
      const unsigned long long q = cur / kB58Pow5;
      n[i] = (uint32_t)q;
      rem = cur - q * kB58Pow5;
    }
    uint32_t rr = (uint32_t)rem;
#pragma unroll
    for (int j = 0; j < 5; j++) {
      const uint32_t q = rr / 58u;
      d[5 * r + j] = (uint8_t)(rr - q * 58u);
      rr = q;
    }
  }
  int k = 0;  // leading zero digits of the 34
  run = true;
#pragma unroll
  for (int j = 0; j < kBase58Syms; j++) {
    run = run && d[kBase58Syms - 1 - j] == 0;
    k += run;
  }
  const int shift = k - z;
#pragma unroll
  for (int j = 0; j < kBase58Syms; j++) {
    const int src = j + shift;
    syms[j] = src < kBase58Syms ? d[kBase58Syms - 1 - src] : (uint8_t)0;
  }
  return kBase58Syms - shift;
}

// 58^j for j < 5 (a constant where j is one, as in an unrolled loop)
VG_FN uint32_t b58_pow(int j) {
  return j == 0 ? 1u : j == 1 ? 58u : j == 2 ? 3364u : j == 3 ? 195112u
                                                              : 11316496u;
}

// The register form of base58check_symbols, for kernel D's walk
// (dfa.cuh base58check_walk): the payload's seven base-58^5 limbs r[7],
// least significant first (digit 5i + j of the 35 is digit j of r[i]),
// and the returned shift k - z: k leading zero digits of the 34, z
// leading zero bytes of the payload.  Symbol j of base58check_symbols is
// digit 33 - shift - j, and the length is 34 - shift.  The 7 rounds of
// division by 58^5 are base58check_symbols'; k comes from 34 compares of
// the limbs against powers of 58 (digit j of r[i] and every digit above
// it are 0 exactly when r[i] < 58^j, given the limbs above are 0).
VG_FN int base58check_limbs(uint32_t r[7], uint32_t version,
                            const uint32_t h[5]) {
  uint32_t n[7];
  n[0] = version;
#pragma unroll
  for (int i = 0; i < 5; i++) n[1 + i] = h[i];
  n[6] = base58check_checksum(version, h);
  int z = 0;
  bool run = n[0] == 0u;
  z += run;
#pragma unroll
  for (int i = 1; i < 7; i++) {
#pragma unroll
    for (int sh = 24; sh >= 0; sh -= 8) {
      run = run && ((n[i] >> sh) & 0xFFu) == 0u;
      z += run;
    }
  }
#pragma unroll
  for (int l = 0; l < 7; l++) {
    unsigned long long rem = 0;
#pragma unroll
    for (int i = 0; i < 7; i++) {
      const unsigned long long cur = (rem << 32) | n[i];
      const unsigned long long q = cur / kB58Pow5;
      n[i] = (uint32_t)q;
      rem = cur - q * kB58Pow5;
    }
    r[l] = (uint32_t)rem;
  }
  int k = 0;
  run = true;
#pragma unroll
  for (int l = 6; l >= 0; l--) {
#pragma unroll
    for (int j = l == 6 ? 3 : 4; j >= 0; j--) {
      run = run && r[l] < b58_pow(j);
      k += run;
    }
  }
  return k - z;
}

// EIP-55 symbols of an Ethereum account h[5] (big-endian words) after
// "0x": nibble i (most significant first) is 0-9 -> 0..9, a-f -> 10..15,
// and A-F -> 16..21 where nibble i of the checksum hash is 8 or more.  The
// checksum hash is keccak256 of the 40 lowercase-hex ASCII bytes: word w's
// eight nibbles fill lane w (nibble j in byte j), the 0x01 pad sits at
// byte 40 (lane 5), the 0x80 pad at byte 135 (lane 16's top bit).  Nibble
// i's checksum is the top (i even) or bottom (i odd) half of digest byte
// i / 2, so its bit 3 is bit 7 or bit 3 of that byte.  Always 40 symbols.
VG_FN void eip55_symbols(uint8_t syms[kEthSyms], const uint32_t h[5]) {
  uint64_t a[25];
#pragma unroll
  for (int w = 0; w < 5; w++) {
    uint64_t lane = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const uint32_t nib = (h[w] >> (28 - 4 * j)) & 0xFu;
      syms[8 * w + j] = (uint8_t)nib;
      lane |= (uint64_t)(nib + (nib >= 10u ? 87u : 48u)) << (8 * j);
    }
    a[w] = lane;
  }
  a[5] = 0x01ull;
#pragma unroll
  for (int i = 6; i < 25; i++) a[i] = 0ull;
  a[16] = 0x8000000000000000ull;
  keccak_f1600(a);
#pragma unroll
  for (int i = 0; i < kEthSyms; i++) {
    const int d = i / 2;
    const uint32_t byte = (uint32_t)(a[d / 8] >> (8 * (d % 8))) & 0xFFu;
    const uint32_t upper = (byte >> (i % 2 == 0 ? 7 : 3)) & 1u;
    if (syms[i] >= 10 && upper) syms[i] += 6;
  }
}

// The checksum hash of eip55_symbols without the symbols (kernel D's
// walk, dfa.cuh eip55_walk): a = keccak256 of h's 40 lowercase-hex ASCII
// bytes, laid out as eip55_symbols lays them out.
VG_FN void eip55_hash(uint64_t a[25], const uint32_t h[5]) {
#pragma unroll
  for (int w = 0; w < 5; w++) {
    uint64_t lane = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const uint32_t nib = (h[w] >> (28 - 4 * j)) & 0xFu;
      lane |= (uint64_t)(nib + (nib >= 10u ? 87u : 48u)) << (8 * j);
    }
    a[w] = lane;
  }
  a[5] = 0x01ull;
#pragma unroll
  for (int i = 6; i < 25; i++) a[i] = 0ull;
  a[16] = 0x8000000000000000ull;
  keccak_f1600(a);
}

// EIP-55 symbol i of account h from its checksum hash a (eip55_hash):
// nibble i, a letter moved to 16..21 where the hash's nibble i is 8 or more
VG_FN int eip55_symbol(const uint64_t a[25], const uint32_t h[5], int i) {
  const uint32_t nib = (h[i / 8] >> (28 - 4 * (i % 8))) & 0xFu;
  const int d = i / 2;
  const uint32_t byte = (uint32_t)(a[d / 8] >> (8 * (d % 8))) & 0xFFu;
  const uint32_t upper = (byte >> (i % 2 == 0 ? 7 : 3)) & 1u;
  return (int)nib + (nib >= 10u && upper ? 6 : 0);
}

VG_CONSTANT uint32_t BECH32_GEN[5] = {0x3B6A57B2u, 0x26508E6Du, 0x1EA119FAu,
                                      0x3D4233DDu, 0x2A1462B3u};

// polymod state after the constant prefix: the expansion of hrp "bc" and
// witness version 0 (vgen_tpu/ops/encode.py _polymod_init("bc", 0))
constexpr uint32_t kBech32InitBcV0 = 0x3D5A5FD2u;
// ... and of "bc" with witness version 1 (_polymod_init("bc", 1))
constexpr uint32_t kBech32InitBcV1 = 0x3D5A5FD3u;
constexpr uint32_t kBech32mConst = 0x2BC830A3u;  // BIP350

VG_FN uint32_t bech32_polymod_step(uint32_t chk, uint32_t v) {
  const uint32_t top = chk >> 25;
  chk = ((chk & 0x1FFFFFFu) << 5) ^ v;
#pragma unroll
  for (int i = 0; i < 5; i++) chk ^= (0u - ((top >> i) & 1u)) & BECH32_GEN[i];
  return chk;
}

// bech32 symbols of a P2WPKH address after "bc1": witness version 0, the
// 160 bits of h[5] as 32 five-bit groups (most significant first; 160 is a
// multiple of 5, so there is no padding), and the 6 checksum symbols
// (bech32 constant 1).  Always 39 symbols.
VG_FN void bech32_p2wpkh_symbols(uint8_t syms[kBech32Syms],
                                 const uint32_t h[5]) {
  syms[0] = 0;
  uint32_t chk = kBech32InitBcV0;
#pragma unroll
  for (int g = 0; g < 32; g++) {
    const int o = 5 * g, i = o >> 5, s = o & 31;
    const unsigned long long two =
        ((unsigned long long)h[i] << 32) | (i + 1 < 5 ? h[i + 1] : 0u);
    const uint32_t v = (uint32_t)(two >> (59 - s)) & 31u;
    syms[1 + g] = (uint8_t)v;
    chk = bech32_polymod_step(chk, v);
  }
#pragma unroll
  for (int i = 0; i < 6; i++) chk = bech32_polymod_step(chk, 0u);
  chk ^= 1u;
#pragma unroll
  for (int i = 0; i < 6; i++) syms[33 + i] = (uint8_t)((chk >> (5 * (5 - i))) & 31u);
}

// Five-bit group g (0 .. 51) of x (8 little-endian limbs, x[7] the most
// significant), most significant first, the last padded with 4 zero bits.
VG_FN uint32_t bech32m_group(const uint32_t x[8], int g) {
  const int o = 5 * g, i = o >> 5, s = o & 31;  // word i of x big-endian
  const unsigned long long two =
      ((unsigned long long)x[7 - i] << 32) | (i + 1 < 8 ? x[6 - i] : 0u);
  return (uint32_t)(two >> (59 - s)) & 31u;
}

// bech32m symbols of a P2TR address after "bc1": witness version 1, the
// 256 bits of x as 52 five-bit groups (bech32m_group) and the 6 checksum
// symbols (bech32m constant), the checksum by the polymod.  Always 59
// symbols.
VG_FN void bech32m_p2tr_symbols(uint8_t syms[kBech32mSyms], const uint32_t x[8]) {
  syms[0] = 1;
  uint32_t chk = kBech32InitBcV1;
#pragma unroll
  for (int g = 0; g < 52; g++) {
    const uint32_t v = bech32m_group(x, g);
    syms[1 + g] = (uint8_t)v;
    chk = bech32_polymod_step(chk, v);
  }
#pragma unroll
  for (int i = 0; i < 6; i++) chk = bech32_polymod_step(chk, 0u);
  chk ^= kBech32mConst;
#pragma unroll
  for (int i = 0; i < 6; i++) syms[53 + i] = (uint8_t)((chk >> (5 * (5 - i))) & 31u);
}

// bech32m's checksum of a P2TR program as 52 independent table lookups
// (kernel I's; bech32m_p2tr_symbols keeps the polymod).  A polymod step
// chk -> ((chk & 0x1FFFFFF) << 5) ^ v ^ G(chk >> 25), G the XOR of the
// generators of the top bits that are set, is linear over GF(2) in chk
// and v.  With L the step at v = 0, the checksum of groups v_0 .. v_51 is
//   L^58(kBech32InitBcV1) ^ XOR_g L^(57 - g)(v_g) ^ kBech32mConst
//   = kBech32mFixed ^ XOR_g BECH32M_GROUPS.t[32 g + v_g],
// the table's row g holding L^(57 - g)(v) for the 32 values of v.  The
// compiler builds the table (52 x 32 words, 6.5 KB) and the constant; a
// warp's 32 lookups of one group fall in one 128-byte row.
struct Bech32mGroups {
  uint32_t t[52 * 32];
};

// L: one polymod step with a zero symbol
VG_HD constexpr uint32_t bech32_polymod_shift(uint32_t chk) {
  const uint32_t top = chk >> 25;
  uint32_t r = (chk & 0x1FFFFFFu) << 5;
  r ^= (top & 1u) ? 0x3B6A57B2u : 0u;  // BECH32_GEN
  r ^= (top & 2u) ? 0x26508E6Du : 0u;
  r ^= (top & 4u) ? 0x1EA119FAu : 0u;
  r ^= (top & 8u) ? 0x3D4233DDu : 0u;
  r ^= (top & 16u) ? 0x2A1462B3u : 0u;
  return r;
}

VG_HD constexpr Bech32mGroups bech32m_groups() {
  Bech32mGroups r{};
  uint32_t basis[5] = {};  // L^(57 - g)(1 << b), from g = 51 down
  for (int b = 0; b < 5; b++) {
    basis[b] = 1u << b;
    for (int j = 0; j < 6; j++) basis[b] = bech32_polymod_shift(basis[b]);
  }
  for (int g = 51; g >= 0; g--) {
    for (int v = 0; v < 32; v++) {
      uint32_t e = 0;
      for (int b = 0; b < 5; b++)
        if ((v >> b) & 1) e ^= basis[b];
      r.t[32 * g + v] = e;
    }
    for (int b = 0; b < 5; b++) basis[b] = bech32_polymod_shift(basis[b]);
  }
  return r;
}

VG_HD constexpr uint32_t bech32m_fixed() {
  uint32_t chk = kBech32InitBcV1;
  for (int j = 0; j < 58; j++) chk = bech32_polymod_shift(chk);
  return chk ^ kBech32mConst;
}

constexpr uint32_t kBech32mFixed = bech32m_fixed();
VG_TABLE Bech32mGroups BECH32M_GROUPS = bech32m_groups();

VG_FN uint32_t bech32m_p2tr_checksum(const uint32_t x[8]) {
  uint32_t chk = kBech32mFixed;
#pragma unroll
  for (int g = 0; g < 52; g++)
    chk ^= VG_LDG(BECH32M_GROUPS.t + 32 * g + bech32m_group(x, g));
  return chk;
}

}  // namespace vg
