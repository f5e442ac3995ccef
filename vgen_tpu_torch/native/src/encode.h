// Address encoders for the native CPU scanner: Base58Check, segwit
// bech32/bech32m, EIP-55 hex.  Counterparts of vgen_tpu/crypto/encode.py
// (host oracle) and vgen_tpu/ops/encode.py (device kernels); the reference
// does all of this on the host with the bitcoin crate (gpu.rs:1030-1093).
#pragma once

#include <cstring>
#include <string>

#include "hashes.h"

namespace vgen {

static const char B58_ALPHABET[] =
    "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz";
static const char BECH32_ALPHABET[] = "qpzry9x8gf2tvdw0s3jn54khce6mua7l";
static const char HEX_LOWER[] = "0123456789abcdef";

// Base58Check of version byte + 20-byte hash -> 25..34 chars.
inline int base58check(char* out, u8 version, const u8 h160[20]) {
  u8 payload[25];
  payload[0] = version;
  std::memcpy(payload + 1, h160, 20);
  u8 d1[32], d2[32];
  sha256(d1, payload, 21);
  sha256(d2, d1, 32);
  std::memcpy(payload + 21, d2, 4);

  // repeated divmod-58 on the 25-byte big-endian number
  u8 digits[40];
  int ndig = 0;
  u8 num[25];
  std::memcpy(num, payload, 25);
  int start = 0;
  while (start < 25) {
    if (num[start] != 0) {
      // one division pass
      u32 rem = 0;
      for (int i = start; i < 25; i++) {
        u32 v = (rem << 8) | num[i];
        num[i] = (u8)(v / 58);
        rem = v % 58;
      }
      digits[ndig++] = (u8)rem;
      if (num[start] == 0) {
        while (start < 25 && num[start] == 0) start++;
      }
    } else {
      start++;
    }
  }
  // leading zero bytes -> '1'
  int zeros = 0;
  while (zeros < 25 && payload[zeros] == 0) zeros++;
  int n = 0;
  for (int i = 0; i < zeros; i++) out[n++] = '1';
  for (int i = ndig - 1; i >= 0; i--) out[n++] = B58_ALPHABET[digits[i]];
  out[n] = 0;
  return n;
}

// bech32 / bech32m checksum machinery (BIP-173 / BIP-350)
inline u32 bech32_polymod_step(u32 chk, u8 v) {
  static const u32 GEN[5] = {0x3b6a57b2, 0x26508e6d, 0x1ea119fa, 0x3d4233dd,
                             0x2a1462b3};
  u8 b = (u8)(chk >> 25);
  chk = ((chk & 0x1ffffff) << 5) ^ v;
  for (int i = 0; i < 5; i++) {
    if ((b >> i) & 1) chk ^= GEN[i];
  }
  return chk;
}

// segwit address "bc1..." for witness version wver and 20- or 32-byte prog.
inline int segwit_encode(char* out, int wver, const u8* prog, int proglen) {
  // hrp "bc" expanded: [3,3,0,2,3]
  u32 chk = 1;
  static const u8 hrp_exp[5] = {3, 3, 0, 2, 3};
  for (int i = 0; i < 5; i++) chk = bech32_polymod_step(chk, hrp_exp[i]);
  u8 data[65];
  int nd = 0;
  data[nd++] = (u8)wver;
  // 8-bit -> 5-bit regroup, pad with zeros
  u32 acc = 0;
  int bits = 0;
  for (int i = 0; i < proglen; i++) {
    acc = (acc << 8) | prog[i];
    bits += 8;
    while (bits >= 5) {
      bits -= 5;
      data[nd++] = (u8)((acc >> bits) & 31);
    }
  }
  if (bits) data[nd++] = (u8)((acc << (5 - bits)) & 31);
  for (int i = 0; i < nd; i++) chk = bech32_polymod_step(chk, data[i]);
  for (int i = 0; i < 6; i++) chk = bech32_polymod_step(chk, 0);
  u32 constant = (wver == 0) ? 1 : 0x2bc830a3;  // bech32 : bech32m
  chk ^= constant;
  int n = 0;
  out[n++] = 'b';
  out[n++] = 'c';
  out[n++] = '1';
  for (int i = 0; i < nd; i++) out[n++] = BECH32_ALPHABET[data[i]];
  for (int i = 0; i < 6; i++)
    out[n++] = BECH32_ALPHABET[(chk >> (5 * (5 - i))) & 31];
  out[n] = 0;
  return n;
}

// EIP-55 checksummed hex address "0x..." from a 20-byte eth address.
inline int eth_encode(char* out, const u8 addr[20]) {
  char lower[40];
  for (int i = 0; i < 20; i++) {
    lower[2 * i] = HEX_LOWER[addr[i] >> 4];
    lower[2 * i + 1] = HEX_LOWER[addr[i] & 15];
  }
  u8 digest[32];
  keccak256(digest, (const u8*)lower, 40);
  out[0] = '0';
  out[1] = 'x';
  for (int i = 0; i < 40; i++) {
    char c = lower[i];
    u8 nib = (i % 2 == 0) ? (digest[i / 2] >> 4) : (digest[i / 2] & 15);
    if (c >= 'a' && c <= 'f' && nib >= 8) c = (char)(c - 'a' + 'A');
    out[2 + i] = c;
  }
  out[42] = 0;
  return 42;
}

}  // namespace vgen
