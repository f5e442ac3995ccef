// Native CPU vanity scanner: keygen -> hash -> encode -> DFA match.
//
// This is the TPU build's counterpart of the reference's rayon CPU scanner
// (reference src/scanner.rs:76-330, ~50-200K keys/s): C++ with the same
// incremental-EC + Montgomery-batch-inversion hot loop the device uses,
// threaded over sub-ranges, exposed through a C ABI for ctypes.
//
// The DFA comes compiled from Python (vgen_tpu/pattern/redfa.py
// compile_dfa): dense table[state, class] over 258 symbols
// (256 bytes + BOT=256 + EOS=257), class-compressed.
//
// Build: see vgen_tpu/native/build.py (g++ -O3 -shared).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include "ec.h"
#include "encode.h"
#include "field.h"
#include "hashes.h"

namespace vgen {
namespace {

constexpr int FMT_P2PKH = 0;
constexpr int FMT_P2PKH_U = 1;
constexpr int FMT_P2WPKH = 2;
constexpr int FMT_P2SH_P2WPKH = 3;
constexpr int FMT_P2TR = 4;
constexpr int FMT_ETH = 5;

constexpr int SYM_BOT = 256;
constexpr int SYM_EOS = 257;

struct Dfa {
  const std::int32_t* table;  // [n_states * n_classes]
  const std::int32_t* classes;  // [258]
  const std::uint8_t* accept;  // [n_states]
  int n_classes;
  int start;

  inline bool match(const char* s, int len) const {
    int st = table[start * n_classes + classes[SYM_BOT]];
    for (int i = 0; i < len; i++) {
      st = table[st * n_classes + classes[(unsigned char)s[i]]];
    }
    st = table[st * n_classes + classes[SYM_EOS]];
    return accept[st] != 0;
  }
};

// 256-bit big-endian scalar helpers (host side keeps keys as 32 BE bytes)
inline void scalar_add_u64(unsigned char k[32], std::uint64_t v) {
  for (int i = 31; i >= 0 && v; i--) {
    std::uint64_t t = (std::uint64_t)k[i] + (v & 0xFF);
    k[i] = (unsigned char)t;
    v = (v >> 8) + (t >> 8);
  }
}

// TapTweak tagged hash (BIP-340): SHA256(SHA256("TapTweak")||SHA256("TapTweak")||x)
inline void tap_tweak(u8 out[32], const u8 x32[32]) {
  u8 tag_hash[32];
  sha256(tag_hash, (const u8*)"TapTweak", 8);
  u8 buf[96];
  std::memcpy(buf, tag_hash, 32);
  std::memcpy(buf + 32, tag_hash, 32);
  std::memcpy(buf + 64, x32, 32);
  sha256(out, buf, 96);
}

// scalar (32B BE) compare against curve order n
inline bool scalar_lt_n(const u8 k[32]) {
  static const u8 N_BE[32] = {0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
                              0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFE,
                              0xBA, 0xAE, 0xDC, 0xE6, 0xAF, 0x48, 0xA0, 0x3B,
                              0xBF, 0xD2, 0x5E, 0x8C, 0xD0, 0x36, 0x41, 0x41};
  for (int i = 0; i < 32; i++) {
    if (k[i] != N_BE[i]) return k[i] < N_BE[i];
  }
  return false;
}

struct SharedTables {
  std::vector<Aff> ig;  // i*G for i in 1..batch (affine), index i-1
  int batch;
};

SharedTables* build_tables(int batch) {
  auto* t = new SharedTables;
  t->batch = batch;
  t->ig.resize(batch);
  Jac acc;
  jac_set_infinity(acc);
  const Aff& G = generator();
  // Jacobian accumulation + per-entry normalize via batched inversion of Z
  std::vector<Jac> jpts(batch);
  for (int i = 0; i < batch; i++) {
    jac_add_affine(acc, acc, G);
    jpts[i] = acc;
  }
  // Montgomery batch inversion of all Z
  std::vector<Fe> pref(batch);
  Fe prod{{1, 0, 0, 0}};
  for (int i = 0; i < batch; i++) {
    pref[i] = prod;
    fe_mul(prod, prod, jpts[i].Z);
  }
  Fe inv_all;
  fe_inv(inv_all, prod);
  for (int i = batch - 1; i >= 0; i--) {
    Fe zi;
    fe_mul(zi, inv_all, pref[i]);
    fe_mul(inv_all, inv_all, jpts[i].Z);
    Fe zi2, zi3;
    fe_sqr(zi2, zi);
    fe_mul(zi3, zi2, zi);
    fe_mul(t->ig[i].x, jpts[i].X, zi2);
    fe_mul(t->ig[i].y, jpts[i].Y, zi3);
    t->ig[i].inf = false;
  }
  return t;
}

struct MatchSink {
  std::mutex mu;
  unsigned long long* out;
  int cap;
  std::atomic<int> found{0};

  void add(unsigned long long off) {
    std::lock_guard<std::mutex> g(mu);
    if (found.load() < cap) {
      out[found.load()] = off;
      found.fetch_add(1);
    }
  }
};

void derive_and_match(int fmt, const Aff& P, const Dfa& dfa,
                      std::uint64_t offset, MatchSink* sink) {
  u8 xb[32], yb[32];
  fe_to_bytes_be(xb, P.x);
  char addr[80];
  int alen = 0;
  u8 h160[20];
  switch (fmt) {
    case FMT_P2PKH: {
      u8 pub[33];
      pub[0] = (u8)(2 + (P.y.n[0] & 1));
      std::memcpy(pub + 1, xb, 32);
      hash160(h160, pub, 33);
      alen = base58check(addr, 0x00, h160);
      break;
    }
    case FMT_P2PKH_U: {
      u8 pub[65];
      pub[0] = 4;
      std::memcpy(pub + 1, xb, 32);
      fe_to_bytes_be(yb, P.y);
      std::memcpy(pub + 33, yb, 32);
      hash160(h160, pub, 65);
      alen = base58check(addr, 0x00, h160);
      break;
    }
    case FMT_P2WPKH: {
      u8 pub[33];
      pub[0] = (u8)(2 + (P.y.n[0] & 1));
      std::memcpy(pub + 1, xb, 32);
      hash160(h160, pub, 33);
      alen = segwit_encode(addr, 0, h160, 20);
      break;
    }
    case FMT_P2SH_P2WPKH: {
      u8 pub[33];
      pub[0] = (u8)(2 + (P.y.n[0] & 1));
      std::memcpy(pub + 1, xb, 32);
      hash160(h160, pub, 33);
      u8 script[22];
      script[0] = 0x00;
      script[1] = 0x14;
      std::memcpy(script + 2, h160, 20);
      u8 sh[20];
      hash160(sh, script, 22);
      alen = base58check(addr, 0x05, sh);
      break;
    }
    case FMT_P2TR: {
      // BIP341 key-path-only tweak of the even-Y internal key
      Aff Pint = P;
      if (Pint.y.n[0] & 1) fe_neg(Pint.y, P.y);
      u8 t32[32];
      tap_tweak(t32, xb);
      if (!scalar_lt_n(t32)) return;  // negligible; reject like the oracle
      Aff TG;
      scalar_mul_g(TG, t32);
      Jac Q;
      jac_from_affine(Q, TG);
      jac_add_affine(Q, Q, Pint);
      if (jac_is_infinity(Q)) return;
      Aff Qa;
      jac_to_affine(Qa, Q);
      u8 qx[32];
      fe_to_bytes_be(qx, Qa.x);
      alen = segwit_encode(addr, 1, qx, 32);
      break;
    }
    case FMT_ETH: {
      u8 pub64[64];
      std::memcpy(pub64, xb, 32);
      fe_to_bytes_be(yb, P.y);
      std::memcpy(pub64 + 32, yb, 32);
      u8 digest[32];
      keccak256(digest, pub64, 64);
      alen = eth_encode(addr, digest + 12);
      break;
    }
    default:
      return;
  }
  if (dfa.match(addr, alen)) sink->add(offset);
}

void scan_worker(int fmt, const unsigned char* start_key,
                 std::uint64_t lo, std::uint64_t hi, const Dfa& dfa,
                 const SharedTables* tables, MatchSink* sink,
                 std::atomic<std::uint64_t>* ops,
                 const std::atomic<int>* stop) {
  const int B = tables->batch;
  std::vector<Aff> pts(B);
  unsigned char kbuf[32];
  std::uint64_t pos = lo;
  while (pos < hi && !stop->load(std::memory_order_relaxed)) {
    int n = (int)std::min<std::uint64_t>(B, hi - pos);
    // base scalar = start + pos; keys covered: base..base+n-1
    std::memcpy(kbuf, start_key, 32);
    scalar_add_u64(kbuf, pos);
    Aff base;
    scalar_mul_g(base, kbuf);  // one scalar-mult per batch (amortized)
    // batch_affine_add masks its dx == 0 doubling slot (j == base scalar,
    // key 2*base) -- deterministic when base < n (tiny-range scans).
    // Recompute that one point exactly via jac_double.
    std::uint64_t base_u64 = 0;
    bool base_small = true;
    for (int i = 0; i < 24; i++)
      if (kbuf[i]) { base_small = false; break; }
    if (base_small)
      for (int i = 24; i < 32; i++) base_u64 = (base_u64 << 8) | kbuf[i];
    const int dj = (base_small && base_u64 >= 1 &&
                    base_u64 <= (std::uint64_t)(n - 1))
                       ? (int)base_u64
                       : -1;
    // key j in [0, n): P = base + j*G; j = 0 is base itself
    derive_and_match(fmt, base, dfa, pos, sink);
    if (n > 1) {
      batch_affine_add(pts, base, tables->ig.data(), n - 1);
      for (int j = 1; j < n; j++) {
        if (j == dj) {
          Jac q;
          jac_from_affine(q, base);
          jac_double(q, q);
          Aff qa;
          jac_to_affine(qa, q);
          derive_and_match(fmt, qa, dfa, pos + j, sink);
        } else {
          derive_and_match(fmt, pts[j - 1], dfa, pos + j, sink);
        }
      }
    }
    ops->fetch_add(n, std::memory_order_relaxed);
    pos += n;
  }
}

}  // namespace
}  // namespace vgen

extern "C" {

void* vgen_tables_new(int batch) { return vgen::build_tables(batch); }

void vgen_tables_free(void* t) {
  delete static_cast<vgen::SharedTables*>(t);
}

// Scan keys start_key + [0, count) (32-byte BE start, caller keeps the range
// below the curve order).  Returns the number of matches written to
// match_offsets (capped at max_matches); total keys scanned -> *ops_out.
// stop_flag (may be null) is polled between batches.
long long vgen_scan(const unsigned char* start_key32, unsigned long long count,
                    int fmt, const std::int32_t* dfa_table, int n_states,
                    int n_classes, const std::int32_t* classes258,
                    const std::uint8_t* accept, int dfa_start, void* tables,
                    int n_threads, unsigned long long* match_offsets,
                    int max_matches, unsigned long long* ops_out,
                    const volatile int* stop_flag) {
  (void)n_states;
  auto* tbl = static_cast<vgen::SharedTables*>(tables);
  vgen::Dfa dfa{dfa_table, classes258, accept, n_classes, dfa_start};
  vgen::MatchSink sink;
  sink.out = match_offsets;
  sink.cap = max_matches;
  std::atomic<std::uint64_t> ops{0};
  std::atomic<int> stop{0};

  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::uint64_t per = (count + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  std::atomic<int> poller_done{0};
  std::thread poller;
  if (stop_flag) {
    poller = std::thread([&] {
      while (!poller_done.load()) {
        if (*stop_flag) {
          stop.store(1);
          break;
        }
        std::this_thread::sleep_for(std::chrono::milliseconds(20));
      }
    });
  }
  for (int t = 0; t < n_threads; t++) {
    std::uint64_t lo = (std::uint64_t)t * per;
    std::uint64_t hi = std::min<std::uint64_t>(count, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(vgen::scan_worker, fmt, start_key32, lo, hi,
                         std::cref(dfa), tbl, &sink, &ops, &stop);
  }
  for (auto& th : threads) th.join();
  poller_done.store(1);
  if (poller.joinable()) poller.join();
  *ops_out = ops.load();
  return sink.found.load();
}

// Single-key full derivation for self-tests: returns address string length.
long long vgen_derive_address(const unsigned char* key32, int fmt, char* out,
                              int out_cap) {
  if (out_cap < 80) return -1;
  vgen::Aff P;
  vgen::scalar_mul_g(P, key32);
  vgen::u8 xb[32], yb[32];
  vgen::fe_to_bytes_be(xb, P.x);
  vgen::fe_to_bytes_be(yb, P.y);
  char addr[80];
  int alen = 0;
  vgen::u8 h160[20];
  switch (fmt) {
    case vgen::FMT_P2PKH: {
      vgen::u8 pub[33];
      pub[0] = (vgen::u8)(2 + (P.y.n[0] & 1));
      std::memcpy(pub + 1, xb, 32);
      vgen::hash160(h160, pub, 33);
      alen = vgen::base58check(addr, 0x00, h160);
      break;
    }
    case vgen::FMT_P2PKH_U: {
      vgen::u8 pub[65];
      pub[0] = 4;
      std::memcpy(pub + 1, xb, 32);
      std::memcpy(pub + 33, yb, 32);
      vgen::hash160(h160, pub, 65);
      alen = vgen::base58check(addr, 0x00, h160);
      break;
    }
    case vgen::FMT_P2WPKH: {
      vgen::u8 pub[33];
      pub[0] = (vgen::u8)(2 + (P.y.n[0] & 1));
      std::memcpy(pub + 1, xb, 32);
      vgen::hash160(h160, pub, 33);
      alen = vgen::segwit_encode(addr, 0, h160, 20);
      break;
    }
    case vgen::FMT_P2SH_P2WPKH: {
      vgen::u8 pub[33];
      pub[0] = (vgen::u8)(2 + (P.y.n[0] & 1));
      std::memcpy(pub + 1, xb, 32);
      vgen::hash160(h160, pub, 33);
      vgen::u8 script[22];
      script[0] = 0x00;
      script[1] = 0x14;
      std::memcpy(script + 2, h160, 20);
      vgen::u8 sh[20];
      vgen::hash160(sh, script, 22);
      alen = vgen::base58check(addr, 0x05, sh);
      break;
    }
    case vgen::FMT_P2TR: {
      vgen::Aff Pint = P;
      if (Pint.y.n[0] & 1) vgen::fe_neg(Pint.y, P.y);
      vgen::u8 t32[32];
      vgen::tap_tweak(t32, xb);
      if (!vgen::scalar_lt_n(t32)) return -2;
      vgen::Aff TG;
      vgen::scalar_mul_g(TG, t32);
      vgen::Jac Q;
      vgen::jac_from_affine(Q, TG);
      vgen::jac_add_affine(Q, Q, Pint);
      if (vgen::jac_is_infinity(Q)) return -2;
      vgen::Aff Qa;
      vgen::jac_to_affine(Qa, Q);
      vgen::u8 qx[32];
      vgen::fe_to_bytes_be(qx, Qa.x);
      alen = vgen::segwit_encode(addr, 1, qx, 32);
      break;
    }
    case vgen::FMT_ETH: {
      vgen::u8 pub64[64];
      std::memcpy(pub64, xb, 32);
      std::memcpy(pub64 + 32, yb, 32);
      vgen::u8 digest[32];
      vgen::keccak256(digest, pub64, 64);
      alen = vgen::eth_encode(addr, digest + 12);
      break;
    }
    default:
      return -1;
  }
  std::memcpy(out, addr, alen + 1);
  return alen;
}

// Batch derivation: n keys (32-byte BE each, packed) -> addresses written
// at out + i*stride (NUL-terminated; empty string where derivation failed,
// e.g. P2TR tweak overflow).  Threaded over contiguous chunks.  The device
// scan loop uses this to re-derive reported winners in bulk instead of one
// ctypes call + Python-object round trip per candidate -- the same role as
// the reference's rayon par_iter over a GPU batch (gpu.rs:1030-1093), but
// only over the device-reported match slots.
void vgen_derive_addresses(const unsigned char* keys, long long n, int fmt,
                           char* out, int stride, int n_threads) {
  if (n <= 0 || stride < 96) return;
  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  // thread-spawn overhead beats the win below ~64 keys/thread
  long long max_useful = (n + 63) / 64;
  if (n_threads > max_useful) n_threads = (int)max_useful;
  long long per = (n + n_threads - 1) / n_threads;
  auto work = [&](long long lo, long long hi) {
    for (long long i = lo; i < hi; i++) {
      long long r = vgen_derive_address(
          keys + 32 * i, fmt, out + (long long)stride * i, stride);
      if (r < 0) out[(long long)stride * i] = 0;
    }
  };
  if (n_threads == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    long long lo = (long long)t * per;
    long long hi = std::min<long long>(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

// ----------------------------------------------------------------- debug
// Component-level exports used by tests to bisect failures.
extern "C" {

void vgen_pubkey(const unsigned char* key32, unsigned char* out64) {
  vgen::Aff P;
  vgen::scalar_mul_g(P, key32);
  vgen::fe_to_bytes_be(out64, P.x);
  vgen::fe_to_bytes_be(out64 + 32, P.y);
}

void vgen_sha256(const unsigned char* msg, unsigned long long len,
                 unsigned char* out32) {
  vgen::sha256(out32, msg, len);
}

void vgen_ripemd160(const unsigned char* msg, unsigned long long len,
                    unsigned char* out20) {
  vgen::ripemd160(out20, msg, len);
}

void vgen_keccak256(const unsigned char* msg, unsigned long long len,
                    unsigned char* out32) {
  vgen::keccak256(out32, msg, len);
}

long long vgen_base58check(unsigned char version, const unsigned char* h160,
                           char* out) {
  return vgen::base58check(out, version, h160);
}

void vgen_fe_mul_test(const unsigned char* a32, const unsigned char* b32,
                      unsigned char* out32) {
  vgen::Fe a, b, r;
  vgen::fe_from_bytes_be(a, a32);
  vgen::fe_from_bytes_be(b, b32);
  vgen::fe_mul(r, a, b);
  vgen::fe_to_bytes_be(out32, r);
}

void vgen_fe_inv_test(const unsigned char* a32, unsigned char* out32) {
  vgen::Fe a, r;
  vgen::fe_from_bytes_be(a, a32);
  vgen::fe_inv(r, a);
  vgen::fe_to_bytes_be(out32, r);
}

}  // extern "C"

extern "C" {

void vgen_fe_add_test(const unsigned char* a32, const unsigned char* b32,
                      unsigned char* out32) {
  vgen::Fe a, b, r;
  vgen::fe_from_bytes_be(a, a32);
  vgen::fe_from_bytes_be(b, b32);
  vgen::fe_add(r, a, b);
  vgen::fe_to_bytes_be(out32, r);
}

void vgen_fe_sub_test(const unsigned char* a32, const unsigned char* b32,
                      unsigned char* out32) {
  vgen::Fe a, b, r;
  vgen::fe_from_bytes_be(a, a32);
  vgen::fe_from_bytes_be(b, b32);
  vgen::fe_sub(r, a, b);
  vgen::fe_to_bytes_be(out32, r);
}

void vgen_jac_double_test(const unsigned char* x32, const unsigned char* y32,
                          unsigned char* out64) {
  vgen::Aff a;
  vgen::fe_from_bytes_be(a.x, x32);
  vgen::fe_from_bytes_be(a.y, y32);
  vgen::Jac j, d;
  vgen::jac_from_affine(j, a);
  vgen::jac_double(d, j);
  vgen::Aff r;
  vgen::jac_to_affine(r, d);
  vgen::fe_to_bytes_be(out64, r.x);
  vgen::fe_to_bytes_be(out64 + 32, r.y);
}

void vgen_jac_addaff_test(const unsigned char* in128, unsigned char* out64) {
  vgen::Aff p, q;
  vgen::fe_from_bytes_be(p.x, in128);
  vgen::fe_from_bytes_be(p.y, in128 + 32);
  vgen::fe_from_bytes_be(q.x, in128 + 64);
  vgen::fe_from_bytes_be(q.y, in128 + 96);
  vgen::Jac j, s;
  vgen::jac_from_affine(j, p);
  vgen::jac_add_affine(s, j, q);
  vgen::Aff r;
  vgen::jac_to_affine(r, s);
  vgen::fe_to_bytes_be(out64, r.x);
  vgen::fe_to_bytes_be(out64 + 32, r.y);
}

}  // extern "C"
