// Per-thread bodies of the scan kernels (kernels.cu launches them).
// Kept apart from the launch code so the arithmetic can also be driven
// from a host compiler.
//
// Arrays are limb-major (8, N) uint32: limb l of element e is at l*N + e.
#pragma once

#include "field.cuh"
#include "dfa.cuh"
#include "ripemd160.cuh"
#include "sha256.cuh"

namespace vg {

// cube root of unity mod p: (beta x, y) = lambda * (x, y) on the curve
VG_CONSTANT uint32_t BETA[8] = {0x719501EEu, 0xC1396C28u, 0x12F58995u,
                                0x9CF04975u, 0xAC3434E9u, 0x6E64479Eu,
                                0x657C0710u, 0x7AE96A2Bu};

// dx of a window's lane: table column t - the window's base x, with a
// zero (the doubling lane, t == base) replaced by 1 so it cannot poison
// the chain.
VG_FN void dx_of(uint32_t r[8], const uint32_t base[8], const uint32_t t[8]) {
  fe_sub(r, t, base);
  if (fe_is_zero(r)) r[0] = 1u;
}

// The chain inputs of kernels A and G.  A chain visits the elements
// e = t + j*T (strided by the chain count T, so each step's loads and
// stores coalesce) through a position: at(e), next (e + T), prev (e - T),
// and the value at a position.

// Kernel A: dx of element e = k*B + b, recomputed from tx and bx instead
// of stored.  T = q*B + r, so a step moves (k, b) by additions: one
// division by B a chain end instead of one an element; the position keeps
// bx[k] and reloads it when k moves.
struct DxInput {
  const uint32_t* bx;
  const uint32_t* tx;
  int B, q, r;
  long T;
  struct Pos {
    long e;
    int k, b;
    uint32_t base[8];  // bx[k]
  };
  VG_FN DxInput(const uint32_t* bx_, const uint32_t* tx_, int B_, long T_)
      : bx(bx_), tx(tx_), B(B_), q((int)(T_ / B_)), r((int)(T_ % B_)), T(T_) {}
  VG_FN void load_base(Pos& p) const {
#pragma unroll
    for (int i = 0; i < 8; i++) p.base[i] = bx[p.k * 8L + i];
  }
  VG_FN Pos at(long e) const {
    Pos p{e, (int)(e / B), (int)(e % B), {}};
    load_base(p);
    return p;
  }
  VG_FN void next(Pos& p) const {
    const int k = p.k;
    p.e += T;
    p.k += q;
    p.b += r;
    if (p.b >= B) {
      p.b -= B;
      p.k++;
    }
    if (p.k != k) load_base(p);
  }
  VG_FN void prev(Pos& p) const {
    const int k = p.k;
    p.e -= T;
    p.k -= q;
    p.b -= r;
    if (p.b < 0) {
      p.b += B;
      p.k--;
    }
    if (p.k != k) load_base(p);
  }
  VG_FN void operator()(uint32_t v[8], const Pos& p) const {
    uint32_t t[8];
    fe_load(t, tx, B, p.b);
    dx_of(v, p.base, t);
  }
};

// Kernel G: element e of a materialized (8, N) array, a zero replaced by 1
// (so its "inverse" is exactly 1).
struct GuardedInput {
  const uint32_t* v;
  long N, T;
  struct Pos {
    long e;
  };
  VG_FN Pos at(long e) const { return {e}; }
  VG_FN void next(Pos& p) const { p.e += T; }
  VG_FN void prev(Pos& p) const { p.e -= T; }
  VG_FN void operator()(uint32_t r[8], const Pos& p) const {
    fe_load(r, v, N, p.e);
    if (fe_is_zero(r)) r[0] = 1u;
  }
};

// The chains' prefix products, element-major: element e's 8 limbs at
// 8e .. 8e + 7, so a thread moves them in two 16-byte accesses and a warp's
// step is one 1 KB piece (the (8, N) arrays of the inputs and outputs take
// eight 4-byte accesses a thread).
struct Scratch {
  uint32_t* s;
  VG_FN void store(long e, const uint32_t a[8]) const {
#ifdef __CUDACC__
    uint4* p = reinterpret_cast<uint4*>(s + 8 * e);
    p[0] = make_uint4(a[0], a[1], a[2], a[3]);
    p[1] = make_uint4(a[4], a[5], a[6], a[7]);
#else
    for (int i = 0; i < 8; i++) s[8 * e + i] = a[i];
#endif
  }
  VG_FN void load(uint32_t a[8], long e) const {
#ifdef __CUDACC__
    const uint4* p = reinterpret_cast<const uint4*>(s + 8 * e);
    const uint4 lo = p[0], hi = p[1];
    a[0] = lo.x, a[1] = lo.y, a[2] = lo.z, a[3] = lo.w;
    a[4] = hi.x, a[5] = hi.y, a[6] = hi.z, a[7] = hi.w;
#else
    for (int i = 0; i < 8; i++) a[i] = s[8 * e + i];
#endif
  }
};

// Kernels A and G, chain t of T = N / M: a Montgomery chain over the M
// elements t + j*T.  Forward: exclusive prefix products into scratch (a
// Scratch), acc = the chain's total.  The output is canonical, so the
// chain geometry does not change the result.
template <class Input, class Prefixes>
VG_FN void inv_chain_forward(const Input& in, uint32_t acc[8],
                             const Prefixes& scratch, int M, long t) {
  uint32_t v[8];
  fe_set_one(acc);
  auto p = in.at(t);
  for (int j = 0; j < M; j++) {
    scratch.store(p.e, acc);
    in(v, p);
    fe_mul(acc, acc, v);
    if (j + 1 < M) in.next(p);
  }
}

// Backward, from acc = the inverse of the chain's total, into out (8, N):
// inv[e] = acc * prefix[e], acc *= in(e).
template <class Input, class Prefixes>
VG_FN void inv_chain_backward(const Input& in, uint32_t acc[8], uint32_t* out,
                              long N, const Prefixes& scratch, int M, long t) {
  uint32_t pre[8], v[8];
  auto p = in.at(t + (M - 1) * in.T);
  for (int j = M - 1; j >= 0; j--) {
    scratch.load(pre, p.e);
    fe_mul(pre, acc, pre);
    fe_store(out, N, p.e, pre);
    in(v, p);
    fe_mul(acc, acc, v);
    if (j > 0) in.prev(p);
  }
}

// One chain with its own inversion (a group of one).
template <class Input, class Prefixes>
VG_FN void inv_chain_thread(const Input& in, uint32_t* out, long N,
                            const Prefixes& scratch, int M, long t) {
  uint32_t acc[8];
  inv_chain_forward(in, acc, scratch, M, t);
  fe_inv(acc, acc);
  inv_chain_backward(in, acc, out, N, scratch, M, t);
}

// The product tree that lets a group of G chains (G a power of two, at
// least 2) share one inversion, over a round of Q groups.  Node i (1 <= i
// < 2G) of group q: leaf r = i - G (chain q G + r's total) at column
// q G + r of leaf, inner node i < G, the product of nodes 2i and 2i + 1,
// at column q G + i of inner; both limb-major (8, stride).  Node 1 is the
// group's product.  Up-sweep: the inner nodes, deepest first.  Each root
// is then inverted in place, and the down-sweep turns every node into its
// inverse, root first: inv(child) = inv(parent) * sibling.  Leaf r then
// holds the inverse of chain r's total.  Input zeros are guarded to 1, so
// no node is zero.
struct InvTree {
  uint32_t* leaf;
  uint32_t* inner;
  long stride;
  int G;
  VG_FN long col(int q, int i) const {
    return (long)q * G + (i >= G ? i - G : i);
  }
  VG_FN void load(uint32_t r[8], int q, int i) const {
    fe_load(r, i >= G ? leaf : inner, stride, col(q, i));
  }
  VG_FN void store(int q, int i, const uint32_t a[8]) const {
    fe_store(i >= G ? leaf : inner, stride, col(q, i), a);
  }
  // step x < Q n of the level of nodes n .. 2n - 1 (n < G): node n + x % n
  // of group x / n
  VG_FN void up(int n, int x) const {
    const int q = x / n, i = n + x % n;
    uint32_t a[8], b[8];
    load(a, q, 2 * i);
    load(b, q, 2 * i + 1);
    fe_mul(a, a, b);
    store(q, i, a);
  }
  VG_FN void invert_root(int q) const {
    uint32_t a[8];
    load(a, q, 1);
    fe_inv(a, a);
    store(q, 1, a);
  }
  // step x < Q n below the level of nodes n .. 2n - 1, whose inverses are
  // in place: both children of node n + x % n of group x / n become theirs
  VG_FN void down(int n, int x) const {
    const int q = x / n, i = n + x % n;
    uint32_t p[8], a[8], b[8];
    load(p, q, i);
    load(a, q, 2 * i);
    load(b, q, 2 * i + 1);
    fe_mul(b, p, b);  // inv(a) = inv(parent) * b
    fe_mul(a, p, a);
    store(q, 2 * i, b);
    store(q, 2 * i + 1, a);
  }
  // The whole round by `lanes` lanes, lane `lane` taking every lanes-th
  // step of a level; sync() between levels (a warp's __syncwarp, or
  // nothing for one lane).
  template <class Sync>
  VG_FN void round(int Q, int lane, int lanes, Sync sync) const {
    for (int n = G >> 1; n >= 1; n >>= 1) {
      for (int x = lane; x < Q * n; x += lanes) up(n, x);
      sync();
    }
    for (int q = lane; q < Q; q += lanes) invert_root(q);
    sync();
    for (int n = 1; n < G; n <<= 1) {
      for (int x = lane; x < Q * n; x += lanes) down(n, x);
      sync();
    }
  }
};

// Kernels A and G's persistent schedule (inv_block.cuh), also computed on
// the host: T chains in rounds of `round` chains; an SM holds kInvSmChains
// chains of rounds at once (one block of 512), so `sms` of them hold
// sms * kInvSmChains / round blocks.  Each block walks `per` rounds (the
// last blocks one fewer), so that all blocks run in one wave.
constexpr int kInvSmChains = 512;
struct InvSchedule {
  long rounds;
  int blocks, per;
};
VG_HD inline InvSchedule inv_schedule(long T, int round, int sms) {
  const long rounds = (T + round - 1) / round;
  const long slots = (long)sms * (kInvSmChains / round);
  const long per = (rounds + slots - 1) / slots;
  return {rounds, (int)((rounds + per - 1) / per), (int)per};
}

// Lexicographic lo[s] <= w <= hi[s] for any slot s of W words (word 0
// most significant).  Padding slots have lo > hi and never match.
template <int W = 5>
VG_FN bool in_intervals(const uint32_t w[W], const uint32_t* lo,
                        const uint32_t* hi, int n_slots) {
  bool hit = false;
  for (int s = 0; s < n_slots; s++) {
    int ge = 0, le = 0;  // 0 undecided, 1 true, -1 false
    for (int i = 0; i < W; i++) {
      const uint32_t l = lo[s * W + i], h = hi[s * W + i];
      if (ge == 0 && w[i] != l) ge = w[i] > l ? 1 : -1;
      if (le == 0 && w[i] != h) le = w[i] < h ? 1 : -1;
    }
    hit |= (ge >= 0) && (le >= 0);
  }
  return hit;
}

// Kernel J, one lane (m, j): window j's affine base point (bx[j], by[j])
// ((K, 8) row-major arrays) plus the affine point m of qs ((R, 2, 8): x,
// then y), by one affine add with its own inversion: lambda = (qy - y) /
// (qx - x), x' = lambda^2 - x - qx, y' = lambda (x - x') - y, written to
// out[m][0][j] and out[m][1][j] (out (R, 2, K, 8)).  The caller keeps x !=
// qx (no doubling, no point at infinity).
VG_FN void base_advance_lane(const uint32_t* bx, const uint32_t* by,
                             const uint32_t* qs, uint32_t* out, long K,
                             long m, long j) {
  uint32_t x[8], y[8], qx[8], qy[8], t[8], lam[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    x[i] = VG_LDG(bx + j * 8 + i);
    y[i] = VG_LDG(by + j * 8 + i);
    qx[i] = VG_LDG(qs + m * 16 + i);
    qy[i] = VG_LDG(qs + m * 16 + 8 + i);
  }
  fe_sub(t, qx, x);
  fe_inv(t, t);
  fe_sub(lam, qy, y);
  fe_mul(lam, lam, t);
  fe_sqr(t, lam);
  fe_sub(t, t, x);
  fe_sub(t, t, qx);  // x'
  fe_sub(x, x, t);
  fe_mul(x, lam, x);
  fe_sub(y, x, y);  // y'
  uint32_t* ox = out + (m * 2 * K + j) * 8;
  uint32_t* oy = ox + K * 8;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    ox[i] = t[i];
    oy[i] = y[i];
  }
}

// The affine add of window k's base point and table point b of lane
// e = k*B + b, from the lane's precomputed inverse of dx = tx - bx:
// lambda = (ty - by) / dx, x = lambda^2 - bx - tx and, when kWithY,
// y = lambda (bx - x) - by.  Every value is canonical (< p), so y's parity
// is the compressed-key prefix's.  Returns false where dx == 0 (the
// doubling lane), leaving x and y unset.
template <bool kWithY>
VG_FN bool lane_add(uint32_t x[8], uint32_t y[8], const uint32_t* bx,
                    const uint32_t* by, const uint32_t* tx, const uint32_t* ty,
                    const uint32_t* inv, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  uint32_t base[8], t[8], lam[8], u[8];
#pragma unroll
  for (int i = 0; i < 8; i++) base[i] = bx[k * 8 + i];
  fe_load(t, tx, B, b);
  fe_sub(lam, t, base);
  if (fe_is_zero(lam)) return false;
  fe_load(lam, ty, B, b);
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = by[k * 8 + i];
  fe_sub(lam, lam, u);
  fe_load(x, inv, N, e);
  fe_mul(lam, lam, x);
  fe_sqr(x, lam);
  fe_sub(x, x, base);
  fe_sub(x, x, t);
  if constexpr (kWithY) {
    fe_sub(t, base, x);
    fe_mul(t, lam, t);
    fe_sub(y, t, u);
  }
  return true;
}

// The GLV_EXACT_Y formats hash the full point, so their +- variant pair is
// (x, +y) and (x, -y) (full finish); the others hash a compressed key,
// whose +- pair is the two prefix parities (x-only finish).
template <int kFmt>
constexpr bool kExactY = kFmt == kFmtP2PKHUncompressed || kFmt == kFmtEthereum;

// h = the 5-word value format kFmt hashes the point (x, y) into
// (vgen_tpu/ops/pipeline.py interval_value_words): hash160 of the
// compressed key with prefix 2 + par (P2PKH, P2WPKH; y unused), the hash160
// of its redeem script (P2SH-P2WPKH), hash160 of 04 || x || y
// (uncompressed; par unused), or the Ethereum account (par unused).
template <int kFmt>
VG_FN void value_words(uint32_t h[5], const uint32_t x[8], const uint32_t y[8],
                       uint32_t par) {
  if constexpr (kFmt == kFmtEthereum) {
    eth_account(h, x, y);
  } else {
    uint32_t st[8];
    if constexpr (kFmt == kFmtP2PKHUncompressed) {
      sha256_x65(st, x, y);
    } else {
      sha256_x33(st, x, 2u + par);
    }
    ripemd160_sha_state(h, st);
    if constexpr (kFmt == kFmtP2SHP2WPKH) script_hash(h, h);
  }
}

// The 6-bit GLV mask of lane e (kernels B and E): bit 2v+pi is set when
// hit(value of variant (beta^v x, pi)) holds, pi the prefix parity of the
// compressed key or, for kExactY, the sign of y (pi = 0: +y, 1: -y); the
// bit layout of vgen_tpu_torch.crypto.secp256k1.glv_bit_variant_keys.  0
// where dx == 0 or b >= remaining[k].  kUnrollParity unrolls the parity
// pair of the compressed-key formats (their prefix byte then folds into
// the schedule; kernel E keeps the loop, to bound the code of two inlined
// encoders).
template <int kFmt, bool kUnrollParity, class Hit>
VG_FN int32_t glv_lane(const uint32_t* bx, const uint32_t* by,
                       const uint32_t* tx, const uint32_t* ty,
                       const uint32_t* inv, const int32_t* remaining, long B,
                       long N, long e, const Hit& hit) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t x[8], y[8], u[8];
  if (!lane_add<kExactY<kFmt>>(x, y, bx, by, tx, ty, inv, B, N, e)) return 0;
  // the variants' x-coordinates: x, beta x, beta^2 x = beta (beta x)
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = BETA[i];
  int32_t mask = 0;
#pragma unroll 1
  for (int v = 0; v < 3; v++) {
    if (v > 0) fe_mul(x, x, u);
    if constexpr (kExactY<kFmt>) {
      // y, then -y; negating twice restores y for the next v
#pragma unroll 1
      for (int pi = 0; pi < 2; pi++) {
        uint32_t h[5];
        value_words<kFmt>(h, x, y, 0u);
        if (hit(h)) mask |= 1 << (2 * v + pi);
        fe_neg(y, y);
      }
    } else if constexpr (kUnrollParity) {
#pragma unroll
      for (int pi = 0; pi < 2; pi++) {
        uint32_t h[5];
        value_words<kFmt>(h, x, x, (uint32_t)pi);
        if (hit(h)) mask |= 1 << (2 * v + pi);
      }
    } else {
#pragma unroll 1
      for (int pi = 0; pi < 2; pi++) {
        uint32_t h[5];
        value_words<kFmt>(h, x, x, (uint32_t)pi);
        if (hit(h)) mask |= 1 << (2 * v + pi);
      }
    }
  }
  return mask;
}

// Kernel B, lane e: glv_lane against the intervals.
template <int kFmt>
VG_FN int32_t range_glv_lane(const uint32_t* bx, const uint32_t* by,
                             const uint32_t* tx, const uint32_t* ty,
                             const uint32_t* inv, const uint32_t* lo,
                             const uint32_t* hi, int n_slots,
                             const int32_t* remaining, long B, long N,
                             long e) {
  return glv_lane<kFmt, true>(bx, by, tx, ty, inv, remaining, B, N, e,
                              [&](const uint32_t h[5]) {
                                return in_intervals(h, lo, hi, n_slots);
                              });
}

// Kernel C, lane e = k*B + b: the full affine add, then 1 when the value of
// format kFmt lies in an interval (the compressed prefix is 2 + (y & 1)).
// 0 where dx == 0 or b >= remaining[k].
template <int kFmt>
VG_FN int32_t range_lane(const uint32_t* bx, const uint32_t* by,
                         const uint32_t* tx, const uint32_t* ty,
                         const uint32_t* inv, const uint32_t* lo,
                         const uint32_t* hi, int n_slots,
                         const int32_t* remaining, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t x[8], y[8], h[5];
  if (!lane_add<true>(x, y, bx, by, tx, ty, inv, B, N, e)) return 0;
  value_words<kFmt>(h, x, y, y[0] & 1u);
  return in_intervals(h, lo, hi, n_slots) ? 1 : 0;
}

// Kernel D, lane e: the full affine add, the value, its address symbols in
// format kFmt, the DFA walk -> 0/1.  0 where dx == 0 or b >= remaining[k].
template <int kFmt>
VG_FN int32_t dfa_lane(const uint32_t* bx, const uint32_t* by,
                       const uint32_t* tx, const uint32_t* ty,
                       const uint32_t* inv, const Dfa& dfa,
                       const int32_t* remaining, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t x[8], y[8], h[5];
  if (!lane_add<true>(x, y, bx, by, tx, ty, inv, B, N, e)) return 0;
  value_words<kFmt>(h, x, y, y[0] & 1u);
  return address_matches<kFmt>(dfa, h) ? 1 : 0;
}

// Kernel E, lane e: glv_lane through the address symbols and the DFA.
template <int kFmt>
VG_FN int32_t glv_dfa_lane(const uint32_t* bx, const uint32_t* by,
                           const uint32_t* tx, const uint32_t* ty,
                           const uint32_t* inv, const Dfa& dfa,
                           const int32_t* remaining, long B, long N, long e) {
  return glv_lane<kFmt, false>(bx, by, tx, ty, inv, remaining, B, N, e,
                               [&](const uint32_t h[5]) {
                                 return address_matches<kFmt>(dfa, h);
                               });
}

// -- Kernels C and D: one key per lane, in tiles of one window --------------

constexpr int kTileLanes = 256;  // a tile: lanes b0 .. b0 + 255 of one window

#ifdef __CUDACC__
// The tile kernels' grid (C, D and I): (tiles per window, K).
inline dim3 tile_grid(int K, int B) {
  return dim3((unsigned)((B + kTileLanes - 1) / kTileLanes), (unsigned)K);
}
#endif

// Where a lane's rows are read: tx, ty and inv as three columns, tx and
// ty of stride ``stride``, inv of ``inv_stride`` (device memory: B and
// K * B from the lane's own column; the probe unit's prefetch stage
// buffer: kTileLanes).
struct LaneRows {
  const uint32_t* tx;
  const uint32_t* ty;
  const uint32_t* inv;
  long stride, inv_stride;
};

// lane_add<true> from a lane's rows: the affine add of window k's base
// point (bxk, byk) and the lane's table point -> x, y canonical; false
// where dx == 0.  Each row is read where it is first needed, as lane_add
// reads them.
VG_FN bool affine_add_xy(uint32_t x[8], uint32_t y[8], const uint32_t bxk[8],
                         const uint32_t byk[8], const LaneRows& rows) {
  uint32_t t[8], lam[8], u[8];
  fe_load(t, rows.tx, rows.stride, 0);
  fe_sub(lam, t, bxk);
  if (fe_is_zero(lam)) return false;
  fe_load(lam, rows.ty, rows.stride, 0);
  fe_sub(lam, lam, byk);
  fe_load(u, rows.inv, rows.inv_stride, 0);
  fe_mul(lam, lam, u);
  fe_sqr(x, lam);
  fe_sub(x, x, bxk);
  fe_sub(x, x, t);
  fe_sub(u, bxk, x);
  fe_mul(u, lam, u);
  fe_sub(y, u, byk);
  return true;
}

// Kernel C's hit: the value in an interval (the slots in shared memory)
struct IntervalHit {
  const uint32_t* lo;
  const uint32_t* hi;
  int n_slots;
  VG_FN bool operator()(const uint32_t h[5]) const {
    return in_intervals(h, lo, hi, n_slots);
  }
};

// Kernel D's hit: the address of format kFmt walked in registers
// (dfa.cuh address_walk)
template <int kFmt, class D>
struct WalkHit {
  D dfa;
  VG_FN bool operator()(const uint32_t h[5]) const {
    return address_walk<kFmt>(dfa, h);
  }
};

// Kernels C and D, lane (k, b) from its rows: the full affine add, the
// value of format kFmt (the compressed prefix is 2 + (y & 1)), 1 where
// hit(value) holds, else 0; 0 where dx == 0.  rows_read() runs once the
// rows are read (the probe unit's prefetch may then reuse their buffer).
template <int kFmt, class Hit>
struct SingleKeyLane {
  const uint32_t* bx;
  const uint32_t* by;
  Hit hit;
  template <class Then>
  VG_FN int32_t operator()(int k, const LaneRows& rows,
                           const Then& rows_read) const {
    uint32_t bxk[8], byk[8], x[8], y[8], h[5];
#pragma unroll
    for (int i = 0; i < 8; i++) {
      bxk[i] = bx[k * 8 + i];
      byk[i] = by[k * 8 + i];
    }
    const bool ok = affine_add_xy(x, y, bxk, byk, rows);
    rows_read();
    if (!ok) return 0;
    value_words<kFmt>(h, x, y, y[0] & 1u);
    return hit(h) ? 1 : 0;
  }
};

// One tile per block: lane b = i * kTileLanes + t of window k gets
// lane(k, rows) from device memory where b < min(remaining[k], B), 0
// where b < B; no loop.
template <class Lane>
VG_FN void single_key_tile(const Lane& lane, const uint32_t* tx,
                           const uint32_t* ty, const uint32_t* inv,
                           const int32_t* remaining, int32_t* out, int K,
                           int B, int k, int i, int t) {
  const int b = i * kTileLanes + t;
  if (b >= B) return;
  int32_t r = 0;
  if (b < remaining[k]) {
    const LaneRows rows{tx + b, ty + b, inv + (long)k * B + b, B,
                        (long)K * B};
    r = lane(k, rows, [] {});
  }
  out[(long)k * B + b] = r;
}

}  // namespace vg
