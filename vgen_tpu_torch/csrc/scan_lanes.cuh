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

// dx of element e = k*B + b: tx[b] - bx[k], with a zero (the doubling
// lane, tx == bx) replaced by 1 so it cannot poison the chain.
VG_FN void dx_of(uint32_t r[8], const uint32_t* bx, const uint32_t* tx,
                 long B, long e) {
  const long k = e / B, b = e - k * B;
  uint32_t t[8], base[8];
  fe_load(t, tx, B, b);
#pragma unroll
  for (int i = 0; i < 8; i++) base[i] = bx[k * 8 + i];
  fe_sub(r, t, base);
  if (fe_is_zero(r)) r[0] = 1u;
}

// The chain inputs of kernel A: dx of element e, recomputed from tx and bx
// instead of stored.
struct DxInput {
  const uint32_t* bx;
  const uint32_t* tx;
  long B;
  VG_FN void operator()(uint32_t r[8], long e) const { dx_of(r, bx, tx, B, e); }
};

// The chain inputs of kernel G: element e of a materialized (8, N) array,
// a zero replaced by 1 (so its "inverse" is exactly 1).
struct GuardedInput {
  const uint32_t* v;
  long N;
  VG_FN void operator()(uint32_t r[8], long e) const {
    fe_load(r, v, N, e);
    if (fe_is_zero(r)) r[0] = 1u;
  }
};

// Kernels A and G, thread t of T = N / M: a Montgomery chain over the M
// elements e = t + j*T (strided by the thread count, so each step's loads
// and stores coalesce).  Forward: exclusive prefix products into scratch,
// acc = the chain's total.  The output is canonical, so the chain geometry
// does not change the result.
template <class Input>
VG_FN void inv_chain_forward(const Input& in, uint32_t acc[8],
                             uint32_t* scratch, long N, long T, int M, long t) {
  uint32_t v[8];
  fe_set_one(acc);
  for (int j = 0; j < M; j++) {
    const long e = t + j * T;
    fe_store(scratch, N, e, acc);
    in(v, e);
    fe_mul(acc, acc, v);
  }
}

// Backward, from acc = the inverse of the chain's total:
// inv[e] = acc * prefix[e], acc *= in(e).
template <class Input>
VG_FN void inv_chain_backward(const Input& in, uint32_t acc[8], uint32_t* out,
                              const uint32_t* scratch, long N, long T, int M,
                              long t) {
  uint32_t v[8], pre[8];
  for (int j = M - 1; j >= 0; j--) {
    const long e = t + j * T;
    fe_load(pre, scratch, N, e);
    fe_mul(pre, acc, pre);
    fe_store(out, N, e, pre);
    in(v, e);
    fe_mul(acc, acc, v);
  }
}

// One thread's whole chain with its own inversion (a group of one).
template <class Input>
VG_FN void inv_chain_thread(const Input& in, uint32_t* out, uint32_t* scratch,
                            long N, long T, int M, long t) {
  uint32_t acc[8];
  inv_chain_forward(in, acc, scratch, N, T, M, t);
  fe_inv(acc, acc);
  inv_chain_backward(in, acc, out, scratch, N, T, M, t);
}

// The product tree that lets a group of G threads (G a power of two) share
// one inversion.  Nodes live in a limb-major (8, stride) array, node i
// (1 <= i < 2G) at column base + i: leaf r (G <= i = G + r < 2G) holds
// thread r's chain total, node i < G the product of nodes 2i and 2i + 1,
// so node 1 is the group's product.  Up-sweep: the G - 1 inner nodes,
// deepest first.  Node 1 is then inverted in place, and the down-sweep
// turns every node into its inverse, root first: inv(node i) =
// inv(parent) * sibling.  Leaf r then holds the inverse of thread r's
// total.  Input zeros are guarded to 1, so no node is zero.
VG_FN void tree_up(uint32_t* tree, long stride, long base, long i) {
  uint32_t l[8], r[8];
  fe_load(l, tree, stride, base + 2 * i);
  fe_load(r, tree, stride, base + 2 * i + 1);
  fe_mul(l, l, r);
  fe_store(tree, stride, base + i, l);
}

// v = the inverse of node i >= 2, from its parent's inverse (already in
// the tree) and its sibling's product (not yet replaced).
VG_FN void tree_down(uint32_t v[8], const uint32_t* tree, long stride,
                     long base, long i) {
  uint32_t s[8];
  fe_load(v, tree, stride, base + (i >> 1));
  fe_load(s, tree, stride, base + (i ^ 1));
  fe_mul(v, v, s);
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
