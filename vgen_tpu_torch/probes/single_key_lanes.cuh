// Per-thread bodies of probe_single_key's instances (probes.cu launches
// them; vgen_tpu_torch/probes/profile_dfa.py is the tool): kernel D's
// P2PKH lane over the product's tiles cut after a stage, and the
// schedules and walk that the product does not take: the persistent tile
// loop over C's and D's lanes, with and without a cp.async prefetch of the
// next lane's rows, and D's symbols in a per-thread array.  Each stage
// returns a word of what it computed, so nothing before the cut is dead
// code: the XOR of x and y after the full finish, of the hash160 words
// after the value, the checksum word after the checksum, the XOR of the
// seven base-58^5 limbs and the shift after the base conversion.  Like the
// headers in csrc/ this compiles as plain C++ too.
#pragma once

#include "scan_lanes.cuh"

namespace vg {
namespace probe {

// probe_single_key instances (profile_dfa.py MODES): the four stages (one
// tile per block, as the product); C and D (P2PKH) over the persistent
// tile loop, without and with the prefetch; D one tile per block with the
// symbols in a per-thread array (kernel E's walk); then C and D on the
// per-lane grid (one thread per lane over N / 256 blocks, D's symbols in a
// per-thread array and its int32 table through the read-only cache).  The
// array and per-lane modes take any hash format, the others P2PKH.
enum SingleKeyMode {
  kSkFinish, kSkValue, kSkChecksum, kSkSymbols, kSkCPersistent, kSkCPrefetch,
  kSkDPersistent, kSkDPrefetch, kSkDArrays, kSkCLane, kSkDLane,
  kNumSingleKeyModes
};
constexpr bool kSkAnyFormat(int mode) {
  return mode == kSkDArrays || mode == kSkCLane || mode == kSkDLane;
}
constexpr int kNumSingleKeyStages = kSkSymbols + 1;

// How C's and D's lanes are taken: one tile per block over a (tiles per
// window, K) grid (the product's, scan_lanes.cuh single_key_tile); or the
// persistent tile loop single_key_tiles (as many blocks as the SMs hold),
// its lanes reading their rows from device memory or, with the prefetch,
// from the stage buffer that cp.async fills.
enum TileSchedule { kTileGrid, kTilePersistent, kTilePrefetch };
constexpr int kRowWords = 24;  // a lane's rows: tx, ty and inv, 8 words each
constexpr int kStageBytes = kRowWords * kTileLanes * 4;

// *dst = *src, as cp.async on the card (4 bytes through L1 into shared
// memory, complete at copy_wait_all); a plain copy on the host.
VG_FN void copy_async(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

VG_FN void copy_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The persistent tile loop of kernels C and D, thread t of a block.  The K windows of
// B lanes are K * tpw tiles, tpw = ceil(B / kTileLanes), tile k * tpw + i
// lanes i * kTileLanes .. of window k; the block takes tiles first, first
// + stride, ... (the grid: its blocks resident at once), stepping window
// and tile with no division, so a tile's k is known and no lane divides
// by B.  Lane b = i * kTileLanes + t gets lane(k, rows, rows_read) where
// b < min(remaining[k], B) and 0 where b < B: a tile at or past
// remaining[k] loads nothing.  Without kPrefetch the lane reads its rows
// from device memory; with it the thread has copied them (cp.async) into
// its column of ``stage``, the block's (kRowWords, kTileLanes) shared
// buffer (word w at stage[w * kTileLanes + t]), and copies its next live
// lane's as soon as the lane has read them, so the copy runs under the
// hashing.  A thread reads only its own column: no barrier.
template <bool kPrefetch, class Lane>
VG_FN void single_key_tiles(const Lane& lane, const uint32_t* tx,
                            const uint32_t* ty, const uint32_t* inv,
                            const int32_t* remaining, int32_t* out, int K,
                            int B, int first, int stride, int t,
                            uint32_t* stage) {
  const int tpw = (B + kTileLanes - 1) / kTileLanes;
  const int dk = stride / tpw, di = stride - dk * tpw;
  const long N = (long)K * B;
  uint32_t* col = stage + t;
  auto live = [&](int k, int i) {
    const int b = i * kTileLanes + t;
    return k < K && b < B && b < remaining[k];
  };
  auto fetch = [&](int k, int i) {
    const long b = i * kTileLanes + t;
#pragma unroll
    for (int w = 0; w < 8; w++) {
      copy_async(col + w * kTileLanes, tx + w * B + b);
      copy_async(col + (8 + w) * kTileLanes, ty + w * B + b);
      copy_async(col + (16 + w) * kTileLanes, inv + w * N + k * B + b);
    }
  };
  int k = first / tpw, i = first - k * tpw;
  bool on = live(k, i);
  if (kPrefetch && on) fetch(k, i);
  while (k < K) {
    const int b = i * kTileLanes + t;
    int nk = k + dk, ni = i + di;
    if (ni >= tpw) {
      ni -= tpw;
      nk++;
    }
    const bool next_on = live(nk, ni);
    int32_t r = 0;
    if constexpr (kPrefetch) {
      if (on) {
        copy_wait_all();
        const LaneRows rows{col, col + 8 * kTileLanes, col + 16 * kTileLanes,
                            kTileLanes, kTileLanes};
        r = lane(k, rows, [&] {
          if (next_on) fetch(nk, ni);
        });
      } else if (next_on) {
        fetch(nk, ni);
      }
    } else if (on) {
      const LaneRows rows{tx + b, ty + b, inv + (long)k * B + b, B, N};
      r = lane(k, rows, [] {});
    }
    if (b < B) out[(long)k * B + b] = r;
    k = nk;
    i = ni;
    on = next_on;
  }
}

// Kernel D's hit with the symbols in a per-thread array walked after them
// (dfa.cuh address_matches, kernel E's form)
template <int kFmt, class D>
struct ArrayHit {
  D dfa;
  VG_FN bool operator()(const uint32_t h[5]) const {
    return address_matches<kFmt>(dfa, h);
  }
};

template <int kStage>
struct StageLane {
  const uint32_t* bx;
  const uint32_t* by;
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
    uint32_t w = 0;
    if constexpr (kStage == kSkFinish) {
#pragma unroll
      for (int i = 0; i < 8; i++) w ^= x[i] ^ y[i];
      return (int32_t)w;
    }
    value_words<kFmtP2PKH>(h, x, y, y[0] & 1u);
    if constexpr (kStage == kSkValue) {
#pragma unroll
      for (int i = 0; i < 5; i++) w ^= h[i];
    } else if constexpr (kStage == kSkChecksum) {
      w = base58check_checksum(0u, h);
    } else {
      uint32_t r[7];
      w = (uint32_t)base58check_limbs(r, 0u, h) << 26;
#pragma unroll
      for (int i = 0; i < 7; i++) w ^= r[i];
    }
    return (int32_t)w;
  }
};

}  // namespace probe
}  // namespace vg
