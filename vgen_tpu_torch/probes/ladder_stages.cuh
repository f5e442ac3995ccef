// Kernel F's lane cut after a stage, for probes/profile_ladder.py: the
// full finish (the affine add of base and table point), then the even-Y
// key and the TapTweak hash, then the ladder's digits and its table
// entries' loads (XORed into the output in place of the adds), then the
// whole lane (csrc/p2tr_lanes.cuh p2tr_ladder_lane), whose difference
// from the one before is the lean adds.  Each stage calls the production
// functions.  Like the headers in csrc/ this compiles as plain C++ too.
#pragma once

#include "p2tr_lanes.cuh"

namespace vg {
namespace probe {

// probe_ladder_stage instances (profile_ladder.py STAGES)
enum LadderStage { kLsFinish, kLsTagged, kLsDigits, kLsFull, kNumLadderStages };

// Kernel F's contract (csrc/p2tr.cu ladder_kernel, kFinish): X, Z stored at
// e, ok returned.  Cut after finish: X = x, Z = y, ok = dx != 0; after
// tagged: X = t, Z = the even-Y y, ok also t < n; after digits: X = x ^
// px ^ ..., Z = y ^ py ^ ... over the nonzero digits' entries (py negated
// for a negative digit), ok as tagged's.
template <int kStage, int kBits, bool kSigned>
VG_FN int32_t ladder_stage_lane(const uint32_t* bx, const uint32_t* by,
                                const uint32_t* tx, const uint32_t* ty,
                                const uint32_t* inv, const uint32_t* table,
                                uint32_t* Xo, uint32_t* Zo, long B, long N,
                                long e) {
  if constexpr (kStage == kLsFull) {
    return p2tr_ladder_lane<kBits, kSigned>(bx, by, tx, ty, inv, table, Xo, Zo,
                                            B, N, e);
  } else {
    uint32_t x[8], y[8], t[8];
    bool ok = lane_add_all(x, y, bx, by, tx, ty, inv, B, N, e);
    if constexpr (kStage != kLsFinish) {
      if (y[0] & 1u) fe_neg(y, y);
      taptweak_hash(t, x);
      ok = ok && below_order(t);
    }
    if constexpr (kStage == kLsTagged) fe_copy(x, t);
    if constexpr (kStage == kLsDigits) {
      uint32_t carry = 0u, px[8], py[8];
#pragma unroll 1
      for (int w = 0; w < LadderWindows<kBits, kSigned>::kWindows; w++) {
        bool neg;
        const uint32_t digit = ladder_digit<kBits, kSigned>(t, carry, neg);
        if (digit == 0u) continue;
        ladder_entry<kBits, kSigned>(px, py, table, w, digit);
        if (kSigned && neg) fe_neg(py, py);
#pragma unroll
        for (int i = 0; i < 8; i++) {
          x[i] ^= px[i];
          y[i] ^= py[i];
        }
      }
    }
    fe_store(Xo, N, e, x);
    fe_store(Zo, N, e, y);
    return ok ? 1 : 0;
  }
}

}  // namespace probe
}  // namespace vg
