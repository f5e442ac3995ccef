// Field-multiply forms the product does not use yet, timed by the probes
// beside the production ones (csrc/field.cuh): the squaring as a full
// multiply (the product's squaring before its dedicated one), the
// 512-bit product written in PTX carry chains, and the product split into
// column sums with no carry and a separate carry pass (the TPU's
// "nocarry" form), and the whole multiply in that form.  Like the headers
// in csrc/ this compiles as plain C++ too; there the PTX product is the
// production one.
#pragma once

#include "field.cuh"

namespace vg {

// r = a^2 mod p as the full multiply fe_mul(a, a): the squaring the
// product used before csrc/field.cuh gained its dedicated fe_sqr, kept so
// that the probes time both.
VG_FN void fe_sqr_by_mul(uint32_t r[8], const uint32_t a[8]) { fe_mul(r, a, a); }

// t = a * b in 16 limbs by PTX carry chains: row i adds a[i] * b into
// t[i..i+8] as a chain of mad.lo.cc over the low halves (its carry into
// t[i + 8]) and one of mad.hi.cc over the high halves, one limb up.  The
// rows' partial sums stay below 2^(32 (i + 9)), so the high chain never
// carries out.
VG_FN void fe_mul_wide_ptx(uint32_t t[16], const uint32_t a[8], const uint32_t b[8]) {
#ifdef __CUDACC__
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "mad.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
        "madc.hi.u32 %8, %9, %17, %8;"
        : "+r"(t[i]), "+r"(t[i + 1]), "+r"(t[i + 2]), "+r"(t[i + 3]),
          "+r"(t[i + 4]), "+r"(t[i + 5]), "+r"(t[i + 6]), "+r"(t[i + 7]),
          "+r"(t[i + 8])
        : "r"(a[i]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
          "r"(b[5]), "r"(b[6]), "r"(b[7]));
  }
#else
  fe_mul_wide(t, a, b);
#endif
}

// r = a * b mod p: the PTX product, then the production fold.
VG_FN void fe_mul_ptx(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[16];
  fe_mul_wide_ptx(t, a, b);
  fe_reduce512(r, t);
}

// Column sums of a * b with no carry between columns: the low half of
// a[i] b[j] adds to column i + j, the high half to column i + j + 1.
// Each column sums at most 16 halves, so stays below 2^36.
VG_FN void fe_mul_cols_nocarry(u64 cols[16], const uint32_t a[8], const uint32_t b[8]) {
#pragma unroll
  for (int k = 0; k < 16; k++) cols[k] = 0ull;
#pragma unroll
  for (int i = 0; i < 8; i++) {
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const u64 p = (u64)a[i] * b[j];
      cols[i + j] += (uint32_t)p;
      cols[i + j + 1] += p >> 32;
    }
  }
}

// Carry propagation of 16 columns (each below 2^63) into 16 limbs;
// returns the carry out of the top limb.
VG_FN uint32_t fe_carry_cols(uint32_t t[16], const u64 cols[16]) {
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < 16; k++) {
    c += cols[k];
    t[k] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a * b mod p in the column form: the column sums, one carry pass (the
// product is below 2^512, so nothing carries out), then the production
// fold.  r may alias a or b.
VG_FN void fe_mul_colsum(uint32_t r[8], const uint32_t a[8],
                          const uint32_t b[8]) {
  u64 cols[16];
  uint32_t t[16];
  fe_mul_cols_nocarry(cols, a, b);
  fe_carry_cols(t, cols);
  fe_reduce512(r, t);
}

}  // namespace vg
