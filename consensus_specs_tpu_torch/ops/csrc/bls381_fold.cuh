// The folded flush's legs (bls381_fold.cu), a leg a kernel.
//
// Set i of a flush has three legs, each independent of the others:
//
//   w_i = c_i agg_i (G1, the 64-bit Fiat-Shamir coefficient, bls381.cuh's
//     ladder), written affine as the set's Miller P (`fold_w_elem`);
//   H_i = h_eff Q_i (G2), by the psi method: bls381_cofactor.cu's kernel
//     (bls381_reg.cuh `cofactor_elem`), launched as it is, writes the
//     affine words as the set's Miller Q and an infinity flag, then
//     `fold_h_elem` puts the G2 generator in where the flag is set;
//   sw_i = c_i sig_i (G2, 64 bits, bls381.cuh's ladder), written Jacobian
//     for the signature sum (K1, bls381_check.cu's segment sum; `fold_sw_elem`).
//
// The set's pair is skipped when w_i or H_i is infinity, and the generator
// of that side (bls381.cuh FoldConst) stands in for it.  Each of the w and
// H legs sets skip[i] to one when its point is infinity and leaves it
// alone otherwise, so skip must be zero before the legs: the two legs of a
// set then write only ones to it, and its value is (w_i or H_i at
// infinity) in any order.  Affine words are canonical, so the pair equals
// the plain version's (ops/pairing_torch.py `_fold_lanes_plain`, whose
// cofactor is the 636-bit ladder over h_eff's bits) bit for bit, and sw_i
// runs the plain version's ladder, so its Jacobian words equal it too.
//
// Only bls381.cuh's struct functions are used here; the H leg's pointer
// functions (bls381_reg.cuh) stay in bls381_cofactor.cu's translation unit,
// so nothing adapts one layer to the other (built that way, the pointer
// layer's tower gave wrong Fq12 products on the card) and each kernel gets
// the registers of its own leg.
#pragma once

#include "bls381.cuh"

// w = c agg (agg 36 words, c the msb-first ncbits bits), affine into g1
// (24 words; the G1 generator at infinity)
BLS_FN void fold_w_elem(const uint32_t* agg, const uint8_t* cbits,
                        int64_t ncbits, const uint32_t* consts, uint32_t* g1,
                        uint8_t* skip) {
  const pt<fp> w = pt_ladder(bls_load<pt<fp>>(agg), cbits, ncbits);
  fp x, y;
  const bool inf = pt_affine(w, bls_load<fp>(consts + FC_G1X),
                             bls_load<fp>(consts + FC_G1Y), x, y);
  bls_store(g1, x);
  bls_store(g1 + BLS_NW, y);
  if (inf) *skip = 1;
}

// the H pair from the cofactor kernel's affine words g2 (48 words, zeros
// at infinity) and its flag h_inf: the G2 generator at infinity
BLS_FN void fold_h_elem(uint8_t h_inf, const uint32_t* consts, uint32_t* g2,
                        uint8_t* skip) {
  if (!h_inf) return;
  for (int w = 0; w < 4 * BLS_NW; ++w) g2[w] = consts[FC_G2X + w];
  *skip = 1;
}

// sw = c sig (sig 72 words), Jacobian into sw (72 words)
BLS_FN void fold_sw_elem(const uint32_t* sig, const uint8_t* cbits,
                         int64_t ncbits, uint32_t* sw) {
  bls_store(sw, pt_ladder(bls_load<pt<fp2>>(sig), cbits, ncbits));
}
