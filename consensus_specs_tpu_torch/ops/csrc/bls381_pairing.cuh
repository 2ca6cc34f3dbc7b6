// The batched BLS12-381 pairing for Hopper (sm_90a) in two launches, one
// block of four warps (CHECK_LANES = 128 threads) a pair or a job: the
// device bodies, on the warp levels of bls381_check.cuh.  The kernels and
// their C entries are in bls381_check.cu, beside the check's: the levels'
// gate (bls_level_gate) is a __device__ array that the header defines, so
// the library holds one translation unit that includes it.
//
// - `miller_pair` (launch 1, `bls381_miller_launch`): the check's Miller
//   part at k = 1 (`check_miller`) over the bits of |x|, then the pair's
//   Fq12, conjugated for x < 0, stored; a skipped pair writes one and runs
//   no level.
// - `product_final_job` (launch 2, `bls381_final_launch`): the job's k
//   Miller values multiplied into two running accumulators in shared
//   memory, each pass two Fq12 products side by side (warps 0-1 and 2-3,
//   `w_mul2`), then one product of the two.  The product is stored, then,
//   when asked, the check's final exponentiation (easy part, then the
//   x-chain hard part with cyclotomic squares) and verdict (`check_final`).
//   Fq12 is a field and every value is canonical, so this order gives the
//   sequential product bit for bit.
//
// Replaces consensus_specs_tpu/ops/pairing_jax.py:393
// `miller_partial_products` and :407 `fq12_product_is_one`, and the parts
// of `_pairing_check_fused` (:351) they run: `_miller_scan` (over
// `_double_step`, `_add_step` and `_line_to_fq12`), `_prod_reduce_raw`,
// `_easy_part` and `_hard_chain`.  The folded signature flush runs it three
// times: launch 1 over its k + 1 legs, launch 2 without the final
// exponentiation (ops/pairing_torch.py `fold_partial_products`), launch 2
// over the partial product with it (`fq12_product_is_one`).  The line
// scalings and the chain's order are the reference's, so the Miller values
// and products equal the plain version's bit for bit.  None of bls381.cuh's
// struct layer runs here (that layer and the pointer layer in one kernel
// gave wrong Fq12 products on the card).
//
// What bounds it: operations, the CIOS products' 32-bit multiplies, and
// their dependency chain: a Miller loop is about 7,000 Fq products, a
// final exponentiation about 9,000, each a chain of products that depend
// on the last.  So the block spreads each level's independent products
// (the 54 of an Fq12 product, the 18 of a cyclotomic square, a doubling
// step's 11 to 15, f^2 beside the doubling) over its lanes between
// barriers, with the pair's or job's Fq12 values in shared memory.  Four
// warps, because one warp's products are bound by its sub-partition's
// multiply pipe: about 2 us a dependent Fq product on the card, however
// many of its lanes take part; a block's four warps use the SM's four
// sub-partitions.  A Miller loop is 486 levels (63 bits of 7, 5 add bits
// of 9 more), where one thread a pair ran its 7,000 products in sequence;
// the pairs' blocks run side by side.  The final exponentiation's Fq
// inverse is a binary GCD on the ALU pipe.
//
// Why no tensor cores or TMA: the work is chains of dependent 381-bit
// products with carries over about 600 bytes of state; no wgmma tile fits
// and nothing streams.  The resources that matter are the integer multiply
// rate, registers (255 a thread: two blocks an SM), a block's lanes and
// shared memory (check_smem, about 20 KB, and a second product's 3.4 KB).
//
// Layouts (int32 tensors read as uint32 words, Montgomery form):
// g1 [n, 2, 12] (xp, yp), g2 [n, 2, 2, 12] (xq, yq), skip uint8 [n],
// f [n, 12, 12]; launch 2 reads f as [b, k, 12, 12] and writes prod
// [b, 12, 12] and ok uint8 [b].
//
// Without __CUDACC__ the levels run their lanes in turn (BLS_LEVEL), so the
// host C++ build runs the same bodies.
#pragma once

#include "bls381_check.cuh"

// lanes 0..11: r = one (Montgomery)
BLS_CALL void lvl_one(int lane, uint32_t* r) {
  if (lane == 0) rq_set_one(r);
  else if (lane < 12) rq_set_zero(r + lane * RQ_W, RQ_W);
}

// Launch 1 for one pair: g1 (xp, yp) 24 words, g2 (xq, yq) 48 words, its
// skip flag; writes its Miller value, conjugated, to f (144 words).  tq
// holds the twist point (72 words).  Block-uniform control flow.
BLS_FN void miller_pair(check_smem* s, uint32_t* tq, const uint32_t* g1,
                        const uint32_t* g2, const uint8_t* skip,
                        uint32_t* f) {
  if (*skip) {
    BLS_LEVEL(lvl_one(lane, f));
    return;
  }
  check_job_args j;
  j.g1 = g1;
  j.g2 = g2;
  j.skip = skip;
  j.tq = tq;
  j.k = 1;
  check_miller(s, j);
  BLS_LEVEL(lvl_store(lane, s->w[CS_F], f));
}

// level 1 of two Fq12 products: r0 = a0 b0 on warps 0-1 through m0, and
// a1 b1 on warps 2-3 through m1; a lane picks its operands, and every lane
// makes the one call
BLS_CALL void lvl_mul2_products(int lane, mul_smem* m0, mul_smem* m1,
                                const uint32_t* a0, const uint32_t* b0,
                                const uint32_t* a1, const uint32_t* b1) {
  const bool hi = lane >= CHECK_HALF;
  lvl_mul_products(hi ? lane - CHECK_HALF : lane, hi ? m1 : m0,
                   hi ? a1 : a0, hi ? b1 : b0);
}

BLS_CALL void lvl_mul2_sums(int lane, mul_smem* m0, mul_smem* m1) {
  const bool hi = lane >= CHECK_HALF;
  lvl_mul_sums(hi ? lane - CHECK_HALF : lane, hi ? m1 : m0);
}

BLS_CALL void lvl_mul2_out(int lane, mul_smem* m0, mul_smem* m1,
                           uint32_t* r0, uint32_t* r1) {
  const bool hi = lane >= CHECK_HALF;
  lvl_mul_out(hi ? lane - CHECK_HALF : lane, hi ? m1 : m0, hi ? r1 : r0);
}

// r0 = a0 b0 and r1 = a1 b1 in the three levels of one product; each r
// may alias its own operands
BLS_FN void w_mul2(check_smem* s, mul_smem* m1, uint32_t* r0,
                   const uint32_t* a0, const uint32_t* b0, uint32_t* r1,
                   const uint32_t* a1, const uint32_t* b1) {
  BLS_LEVEL(lvl_mul2_products(lane, &s->mul, m1, a0, b0, a1, b1));
  BLS_LEVEL(lvl_mul2_sums(lane, &s->mul, m1));
  BLS_LEVEL(lvl_mul2_out(lane, &s->mul, m1, r0, r1));
}

// Launch 2 for one job: f [k, 144] Miller values (k >= 1).  Writes their
// product to prod (144 words) and, when do_final, the verdict of its final
// exponentiation to ok.  The values v_0 .. v_{k-1} go into two
// accumulators, s->w[CS_F] from v_0 and s->w[CS_T0] from v_1, which take
// v_i and v_{i+1} in one pass; an odd last value goes to the first alone,
// and one product joins the two: ceil(k / 2) passes for k >= 2.
BLS_FN void product_final_job(check_smem* s, mul_smem* m1, const uint32_t* f,
                              int64_t k, int do_final, uint32_t* prod,
                              uint8_t* ok) {
  uint32_t* acc0 = s->w[CS_F];
  uint32_t* acc1 = s->w[CS_T0];
  BLS_LEVEL(lvl_conj(lane, acc0, f, false));
  if (k > 1) BLS_LEVEL(lvl_conj(lane, acc1, f + RQ12_W, false));
  int64_t i = 2;
  for (; i + 1 < k; i += 2)
    w_mul2(s, m1, acc0, acc0, f + i * RQ12_W, acc1, acc1,
           f + (i + 1) * RQ12_W);
  if (i < k) w_mul(s, acc0, acc0, f + i * RQ12_W);
  if (k > 1) w_mul(s, acc0, acc0, acc1);
  BLS_LEVEL(lvl_store(lane, acc0, prod));
  if (do_final) check_final(s, ok);
}
