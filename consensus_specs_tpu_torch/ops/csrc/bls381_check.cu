// The batched BLS12-381 pairing check for Hopper (sm_90a) in one launch,
// one block of four warps a job: the Miller loop of the job's k pairs into
// one shared
// accumulator, the product written out, then the final exponentiation and
// the verdict, in the same warp.
//
// Replaces consensus_specs_tpu/ops/pairing_jax.py `pairing_check` in its
// fused form `_pairing_check_fused` (`_miller_scan`, `_easy_part`,
// `_hard_chain`) on the check-by-check path, where the pairing's two
// launches (below) serve the signature flush.  The product before the
// final exponentiation equals the pairing's launch 2's bit for bit
// (bls381_check.cuh says why), and the verdict is the same.
//
// What bounds it: operations, the CIOS products' 32-bit multiplies, and
// their dependency chain within the job: a single Verify is one job, so a
// thread a job left 31 lanes of its warp and 131 SMs idle.  Here 128
// lanes (four warps, one on each sub-partition of an SM) share each tower
// op's independent products (the 54 Fq products of an Fq12 product, the
// 18 of a cyclotomic square, the steps of the job's pairs, f^2 beside the
// first chunk's doubling steps) between barriers, with the job's Fq12
// values in shared memory and each product in registers (bls381_reg.cuh).
// Four warps, because one warp's products are bound by its sub-partition's
// multiply pipe: about 2 us a dependent Fq product on the card, however
// many of its lanes take part.  The critical path of a Miller bit falls
// from about 124 dependent products to 5 (f^2 beside the first doubling
// level, two more doubling levels, a product by each of the two lines);
// the final exponentiation's Fq inverse is a binary GCD on the ALU pipe.
//
// Why no tensor cores or TMA: the work is chains of dependent 381-bit
// products with carries over about 600 bytes of state; no wgmma tile fits
// and nothing streams.  The resources that matter are the integer multiply
// rate, registers, a block's lanes and shared memory (check_smem, about
// 18 KB a job).
//
// K1, the segment sums (`bls381_segment_sum_launch`), replaces
// consensus_specs_tpu/ops/g1_sweep.py:84 `_jax_sweep` (a [segments, L]
// Jacobian tensor reduced by log2(L) batched `point_add` launches at
// halving shapes) and the halving sum of ops/msm.py:324 `g2_multi_exp`
// (`_tree_sum_host`), in the reference's pair order.  What bounds it: the
// chain of dependent products, not the multiplies (a round of L/2 G1 adds
// is 8 L products, a 128-point segment's 127 adds 2,032).  Its depth is
// log2(L) rounds of five product levels (eight with a doubling), one Fq
// product a lane and a level, with a combine level of additions after
// most, against 16 dependent products a round (G2 43) in the
// thread-an-add design before it; a 128-point G1 segment is 43 product
// passes, a 16-point G2 segment 20.  A block a segment, so a block's 8
// committee sums use 8 SMs.
//
// Layouts (int32 tensors read as uint32 words, Montgomery form): g1
// [b, k, 2, 12] (xp, yp), g2 [b, k, 2, 2, 12] (xq, yq) affine, skip uint8
// [b, k]; tq [b, k, 72] is scratch for the twist points; writes prod
// [b, 12, 12] and ok uint8 [b].  K1 reads and overwrites buf [segments,
// L, point] (a G1 point (X, Y, Z) 36 words, a G2 point 72) and writes out
// [segments, point].
//
// This file also holds the kernels and C entries of the pairing's two
// launches (bodies and design in bls381_pairing.cuh) and of K1, the segment
// sums (bodies and design in bls381_segment.cuh), which run the same
// levels: bls381_check.cuh defines the levels' gate, so the library holds
// one translation unit that includes it.

#include "bls381_pairing.cuh"
#include "bls381_segment.cuh"

namespace {

__global__ void __launch_bounds__(CHECK_LANES)
bls381_check_kernel(const uint32_t* __restrict__ g1,
                    const uint32_t* __restrict__ g2,
                    const uint8_t* __restrict__ skip, uint32_t* tq,
                    int64_t k, uint32_t* __restrict__ prod,
                    uint8_t* __restrict__ ok) {
  __shared__ check_smem s;
  const int64_t job = blockIdx.x;
  check_job_args j;
  j.g1 = g1 + job * k * 2 * RQ_W;
  j.g2 = g2 + job * k * 2 * RQ2_W;
  j.skip = skip + job * k;
  j.tq = tq + job * k * RG2_W;
  j.k = k;
  check_job(&s, j, prod + job * RQ12_W, ok + job);
}

// the pairing's launch 1: a block a pair
__global__ void __launch_bounds__(CHECK_LANES)
bls381_miller_kernel(const uint32_t* __restrict__ g1,
                     const uint32_t* __restrict__ g2,
                     const uint8_t* __restrict__ skip,
                     uint32_t* __restrict__ f) {
  __shared__ check_smem s;
  __shared__ uint32_t tq[RG2_W];
  const int64_t i = blockIdx.x;
  miller_pair(&s, tq, g1 + i * 2 * RQ_W, g2 + i * 2 * RQ2_W, skip + i,
              f + i * RQ12_W);
}

// the pairing's launch 2: a block a job
__global__ void __launch_bounds__(CHECK_LANES)
bls381_final_kernel(const uint32_t* __restrict__ f, int64_t k, int do_final,
                    uint32_t* __restrict__ prod, uint8_t* __restrict__ ok) {
  __shared__ check_smem s;
  __shared__ mul_smem m1;
  const int64_t job = blockIdx.x;
  product_final_job(&s, &m1, f + job * k * RQ12_W, k, do_final,
                    prod + job * RQ12_W, ok + job);
}

// K1: a block a segment of len points of F (fp: G1, fp2: G2), summed in
// place in buf, its sum written to out
template <typename F>
__global__ void __launch_bounds__(CHECK_LANES)
bls381_segment_sum_kernel(uint32_t* buf, int64_t len,
                          uint32_t* __restrict__ out) {
  __shared__ seg_smem<F> s;
  constexpr int64_t w = 3 * seg_field<F>::FW;
  segment_job<F>(&s, buf + static_cast<int64_t>(blockIdx.x) * len * w, len,
                 out + static_cast<int64_t>(blockIdx.x) * w);
}

}  // namespace

// Plain C entry of K1: `segments` segments of `len` points each (G2 when g2
// is nonzero, else G1), a power of two; buf is overwritten.  Launches on
// `stream` and returns cudaGetLastError() as an int (cudaErrorInvalidValue
// for a length that is not a power of two).
extern "C" int bls381_segment_sum_launch(int g2, void* buf, int64_t len,
                                         void* out, int64_t segments,
                                         void* stream) {
  if (len < 1 || (len & (len - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (segments > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned int blocks = static_cast<unsigned int>(segments);
    if (g2) {
      bls381_segment_sum_kernel<fp2><<<blocks, CHECK_LANES, 0, s>>>(
          static_cast<uint32_t*>(buf), len, static_cast<uint32_t*>(out));
    } else {
      bls381_segment_sum_kernel<fp><<<blocks, CHECK_LANES, 0, s>>>(
          static_cast<uint32_t*>(buf), len, static_cast<uint32_t*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry: b jobs of k >= 1 pairs, one block of four warps a job.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int bls381_pairing_check_launch(const void* g1, const void* g2,
                                           const void* skip, void* tq,
                                           void* prod, void* ok, int64_t k,
                                           int64_t b, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0) {
    bls381_check_kernel<<<static_cast<unsigned int>(b), CHECK_LANES, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(g1), static_cast<const uint32_t*>(g2),
        static_cast<const uint8_t*>(skip), static_cast<uint32_t*>(tq), k,
        static_cast<uint32_t*>(prod), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of the pairing's launch 1: n pairs, a block each.  Launches
// on `stream` and returns cudaGetLastError() as an int.
extern "C" int bls381_miller_launch(const void* g1, const void* g2,
                                    const void* skip, void* f, int64_t n,
                                    void* stream) {
  if (n > 0) {
    bls381_miller_kernel<<<static_cast<unsigned int>(n), CHECK_LANES, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(g1), static_cast<const uint32_t*>(g2),
        static_cast<const uint8_t*>(skip), static_cast<uint32_t*>(f));
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of the pairing's launch 2: b jobs of k >= 1 Miller values
// each, a block each.  `ok` is written only when do_final is nonzero.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int bls381_final_launch(const void* f, int64_t k, int do_final,
                                   void* prod, void* ok, int64_t b,
                                   void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0) {
    bls381_final_kernel<<<static_cast<unsigned int>(b), CHECK_LANES, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), k, do_final,
        static_cast<uint32_t*>(prod), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
