// The batched BLS12-381 pairing check for Hopper (sm_90a), in two launches:
//
//   launch 1: one thread a (job, pair) runs the Miller loop over the bits of
//             |x| and writes its Fq12 (conjugated for x < 0; one where the
//             pair is skipped);
//   launch 2: one thread a job multiplies its k Miller values, writes the
//             product, and (when asked) runs the final exponentiation (easy
//             part, then the x-chain hard part with cyclotomic squares) and
//             writes whether it is one.
//
// Replaces consensus_specs_tpu/ops/pairing_jax.py `pairing_check` in its
// fused form `_pairing_check_fused` (`_miller_scan` over `_double_step`,
// `_add_step` and `_line_to_fq12`; `_prod_reduce_raw`; `_easy_part`,
// `_hard_chain`, `_exp_by_neg_x_scan`; `fq12_is_one`), and with launch 2
// alone `miller_partial_products` / `fq12_product_is_one`.  The line
// scalings and the chain's order are the reference's, so the products equal
// the plain version's bit for bit.
//
// What bounds it: operations, the CIOS products' 32-bit multiplies: a
// Miller loop is about 7,000 Fq products, a final exponentiation about
// 9,000 (the exact count of a run comes from the plain version's counter).
// One thread a pair or a job holds an Fq12 (144 words) and the twist point
// in registers and local memory; a single Verify is one job of two pairs,
// so launch 2 runs on one thread.  Simple and right first: the sparse line
// product, the shared squaring of a job's pairs and a wider final
// exponentiation are later work.
//
// Layouts (int32 tensors read as uint32 words, Montgomery form):
// g1 [n, 2, 12] (xp, yp), g2 [n, 2, 2, 12] (xq, yq), skip uint8 [n],
// f [n, 12, 12]; launch 2 reads f as [b, k, 12, 12] and writes prod
// [b, 12, 12] and ok uint8 [b].

#include "bls381.cuh"

namespace {

__global__ void __launch_bounds__(64)
bls381_miller_kernel(const uint32_t* __restrict__ g1,
                     const uint32_t* __restrict__ g2,
                     const uint8_t* __restrict__ skip,
                     uint32_t* __restrict__ f, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  miller_elem(g1 + i * 2 * BLS_NW, g2 + i * 4 * BLS_NW, skip[i],
              f + i * 12 * BLS_NW);
}

__global__ void __launch_bounds__(64)
bls381_final_kernel(const uint32_t* __restrict__ f, int64_t k, int do_final,
                    uint32_t* __restrict__ prod, uint8_t* __restrict__ ok,
                    int64_t b) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= b) return;
  final_elem(f + j * k * 12 * BLS_NW, k, do_final, prod + j * 12 * BLS_NW,
             ok + j);
}

constexpr int kThreads = 64;

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry of launch 1: n pairs.  Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int bls381_miller_launch(const void* g1, const void* g2,
                                    const void* skip, void* f, int64_t n,
                                    void* stream) {
  if (n > 0) {
    bls381_miller_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(g1), static_cast<const uint32_t*>(g2),
        static_cast<const uint8_t*>(skip), static_cast<uint32_t*>(f), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of launch 2: b jobs of k >= 1 Miller values each.  `ok` is
// written only when do_final is nonzero.  Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int bls381_final_launch(const void* f, int64_t k, int do_final,
                                   void* prod, void* ok, int64_t b,
                                   void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0) {
    bls381_final_kernel<<<blocks_for(b), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), k, do_final,
        static_cast<uint32_t*>(prod), static_cast<uint8_t*>(ok), b);
  }
  return static_cast<int>(cudaGetLastError());
}
