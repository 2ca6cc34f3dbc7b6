// Dependent latency of one BLS12-381 Fq Montgomery product in one warp on
// the card, in three forms (scripts/torch_fq_product_latency.py builds and
// times it): the port's register-resident product with PTX carry chains
// (bls381_reg.cuh rq_mul), the portable CIOS body, and a carry-save form
// (column sums of 32-bit halves in 64-bit accumulators).  Each thread
// runs `iters` products, each on the previous one's result.

#include "bls381_reg.cuh"

namespace {

__device__ __forceinline__ void mul_portable(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b) {
  uint32_t t[RQ_W + 2];
#pragma unroll
  for (int i = 0; i < RQ_W + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < RQ_W; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[RQ_W];
    t[RQ_W] = (uint32_t)c;
    t[RQ_W + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * BLS_QINV;
    c = ((uint64_t)m * BLS_Q[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < RQ_W; ++j) {
      c += (uint64_t)m * BLS_Q[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[RQ_W];
    t[RQ_W - 1] = (uint32_t)c;
    t[RQ_W] = t[RQ_W + 1] + (uint32_t)(c >> 32);
  }
  uint32_t d[RQ_W], borrow = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    const uint64_t v = (uint64_t)t[i] - BLS_Q[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) r[i] = borrow ? t[i] : d[i];
}

__device__ __forceinline__ void mul_carry_save(uint32_t* r, const uint32_t* a,
                                               const uint32_t* b) {
  uint64_t c[2 * RQ_W];
#pragma unroll
  for (int k = 0; k < 2 * RQ_W; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < RQ_W; ++i)
#pragma unroll
    for (int j = 0; j < RQ_W; ++j) {
      const uint64_t p = (uint64_t)a[j] * b[i];
      c[i + j] += (uint32_t)p;
      c[i + j + 1] += p >> 32;
    }
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    const uint32_t m = (uint32_t)c[i] * BLS_QINV;
#pragma unroll
    for (int j = 0; j < RQ_W; ++j) {
      const uint64_t p = (uint64_t)m * BLS_Q[j];
      c[i + j] += (uint32_t)p;
      c[i + j + 1] += p >> 32;
    }
    c[i + 1] += c[i] >> 32;
  }
  uint32_t t[RQ_W], d[RQ_W], borrow = 0;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < RQ_W; ++k) {
    carry += c[RQ_W + k];
    t[k] = (uint32_t)carry;
    carry >>= 32;
  }
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) {
    const uint64_t v = (uint64_t)t[i] - BLS_Q[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
#pragma unroll
  for (int i = 0; i < RQ_W; ++i) r[i] = borrow ? t[i] : d[i];
}

template <int FORM>
__global__ void chain_kernel(uint32_t* data, int iters) {
  uint32_t x[RQ_W], y[RQ_W];
  const int t = threadIdx.x;
  for (int i = 0; i < RQ_W; ++i) {
    x[i] = data[t * 2 * RQ_W + i];
    y[i] = data[t * 2 * RQ_W + RQ_W + i];
  }
  for (int it = 0; it < iters; ++it) {
    if (FORM == 0) rq_mul(x, x, y);
    else if (FORM == 1) mul_portable(x, x, y);
    else mul_carry_save(x, x, y);
  }
  for (int i = 0; i < RQ_W; ++i) data[t * 2 * RQ_W + i] = x[i];
}

}  // namespace

// form 0: rq_mul, 1: portable CIOS, 2: carry-save; one block of `threads`
// threads, each reading (x, y) from data [threads, 24] words and writing
// x y^iters (Montgomery) back over x.
extern "C" int fq_chain_launch(int form, void* data, int iters, int threads,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* d = static_cast<uint32_t*>(data);
  if (form == 0) chain_kernel<0><<<1, threads, 0, s>>>(d, iters);
  else if (form == 1) chain_kernel<1><<<1, threads, 0, s>>>(d, iters);
  else chain_kernel<2><<<1, threads, 0, s>>>(d, iters);
  return static_cast<int>(cudaGetLastError());
}
