// The windowed Pippenger G1 multi-scalar multiplication for Hopper
// (sm_90a): sum_i s_i P_i over n points, the KZG engine's commitments and
// proofs (crypto/kzg.py g1_lincomb over the 4,096-point Lagrange basis).
//
// Replaces consensus_specs_tpu/ops/msm.py `_pippenger_g1`, one XLA program
// of 8-bit windows (32), 16 bucket-table lanes a window and 255 buckets,
// whose order of additions is an implementation detail of that program:
// the path consumes only the result's affine (compressed) bytes, which any
// order gives.  So the kernel groups the work for the card instead, in
// five launches (bodies and layouts in bls381_pippenger.cuh):
//
//   1. bucket: a block of 256 threads a window, a thread a bucket: the
//      window's point indices grouped by digit (counts, exclusive scans,
//      a stable scatter) and the bucket of each work item of at most
//      kChunk points;
//   2. sums: a thread a (window, bucket, chunk) item, its chunk summed by
//      mixed adds;
//   3. tree: a block a window: each bucket's chunk sums by a tree, then the
//      255 bucket sums B_b;
//   4. bits: a block of 64 threads a (window, bit j): T_j = sum of the B_b
//      with bit j of b set, a tree over 128 buckets;
//   5. horner: one block, a thread a window for G_w = sum_j 2^j T_j, then
//      one thread's Horner over the 32 windows.
//
// What bounds it: operations, the CIOS products of the point formulas
// (bls381.cuh pt_add, 16 products; pip_madd, 11; pt_double, 7), each a
// dependent chain of 32-bit multiplies with carries that takes about 2-3 us
// a product in one thread on this card, whatever its form.  So the design
// bounds each thread's chain and runs many chains at once: a chunk is at
// most kChunk - 1 dependent adds whatever the scalars (equal scalars put a
// window's n points in one bucket), a bucket's chunks and a bit's 128
// buckets are trees of log2 depth, and the window sum is 7 doublings and 7
// adds in place of the 2 x 255 adds of running sums.  Horner over the 32
// window sums stays one chain of 248 doublings and 31 adds (about 2,200
// products, about 4 ms at 1.7 us a product): the design's floor.  No
// tensor-core (wgmma) or TMA form fits this work: a product is a chain of
// dependent 381-bit multiply-adds with carries, not a tile of independent
// products, and the bucketing scatters each point to the bucket its digit
// names.
//
// The scratch arrays are the caller's (ops/bls381_cuda.py
// `pippenger_scratch`); every slot a launch reads an earlier launch of the
// same call writes first.

#include "bls381_pippenger.cuh"

namespace {

constexpr int kWindowBits = 8;
constexpr int kChunk = 16;
using Shape = pip_shape<kWindowBits, kChunk>;
constexpr int kBucketThreads = Shape::kSlots;       // a thread a bucket
constexpr int kSumThreads = 32;
constexpr int kTreeThreads = 256;
constexpr int kBitThreads = Shape::kLeaves / 2;     // a thread a leaf pair
constexpr int kHornerThreads = Shape::kWindows;     // a thread a window

__global__ void __launch_bounds__(kBucketThreads)
bls381_pippenger_bucket_kernel(const uint8_t* __restrict__ digits, int64_t n,
                               int32_t* __restrict__ idx,
                               int32_t* __restrict__ bstart,
                               int32_t* __restrict__ istart,
                               int32_t* __restrict__ item_bucket) {
  __shared__ int32_t sh[2 * (Shape::kSlots + 1)];
  pip_bucket<kWindowBits, kChunk>(digits, n, idx, bstart, istart,
                                  item_bucket, sh, blockIdx.x, threadIdx.x,
                                  blockDim.x);
}

__global__ void __launch_bounds__(kSumThreads)
bls381_pippenger_sums_kernel(const uint32_t* __restrict__ pts, int64_t n,
                             const int32_t* __restrict__ idx,
                             const int32_t* __restrict__ bstart,
                             const int32_t* __restrict__ istart,
                             const int32_t* __restrict__ item_bucket,
                             uint32_t* __restrict__ partial) {
  const int64_t m = Shape::items(n);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (e >= Shape::kWindows * m) return;
  pip_bucket_sum<kWindowBits, kChunk>(pts, n, idx, bstart, istart,
                                      item_bucket, partial,
                                      static_cast<int>(e / m), e % m);
}

__global__ void __launch_bounds__(kTreeThreads)
bls381_pippenger_tree_kernel(uint32_t* partial, int64_t n,
                             const int32_t* __restrict__ istart,
                             const int32_t* __restrict__ item_bucket,
                             uint32_t* __restrict__ B) {
  pip_bucket_tree<kWindowBits, kChunk>(partial, n, istart, item_bucket, B,
                                       blockIdx.x, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kBitThreads)
bls381_pippenger_bits_kernel(const uint32_t* __restrict__ B, uint32_t* tbuf,
                             uint32_t* __restrict__ T) {
  pip_bit_tree<kWindowBits, kChunk>(B, tbuf, T, blockIdx.x / kWindowBits,
                                    blockIdx.x % kWindowBits, threadIdx.x,
                                    blockDim.x);
}

__global__ void __launch_bounds__(kHornerThreads)
bls381_pippenger_horner_kernel(const uint32_t* __restrict__ T, uint32_t* G,
                               uint32_t* __restrict__ out) {
  pip_horner<kWindowBits, kChunk>(T, G, out, threadIdx.x, blockDim.x);
}

}  // namespace

// Plain C entry of the five launches of one MSM of n points (36 words
// each) by their digits [32, n], on `stream`, into out [36]; the scratch
// (layouts in bls381_pippenger.cuh, m = 255 + ceil(n / 16)): idx [32, n],
// bstart and istart [32, 257], item_bucket [32, m] int32, partial
// [32, m, 36], B [32, 256, 36], tbuf [32, 8, 64, 36], T [32, 8, 36],
// G [32, 36].  `stage` picks one launch (1-5) or, 0, all five in order.
// Returns cudaGetLastError() as an int after the last launch (each launch
// is checked; the first refused one returns).
extern "C" int bls381_pippenger_launch(
    const void* pts, const void* digits, int64_t n, void* idx, void* bstart,
    void* istart, void* item_bucket, void* partial, void* B, void* tbuf,
    void* T, void* G, void* out, int stage, void* stream) {
  if (n < 1 || stage < 0 || stage > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t items = Shape::kWindows * Shape::items(n);
  cudaError_t rc = cudaSuccess;
  if (stage == 0 || stage == 1) {
    bls381_pippenger_bucket_kernel<<<Shape::kWindows, kBucketThreads, 0, s>>>(
        static_cast<const uint8_t*>(digits), n, static_cast<int32_t*>(idx),
        static_cast<int32_t*>(bstart), static_cast<int32_t*>(istart),
        static_cast<int32_t*>(item_bucket));
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  }
  if (stage == 0 || stage == 2) {
    bls381_pippenger_sums_kernel<<<
        static_cast<unsigned int>((items + kSumThreads - 1) / kSumThreads),
        kSumThreads, 0, s>>>(
        static_cast<const uint32_t*>(pts), n,
        static_cast<const int32_t*>(idx), static_cast<const int32_t*>(bstart),
        static_cast<const int32_t*>(istart),
        static_cast<const int32_t*>(item_bucket),
        static_cast<uint32_t*>(partial));
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  }
  if (stage == 0 || stage == 3) {
    bls381_pippenger_tree_kernel<<<Shape::kWindows, kTreeThreads, 0, s>>>(
        static_cast<uint32_t*>(partial), n,
        static_cast<const int32_t*>(istart),
        static_cast<const int32_t*>(item_bucket), static_cast<uint32_t*>(B));
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  }
  if (stage == 0 || stage == 4) {
    bls381_pippenger_bits_kernel<<<Shape::kWindows * kWindowBits,
                                   kBitThreads, 0, s>>>(
        static_cast<const uint32_t*>(B), static_cast<uint32_t*>(tbuf),
        static_cast<uint32_t*>(T));
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  }
  if (stage == 0 || stage == 5) {
    bls381_pippenger_horner_kernel<<<1, kHornerThreads, 0, s>>>(
        static_cast<const uint32_t*>(T), static_cast<uint32_t*>(G),
        static_cast<uint32_t*>(out));
    rc = cudaGetLastError();
  }
  return static_cast<int>(rc);
}
