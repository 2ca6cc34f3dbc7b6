// The windowed Pippenger G1 multi-scalar multiplication for Hopper
// (sm_90a): sum_i s_i P_i over n points, the KZG engine's commitments and
// proofs (crypto/kzg.py g1_lincomb over the 4,096-point Lagrange basis).
//
// Replaces consensus_specs_tpu/ops/msm.py `_pippenger_g1`, one XLA program
// of 8-bit windows (32), 16 bucket-table lanes a window and 255 buckets.
// Three launches, in the reference's order of additions
// (bls381_pippenger.cuh), so the Jacobian output equals the plain version's
// (ops/msm.py `_pippenger_g1`) bit for bit:
//
//   1. the fold: 512 threads, one a (window, table lane), each folding its
//      chunk of n / 16 points into its private 256-slot table in global
//      memory ([32, 16, 256, 36] words, 18.9 MB);
//   2. the window: one block a window, the four merge rounds over the
//      lanes, then the two suffix scans of eight rounds over the 255
//      bucket sums through two buffers, a barrier after each round, and
//      the window's sum G_w;
//   3. Horner: one thread, 32 windows of 8 doublings and an add.
//
// What bounds it: operations, the CIOS products of the point formulas
// (bls381.cuh pt_add, 16 products; pt_double, 7), each a dependent chain
// of 32-bit multiplies with carries.  The function needs 32 (n + 2 * 255)
// adds at most and Horner's 256 doublings and 32 adds; the kernel also
// runs the merge rounds' 15 * 255 adds a window and the scans' n log n
// form (about 3,600 adds a window instead of 510).  No tensor-core or TMA
// form fits this work: a product is a chain of dependent 381-bit
// multiply-adds with carries, not a tile of independent products, and the
// fold scatters each point to the bucket its digit names.  Simple and right
// first: launch 1 runs 512 threads on a card of 132 SMs, each a chain of
// n / 16 dependent adds, and launch 3 one thread.
//
// Layouts: bls381_pippenger.cuh.  The tables and scan buffers are scratch
// the caller allocates; every slot launch 1 reads it writes first.

#include "bls381_pippenger.cuh"

namespace {

constexpr int kWindowBits = 8;
constexpr int kLanes = 16;
using Shape = pip_shape<kWindowBits, kLanes>;
constexpr int kFoldThreads = 32;
constexpr int kWindowThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
bls381_pippenger_fold_kernel(const uint32_t* __restrict__ pts,
                             const uint8_t* __restrict__ digits, int64_t n,
                             uint32_t* __restrict__ tables) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= Shape::kWindows * kLanes) return;
  pip_fold_lane<kWindowBits, kLanes>(pts, digits, n, tables, lane / kLanes,
                                     lane % kLanes);
}

__global__ void __launch_bounds__(kWindowThreads)
bls381_pippenger_window_kernel(uint32_t* tables, uint32_t* scan,
                               uint32_t* G) {
  pip_window<kWindowBits, kLanes>(tables, scan, G, blockIdx.x, threadIdx.x,
                                  blockDim.x);
}

__global__ void __launch_bounds__(1)
bls381_pippenger_horner_kernel(const uint32_t* __restrict__ G,
                               uint32_t* __restrict__ out) {
  pip_horner<kWindowBits, kLanes>(G, out);
}

}  // namespace

// Plain C entry of launch 1: n points (36 words each, n a multiple of 16)
// and their digits [32, n] folded into tables [32, 16, 256, 36].  Launches
// on `stream` and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for n not a multiple of 16).
extern "C" int bls381_pippenger_fold_launch(const void* pts,
                                            const void* digits, int64_t n,
                                            void* tables, void* stream) {
  if (n < 0 || n % kLanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int lanes = Shape::kWindows * kLanes;
  bls381_pippenger_fold_kernel<<<lanes / kFoldThreads, kFoldThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pts), static_cast<const uint8_t*>(digits),
      n, static_cast<uint32_t*>(tables));
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of launch 2: each window's tables merged and scanned (tables
// overwritten, scan [32, 2, 255, 36] scratch), its sum written to G [32, 36].
extern "C" int bls381_pippenger_window_launch(void* tables, void* scan,
                                              void* G, void* stream) {
  bls381_pippenger_window_kernel<<<Shape::kWindows, kWindowThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(tables), static_cast<uint32_t*>(scan),
      static_cast<uint32_t*>(G));
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of launch 3: Horner over G [32, 36] into out [36].
extern "C" int bls381_pippenger_horner_launch(const void* G, void* out,
                                              void* stream) {
  bls381_pippenger_horner_kernel<<<1, 1, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(G), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
