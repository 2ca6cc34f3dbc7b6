// SHA-256 gather-hash for Hopper (sm_90a): one round of a fused merkle sweep.
//
// Replaces consensus_specs_tpu/ops/sha256.py::_fused_rounds_device, the XLA
// program that runs every round of an incremental re-root on the device
// (each round gathers its pair inputs from a pool of chunks, hashes them and
// appends the digests to the pool for later rounds).  For round k of a
// sweep this kernel computes
//
//     pool[out_offset + i] = SHA-256(pool[idx_l[i]] || pool[idx_r[i]])
//
// for i < n_pairs, where every index names a literal row or an earlier
// round's output, so the rows a round reads lie below `out_offset` and the
// rows it writes at or above it: no row is both read and written in one
// launch.  The caller (ops/sha256.py fused_rounds) launches one round after
// the other on one stream, with no synchronize in between.
//
// It does not carry over the XLA program's shapes: the reference pads each
// round and the pool to powers of two and re-concatenates the pool every
// round, only to bound recompiles.  Here the caller allocates one
// int32[pool_rows + sum of round sizes, 8] buffer a sweep and each round
// writes its digests in place at an unpadded offset.
//
// What bounds it: integer work, as for sha256_pairs.cu.  A pair moves 104
// bytes (two 4-byte indices, two gathered 32-byte rows, one 32-byte digest)
// and costs the same two compressions (at least 2,288 instructions; as
// compiled 2,408 in its SASS, 2,047 on the integer pipe, which holds it).  The
// gathered rows are random, but each is a whole 32-byte sector (two 16-byte
// loads), so the gather costs no extra memory transactions per byte.
//   - one thread per pair, the two compressions in registers
//     (sha256_core.cuh, shared with the pair-hash kernel);
//   - each thread reads its two indices, then its two rows as four 16-byte
//     loads through the read-only path, and stores its digest as two; the
//     ragged edge is a bounds check.
//
// Words are host-order uint32 values inside an int32 tensor, as for
// sha256_pairs.cu.

#include "sha256_core.cuh"

namespace {

__global__ void __launch_bounds__(256)
sha256_gather_kernel(uint4* pool, const int32_t* __restrict__ idx_l,
                     const int32_t* __restrict__ idx_r, int64_t out_offset,
                     int64_t n_pairs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;

  const uint4* src = pool;
  const int64_t l = idx_l[i];
  const int64_t r = idx_r[i];
  const uint4 a = __ldg(src + 2 * l);
  const uint4 b = __ldg(src + 2 * l + 1);
  const uint4 c = __ldg(src + 2 * r);
  const uint4 d = __ldg(src + 2 * r + 1);
  uint32_t w[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                    c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
  uint32_t o[8];
  sha256_64byte(w, o);
  uint4* dst = pool + 2 * (out_offset + i);
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

}  // namespace

// Plain C entry: `pool` holds int32[rows, 8] (16-byte aligned) with rows >=
// out_offset + n_pairs; `idx_l` and `idx_r` hold n_pairs int32 row indices,
// each below out_offset.  Launches on `stream` and returns
// cudaGetLastError() as an int, so a refused launch is reported to the
// caller.
extern "C" int sha256_gather_launch(void* pool, const void* idx_l,
                                    const void* idx_r, int64_t out_offset,
                                    int64_t n_pairs, void* stream) {
  constexpr int kThreads = 256;
  if (n_pairs > 0) {
    const int64_t blocks = (n_pairs + kThreads - 1) / kThreads;
    sha256_gather_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint4*>(pool), static_cast<const int32_t*>(idx_l),
        static_cast<const int32_t*>(idx_r), out_offset, n_pairs);
  }
  return static_cast<int>(cudaGetLastError());
}
