"""The CUDA kernels' device functions, compiled as host C++, against the
plain torch version.

`ops/csrc/bls381.cuh` compiles without `__CUDACC__` as plain C++: the same
CIOS products, tower, point formulas, Miller steps and final
exponentiation that `bls381_field.cu`, `bls381_g2.cu` and
`bls381_pairing.cu`, `bls381_msm.cu` and `bls381_fold.cu` run on the
card.  This test builds a small shared library from it with the host's C++
compiler, loops the kernels' per-element bodies (`field_op_elem`,
`g2_ladder_elem`, `g1_ladder_elem`, `segment_step_elem` in the segment-sum
kernel's rounds, `fold_lane_elem` and `fold_tail_elem` around a segment
sum, `miller_elem`, `final_elem`) over seeded inputs, and holds every
output against the plain version (`bls381_cuda.FIELD_OPS`,
`curve_torch.point_scalar_mul`, `bls381_cuda.halving_sum`,
`pairing_torch._fold_lanes_plain`; the pairing launches in
tests/test_torch_pairing.py, on the Miller values its fixture computed) bit
for bit, so the kernels' arithmetic is checked on every run of the tests,
not only on the card.  Without a C++ compiler
on the host it skips with that reason.
"""
import ctypes
import math
import os
import random
import shutil
import subprocess

import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto import hash_to_curve as h2c
from consensus_specs_tpu_torch.crypto.fields import Q
from consensus_specs_tpu_torch.ops import (
    bls381_cuda, cuda_build, fq, pairing_torch)
from consensus_specs_tpu_torch.ops import curve_torch as ct

SEED = 2026
N = 4

HARNESS = r"""
#include "bls381.cuh"
extern "C" void field(int op, const uint32_t* a, const uint32_t* b,
                      uint32_t* out, int64_t n) {
  const int w = field_op_words(op);
  for (int64_t i = 0; i < n; ++i)
    field_op_elem(op, a + i * w, b ? b + i * w : nullptr, out + i * w);
}
extern "C" void ladder(const uint32_t* p, const uint8_t* bits, int64_t nbits,
                       uint32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    g2_ladder_elem(p + i * 72, bits + i * nbits, nbits, out + i * 72);
}
extern "C" void g1_ladder(const uint32_t* p, const uint8_t* bits,
                          int64_t nbits, uint32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    g1_ladder_elem(p + i * 36, bits + i * nbits, nbits, out + i * 36);
}
// the segment-sum kernel's rounds, one segment after another
extern "C" void segment_sum(int g2, uint32_t* buf, int64_t len,
                            uint32_t* out, int64_t segments) {
  const int64_t w = g2 ? 72 : 36;
  for (int64_t s = 0; s < segments; ++s) {
    uint32_t* seg = buf + s * len * w;
    for (int64_t h = len / 2; h >= 1; h /= 2)
      for (int64_t i = 0; i < h; ++i) {
        if (g2) segment_step_elem<fp2>(seg, i, h);
        else segment_step_elem<fp>(seg, i, h);
      }
    for (int64_t j = 0; j < w; ++j) out[s * w + j] = seg[j];
  }
}
// the fold's launch 1, the segment sum of sw and launch 3
extern "C" void fold(const uint32_t* agg, const uint8_t* cbits, int64_t nc,
                     const uint32_t* hq, const uint32_t* sig,
                     const uint8_t* hbits, int64_t nh, const uint32_t* consts,
                     uint32_t* g1, uint32_t* g2, uint8_t* skip, uint32_t* sw,
                     int64_t k) {
  for (int64_t i = 0; i < k; ++i)
    fold_lane_elem(agg + i * 36, cbits + i * nc, nc, hq + i * 72,
                   sig + i * 72, hbits, nh, consts, g1 + i * 24, g2 + i * 48,
                   skip + i, sw + i * 72);
  uint32_t S[72];
  segment_sum(1, sw, k, S, 1);
  fold_tail_elem(S, consts, g1 + k * 24, g2 + k * 48, skip + k);
}
extern "C" void miller(const uint32_t* g1, const uint32_t* g2,
                       const uint8_t* skip, uint32_t* f, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    miller_elem(g1 + i * 24, g2 + i * 48, skip[i], f + i * 144);
}
extern "C" void final(const uint32_t* f, int64_t k, int do_final,
                      uint32_t* prod, uint8_t* ok, int64_t b) {
  for (int64_t j = 0; j < b; ++j)
    final_elem(f + j * k * 144, k, do_final, prod + j * 144, ok + j);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build bls381.cuh with")
    out = tmp_path_factory.mktemp("bls381_host")
    src = out / "harness.cpp"
    src.write_text(HARNESS)
    lib_path = out / "libbls381_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-w",
                    "-I", cuda_build.CSRC, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.field.argtypes = [ctypes.c_int, p, p, p, i64]
    lib.ladder.argtypes = [p, p, i64, p, i64]
    lib.g1_ladder.argtypes = [p, p, i64, p, i64]
    lib.segment_sum.argtypes = [ctypes.c_int, p, i64, p, i64]
    lib.fold.argtypes = [p, p, i64, p, p, p, i64, p, p, p, p, p, i64]
    lib.miller.argtypes = [p, p, p, p, i64]
    lib.final.argtypes = [p, i64, ctypes.c_int, p, p, i64]
    return lib


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")


def _words(t):
    return fq.to_words(t).contiguous()


def _operand(rng, suffix):
    n = N * math.prod(suffix[:-1])
    vals = [rng.randrange(Q) for _ in range(n - 3)] + [0, 1, Q - 1]
    return fq.pack_mont(vals).reshape((N,) + suffix)


@pytest.mark.parametrize("op", list(bls381_cuda.FIELD_OPS))
def test_field_op_equals_the_plain_version(host_lib, op):
    suffix, arity, plain = bls381_cuda.FIELD_OPS[op]
    rng = random.Random(f"{SEED}-{op}")
    a = _operand(rng, suffix)
    b = _operand(rng, suffix) if arity == 2 else None
    if op.startswith("g"):
        a[2][2] = 0                       # infinity (Z = 0) on the left
        if b is not None:
            b[1] = a[1]                   # equal points: the doubling row
            b[3][2] = 0                   # infinity on the right
    wa = _words(a)
    wb = _words(b) if b is not None else None
    out = torch.empty_like(wa)
    host_lib.field(bls381_cuda._OP_CODE[op], wa.data_ptr(),
                   None if wb is None else wb.data_ptr(), out.data_ptr(), N)
    want = plain(a) if b is None else plain(a, b)
    assert torch.equal(fq.from_words(out), want)


def test_ladder_equals_the_plain_version(host_lib):
    pre = []
    for i in range(2):
        u0, u1 = h2c.hash_to_field_fq2(bytes([i]) * 9, 2, h2c.DST_G2)
        pre.append(h2c.iso_map(*h2c.sswu_map(u0))
                   + h2c.iso_map(*h2c.sswu_map(u1)))
    pts = ct.g2_pack(pre)
    bits = ct.scalars_to_bits([0xB5A9F, 0x1], 20)
    words = _words(torch.stack(pts, dim=1))
    out = torch.empty_like(words)
    host_lib.ladder(words.data_ptr(), bits.data_ptr(), 20, out.data_ptr(), 2)
    want = ct.point_scalar_mul(ct.F2, pts, bits)
    assert torch.equal(fq.from_words(out), torch.stack(want, dim=1))


def test_g1_ladder_equals_the_plain_version(host_lib):
    g1 = cv.g1_generator()
    pts = ct.g1_pack([g1 * 1234567, g1 * 89, cv.g1_infinity()])
    bits = ct.scalars_to_bits([0xF00DBEEF, 0x1, 0x3], 32)
    words = _words(torch.stack(pts, dim=1))
    out = torch.empty_like(words)
    host_lib.g1_ladder(words.data_ptr(), bits.data_ptr(), 32,
                       out.data_ptr(), 3)
    want = ct.point_scalar_mul(ct.F1, pts, bits)
    assert torch.equal(fq.from_words(out), torch.stack(want, dim=1))


def _segments(g, inf):
    """Three segments of four points: distinct points, one with an
    infinity, an equal pair (the doubling) and an opposite pair (the
    identity) in the halving's pairs."""
    a, b, c = g * 5, g * 11, g * 17
    return [[a, b, c, g], [inf, a, inf, a], [a, b, -a, c]]


@pytest.mark.parametrize("field", ["g1", "g2"])
def test_segment_sum_equals_the_plain_version(host_lib, field):
    if field == "g1":
        gen, inf, pack, F = cv.g1_generator(), cv.g1_infinity(), ct.g1_pack, ct.F1
    else:
        gen, inf, pack, F = cv.g2_generator(), cv.g2_infinity(), ct.g2_pack, ct.F2
    segs = _segments(gen, inf)
    pts = tuple(c.reshape((3, 4) + c.shape[1:])
                for c in pack([p for s in segs for p in s]))
    buf = _words(torch.stack(pts, dim=2))
    out = torch.empty((3,) + tuple(buf.shape[2:]), dtype=torch.int32)
    host_lib.segment_sum(int(field == "g2"), buf.data_ptr(), 4,
                         out.data_ptr(), 3)
    want = bls381_cuda.halving_sum(F, pts)
    assert torch.equal(fq.from_words(out), torch.stack(want, dim=1))


@pytest.mark.parametrize("case", ["valid lanes", "infinity sum"])
def test_fold_lanes_equal_the_plain_version(host_lib, case):
    """The fold's three launches (the segment sum between them) against
    `_fold_lanes_plain`, over a 12-bit stand-in for h_eff (the kernel walks
    whatever bits it is given): four lanes with an infinity aggregate, or
    two lanes whose signatures are infinity (S at infinity, its pair
    skipped)."""
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    if case == "valid lanes":
        aggs = [g1 * 3, cv.g1_infinity(), g1 * 7, g1 * 9]
        sigs = [g2 * 5, g2 * 6, cv.g2_infinity(), g2 * 8]
        coeffs = [0xDEADBEEF12345678, 1, 0xFFFFFFFFFFFFFFFF, 0x8000000000000001]
    else:
        aggs = [g1 * 3, g1 * 4]
        sigs = [cv.g2_infinity(), cv.g2_infinity()]
        coeffs = [0x1234, 0x5678]
    k = len(aggs)
    hq = [g2 * (21 + i) for i in range(k)]
    aggP, hP, sP = ct.g1_pack(aggs), ct.g2_pack(hq), ct.g2_pack(sigs)
    cbits = ct.scalars_to_bits(coeffs, 64)
    hbits = ct.scalars_to_bits([0xB2D], 12)[0]
    consts = pairing_torch._fold_consts()
    want = pairing_torch._fold_lanes_plain(aggP, cbits, hP, sP, hbits, consts)
    agg = _words(torch.stack(aggP, dim=1))
    hw = _words(torch.stack(hP, dim=1))
    sw_in = _words(torch.stack(sP, dim=1))
    cw = torch.cat([fq.to_words(c).reshape(-1) for c in consts]).contiguous()
    g1w = torch.empty((k + 1, 2, 12), dtype=torch.int32)
    g2w = torch.empty((k + 1, 2, 2, 12), dtype=torch.int32)
    skip = torch.empty(k + 1, dtype=torch.uint8)
    sw = torch.empty((k, 3, 2, 12), dtype=torch.int32)
    host_lib.fold(agg.data_ptr(), cbits.data_ptr(), 64, hw.data_ptr(),
                  sw_in.data_ptr(), hbits.data_ptr(), 12, cw.data_ptr(),
                  g1w.data_ptr(), g2w.data_ptr(), skip.data_ptr(),
                  sw.data_ptr(), k)
    p, q = fq.from_words(g1w), fq.from_words(g2w)
    got = (p[:, 0], p[:, 1], q[:, 0], q[:, 1], skip.to(torch.bool))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "infinity sum":
        assert want[4].tolist() == [False, False, True]
