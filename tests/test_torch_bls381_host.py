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
not only on the card.  The redesigned kernels' bodies come from
`bls381_reg.cuh` and `bls381_check.cuh`, the same sources as
`bls381_cofactor.cu` and `bls381_check.cu`: `cofactor_elem` a point, and
`check_job`, whose warp levels run for lanes 0..31 in turn here (the
portable product stands in for the PTX carry chains).  The Pippenger MSM's
three launches come from `bls381_pippenger.cuh`, the source of
`bls381_pippenger.cu`, instantiated at 4-bit windows and 4 lanes (held bit
for bit against ops/msm.py `_pippenger_g1` at the same parameters) and at
the kernel's 8-bit windows and 16 lanes (held against the host oracle
`crypto/curve.msm`); the window launch runs with one thread, which walks
every element of each round.  Without a C++ compiler on the host it skips
with that reason.
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
from consensus_specs_tpu_torch.crypto.fields import Q, R
from consensus_specs_tpu_torch.ops import (
    bls381_cuda, bls_cuda, cuda_build, fq, msm, pairing_torch)
from consensus_specs_tpu_torch.ops import curve_torch as ct
from consensus_specs_tpu_torch.ops import fq_tower as ft

SEED = 2026
N = 4

HARNESS = r"""
#include "bls381_check.cuh"
#include "bls381_pippenger.cuh"
#include <stdlib.h>
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
// bls381_reg.cuh's Fq product and binary-GCD inverse, an element each
extern "C" void reg_mul_inv(const uint32_t* a, const uint32_t* b,
                            uint32_t* prod, uint32_t* inv, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    rq_mul(prod + i * 12, a + i * 12, b + i * 12);
    rq_inv(inv + i * 12, a + i * 12);
  }
}
// bls381_cofactor.cu's body, a point after another
extern "C" void cofactor(const uint32_t* p, const uint32_t* consts,
                         uint32_t* xy, uint8_t* inf, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    cofactor_elem(p + i * 72, consts, xy + i * 48, inf + i);
}
// bls381_check.cu's body, a job after another, each level's lanes in turn
extern "C" void check(const uint32_t* g1, const uint32_t* g2,
                      const uint8_t* skip, uint32_t* tq, int64_t k,
                      uint32_t* prod, uint8_t* ok, int64_t b) {
  check_smem* s = (check_smem*)malloc(sizeof(check_smem));
  for (int64_t job = 0; job < b; ++job) {
    check_job_args j;
    j.g1 = g1 + job * k * 24;
    j.g2 = g2 + job * k * 48;
    j.skip = skip + job * k;
    j.tq = tq + job * k * 72;
    j.k = k;
    check_job(s, j, prod + job * 144, ok + job);
  }
  free(s);
}
// bls381_pippenger.cu's three launches: every lane's fold, each window's
// merge and scans by one thread, Horner
template <int WB, int T>
static void pip_run(const uint32_t* pts, const uint8_t* digits, int64_t n,
                    uint32_t* out) {
  using S = pip_shape<WB, T>;
  uint32_t* tables = (uint32_t*)malloc(
      sizeof(uint32_t) * S::kWindows * T * S::kSlots * PIP_PW);
  uint32_t* scan = (uint32_t*)malloc(
      sizeof(uint32_t) * S::kWindows * 2 * S::kBuckets * PIP_PW);
  uint32_t G[S::kWindows * PIP_PW];
  for (int w = 0; w < S::kWindows; ++w)
    for (int t = 0; t < T; ++t)
      pip_fold_lane<WB, T>(pts, digits, n, tables, w, t);
  for (int w = 0; w < S::kWindows; ++w)
    pip_window<WB, T>(tables, scan, G, w, 0, 1);
  pip_horner<WB, T>(G, out);
  free(tables);
  free(scan);
}
extern "C" void pippenger(int small, const uint32_t* pts,
                          const uint8_t* digits, int64_t n, uint32_t* out) {
  if (small) pip_run<4, 4>(pts, digits, n, out);
  else pip_run<8, 16>(pts, digits, n, out);
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
    lib.reg_mul_inv.argtypes = [p, p, p, p, i64]
    lib.cofactor.argtypes = [p, p, p, p, i64]
    lib.check.argtypes = [p, p, p, p, i64, p, p, i64]
    lib.pippenger.argtypes = [ctypes.c_int, p, p, i64, p]
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


def test_register_product_and_inverse_equal_the_plain_version(host_lib):
    """bls381_reg.cuh's inlined product (the portable body here) and its
    binary-GCD inverse against `fq.mul` and the plain Fermat inverse, on
    seeded elements with 0, 1 (Montgomery), q - 1 and the integer 1."""
    rng = random.Random(f"{SEED}-reg")
    vals = [0, fq.R_MONT, Q - 1, 1] + [rng.randrange(Q) for _ in range(12)]
    n = len(vals)
    a = fq.pack(vals)                    # the words as they are
    b = fq.pack([rng.randrange(Q) for _ in range(n)])
    wa, wb = _words(a), _words(b)
    prod, inv = torch.empty_like(wa), torch.empty_like(wa)
    host_lib.reg_mul_inv(wa.data_ptr(), wb.data_ptr(), prod.data_ptr(),
                         inv.data_ptr(), n)
    assert torch.equal(fq.from_words(prod), fq.mul(a, b))
    assert torch.equal(fq.from_words(inv), ft.fq_inv(a))


# the cofactor of G2 in E'(Fq2): 13^2 23^2 2713 11953 262069 times a large
# prime
G2_COFACTOR = int(
    "5d543a95414e7f1091d50792876a202cd91de4547085abaa68a205b2e5a7ddfa628f1c"
    "b4d9e82ef21537e293a6691ae1616ec6e786f0c70cf1c38e31c7238e5", 16)


def cofactor_rows():
    """Points of E'(Fq2) for the cofactor kernel: two hashed points before
    their cofactor clearing (not in G2), the point at infinity and a point
    of order 169, whose multiplications by x meet opposite and infinite
    inputs in their adds and whose h_eff multiple is infinity."""
    pre = []
    for i in (0, 1, 2):
        u0, u1 = h2c.hash_to_field_fq2(bytes([i]) * 3, 2, h2c.DST_G2)
        pre.append(h2c.iso_map(*h2c.sswu_map(u0))
                   + h2c.iso_map(*h2c.sswu_map(u1)))
    return [pre[0], pre[1], cv.g2_infinity(),
            pre[2] * (G2_COFACTOR * R // 169)]


def test_cofactor_elem_equals_the_plain_versions_and_the_oracle(host_lib):
    """bls381_cofactor.cu's body (psi, then affine) against its plain
    version, the plain h_eff ladder made affine, and the JAX package's
    oracle `crypto.hash_to_curve.clear_cofactor`, bit for bit on the
    affine words and the infinity flags."""
    from consensus_specs_tpu.crypto import hash_to_curve as ref_h2c
    from consensus_specs_tpu.crypto import curve as ref_cv
    rows = cofactor_rows()
    pts = ct.g2_pack(rows)
    words = _words(torch.stack(pts, dim=1))
    consts = _words(ct.psi_consts())
    xy = torch.empty((len(rows), 2, 2, 12), dtype=torch.int32)
    inf = torch.empty(len(rows), dtype=torch.uint8)
    host_lib.cofactor(words.data_ptr(), consts.data_ptr(), xy.data_ptr(),
                      inf.data_ptr(), len(rows))
    got = fq.from_words(xy)
    x, y, want_inf = ct.clear_cofactor_g2_plain(pts)
    assert torch.equal(got[:, 0], x) and torch.equal(got[:, 1], y)
    assert inf.tolist() == want_inf.to(torch.uint8).tolist() == [0, 0, 1, 1]
    bits = torch.from_numpy(bls_cuda._H_EFF_BITS).expand(len(rows), -1)
    zero = torch.zeros(2, 32, dtype=torch.int64)
    lx, ly, linf = pairing_torch._g2_jacobian_to_affine(
        ct.point_scalar_mul(ct.F2, pts, bits), zero, zero)
    assert torch.equal(got[:, 0], lx) and torch.equal(got[:, 1], ly)
    assert torch.equal(linf, want_inf)
    xs, ys = ft.fq2_unpack_mont(got[:, 0]), ft.fq2_unpack_mont(got[:, 1])
    for i, p in enumerate(rows):
        ref_p = ref_cv.Point(ref_cv.Fq2(p.x.c0, p.x.c1),
                             ref_cv.Fq2(p.y.c0, p.y.c1),
                             ref_cv.Fq2(p.z.c0, p.z.c1), ref_cv.B2)
        want = ref_h2c.clear_cofactor(ref_p)
        if want.is_infinity():
            assert inf[i] == 1
            continue
        wx, wy = want.affine()
        assert (xs[i].c0, xs[i].c1) == (wx.c0, wx.c1)
        assert (ys[i].c0, ys[i].c1) == (wy.c0, wy.c1)


def _check_jobs(case):
    """(jobs [(pairs, skips)], expected verdicts) for the four-warp check:
    "b2k2" a valid job and an invalid job whose first pair is skipped;
    "k5" one valid job of five pairs, one skipped, over two chunks of the
    kernel's four pair slots."""
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    a, b = 0x1234567, 0x89ABCDE
    if case == "b2k2":
        return [([(g1 * a, g2 * b), (-(g1 * (a * b)), g2)], [False, False]),
                ([(g1 * 5, g2 * 7), (g1 * a, g2)], [True, False])], \
            [True, False]
    pairs = [(g1 * (a + i), g2 * (3 + i)) for i in range(3)]
    total = sum((a + i) * (3 + i) for i in range(3))
    pairs += [(g1 * 11, g2 * 13), (-(g1 * total), g2)]
    return [(pairs, [False, False, False, True, False])], [True]


@pytest.mark.parametrize("case", ["b2k2", "k5"])
def test_check_job_levels_equal_miller_and_product_final(host_lib, case):
    """bls381_check.cu's warp levels, each run for lanes 0..31 in turn:
    the product of the job's Miller values before the final
    exponentiation and the verdict, against `pairing_torch.miller_loop`
    and `product_final` and against the plain version `check_plain`."""
    jobs, expected = _check_jobs(case)
    b, k = len(jobs), len(jobs[0][0])
    xs1, ys1, xs2, ys2, skips = [], [], [], [], []
    for pairs, skip in jobs:
        for (p, q), s in zip(pairs, skip):
            (x1, y1), (x2, y2) = p.affine(), q.affine()
            xs1.append(x1.v)
            ys1.append(y1.v)
            xs2.append(x2)
            ys2.append(y2)
            skips.append(s)
    xp, yp = fq.pack_mont(xs1), fq.pack_mont(ys1)
    xq, yq = ft.fq2_pack_mont(xs2), ft.fq2_pack_mont(ys2)
    skip = torch.tensor(skips)
    g1w = _words(torch.stack([xp, yp], 1))
    g2w = _words(torch.stack([xq, yq], 1))
    skip8 = skip.to(torch.uint8).contiguous()
    tq = torch.empty((b * k, 72), dtype=torch.int32)
    prod = torch.empty((b, 12, 12), dtype=torch.int32)
    ok = torch.zeros(b, dtype=torch.uint8)
    host_lib.check(g1w.data_ptr(), g2w.data_ptr(), skip8.data_ptr(),
                   tq.data_ptr(), k, prod.data_ptr(), ok.data_ptr(), b)
    f = pairing_torch.miller_loop(xp, yp, xq, yq, skip)
    want_prod, want_ok = pairing_torch.product_final(f.reshape(b, k, 12, 32))
    assert torch.equal(fq.from_words(prod), want_prod)
    assert ok.tolist() == [int(v) for v in want_ok] == \
        [int(v) for v in expected]
    plain_prod, plain_ok = pairing_torch.check_plain(
        xp.reshape(b, k, 32), yp.reshape(b, k, 32),
        xq.reshape(b, k, 2, 32), yq.reshape(b, k, 2, 32), skip.reshape(b, k))
    assert torch.equal(plain_prod, want_prod)
    assert plain_ok.tolist() == expected


def _msm_rows(n, w_bits):
    """n points (decoded from bytes, 8 distinct) and scalars with the
    reference test's edge rows: 0, 1, r - 1, the lowest window alone, the
    highest window alone, and an infinity point."""
    rng = random.Random(f"{SEED}-msm-{n}")
    g = cv.g1_generator()
    base = [cv.g1_from_bytes(cv.g1_to_bytes(g * rng.randrange(1, R)),
                             subgroup_check=False) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[:5] = [0, 1, R - 1, (1 << w_bits) - 1, 1 << (256 - w_bits)]
    pts[5] = cv.g1_infinity()
    return pts, scalars


def _pippenger_host(host_lib, pt, digits, small):
    words = _words(torch.stack(pt, dim=1))
    d8 = digits.to(torch.uint8).contiguous()
    out = torch.empty((3, 12), dtype=torch.int32)
    host_lib.pippenger(int(small), words.data_ptr(), d8.data_ptr(),
                       pt[0].shape[0], out.data_ptr())
    return fq.from_words(out)


def test_pippenger_bodies_equal_the_plain_version(host_lib):
    """At 4-bit windows and 4 lanes, 12 points padded to 16: the Jacobian
    words of the three launches' bodies equal `_pippenger_g1`'s."""
    pts, scalars = _msm_rows(12, 4)
    pt, digits = msm._pippenger_inputs(pts, scalars, "cpu", 4, 4)
    got = _pippenger_host(host_lib, pt, digits, True)
    want = msm._pippenger_g1(*pt, digits, w_bits=4, threads=4)
    assert torch.equal(got, torch.stack(want))


def test_pippenger_bodies_equal_the_oracle_at_full_windows(host_lib):
    """At the kernel's 8-bit windows and 16 lanes and 256 points: the
    result's compressed bytes equal `crypto/curve.msm`'s."""
    pts, scalars = _msm_rows(256, 8)
    pt, digits = msm._pippenger_inputs(pts, scalars, "cpu")
    got = _pippenger_host(host_lib, pt, digits, False)
    point = ct.g1_unpack(tuple(c[None] for c in got))[0]
    assert cv.g1_to_bytes(point) == cv.g1_to_bytes(cv.msm(pts, scalars))
