"""The CUDA kernels' device functions, compiled as host C++, against the
plain torch version.

`ops/csrc/bls381.cuh` compiles without `__CUDACC__` as plain C++: the same
CIOS products, tower, point formulas, Miller steps and final
exponentiation that `bls381_field.cu`, `bls381_g2.cu` and
`bls381_pairing.cu` run on the card.  This test builds a small shared
library from it with the host's C++ compiler, loops the kernels'
per-element bodies (`field_op_elem`, `g2_ladder_elem`, `miller_elem`,
`final_elem`) over seeded inputs, and holds every output against the
plain version (`bls381_cuda.FIELD_OPS`, `curve_torch.point_scalar_mul`;
the pairing launches in tests/test_torch_pairing.py, on the Miller values
its fixture computed) bit for bit, so the kernels' arithmetic is checked
on every run of the tests, not only on the card.  Without a C++ compiler
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
from consensus_specs_tpu_torch.crypto import hash_to_curve as h2c
from consensus_specs_tpu_torch.crypto.fields import Q
from consensus_specs_tpu_torch.ops import bls381_cuda, cuda_build, fq
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
