"""The port's KZG engine against the JAX package's.

The same width-16 dev setup (the JAX package's `utils/kzg_setup_gen`
`generate_setup`, secret 1337, crossed as its dict of hex strings) and the
same seeded blobs go into the port's `crypto/kzg.KZG`, with its device MSM
installed at threshold 1 (`g1_multi_exp`: on the CPU the lanes engine's
plain versions, the G1 ladder and the segment sum), and into the JAX
package's host KZG (no device MSM).  Commitments, proofs, `verify_kzg_proof`
and `verify_blob_kzg_proof_batch` verdicts (valid, and with two proofs
swapped: the batch fails and is re-checked blob by blob) must be equal byte
for byte, and so must the `kzg_pairing_legs` and `kzg_batch_attributions`
counters.  The BLS shim's `multi_exp` on the device backend equals the
reference's.  Under `slow`: a width-256 KZG whose commitments run the plain
Pippenger engine at the reference's parameters (about 8 minutes here).
"""
import filecmp
import os

import numpy as np
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.crypto import kzg as ref_kzg
from consensus_specs_tpu.sigpipe.metrics import METRICS as REF_METRICS
from consensus_specs_tpu.utils.kzg_setup_gen import generate_setup
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.crypto import kzg
from consensus_specs_tpu_torch.crypto.fields import R
from consensus_specs_tpu_torch.ops import bls381_cuda, curve_torch, msm
from consensus_specs_tpu_torch.sigpipe import METRICS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 16
SECRET = 1337
SEED = 2026


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.set_device("cpu")
    kzg.set_device_msm(kzg._default_device_msm)


@pytest.fixture(scope="module")
def engines():
    setup = generate_setup(WIDTH, SECRET)
    return kzg.KZG(WIDTH, setup=setup), ref_kzg.KZG(WIDTH, setup=setup)


def _blobs(n, width, seed):
    """n blobs of canonical field elements: 31 seeded low bytes each, as
    bench.py makes them."""
    rng = np.random.default_rng([SEED, seed])
    out = []
    for _ in range(n):
        elems = rng.integers(0, 256, size=(width, 32), dtype=np.uint8)
        elems[:, 0] = 0
        out.append(elems.tobytes())
    return out


def _legs(snapshot):
    legs = snapshot.get("kzg_pairing_legs", {})
    return (legs.get("count", 0), legs.get("total", 0),
            snapshot.get("kzg_batch_attributions", 0))


def test_port_reads_its_own_ceremony_setup():
    path = os.path.realpath(kzg._SETUP_PATH)
    assert path.startswith(os.path.join(ROOT, "consensus_specs_tpu_torch"))
    assert filecmp.cmp(path, os.path.realpath(ref_kzg._SETUP_PATH),
                       shallow=False)
    assert kzg._device_msm is kzg._default_device_msm
    assert kzg._device_msm_threshold == 128


def test_blob_path_equals_the_reference_byte_for_byte(engines):
    mine, ref = engines
    ref_kzg.set_device_msm(None)
    kzg.use_tpu_msm(threshold=1)
    blobs = _blobs(2, WIDTH, 1)

    before = bls381_cuda.g1_ladder.plain_calls
    commitments = [mine.blob_to_kzg_commitment(b) for b in blobs]
    assert commitments == [ref.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [mine.compute_blob_kzg_proof(b, c)
              for b, c in zip(blobs, commitments)]
    assert proofs == [ref.compute_blob_kzg_proof(b, c)
                      for b, c in zip(blobs, commitments)]
    # four MSMs of 16 points on the device MSM: the lanes engine here
    assert bls381_cuda.g1_ladder.plain_calls == before + 4

    z = kzg.bls_field_to_bytes(123456789)
    proof, y = mine.compute_kzg_proof(blobs[0], z)
    assert (proof, y) == ref.compute_kzg_proof(blobs[0], z)
    wrong_y = kzg.bls_field_to_bytes(
        (kzg.bytes_to_bls_field(y) + 1) % R)
    for y_bytes, want in ((y, True), (wrong_y, False)):
        assert mine.verify_kzg_proof(commitments[0], z, y_bytes, proof) \
            is want
        assert ref.verify_kzg_proof(commitments[0], z, y_bytes, proof) \
            is want

    swapped = [proofs[1], proofs[0]]
    for case, batch, want in (("valid", proofs, True),
                              ("swapped", swapped, False)):
        METRICS.reset()
        REF_METRICS.reset()
        got = mine.verify_blob_kzg_proof_batch(blobs, commitments, batch)
        assert got is want, case
        assert ref.verify_blob_kzg_proof_batch(blobs, commitments,
                                               batch) is want, case
        assert _legs(METRICS.snapshot()) == _legs(REF_METRICS.snapshot())
        assert _legs(METRICS.snapshot()) == (
            (1, 2, 0) if want else (2, 6, 1)), case


def test_device_failure_raises_without_a_host_fallback(engines,
                                                     monkeypatch):
    """On the default device with no card, a commitment through the device
    MSM raises: the host Pippenger does not stand in."""
    import torch
    mine, _ref = engines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kzg.use_tpu_msm(threshold=1)
    port.set_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA card"):
        mine.blob_to_kzg_commitment(_blobs(1, WIDTH, 3)[0])
    kzg.set_device_msm(None)
    assert len(mine.blob_to_kzg_commitment(_blobs(1, WIDTH, 3)[0])) == 48


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_shim_multi_exp_on_the_device_backend_equals_the_reference(
        group, monkeypatch):
    from consensus_specs_tpu.crypto import curve as ref_cv
    from consensus_specs_tpu.utils import bls as ref_shim
    from consensus_specs_tpu_torch.utils import bls as shim
    k = (1, 7, 11, 13)
    scalars = [5, 6, 7, 8]
    if group == "g1":
        pts = [cv.g1_generator() * i for i in k]
        ref_pts = [ref_cv.g1_generator() * i for i in k]
        enc, ref_enc = cv.g1_to_bytes, ref_cv.g1_to_bytes
        wrapper = bls381_cuda.g1_ladder
    else:
        pts = [cv.g2_generator() * i for i in k]
        ref_pts = [ref_cv.g2_generator() * i for i in k]
        enc, ref_enc = cv.g2_to_bytes, ref_cv.g2_to_bytes
        wrapper = bls381_cuda.g2_ladder
    want = ref_enc(ref_shim.multi_exp(ref_pts, scalars))   # native
    monkeypatch.setattr(shim, "_backend_name", "cuda")
    before = wrapper.plain_calls
    assert enc(shim.multi_exp(pts, scalars)) == want       # below threshold
    assert wrapper.plain_calls == before
    monkeypatch.setattr(shim, "MULTI_EXP_DEVICE_THRESHOLD", 1)
    assert enc(shim.multi_exp(pts, scalars)) == want
    assert wrapper.plain_calls == before + 1
    shim.use_backend("native")
    assert enc(shim.multi_exp(pts, scalars)) == want
    assert wrapper.plain_calls == before + 1


@pytest.mark.slow
def test_width_256_commitment_through_the_plain_pippenger():
    setup = generate_setup(256, SECRET)
    mine, ref = kzg.KZG(256, setup=setup), ref_kzg.KZG(256, setup=setup)
    ref_kzg.set_device_msm(None)

    def plain_pippenger(points, scalars):
        out = bls381_cuda.pippenger_g1(
            *msm._pippenger_inputs(points, scalars, "cpu"))
        return curve_torch.g1_unpack(tuple(c[None] for c in out))[0]
    kzg.set_device_msm(plain_pippenger, threshold=1)
    blob = _blobs(1, 256, 2)[0]
    before = bls381_cuda.pippenger_g1.plain_calls
    assert mine.blob_to_kzg_commitment(blob) == \
        ref.blob_to_kzg_commitment(blob)
    assert bls381_cuda.pippenger_g1.plain_calls == before + 1
    c = 987654321
    assert mine.blob_to_kzg_commitment(kzg.bls_field_to_bytes(c) * 256) == \
        cv.g1_to_bytes(cv.g1_generator() * c)
