#!/usr/bin/env python3
"""The JAX package's KZG commitments, proofs and verdicts for chip_smoke.py's
blob path.

    JAX_PLATFORMS=cpu python3 scripts/torch_kzg_reference.py

Runs the JAX package's host KZG engine (`crypto/kzg.py`, its device MSM
uninstalled: the host Pippenger oracle) on the ceremony setup
(`trusted_setup_4096.json`) over bench.py `bench_kzg`'s six blobs
(`np.random.default_rng(7)`, 4,096 field elements a blob, the top byte of
each element zeroed) and prints the six commitments, the six blob proofs,
the verdict of `verify_blob_kzg_proof_batch` on them and on a copy with the
first two proofs swapped, and the commitment of the constant blob
(CEREMONY_CONSTANT in every element).  chip_smoke.py's phase "kzg" pins
these as KZG_COMMITMENTS, KZG_PROOFS and its verdict checks, and holds the
port's run on the card against them.  Takes a few minutes on the CPU (twelve
host MSMs of 4,096 points and the setup's decompression).
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_BLOBS = 6                     # bench.py N_BLOBS
CEREMONY_CONSTANT = 987654321   # tests/test_kzg.py's constant blob


def blobs(width):
    """bench.py bench_kzg's blobs: 31 random low bytes a field element."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(N_BLOBS):
        elems = rng.integers(0, 256, size=(width, 32), dtype=np.uint8)
        elems[:, 0] = 0
        out.append(elems.tobytes())
    return out


def main():
    from consensus_specs_tpu.crypto import kzg as kzg_mod
    kzg_mod.set_device_msm(None)
    t0 = time.perf_counter()
    kz = kzg_mod.KZG()
    bs = blobs(kz.width)
    commitments = [kz.blob_to_kzg_commitment(b) for b in bs]
    proofs = [kz.compute_blob_kzg_proof(b, c)
              for b, c in zip(bs, commitments)]
    valid = kz.verify_blob_kzg_proof_batch(bs, commitments, proofs)
    swapped = kz.verify_blob_kzg_proof_batch(
        bs, commitments, [proofs[1], proofs[0], *proofs[2:]])
    constant = kz.blob_to_kzg_commitment(
        kzg_mod.bls_field_to_bytes(CEREMONY_CONSTANT) * kz.width)
    print("KZG_COMMITMENTS = (")
    for c in commitments:
        print(f'    "{c.hex()}",')
    print(")")
    print("KZG_PROOFS = (")
    for p in proofs:
        print(f'    "{p.hex()}",')
    print(")")
    print(f"batch verdict {valid}, with proofs 0 and 1 swapped {swapped}")
    print(f"constant blob ({CEREMONY_CONSTANT}) commitment {constant.hex()}")
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
