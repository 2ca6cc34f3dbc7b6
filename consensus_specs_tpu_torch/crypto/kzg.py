"""KZG polynomial commitments over the Ethereum ceremony trusted setup.

A copy of consensus_specs_tpu/crypto/kzg.py, the deneb KZG library
(consensus-specs specs/deneb/polynomial-commitments.md: function names and
Fiat-Shamir transcripts match section by section; docstrings cite lines).
Field arithmetic is plain ints mod BLS_MODULUS (= the BLS12-381 subgroup
order); curve work routes through crypto.curve incl. its host Pippenger
MSM.  Batch modular inversion accelerates barycentric evaluation without
changing results.  Two differences from the reference:

- **The MSM runs on the device by default.**  `g1_lincomb` of 128 points
  or more calls ops/msm.py `g1_multi_exp` (the Pippenger kernel on the
  card, the plain torch versions after `set_device("cpu")`), as the
  port's BLS backend defaults to the card; `set_device_msm(None)` opts
  out to the host oracle.  ops/ is imported at the first device MSM, not
  here, so crypto/ imports without torch kernels.
- **No fallback.**  The device MSM is called directly, with no
  supervisor and no host Pippenger behind it: a device failure raises.
  The batch verifier's three lincombs go through sigpipe/fold.py
  `fold_kzg_lincombs`, which has no fallback either.

The pairings stay on the host oracle (crypto/pairing.py), as in the
reference.  The ceremony setup is the port's own copy
(config/trusted_setups/trusted_setup_4096.json).
"""
from __future__ import annotations

import json
import os
from functools import lru_cache

from .fields import R as BLS_MODULUS
from . import curve as cv
from .curve import Point, msm
from ..utils.hash import hash as sha256

BYTES_PER_FIELD_ELEMENT = 32
KZG_ENDIANNESS = "big"
PRIMITIVE_ROOT_OF_UNITY = 7

FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"

G1_POINT_AT_INFINITY = bytes([0xC0]) + b"\x00" * 47

_SETUP_PATH = os.path.join(os.path.dirname(__file__), "..", "config",
                           "trusted_setups", "trusted_setup_4096.json")


def _default_device_msm(points, scalars) -> Point:
    """ops/msm.py `g1_multi_exp`, imported at the first call."""
    from ..ops.msm import g1_multi_exp
    return g1_multi_exp(points, scalars)


# pluggable device MSM (the arkworks-multiexp slot of the reference's
# backend stack): installed by default (use_tpu_msm() reinstalls it),
# used by g1_lincomb for big batches; set_device_msm(None) uninstalls it
_device_msm = _default_device_msm
_device_msm_threshold = 128


def set_device_msm(fn, threshold: int = 128) -> None:
    """Install a device MSM `fn(points, scalars) -> Point` (None to
    uninstall)."""
    global _device_msm, _device_msm_threshold
    _device_msm = fn
    _device_msm_threshold = threshold


def use_tpu_msm(threshold: int = 128) -> None:
    """Install ops/msm.py `g1_multi_exp` (the default), under the
    reference's name."""
    set_device_msm(_default_device_msm, threshold)


class FieldMath:
    """Scalar-field helpers (polynomial-commitments.md "BLS field")."""

    @staticmethod
    def inverse(x: int) -> int:
        return pow(x % BLS_MODULUS, BLS_MODULUS - 2, BLS_MODULUS)

    @staticmethod
    def div(x: int, y: int) -> int:
        return x * FieldMath.inverse(y) % BLS_MODULUS

    @staticmethod
    def batch_inverse(xs: list[int]) -> list[int]:
        """Montgomery batch inversion: one pow, 3n muls. Zero maps to zero
        like pow(0, p-2) would."""
        prefix = []
        acc = 1
        for x in xs:
            prefix.append(acc)
            if x % BLS_MODULUS != 0:
                acc = acc * x % BLS_MODULUS
        inv = FieldMath.inverse(acc)
        out = [0] * len(xs)
        for i in range(len(xs) - 1, -1, -1):
            x = xs[i] % BLS_MODULUS
            if x == 0:
                out[i] = 0
            else:
                out[i] = prefix[i] * inv % BLS_MODULUS
                inv = inv * x % BLS_MODULUS
        # prefix[i] above includes only nonzero factors before i; recompute
        # correctness by construction: prefix products skip zeros, and so
        # does the suffix unwind.
        return out


def compute_powers(x: int, n: int) -> list[int]:
    powers = []
    current = 1
    for _ in range(n):
        powers.append(current)
        current = current * x % BLS_MODULUS
    return powers


def hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(sha256(data), KZG_ENDIANNESS) % BLS_MODULUS


def bytes_to_bls_field(b: bytes) -> int:
    # the spec types this input Bytes32 (deneb/polynomial-commitments.md
    # bytes_to_bls_field) — enforce the length the type system would
    if len(b) != 32:
        raise ValueError("field element must be exactly 32 bytes")
    x = int.from_bytes(bytes(b), KZG_ENDIANNESS)
    if x >= BLS_MODULUS:
        raise ValueError("field element out of range")
    return x


def bls_field_to_bytes(x: int) -> bytes:
    return int(x).to_bytes(32, KZG_ENDIANNESS)


class KZG:
    """A KZG engine bound to one trusted setup + blob width."""

    def __init__(self, field_elements_per_blob: int = 4096,
                 setup_path: str = _SETUP_PATH, setup: dict | None = None):
        self.width = field_elements_per_blob
        if setup is None:
            with open(setup_path) as f:
                setup = json.load(f)
        self._g1_lagrange_bytes = [bytes.fromhex(h[2:])
                                   for h in setup["g1_lagrange"]]
        self._g1_monomial_bytes = [bytes.fromhex(h[2:])
                                   for h in setup["g1_monomial"]]
        self._g2_monomial_bytes = [bytes.fromhex(h[2:])
                                   for h in setup["g2_monomial"]]
        assert len(self._g1_lagrange_bytes) == self.width
        self._g1_lagrange_brp: list[Point] | None = None
        self._g2_monomial: list[Point] | None = None
        self._roots_brp: tuple | None = None

    # -- setup access (decompressed lazily; ceremony output is trusted,
    #    so no per-point subgroup check here)
    def g1_lagrange_brp(self) -> list[Point]:
        if self._g1_lagrange_brp is None:
            pts = [cv.g1_from_bytes(b, subgroup_check=False)
                   for b in self._g1_lagrange_bytes]
            self._g1_lagrange_brp = bit_reversal_permutation(pts)
        return self._g1_lagrange_brp

    def g2_monomial(self) -> list[Point]:
        if self._g2_monomial is None:
            self._g2_monomial = [cv.g2_from_bytes(b, subgroup_check=False)
                                 for b in self._g2_monomial_bytes]
        return self._g2_monomial

    # -- domain
    def _roots_of_unity_brp(self) -> tuple:
        """Roots of unity in bit-reversal order (the blob evaluation
        domain), polynomial-commitments.md compute_roots_of_unity +
        bit_reversal_permutation (:142)."""
        if self._roots_brp is None:
            root = pow(PRIMITIVE_ROOT_OF_UNITY,
                       (BLS_MODULUS - 1) // self.width, BLS_MODULUS)
            roots = compute_powers(root, self.width)
            assert root != 1 and pow(root, self.width, BLS_MODULUS) == 1
            self._roots_brp = tuple(bit_reversal_permutation(roots))
        return self._roots_brp

    # -- blob <-> polynomial
    def blob_to_polynomial(self, blob: bytes) -> list[int]:
        assert len(blob) == BYTES_PER_FIELD_ELEMENT * self.width
        return [bytes_to_bls_field(
            blob[i * 32:(i + 1) * 32]) for i in range(self.width)]

    def compute_challenge(self, blob: bytes, commitment: bytes) -> int:
        """Fiat-Shamir challenge (polynomial-commitments.md:249)."""
        degree_poly = self.width.to_bytes(16, KZG_ENDIANNESS)
        data = FIAT_SHAMIR_PROTOCOL_DOMAIN + degree_poly + bytes(blob) \
            + bytes(commitment)
        return hash_to_bls_field(data)

    # -- core polynomial ops
    def g1_lincomb(self, points: list[Point], scalars: list[int]) -> bytes:
        """MSM -> compressed bytes (polynomial-commitments.md:268).

        Routes through the device MSM when installed (the default) and the
        batch is large enough to amortize transfer (set_device_msm);
        otherwise the host Pippenger oracle.  A device failure raises."""
        if _device_msm is not None and len(points) >= _device_msm_threshold:
            return cv.g1_to_bytes(_device_msm(points, scalars))
        return cv.g1_to_bytes(msm(points, scalars))

    def evaluate_polynomial_in_evaluation_form(self, polynomial: list[int],
                                               z: int) -> int:
        """Barycentric evaluation at z (polynomial-commitments.md:317)."""
        width = self.width
        assert len(polynomial) == width
        inverse_width = FieldMath.inverse(width)
        roots = self._roots_of_unity_brp()
        # z on the domain: the evaluation is just the stored value
        if z in roots:
            return polynomial[roots.index(z)]
        denominators = [(z - r) % BLS_MODULUS for r in roots]
        inv_denoms = FieldMath.batch_inverse(denominators)
        result = 0
        for i in range(width):
            result += polynomial[i] * roots[i] % BLS_MODULUS \
                * inv_denoms[i] % BLS_MODULUS
        result = result % BLS_MODULUS \
            * (pow(z, width, BLS_MODULUS) - 1) % BLS_MODULUS \
            * inverse_width % BLS_MODULUS
        return result % BLS_MODULUS

    # -- commitments & proofs
    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        """polynomial-commitments.md:353"""
        return self.g1_lincomb(self.g1_lagrange_brp(),
                               self.blob_to_polynomial(blob))

    def compute_quotient_eval_within_domain(self, z: int,
                                            polynomial: list[int],
                                            y: int) -> int:
        """Quotient at a domain point (the removable singularity case)."""
        roots = self._roots_of_unity_brp()
        result = 0
        for i, omega_i in enumerate(roots):
            if omega_i == z:
                continue
            f_i = (polynomial[i] - y) % BLS_MODULUS
            numerator = f_i * omega_i % BLS_MODULUS
            denominator = z * (z - omega_i) % BLS_MODULUS
            result += FieldMath.div(numerator, denominator)
        return result % BLS_MODULUS

    def compute_kzg_proof_impl(self, polynomial: list[int],
                               z: int) -> tuple[bytes, int]:
        """polynomial-commitments.md:466 — returns (proof, y)."""
        roots = self._roots_of_unity_brp()
        y = self.evaluate_polynomial_in_evaluation_form(polynomial, z)
        polynomial_shifted = [(p - y) % BLS_MODULUS for p in polynomial]
        denominator_poly = [(r - z) % BLS_MODULUS for r in roots]
        inv_denoms = FieldMath.batch_inverse(denominator_poly)
        quotient_polynomial = [0] * self.width
        for i in range(self.width):
            if denominator_poly[i] == 0:
                quotient_polynomial[i] = \
                    self.compute_quotient_eval_within_domain(
                        roots[i], polynomial, y)
            else:
                quotient_polynomial[i] = \
                    polynomial_shifted[i] * inv_denoms[i] % BLS_MODULUS
        proof = self.g1_lincomb(self.g1_lagrange_brp(), quotient_polynomial)
        return proof, y

    def compute_kzg_proof(self, blob: bytes,
                          z_bytes: bytes) -> tuple[bytes, bytes]:
        polynomial = self.blob_to_polynomial(blob)
        proof, y = self.compute_kzg_proof_impl(
            polynomial, bytes_to_bls_field(z_bytes))
        return proof, bls_field_to_bytes(y)

    def compute_blob_kzg_proof(self, blob: bytes,
                               commitment_bytes: bytes) -> bytes:
        """polynomial-commitments.md:523"""
        self.validate_kzg_g1(commitment_bytes)
        challenge = self.compute_challenge(blob, commitment_bytes)
        proof, _ = self.compute_kzg_proof_impl(
            self.blob_to_polynomial(blob), challenge)
        return proof

    # -- verification
    @staticmethod
    def validate_kzg_g1(b: bytes) -> None:
        """Subgroup/format validation of untrusted G1 bytes
        (polynomial-commitments.md validate_kzg_g1)."""
        if bytes(b) == G1_POINT_AT_INFINITY:
            return
        cv.g1_from_bytes(bytes(b), subgroup_check=True)

    def verify_kzg_proof_impl(self, commitment: bytes, z: int, y: int,
                              proof: bytes) -> bool:
        """e(C - [y]G1, G2) == e(proof, [tau - z]G2)
        (polynomial-commitments.md:383)."""
        g2 = cv.g2_generator()
        x_minus_z = self.g2_monomial()[1] + g2 * ((BLS_MODULUS - z)
                                                  % BLS_MODULUS)
        p_minus_y = cv.g1_from_bytes(bytes(commitment),
                                     subgroup_check=False) \
            + cv.g1_generator() * ((BLS_MODULUS - y) % BLS_MODULUS)
        from .pairing import pairing_check
        return pairing_check([(p_minus_y, -g2),
                              (cv.g1_from_bytes(bytes(proof),
                                                subgroup_check=False),
                               x_minus_z)])

    def verify_kzg_proof(self, commitment_bytes: bytes, z_bytes: bytes,
                         y_bytes: bytes, proof_bytes: bytes) -> bool:
        self.validate_kzg_g1(commitment_bytes)
        self.validate_kzg_g1(proof_bytes)
        return self.verify_kzg_proof_impl(
            commitment_bytes,
            bytes_to_bls_field(z_bytes),
            bytes_to_bls_field(y_bytes),
            proof_bytes)

    def compute_r_powers(self, commitments, zs, ys, proofs) -> list[int]:
        """Batch-verification challenge powers
        (polynomial-commitments.md:427)."""
        n = len(commitments)
        data = RANDOM_CHALLENGE_KZG_BATCH_DOMAIN \
            + self.width.to_bytes(8, KZG_ENDIANNESS) \
            + n.to_bytes(8, KZG_ENDIANNESS)
        for commitment, z, y, proof in zip(commitments, zs, ys, proofs):
            data += bytes(commitment) + bls_field_to_bytes(z) \
                + bls_field_to_bytes(y) + bytes(proof)
        r = hash_to_bls_field(data)
        return compute_powers(r, n)

    def verify_kzg_proof_batch(self, commitments, zs, ys, proofs) -> bool:
        """Random-linear-combination batch check with one pairing
        (polynomial-commitments.md:410).

        The three shared-base lincombs go through
        sigpipe/fold.fold_kzg_lincombs (the device MSM, no fallback);
        FOLD_VERIFY=0 keeps the plain host msm() calls byte-for-byte."""
        assert len(commitments) == len(zs) == len(ys) == len(proofs)
        proof_points = [cv.g1_from_bytes(bytes(p), subgroup_check=False)
                        for p in proofs]
        c_minus_ys = [
            cv.g1_from_bytes(bytes(c), subgroup_check=False)
            + cv.g1_generator() * ((BLS_MODULUS - y) % BLS_MODULUS)
            for c, y in zip(commitments, ys)]
        r_powers = self.compute_r_powers(commitments, zs, ys, proofs)
        r_times_z = [r * z % BLS_MODULUS for r, z in zip(r_powers, zs)]

        # lazy: crypto/ must not import sigpipe/ at module load (the
        # scheduler imports crypto right back)
        from ..sigpipe import fold
        if fold.live():
            proof_lincomb, proof_z_lincomb, c_minus_y_lincomb = \
                fold.fold_kzg_lincombs(proof_points, c_minus_ys,
                                       r_powers, r_times_z)
        else:
            proof_lincomb = msm(proof_points, r_powers)
            proof_z_lincomb = msm(proof_points, r_times_z)
            c_minus_y_lincomb = msm(c_minus_ys, r_powers)

        from .pairing import pairing_check
        g2 = cv.g2_generator()
        return pairing_check([
            (c_minus_y_lincomb + proof_z_lincomb, -g2),
            (proof_lincomb, self.g2_monomial()[1]),
        ])

    def verify_blob_kzg_proof(self, blob: bytes, commitment_bytes: bytes,
                              proof_bytes: bytes) -> bool:
        """polynomial-commitments.md:544"""
        self.validate_kzg_g1(commitment_bytes)
        self.validate_kzg_g1(proof_bytes)
        challenge = self.compute_challenge(blob, commitment_bytes)
        polynomial = self.blob_to_polynomial(blob)
        y = self.evaluate_polynomial_in_evaluation_form(polynomial,
                                                        challenge)
        return self.verify_kzg_proof_impl(commitment_bytes, challenge, y,
                                          proof_bytes)

    def verify_blob_kzg_proof_batch(self, blobs, commitments,
                                    proofs) -> bool:
        """North-star config #4 (polynomial-commitments.md:569).

        With folding live the N blobs cost ONE 2-leg pairing (the RLC
        batch, its lincombs on the `ops.pairing_fold` seam), observed
        in `kzg_pairing_legs`; FOLD_VERIFY=0 is the escape hatch back
        to N per-blob 2-leg checks, byte-identical verdicts.  A batch
        that fails re-runs per-blob so the REJECTION is attributed to
        specific blobs (`kzg_batch_attributions`) instead of one
        opaque product — degraded cost, never a degraded verdict."""
        assert len(blobs) == len(commitments) == len(proofs)
        evaluation_challenges = []
        ys = []
        for blob, commitment in zip(blobs, commitments):
            self.validate_kzg_g1(commitment)
            challenge = self.compute_challenge(blob, commitment)
            polynomial = self.blob_to_polynomial(blob)
            evaluation_challenges.append(challenge)
            ys.append(self.evaluate_polynomial_in_evaluation_form(
                polynomial, challenge))
        for proof in proofs:
            self.validate_kzg_g1(proof)
        # lazy for the same crypto<->sigpipe cycle as the batch check
        from ..sigpipe import fold
        from ..sigpipe.metrics import METRICS
        n = len(blobs)
        if not fold.live():
            METRICS.observe("kzg_pairing_legs", 2 * max(n, 1))
            return all(
                self.verify_kzg_proof_impl(c, z, y, p)
                for c, z, y, p in zip(commitments, evaluation_challenges,
                                      ys, proofs))
        ok = self.verify_kzg_proof_batch(
            commitments, evaluation_challenges, ys, proofs)
        METRICS.observe("kzg_pairing_legs", 2)
        if ok:
            return True
        # the RLC product only says "some blob lied" — degrade to
        # per-blob checks so the verdict names the liars
        METRICS.inc("kzg_batch_attributions")
        METRICS.observe("kzg_pairing_legs", 2 * max(n, 1))
        return all(
            self.verify_kzg_proof_impl(c, z, y, p)
            for c, z, y, p in zip(commitments, evaluation_challenges,
                                  ys, proofs))


@lru_cache(maxsize=4)
def get_kzg(field_elements_per_blob: int = 4096) -> KZG:
    return KZG(field_elements_per_blob)


def bit_reversal_permutation(sequence: list) -> list:
    """Reorder by bit-reversed index (polynomial-commitments.md:142)."""
    n = len(sequence)
    assert n & (n - 1) == 0, "length must be a power of two"
    bits = n.bit_length() - 1
    return [sequence[int(format(i, f"0{bits}b")[::-1], 2)]
            for i in range(n)]
