"""G2-leg folding: every signature leg of a fused flush as ONE pair.

Counterpart of consensus_specs_tpu/sigpipe/fold.py.  The fused product
(scheduler.py) pays two Miller loops a signature set,
e(c_i agg_i, H(root_i)) e(-c_i g1, sig_i), though the second legs all
share the base -g1 and fold by bilinearity to one pair:

    prod_i e(-c_i g1, sig_i)  ==  e(-g1, S),   S = sum_i c_i sig_i

so an N-set flush needs N + 1 Miller loops instead of 2N (the counted
`miller_loops_per_flush`).

* :func:`fold_signatures`: S by the device G2 multi-exponentiation
  (ops/msm.g2_multi_exp: the G2 ladder, then one segment sum), for the
  staged chain.
* :func:`fold_kzg_lincombs`: the KZG batch verifier's three shared-base
  G1 lincombs (crypto/kzg.verify_kzg_proof_batch), the same algebra (N
  untrusted points under Fiat-Shamir weights folding to a 2-leg pairing),
  as three device MSMs (ops/msm.g1_multi_exp).
* :func:`fold_flush`: the one-launch path (the device backend and the
  fused pairing mode): the cofactor ladder, the Fiat-Shamir G1 weighting,
  the G2 signature sum and the partial Miller product of the flush on the
  card (parallel/shard_verify.pairing_fold ->
  ops/pairing_torch.fold_partial_products), then one final
  exponentiation.

Bisection is untouched: probes re-derive every weighted pair on the host
ladder (scheduler `group_valid`), so a corrupt fold can only fail the
product, never flip a per-set verdict.  Unlike the reference there is no
resilience dispatch and no host fold or host ladder to fall back to: a
device failure raises.

``FOLD_VERIFY=0`` (or ``off``) is the reference's switch: the scheduler
then emits the 2N-leg flush.  Resolved lazily: the env var is read at
first use, direct assignment wins, and reset_mode() forgets a cached
choice.
"""
from __future__ import annotations

import os as _os

from .metrics import METRICS

FOLD_MODE = None        # None = unresolved; "on" | "off" once resolved


def reset_mode() -> None:
    """Forget the cached folding choice: the next flush re-reads the
    FOLD_VERIFY env var."""
    global FOLD_MODE
    FOLD_MODE = None


def _resolve_mode() -> str:
    global FOLD_MODE
    if FOLD_MODE is None:
        FOLD_MODE = ("off"
                     if _os.environ.get("FOLD_VERIFY", "") in ("0", "off")
                     else "on")
    return FOLD_MODE


def live() -> bool:
    """Whether the scheduler's fused flush folds its signature legs."""
    return _resolve_mode() == "on"


def one_launch_live() -> bool:
    """Whether the whole folded flush runs as the one-launch fold: folding
    on, the device backend ("cuda") and the fused pairing mode
    (ops/pairing_torch.PAIRING_MODE); otherwise the folded flush runs its
    staged chain (hash-to-G2, weighting, G2 fold, pairing check), with the
    same verdicts."""
    if not live():
        return False
    from ..utils import bls
    if bls.current_backend() != "cuda":
        return False
    from ..ops import pairing_torch
    return pairing_torch._resolve_mode() == "fused"


def fold_signatures(sigs, coeffs):
    """All signature legs of a flush folded to one G2 point
    S = sum_i c_i sig_i, one device multi-exponentiation."""
    from ..ops import msm
    METRICS.inc("fold_dispatches")
    return msm.g2_multi_exp(sigs, coeffs)


def fold_kzg_lincombs(proof_points, c_minus_ys, r_powers, r_times_z):
    """The KZG batch verifier's three shared-base G1 lincombs,
    sum r_i proof_i, sum (r_i z_i) proof_i and sum r_i (C_i - y_i), as one
    fold dispatch of three device G1 MSMs (ops/msm.g1_multi_exp: the
    kernels on the card, their plain versions on the CPU): returns
    (proof_lincomb, proof_z_lincomb, c_minus_y_lincomb)."""
    from ..ops import msm
    METRICS.inc("fold_dispatches")
    return (msm.g1_multi_exp(proof_points, r_powers),
            msm.g1_multi_exp(proof_points, r_times_z),
            msm.g1_multi_exp(c_minus_ys, r_powers))


def fold_flush(aggs, coeffs, roots, sigs) -> bool:
    """The one-launch folded flush: the verdict of the N + 1-leg product
    (parallel/shard_verify.pairing_fold, width 1)."""
    from ..parallel import shard_verify
    METRICS.inc("fold_dispatches")
    ok = shard_verify.pairing_fold(aggs, coeffs, roots, sigs)
    # N aggregate legs and one e(-g1, S_d) leg a mesh device: N + 1 here
    METRICS.observe("miller_loops_per_flush",
                    len(aggs) + shard_verify.mesh_devices())
    return ok
