"""Fused epoch processing: one `ops.epoch_sweep` dispatch per epoch.

Counterpart of consensus_specs_tpu/specs/epoch_fast.py.  The reference's
epoch passes are per-validator Python loops with O(n) helpers inside
(`get_base_reward` recomputes the total active balance), quadratic at
mainnet scale.  This engine reads the registry ONCE per epoch into columns
(`StateArrays`), builds the attester masks and the global scalars on the
host, runs justification on the host, and hands every hot pass
(attestation deltas, slashings, effective-balance hysteresis, the
registry-eligibility masks) to ONE sweep: `ops.epoch_sweep.run_sweep`, one
upload, the CUDA kernel's launch sequence, one download.  Balances write
back through `ssz.incremental.bulk_set_basic` in one call, so the re-root
stays the O(dirty) fused merkle sweep; the rare registry mutations and the
effective-balance changes stay scalar spec writes.

Differences from the reference:

- no supervisor and no numpy fallback: `fused_epoch` calls `run_sweep`
  directly, and a build or launch failure on the card raises;
- `set_guard(rate, seed)` samples epochs whose lanes are recomputed by
  `ops.epoch_sweep.plain_sweep` on CPU copies of the inputs and compared;
  a mismatch counts `epoch_guard_mismatches` and raises RuntimeError, and
  never substitutes the oracle's lanes;
- `_collect` builds the phase0 family only; the altair and electra
  branches come with the altair spec (ROADMAP.md).  The sweep itself
  already computes both families.

Public surface: ENABLED, SWEEP_SITE, scalar_epoch, fused_epoch, set_guard.
`scalar_epoch()` restores the reference-shaped scalar pass list
(`Phase0Spec.process_epoch`), which the tests hold the fused engine
against.
"""
from __future__ import annotations

import contextlib
import random
from math import isqrt

import numpy as np

from ..ops import epoch_sweep
from ..sigpipe.metrics import METRICS

ENABLED = True

SWEEP_SITE = "ops.epoch_sweep"

_I64MAX = np.iinfo(np.int64).max
_ORDER_BITS = 24          # attestations per epoch < 2**24; delay keys above

_GUARD_RATE = 0.0
_GUARD_RNG = random.Random(0)


@contextlib.contextmanager
def scalar_epoch():
    """Temporarily disable the fused engine (differential testing)."""
    global ENABLED
    prev, ENABLED = ENABLED, False
    try:
        yield
    finally:
        ENABLED = prev


def set_guard(rate: float, seed: int = 0) -> None:
    """Differential-guard sampling probability for the fused sweep.  A
    sampled epoch recomputes every lane with `plain_sweep` on the host and
    compares; a mismatch raises."""
    global _GUARD_RATE, _GUARD_RNG
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"guard rate {rate} outside [0, 1]")
    _GUARD_RATE = rate
    _GUARD_RNG = random.Random(seed)


# ---------------------------------------------------------------------------
# structure-of-arrays extraction
# ---------------------------------------------------------------------------

class StateArrays:
    """Validator-axis columns of the BeaconState (read-only snapshot)."""

    def __init__(self, state):
        vs = state.validators
        n = len(vs)
        self.n = n
        self.eff = np.fromiter(
            (int(v.effective_balance) for v in vs), np.int64, n)
        self.slashed = np.fromiter((bool(v.slashed) for v in vs), bool, n)
        self.activation_eligibility = np.fromiter(
            (int(v.activation_eligibility_epoch) for v in vs), np.uint64, n)
        self.activation = np.fromiter(
            (int(v.activation_epoch) for v in vs), np.uint64, n)
        self.exit = np.fromiter(
            (int(v.exit_epoch) for v in vs), np.uint64, n)
        self.withdrawable = np.fromiter(
            (int(v.withdrawable_epoch) for v in vs), np.uint64, n)
        self.balances = np.fromiter(
            (int(b) for b in state.balances), np.int64, n)

    def active(self, epoch) -> np.ndarray:
        e = np.uint64(int(epoch))
        return (self.activation <= e) & (e < self.exit)

    def total_active_balance(self, epoch, increment) -> int:
        return max(int(increment), int(self.eff[self.active(epoch)].sum()))


# ---------------------------------------------------------------------------
# phase0: attestation participation masks
# ---------------------------------------------------------------------------

def phase0_attestation_masks(spec, state, epoch, targets_only=False):
    """source/target/head attester masks for `epoch`'s pending attestations
    plus, per source attester, the minimal-inclusion-delay key and its
    proposer (beacon-chain.md get_matching_*_attestations and
    get_inclusion_delay_deltas).

    `targets_only` skips the head/inclusion-delay bookkeeping: the
    justification pass needs only the target mask."""
    n = len(state.validators)
    src = np.zeros(n, bool)
    tgt = np.zeros(n, bool)
    head = np.zeros(n, bool)
    best_key = np.full(n, _I64MAX, np.int64)
    best_prop = np.zeros(n, np.int64)
    atts = spec.get_matching_source_attestations(state, epoch)
    if not atts:
        return src, tgt, head, best_key, best_prop
    target_root = spec.get_block_root(state, epoch)
    for order, a in enumerate(atts):
        committee = spec.get_beacon_committee(
            state, a.data.slot, a.data.index)
        m = len(committee)
        comm = np.fromiter((int(c) for c in committee), np.int64, m)
        bits = np.fromiter(
            (bool(b) for b in a.aggregation_bits), bool, m)
        att = comm[bits]
        src[att] = True
        if a.data.target.root == target_root:
            tgt[att] = True
            if not targets_only and a.data.beacon_block_root == \
                    spec.get_block_root_at_slot(state, int(a.data.slot)):
                head[att] = True
        if targets_only:
            continue
        key = (int(a.inclusion_delay) << _ORDER_BITS) | order
        upd = key < best_key[att]
        best_key[att] = np.where(upd, key, best_key[att])
        best_prop[att] = np.where(upd, int(a.proposer_index), best_prop[att])
    return src, tgt, head, best_key, best_prop


# ---------------------------------------------------------------------------
# sweep inputs: everything the sweep needs, host-extracted once
# ---------------------------------------------------------------------------

class SweepInputs:
    """The bundle `ops.epoch_sweep.run_sweep` takes, immutable by
    convention.

    `family` is "phase0" or "altair"; `cols` maps the family's column
    names (ops.epoch_sweep.{PHASE0,ALTAIR}_COLS) to length-n numpy arrays
    (int64, uint64 epochs, bool masks); `scalars` maps the family's scalar
    names to ints; `statics` is a sorted tuple of (name, value) pairs, the
    reference's compile-cache key, which the kernel takes as arguments."""

    __slots__ = ("family", "n", "cols", "scalars", "statics")

    def __init__(self, family, n, cols, scalars, statics):
        self.family = family
        self.n = n
        self.cols = cols
        self.scalars = scalars
        self.statics = statics


def _collect(spec, state, arr, masks_prev, do_rewards, leak, tb, cur, prev):
    """Build the phase0 SweepInputs from the post-justification state.
    Every value here is read ONCE; the sweep is a pure function of this
    bundle."""
    n = arr.n
    incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    adj = min(sum(int(x) for x in state.slashings)
              * int(spec.proportional_slashing_multiplier()), tb)
    if masks_prev is None:
        masks_prev = (np.zeros(n, bool), np.zeros(n, bool),
                      np.zeros(n, bool), np.full(n, _I64MAX, np.int64),
                      np.zeros(n, np.int64))
    src, tgt, head, best_key, best_prop = masks_prev
    cols = {
        "eff": arr.eff, "slashed": arr.slashed,
        "activation": arr.activation, "exit_epoch": arr.exit,
        "act_elig": arr.activation_eligibility,
        "withdrawable": arr.withdrawable,
        "balances": arr.balances,
        "max_eff": np.full(n, int(spec.MAX_EFFECTIVE_BALANCE), np.int64),
        "src": src, "tgt": tgt, "head": head,
        "best_key": best_key, "best_prop": best_prop,
    }
    scalars = {
        "cur": cur, "prev": prev,
        "finalized": int(state.finalized_checkpoint.epoch),
        "slash_epoch": cur + int(spec.EPOCHS_PER_SLASHINGS_VECTOR) // 2,
        "tb": tb, "adj": adj, "sqrt_tb": isqrt(tb),
        "finality_delay": (int(spec.get_finality_delay(state))
                           if do_rewards else 1),
    }
    statics = {
        "do_rewards": bool(do_rewards), "leak": bool(leak), "incr": incr,
        "max_eb": int(spec.MAX_EFFECTIVE_BALANCE),
        "ejection": int(spec.config.EJECTION_BALANCE),
        "hyst_q": int(spec.HYSTERESIS_QUOTIENT),
        "hyst_down": int(spec.HYSTERESIS_DOWNWARD_MULTIPLIER),
        "hyst_up": int(spec.HYSTERESIS_UPWARD_MULTIPLIER),
        "brf": int(spec.BASE_REWARD_FACTOR),
        "brpe": int(spec.BASE_REWARDS_PER_EPOCH),
        "prop_q": int(spec.PROPOSER_REWARD_QUOTIENT),
        "inact_q": int(spec.INACTIVITY_PENALTY_QUOTIENT),
    }
    return SweepInputs("phase0", n, cols, scalars,
                       tuple(sorted(statics.items())))


def _guard(inp, out) -> None:
    """Hold the sweep's lanes against plain_sweep on CPU copies."""
    METRICS.inc("epoch_guard_samples")
    oracle = epoch_sweep.plain_sweep(
        epoch_sweep.host_columns(inp),
        {k: int(v) for k, v in inp.scalars.items()}, inp.statics)
    if not all(np.array_equal(a, b.numpy()) for a, b in zip(out, oracle)):
        METRICS.inc("epoch_guard_mismatches")
        raise RuntimeError(
            f"{SWEEP_SITE} guard mismatch: the sweep's lanes differ from "
            f"plain_sweep on the host")


# ---------------------------------------------------------------------------
# writeback + registry application (the rare scalar mutations)
# ---------------------------------------------------------------------------

def _bulk_write(view, old: np.ndarray, new: np.ndarray) -> int:
    """ONE Python-level writeback call for a whole mutated column: the
    changed-index vector and its values go through
    `incremental.bulk_set_basic`, which marks the dirty merkle cone in one
    pass.  Returns the element count (epoch_writeback_elems)."""
    changed = np.nonzero(new != old)[0]
    if changed.size:
        from ..ssz import incremental
        incremental.bulk_set_basic(view, changed, new[changed])
    return int(changed.size)


def _apply_registry(spec, state, cur, arr, elig_q, eject, ready) -> None:
    """process_registry_updates from the sweep's masks
    (beacon-chain.md "Registry updates"): only the (rare) mutating indices
    run scalar spec calls, so churn bookkeeping stays identical."""
    for i in np.nonzero(elig_q)[0].tolist():
        state.validators[i].activation_eligibility_epoch = cur + 1
    for i in np.nonzero(eject)[0].tolist():
        spec.initiate_validator_exit(state, i)
    # activation queue: the sweep's `ready` mask is computed from the
    # PRE-update eligibility epochs, which is exact: newly eligible
    # validators get epoch cur+1 > finalized and cannot be ready in the
    # same epoch
    idx = np.nonzero(ready)[0]
    order = np.lexsort((idx, arr.activation_eligibility[idx]))
    churn = int(spec.get_validator_churn_limit(state))
    target_epoch = int(spec.compute_activation_exit_epoch(cur))
    for i in idx[order][:churn].tolist():
        state.validators[i].activation_epoch = target_epoch


def _write_effective_balances(state, arr, new_eff: np.ndarray) -> int:
    """The effective-balance changes of the hysteresis lanes, one scalar
    write each.  Returns their count."""
    changed = np.nonzero(new_eff != arr.eff)[0]
    for i in changed.tolist():
        state.validators[i].effective_balance = int(new_eff[i])
    return int(changed.size)


# ---------------------------------------------------------------------------
# the orchestrator: ONE dispatch per process_epoch
# ---------------------------------------------------------------------------

def fused_epoch(spec, state) -> bool:
    """Run the fused head of `process_epoch` (justification through the
    effective-balance update) with exactly ONE `ops.epoch_sweep`
    dispatch.  Returns True when it handled that prefix (the caller then
    runs only the tail resets); returns False, before mutating anything,
    when the engine is disabled or the registry is empty, so the caller
    falls through to the scalar pass list."""
    if not ENABLED:
        return False
    n = len(state.validators)
    if n == 0:
        return False
    cur = int(spec.get_current_epoch(state))
    prev = int(spec.get_previous_epoch(state))
    genesis = int(spec.GENESIS_EPOCH)
    do_rewards = cur != genesis
    incr = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    arr = StateArrays(state)
    tb = arr.total_active_balance(cur, incr)

    # -- host prefix: justification (checkpoint/bit mutations only) ----
    masks_prev = None
    if do_rewards:
        masks_prev = phase0_attestation_masks(spec, state, prev)
    if cur > genesis + 1:
        prev_m = masks_prev[1] & ~arr.slashed
        cur_m = phase0_attestation_masks(
            spec, state, cur, targets_only=True)[1] & ~arr.slashed
        spec.weigh_justification_and_finalization(
            state, tb,
            max(incr, int(arr.eff[prev_m].sum())),
            max(incr, int(arr.eff[cur_m].sum())))

    # leak/finality/finalized all read the POST-justification state
    leak = bool(spec.is_in_inactivity_leak(state)) if do_rewards else False
    inp = _collect(spec, state, arr, masks_prev, do_rewards, leak, tb,
                   cur, prev)

    # -- the ONE dispatch ----------------------------------------------
    METRICS.inc("epoch_sweep_dispatches")
    out = epoch_sweep.run_sweep(inp)
    if _GUARD_RNG.random() < _GUARD_RATE:
        _guard(inp, out)
    new_bal, new_eff, elig_q, eject, ready = out

    # -- batched writeback + the rare scalar mutations ------------------
    wb = _bulk_write(state.balances, arr.balances, new_bal)
    _apply_registry(spec, state, cur, arr, elig_q, eject, ready)
    wb += _write_effective_balances(state, arr, new_eff)
    METRICS.inc("epoch_writeback_elems", wb)
    return True
