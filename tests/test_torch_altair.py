"""The port's altair state transition against the JAX package.

Minimal-preset altair states are built by the JAX package (one cached
genesis from `test_infra`, and the edge and leak states of
tests/test_epoch_sweep.py) and carried into the port as SSZ bytes; blocks
are built and applied by the JAX package with its native BLS and their
bytes applied in the port.  Every case compares post-state bytes and roots
exactly:

- the genesis root, and the next sync committee computed in both;
- `process_epoch` with incremental merkleization on in both packages, in a
  finalizing, a leaking and an activation-queue variant (the altair family
  of the fused sweep, the inactivity scores' and balances' bulk writeback,
  the participation rotation), and the fused epoch against the port's own
  `scalar_epoch()` pass list;
- a block with one attestation and a partial sync aggregate: its sync
  set collected by the pipeline (sigpipe/sets.py) under the aggregate-
  cache hint ("sync", period), and every verdict, the sync aggregate's
  among them, read at its seam; under `slow`, for the plain versions'
  seconds here (a check costs about 3 s, a fold about 10 s), that block
  and an empty block with a full sync aggregate on the port's device
  backend, checked one by one and with `sigpipe.enable()` (one folded
  flush, the sync set's committee sum cached under its hint);
- an empty sync aggregate with the infinity signature, accepted with no
  pairing; a valid full sync aggregate, accepted by one
  FastAggregateVerify on the port's native backend (a host pairing); a
  wrong sync signature, which raises AssertionError in both packages at
  `process_sync_aggregate`;
- `upgrade_from` of a phase0 state carrying pending attestations;
- incremental re-roots slot by slot across an altair epoch, each equal to
  the host oracle and to the JAX package's root;
- under `slow`, where tier-1's time limit leaves no room for them:
  `chip_smoke.altair_epoch_state` at 4,096 mainnet validators across slot
  127 -> 128, and `chip_smoke.altair_block_case` at 4,096 with BLS off and
  with BLS on (its build alone runs about 1,100 registry scans and 512
  pubkey decompressions, tens of seconds here).
"""
import importlib.util
import os
import traceback

import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu import resilience
from consensus_specs_tpu import sigpipe as ref_sigpipe
from consensus_specs_tpu.sigpipe import METRICS as JMETRICS
from consensus_specs_tpu.specs import get_spec as reference_spec
from consensus_specs_tpu.ssz import incremental as jinc
from consensus_specs_tpu.test_infra import disable_bls
from consensus_specs_tpu.test_infra.attestations import get_valid_attestation
from consensus_specs_tpu.test_infra.blocks import (
    build_empty_block_for_next_slot, next_slot, sign_block,
    state_transition_and_sign_block)
from consensus_specs_tpu.test_infra.context import (
    _genesis_state, default_activation_threshold, default_balances)
from consensus_specs_tpu.test_infra.genesis import build_mock_validator
from consensus_specs_tpu.test_infra.sync_committee import get_sync_aggregate
from consensus_specs_tpu.utils import bls as jbls
from consensus_specs_tpu_torch import sigpipe
from consensus_specs_tpu_torch.ops import bls381_cuda, epoch_sweep_cuda
from consensus_specs_tpu_torch.sigpipe import METRICS as TMETRICS
from consensus_specs_tpu_torch.sigpipe import cache as sig_cache
from consensus_specs_tpu_torch.specs import epoch_fast, get_spec
from consensus_specs_tpu_torch.specs.altair import AltairSpec
from consensus_specs_tpu_torch.ssz import incremental as tinc
from consensus_specs_tpu_torch.ssz import merkle
from consensus_specs_tpu_torch.utils import bls
from test_torch_epoch_sweep import reference_state_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py loaded as a module, for its altair recipes (importing
    it runs no check)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reset():
    sigpipe.disable()
    ref_sigpipe.disable()
    sig_cache.clear()
    for inc in (tinc, jinc):
        inc.disable()
    epoch_fast.set_guard(0.0)
    TMETRICS.reset()
    JMETRICS.reset()


@pytest.fixture(autouse=True)
def _clean():
    port.set_device("cpu")
    merkle.use_host_hashing()
    resilience.disable()
    bls.use_backend("native")
    bls.bls_active = jbls.bls_active = True
    _reset()
    yield
    _reset()
    bls.use_backend("cuda")
    bls.bls_active = jbls.bls_active = True
    merkle.use_device_hashing()


@pytest.fixture(scope="module")
def genesis():
    """The JAX package's minimal altair genesis (64 validators, both sync
    committees from `get_next_sync_committee`), shared by every case."""
    ref = reference_spec("altair", "minimal")
    return ref, _genesis_state(ref, default_balances,
                               default_activation_threshold, "default")


def _port_state(data):
    return get_spec("altair", "minimal").BeaconState.decode_bytes(data)


def _assert_same(state, ref_state):
    assert state.encode_bytes() == ref_state.encode_bytes()
    assert bytes(state.hash_tree_root()) == bytes(ref_state.hash_tree_root())


def test_spec_is_registered():
    spec = get_spec("altair", "minimal")
    assert isinstance(spec, AltairSpec) and spec.fork == "altair"
    assert spec.is_post("phase0") and spec.is_post("altair")
    assert not spec.is_post("bellatrix")
    ref = reference_spec("altair", "minimal")
    for name in ("BeaconState", "BeaconBlockBody", "SyncAggregate",
                 "SyncCommittee", "SyncCommitteeMessage",
                 "SignedContributionAndProof", "SyncAggregatorSelectionData"):
        ours, theirs = getattr(spec, name), getattr(ref, name)
        assert list(ours.fields()) == list(theirs.fields()), name
        assert bytes(ours().hash_tree_root()) == \
            bytes(theirs().hash_tree_root()), name


def test_genesis_root_and_next_sync_committee(genesis):
    ref, g = genesis
    state = _port_state(g.encode_bytes())
    assert bytes(state.hash_tree_root()) == bytes(g.hash_tree_root())
    spec = get_spec("altair", "minimal")
    assert spec.get_next_sync_committee(state).encode_bytes() == \
        ref.get_next_sync_committee(g).encode_bytes()


# ---------------------------------------------------------------------------
# process_epoch
# ---------------------------------------------------------------------------

VARIANTS = ("finalizing", "leaking", "queue")


def _epoch_pair(variant):
    """The minimal altair edge state ("finalizing"), the leak state
    ("leaking"), or the edge state with six pending validators appended to
    the activation queue, three times the churn limit ("queue"), in both
    packages."""
    ref = reference_spec("altair", "minimal")
    data = reference_state_bytes("altair", variant == "leaking")
    if variant == "queue":
        state = ref.BeaconState.decode_bytes(data)
        for _ in range(6):
            v = build_mock_validator(ref, len(state.validators),
                                     ref.MAX_EFFECTIVE_BALANCE)
            v.activation_eligibility_epoch = 0
            state.validators.append(v)
            state.balances.append(ref.MAX_EFFECTIVE_BALANCE)
            state.previous_epoch_participation.append(0)
            state.current_epoch_participation.append(0)
            state.inactivity_scores.append(0)
        data = state.encode_bytes()
    return (get_spec("altair", "minimal"), _port_state(data), ref,
            ref.BeaconState.decode_bytes(data))


@pytest.mark.parametrize("variant", VARIANTS)
def test_process_epoch_matches_jax(variant):
    spec, state, ref, ref_state = _epoch_pair(variant)
    jinc.enable()
    tinc.enable()
    jinc.track(ref_state)
    tinc.track(state)
    assert bytes(spec.hash_tree_root(state)) == \
        bytes(ref.hash_tree_root(ref_state))
    plain_before = epoch_sweep_cuda.epoch_sweep_cuda.plain_calls
    TMETRICS.reset()
    JMETRICS.reset()
    with disable_bls():
        ref.process_epoch(ref_state)
    spec.process_epoch(state)
    assert epoch_sweep_cuda.epoch_sweep_cuda.plain_calls == plain_before + 1
    assert TMETRICS.count("epoch_sweep_dispatches") == 1
    assert JMETRICS.count("epoch_sweep_dispatches") == 1
    assert TMETRICS.count("epoch_writeback_elems") == \
        JMETRICS.count("epoch_writeback_elems") > 0
    _assert_same(state, ref_state)
    assert bytes(spec.hash_tree_root(state)) == tinc.oracle_root(state)
    if variant == "leaking":
        assert any(int(s) for s in state.inactivity_scores)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_epoch_equals_scalar_epoch(variant):
    spec, fused, _ref, _ref_state = _epoch_pair(variant)
    scalar = fused.copy()
    TMETRICS.reset()
    epoch_fast.set_guard(1.0)
    spec.process_epoch(fused)
    with epoch_fast.scalar_epoch():
        spec.process_epoch(scalar)
    assert TMETRICS.count("epoch_sweep_dispatches") == 1
    assert TMETRICS.count("epoch_guard_samples") == 1
    assert fused.encode_bytes() == scalar.encode_bytes()
    if variant == "queue":
        assert [int(v.activation_epoch) for v in fused.validators[-6:]
                ].count(2**64 - 1) == 4


def test_incremental_reroots_across_an_epoch(genesis):
    """Slot by slot across the altair epoch boundary with incremental mode
    on (the participation rotation, the inactivity scores' and balances'
    writeback): every re-root equals the host oracle and the JAX
    package's root of the same slots."""
    ref, _g = genesis
    data = reference_state_bytes("altair", False)
    ref_state = ref.BeaconState.decode_bytes(data)
    spec = get_spec("altair", "minimal")
    state = _port_state(data)
    tinc.enable()
    tinc.track(state)
    TMETRICS.reset()
    spe = int(spec.SLOTS_PER_EPOCH)
    start = int(state.slot)
    end = (start // spe + 1) * spe + 2
    roots = 0
    for slot in range(start + 1, end + 1):
        with disable_bls():
            ref.process_slots(ref_state, slot)
        spec.process_slots(state, slot)
        root = bytes(spec.hash_tree_root(state))
        assert root == tinc.oracle_root(state)
        assert root == bytes(ref.hash_tree_root(ref_state))
        roots += 1
    assert TMETRICS.count("epoch_sweep_dispatches") == 1
    assert TMETRICS.count("merkle_cached_roots") >= roots
    assert state.encode_bytes() == ref_state.encode_bytes()


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _sync_block(ref, pre, participation_fn=None, attest=False):
    """A block at pre.slot + 1 with a sync aggregate of the positions
    `participation_fn` keeps (all by default) and, with `attest`, one
    attestation of pre.slot, built and applied by the JAX package.
    Returns (the signed block, the JAX package's post-state)."""
    state = pre.copy()
    attestation = (get_valid_attestation(ref, state, signed=True)
                   if attest else None)
    look = state.copy()
    next_slot(ref, look)
    block = build_empty_block_for_next_slot(ref, state)
    if attestation is not None:
        block.body.attestations.append(attestation)
    block.body.sync_aggregate = get_sync_aggregate(ref, look,
                                                   participation_fn)
    return state_transition_and_sign_block(ref, state, block), state


@pytest.fixture(scope="module")
def pre_state(genesis):
    """The JAX package's genesis advanced to slot 1."""
    ref, g = genesis
    pre = g.copy()
    next_slot(ref, pre)
    return ref, pre


@pytest.fixture(scope="module")
def full_sync_block(pre_state):
    """An empty block at slot 2 with a full sync aggregate."""
    ref, pre = pre_state
    return (ref, pre, *_sync_block(ref, pre))


@pytest.fixture(scope="module")
def attested_block(pre_state):
    """A block at slot 2 with one attestation of slot 1 and a partial sync
    aggregate (every third member out)."""
    ref, pre = pre_state
    return (ref, pre, *_sync_block(ref, pre, lambda p: p % 3 != 0,
                                   attest=True))


def _plain_calls():
    return {name: sum(w.plain_calls for w in ws)
            for name, ws in bls381_cuda.WRAPPERS.items()}


def _apply(case, pipeline):
    """The block's bytes through the port's device backend, checked one by
    one or with the pipeline on; the post-state must equal the JAX
    package's.  Returns the plain calls of each kernel."""
    _ref, pre, signed, ref_post = case
    spec = get_spec("altair", "minimal")
    state = spec.BeaconState.decode_bytes(pre.encode_bytes())
    bls.use_backend("cuda")
    before = _plain_calls()
    TMETRICS.reset()
    if pipeline:
        sigpipe.enable()
    spec.state_transition(
        state, spec.SignedBeaconBlock.decode_bytes(signed.encode_bytes()))
    after = _plain_calls()
    _assert_same(state, ref_post)
    return {name: after[name] - before[name] for name in after}


def _block_by_checks(case, n_checks):
    calls = _apply(case, pipeline=False)
    # every check one cofactor clearing and one four-warp check, the sync
    # aggregate's among them; no ladder, field or two-launch pairing
    assert calls["bls381_cofactor"] == calls["bls381_check"] == n_checks
    assert calls["bls381_g2"] == calls["bls381_field"] == \
        calls["bls381_pairing"] == 0


def _block_with_sigpipe(case, n_checks):
    calls = _apply(case, pipeline=True)
    snap = TMETRICS.snapshot()
    assert (snap["seam_hits"], snap.get("seam_misses", 0)) == (n_checks, 0)
    assert snap["signatures_scheduled"] == n_checks
    assert snap["dispatches"] == snap["fold_dispatches"] == 1
    assert snap["miller_loops_per_flush"]["total"] == n_checks + 1
    assert calls["bls381_fold"] == 1 and calls["bls381_pairing"] == 3
    assert calls["bls381_segment_sum"] >= 1
    assert calls["bls381_g2"] == calls["bls381_check"] == 0
    hints = [hint for _agg, hint in sig_cache.AGGREGATES._cache.values()]
    assert ("sync", 0) in hints


@pytest.mark.slow
def test_full_sync_block_with_sigpipe(full_sync_block):
    # the block, its randao reveal and the sync aggregate in one fold
    _block_with_sigpipe(full_sync_block, 3)


@pytest.mark.slow
def test_attested_block_with_sigpipe(attested_block):
    _block_with_sigpipe(attested_block, 4)


@pytest.mark.slow
def test_full_sync_block_by_checks_on_the_device_backend(full_sync_block):
    _block_by_checks(full_sync_block, 3)


@pytest.mark.slow
def test_attested_block_by_checks_on_the_device_backend(attested_block):
    # the block, its randao reveal, the attestation, the sync aggregate
    _block_by_checks(attested_block, 4)


def test_sync_set_is_collected_and_read_at_its_seam(attested_block):
    """The pipeline's collection (sigpipe/sets.py) emits the partial sync
    aggregate's set (its participants, the previous slot's root, the
    aggregate-cache hint ("sync", period)), and process_sync_aggregate
    reads its verdict at the seam: with every collected set's verdict
    installed, the block applies with no pairing and no seam miss."""
    from consensus_specs_tpu_torch.sigpipe import sets
    ref, pre, signed, ref_post = attested_block
    spec = get_spec("altair", "minimal")
    state = spec.BeaconState.decode_bytes(pre.encode_bytes())
    block = spec.SignedBeaconBlock.decode_bytes(signed.encode_bytes())
    look = state.copy()
    spec.process_slots(look, block.message.slot)
    collected = sets.collect_block_sets(spec, look, block)
    assert [s.kind for s in collected][-1] == "sync_aggregate"
    sync_set = collected[-1]
    committee = list(look.current_sync_committee.pubkeys)
    assert sync_set.pubkeys == tuple(
        bytes(pk) for i, pk in enumerate(committee) if i % 3 != 0)
    assert sync_set.hint == ("sync", 0)

    class Verdicts:
        def __init__(self):
            self.hits = []

        def lookup(self, pubkeys, root, signature):
            for s in collected:
                if (s.pubkeys, s.signing_root, s.signature) == \
                        (pubkeys, root, signature):
                    self.hits.append(s.kind)
                    return True
            return None
    verdicts = Verdicts()
    bls.use_backend("cuda")
    before = _plain_calls()
    with spec.install_sigpipe_verdicts(verdicts):
        spec.state_transition(state, block)
    assert _plain_calls() == before
    assert sorted(verdicts.hits) == sorted(s.kind for s in collected)
    _assert_same(state, ref_post)


def test_empty_sync_aggregate_with_infinity_is_accepted(pre_state):
    """No participant and the infinity signature: eth_fast_aggregate_verify
    returns True with no pairing, and the absent members pay their
    penalty, in both packages."""
    ref, pre = pre_state
    spec = get_spec("altair", "minimal")
    state = spec.BeaconState.decode_bytes(pre.encode_bytes())
    ref_state = pre.copy()
    aggregate = ref.SyncAggregate(
        sync_committee_signature=ref.G2_POINT_AT_INFINITY)
    ref.process_sync_aggregate(ref_state, aggregate)
    bls.use_backend("cuda")
    before = _plain_calls()
    spec.process_sync_aggregate(state, spec.SyncAggregate.decode_bytes(
        aggregate.encode_bytes()))
    assert _plain_calls() == before
    _assert_same(state, ref_state)
    assert state.balances != pre_state[1].balances


def test_full_sync_aggregate_verifies_with_a_pairing(full_sync_block,
                                                     monkeypatch):
    """A valid full sync aggregate through process_sync_aggregate alone
    with BLS on: the port's native backend runs one FastAggregateVerify
    over the 32 members (one host pairing, the memo cleared), accepts it,
    and the post-state equals the JAX package's."""
    from consensus_specs_tpu_torch.crypto import bls12_381
    ref, pre, signed, _post = full_sync_block
    aggregate = signed.message.body.sync_aggregate
    look = pre.copy()
    next_slot(ref, look)
    spec = get_spec("altair", "minimal")
    state = spec.BeaconState.decode_bytes(look.encode_bytes())
    ref.process_sync_aggregate(look, aggregate)
    verifies = []
    fast_aggregate_verify = bls12_381.FastAggregateVerify

    def counted(pubkeys, message, signature):
        verifies.append(len(pubkeys))
        return fast_aggregate_verify(pubkeys, message, signature)
    monkeypatch.setattr(bls12_381, "FastAggregateVerify", counted)
    monkeypatch.setattr(bls._VERIFY_MEMO, "_store", {})
    spec.process_sync_aggregate(state, spec.SyncAggregate.decode_bytes(
        aggregate.encode_bytes()))
    assert verifies == [int(spec.SYNC_COMMITTEE_SIZE)]
    _assert_same(state, look)


def test_bad_sync_signature_raises_in_both(attested_block):
    """A valid point over the wrong root: process_sync_aggregate raises
    AssertionError in both packages, and nothing before it is undone."""
    ref, pre, signed, _post = attested_block
    aggregate = signed.message.body.sync_aggregate.copy()
    aggregate.sync_committee_signature = jbls.Sign(
        1, b"not the sync committee's root")
    look = pre.copy()
    next_slot(ref, look)
    spec = get_spec("altair", "minimal")
    state = spec.BeaconState.decode_bytes(look.encode_bytes())
    with pytest.raises(AssertionError):
        ref.process_sync_aggregate(look.copy(), aggregate)
    with pytest.raises(AssertionError) as err:
        spec.process_sync_aggregate(state, spec.SyncAggregate.decode_bytes(
            aggregate.encode_bytes()))
    frames = [f.name for f in traceback.extract_tb(err.value.__traceback__)]
    assert frames[-1] == "process_sync_aggregate"
    assert state.encode_bytes() == look.encode_bytes()


def test_upgrade_from_phase0_matches_jax():
    """upgrade_to_altair of a phase0 state with pending attestations: the
    participation translated from them, both sync committees chosen."""
    data = reference_state_bytes("phase0", False)
    ref_pre = reference_spec("phase0", "minimal").BeaconState.decode_bytes(
        data)
    assert len(ref_pre.previous_epoch_attestations) > 0
    ref = reference_spec("altair", "minimal")
    ref_post = ref.upgrade_from(ref_pre)
    pre = get_spec("phase0", "minimal").BeaconState.decode_bytes(data)
    post = get_spec("altair", "minimal").upgrade_from(pre)
    _assert_same(post, ref_post)
    assert any(int(f) for f in post.previous_epoch_participation)


# ---------------------------------------------------------------------------
# chip_smoke.py's altair recipes at a small registry
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_chip_smoke_altair_epoch_recipe_equals_the_reference():
    """chip_smoke.py's altair epoch recipe at 4,096 mainnet validators
    across slot 127 -> 128 in both packages (3-4 s on the CPU; the card
    run holds the same recipe at 262,144 against the JAX package's pinned
    root)."""
    cs = _chip_smoke()
    spec = get_spec("altair", "mainnet")
    state = cs.altair_epoch_state(spec, 4096)
    ref = reference_spec("altair", "mainnet")
    ref_state = ref.BeaconState.decode_bytes(state.encode_bytes())
    TMETRICS.reset()
    spec.process_slots(state, cs.EPOCH_SLOT + 1)
    ref.process_slots(ref_state, cs.EPOCH_SLOT + 1)
    assert TMETRICS.count("epoch_sweep_dispatches") == 1
    _assert_same(state, ref_state)
    # validator 12 ejected, 13 eligible, 14 activated; 10 slashed
    assert int(state.validators[12].exit_epoch) == 8
    assert int(state.validators[13].activation_eligibility_epoch) == 4
    assert int(state.validators[14].activation_epoch) == 8
    assert any(int(s) for s in state.inactivity_scores)


@pytest.fixture(scope="module")
def altair_block_recipe():
    port.set_device("cpu")
    merkle.use_host_hashing()
    cs = _chip_smoke()
    spec = get_spec("altair", "mainnet")
    state, signed, facts = cs.altair_block_case(spec, 4096)
    return cs, spec, state, signed, facts


@pytest.mark.slow
def test_chip_smoke_altair_block_recipe_equals_the_reference(
        altair_block_recipe):
    """The recipe's post-state (a copy advanced and applied with BLS off)
    equals the JAX package's state_transition of its bytes, BLS off."""
    _cs, _spec, state, signed, facts = altair_block_recipe
    assert [size for _s, _i, size in facts["committees"]] == [128] * 8
    ref = reference_spec("altair", "mainnet")
    ref_state = ref.BeaconState.decode_bytes(state.encode_bytes())
    jbls.bls_active = False
    ref.state_transition(ref_state,
                         ref.SignedBeaconBlock.decode_bytes(
                             signed.encode_bytes()))
    _assert_same(facts["post"], ref_state)


@pytest.mark.slow
def test_chip_smoke_altair_block_recipe_passes_with_bls_on(
        altair_block_recipe):
    """BLS on in both packages (the port's native backend): the block is
    accepted with the same post-state, and the copy whose sync aggregate
    signs another root is rejected at process_sync_aggregate."""
    cs, spec, state, signed, facts = altair_block_recipe
    ref = reference_spec("altair", "mainnet")
    ref_state = ref.BeaconState.decode_bytes(state.encode_bytes())
    ref.state_transition(ref_state,
                         ref.SignedBeaconBlock.decode_bytes(
                             signed.encode_bytes()))
    post = state.copy()
    spec.state_transition(post, signed)
    _assert_same(post, ref_state)
    with pytest.raises(AssertionError) as err:
        spec.state_transition(state.copy(),
                              cs.tampered_sync_block(spec, signed, facts))
    frames = [f.name for f in traceback.extract_tb(err.value.__traceback__)]
    assert frames[-1] == "process_sync_aggregate"
