"""The port's phase0 epoch transition against the JAX package.

Minimal-preset phase0 states with live attestations and registry edge cases
(the edge and leak shapes of tests/test_epoch_sweep.py) are built by the
JAX package and carried across as SSZ bytes.  `process_epoch` in both
packages, with incremental merkleization on, must give equal bytes and
roots, one `epoch_sweep_dispatches` each and equal `epoch_writeback_elems`;
the port's fused epoch must equal its own `scalar_epoch()` pass list.  A
4,096-validator mainnet state made by `chip_smoke.epoch_state` (the card
check's epoch state at a small registry) crosses slot 127 -> 128 with the
JAX package's root.  The shuffle and the committees equal the reference's.
Every tolerance is exact (bytes, roots, indices).
"""
import importlib.util
import os

import numpy as np
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu import resilience
from consensus_specs_tpu.sigpipe import METRICS as JMETRICS
from consensus_specs_tpu.specs import get_spec as reference_spec
from consensus_specs_tpu.specs.shuffle import (
    shuffle_permutation as jshuffle_permutation)
from consensus_specs_tpu.ssz import incremental as jinc
from consensus_specs_tpu.test_infra import disable_bls
from consensus_specs_tpu.test_infra.genesis import build_mock_validator
from consensus_specs_tpu_torch.convert import state_from_ssz
from consensus_specs_tpu_torch.ops import epoch_sweep, epoch_sweep_cuda
from consensus_specs_tpu_torch.sigpipe import METRICS as TMETRICS
from consensus_specs_tpu_torch.specs import epoch_fast, get_spec
from consensus_specs_tpu_torch.specs.shuffle import shuffle_permutation
from consensus_specs_tpu_torch.ssz import incremental as tinc
from test_torch_epoch_sweep import reference_state_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py loaded as a module, for `epoch_state` (importing it
    runs no check)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _clean():
    port.set_device("cpu")
    resilience.disable()
    for inc in (tinc, jinc):
        inc.disable()
    epoch_fast.set_guard(0.0)
    TMETRICS.reset()
    JMETRICS.reset()
    yield
    for inc in (tinc, jinc):
        inc.disable()
    epoch_fast.set_guard(0.0)


@pytest.fixture(scope="module")
def mainnet_pair():
    """A 4,096-validator mainnet phase0 state at slot 127 with pending
    attestations and edge validators, in the port and, from its SSZ
    bytes, in the JAX package."""
    spec = get_spec("phase0", "mainnet")
    state = _chip_smoke().epoch_state(spec, 4096)
    data = state.encode_bytes()
    ref_spec = reference_spec("phase0", "mainnet")
    return spec, data, ref_spec, ref_spec.BeaconState.decode_bytes(data)


VARIANTS = ("finalizing", "leaking", "queue")


def _minimal_pair(variant):
    """The minimal-preset phase0 edge state ("finalizing"), the leak state
    ("leaking"), or the edge state with six pending validators appended to
    the activation queue, three times the churn limit ("queue"), in both
    packages."""
    ref_spec = reference_spec("phase0", "minimal")
    data = reference_state_bytes("phase0", variant == "leaking")
    if variant == "queue":
        ref = ref_spec.BeaconState.decode_bytes(data)
        for _ in range(6):
            v = build_mock_validator(ref_spec, len(ref.validators),
                                     ref_spec.MAX_EFFECTIVE_BALANCE)
            v.activation_eligibility_epoch = 0
            ref.validators.append(v)
            ref.balances.append(ref_spec.MAX_EFFECTIVE_BALANCE)
        data = ref.encode_bytes()
    spec = get_spec("phase0", "minimal")
    return (spec, state_from_ssz(spec, data), ref_spec,
            ref_spec.BeaconState.decode_bytes(data))


@pytest.mark.parametrize("variant", VARIANTS)
def test_process_epoch_matches_jax(variant):
    """Incremental mode on in both packages: the fused epoch (one sweep,
    bulk writeback, the dirty-cone re-root) gives the reference's bytes,
    roots, dispatch count and writeback count."""
    spec, state, ref_spec, ref = _minimal_pair(variant)
    jinc.enable()
    tinc.enable()
    jinc.track(ref)
    tinc.track(state)
    assert bytes(spec.hash_tree_root(state)) == \
        bytes(ref_spec.hash_tree_root(ref))
    plain_before = epoch_sweep_cuda.epoch_sweep_cuda.plain_calls
    JMETRICS.reset()
    TMETRICS.reset()
    with disable_bls():
        ref_spec.process_epoch(ref)
    spec.process_epoch(state)
    assert epoch_sweep_cuda.epoch_sweep_cuda.plain_calls == plain_before + 1
    assert TMETRICS.count("epoch_sweep_dispatches") == 1
    assert JMETRICS.count("epoch_sweep_dispatches") == 1
    assert TMETRICS.count("epoch_writeback_elems") == \
        JMETRICS.count("epoch_writeback_elems") > 0
    assert state.encode_bytes() == ref.encode_bytes()
    root = bytes(spec.hash_tree_root(state))
    assert root == bytes(ref_spec.hash_tree_root(ref))
    assert root == tinc.oracle_root(state)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_epoch_equals_scalar_epoch(variant):
    spec, fused, _ref_spec, _ref = _minimal_pair(variant)
    scalar = fused.copy()
    spec.process_epoch(fused)
    with epoch_fast.scalar_epoch():
        spec.process_epoch(scalar)
    assert TMETRICS.count("epoch_sweep_dispatches") == 1
    assert fused.encode_bytes() == scalar.encode_bytes()
    if variant == "queue":
        assert [int(v.activation_epoch) for v in fused.validators[-6:]
                ].count(2**64 - 1) == 4
    assert bytes(spec.hash_tree_root(fused)) == \
        bytes(spec.hash_tree_root(scalar))


def test_mainnet_epoch_boundary_matches_jax(mainnet_pair):
    """process_slots 127 -> 128 on a mainnet state: justification,
    rewards with the inclusion-delay scatter, slashings, the registry
    queues and the effective-balance updates, with the reference's root."""
    spec, data, ref_spec, ref = mainnet_pair
    state = state_from_ssz(spec, data)
    ref = ref.copy()
    with disable_bls():
        ref_spec.process_slots(ref, 128)
    spec.process_slots(state, 128)
    assert TMETRICS.count("epoch_sweep_dispatches") == 1
    assert state.encode_bytes() == ref.encode_bytes()
    assert bytes(spec.hash_tree_root(state)) == \
        bytes(ref_spec.hash_tree_root(ref))
    # the edge validators moved as the spec says
    assert int(state.validators[12].exit_epoch) == 8         # ejected
    assert int(state.validators[13].activation_eligibility_epoch) == 4
    assert int(state.validators[14].activation_epoch) == 8   # activated
    assert int(state.balances[10]) < int(ref_spec.BeaconState.decode_bytes(
        data).balances[10])                                  # slashed


def test_guard_holds_and_a_mismatch_raises(monkeypatch):
    """Sampled at rate 1, the guard recomputes every lane with plain_sweep;
    a corrupted lane raises and counts a mismatch instead of being
    replaced by the oracle's."""
    spec, state, _ref_spec, _ref = _minimal_pair("finalizing")
    corrupt = state.copy()
    epoch_fast.set_guard(1.0)
    spec.process_epoch(state)
    assert TMETRICS.count("epoch_guard_samples") == 1
    assert TMETRICS.count("epoch_guard_mismatches") == 0

    real = epoch_sweep.run_sweep

    def corrupted(inp):
        lanes = real(inp)
        lanes[0][1] += 1          # one Gwei on one balance
        return lanes
    monkeypatch.setattr(epoch_sweep, "run_sweep", corrupted)
    balances = list(corrupt.balances)
    with pytest.raises(RuntimeError, match="guard mismatch"):
        spec.process_epoch(corrupt)
    assert TMETRICS.count("epoch_guard_samples") == 2
    assert TMETRICS.count("epoch_guard_mismatches") == 1
    # it raised before the writeback: no balance moved
    assert list(corrupt.balances) == balances
    assert list(state.balances) != balances


@pytest.mark.parametrize("seed,n,rounds", [
    (b"\x00" * 32, 0, 90), (b"\x01" * 32, 1, 90), (bytes(range(32)), 2, 10),
    (bytes(range(32, 64)), 1000, 10), (bytes(range(1, 33)), 4096, 90)])
def test_shuffle_permutation_matches_jax(seed, n, rounds):
    got = shuffle_permutation(seed, n, rounds)
    assert got.dtype == np.int64
    assert np.array_equal(got, jshuffle_permutation(seed, n, rounds))


def test_committees_and_shuffled_index_match_jax(mainnet_pair):
    spec, data, ref_spec, ref = mainnet_pair
    state = state_from_ssz(spec, data)
    for slot, index in ((64, 0), (95, 0), (100, 0), (127, 0)):
        assert [int(i) for i in spec.get_beacon_committee(state, slot, index)] \
            == [int(i) for i in ref_spec.get_beacon_committee(ref, slot, index)]
    seed = bytes(spec.get_seed(state, 3, spec.DOMAIN_BEACON_ATTESTER))
    perm = spec._shuffle_permutation(seed, 4096)
    for i in (0, 1, 2047, 4095):
        assert spec.compute_shuffled_index(i, 4096, seed) == \
            ref_spec.compute_shuffled_index(i, 4096, seed) == perm[i]
    att = state.previous_epoch_attestations[0]
    assert sorted(int(i) for i in spec.get_attesting_indices(state, att)) == \
        sorted(int(i) for i in ref_spec.get_attesting_indices(
            ref, ref.previous_epoch_attestations[0]))
