"""The port's per-slot transition against the JAX package.

A mainnet-preset phase0 BeaconState with 4,096 validators is built from a
seed in the JAX package and carried across as SSZ bytes.  The bulk and
subtree thresholds are lowered so that the port's device hashers, which on
the CPU run the plain torch SHA-256, take the big levels; the state root and
three `process_slots` steps inside one epoch must match byte for byte, and
a minimal-preset state must cross its epoch boundary with the reference's
root.
"""
import numpy as np
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.sigpipe import METRICS as JMETRICS
from consensus_specs_tpu.specs import get_spec as reference_spec
from consensus_specs_tpu.ssz import incremental as jinc
from consensus_specs_tpu_torch.convert import state_from_ssz
from consensus_specs_tpu_torch.ops import sha256_cuda
from consensus_specs_tpu_torch.sigpipe import METRICS as TMETRICS
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz import incremental as tinc
from consensus_specs_tpu_torch.ssz import merkle

N_VALIDATORS = 4096
START_SLOT = 97   # mid-epoch: 97..99 never reach an epoch boundary


@pytest.fixture(autouse=True)
def _low_thresholds_on_cpu():
    port.set_device("cpu")
    merkle.use_device_hashing(threshold=256, subtree_threshold=1024)
    yield
    merkle.use_device_hashing()


def _reference_state(seed, n):
    spec = reference_spec("phase0", "mainnet")
    rng = np.random.default_rng(seed)
    max_eb = int(spec.MAX_EFFECTIVE_BALANCE)
    pubkeys = rng.bytes(48 * n)
    state = spec.BeaconState(
        genesis_time=spec.config.MIN_GENESIS_TIME,
        genesis_validators_root=rng.bytes(32),
        randao_mixes=[rng.bytes(32)
                      for _ in range(spec.EPOCHS_PER_HISTORICAL_VECTOR)])
    state.validators = [
        spec.Validator(
            pubkey=pubkeys[48 * i:48 * (i + 1)],
            withdrawal_credentials=b"\x01" + b"\x00" * 11 + rng.bytes(20),
            effective_balance=max_eb,
            activation_epoch=0,
            activation_eligibility_epoch=0,
            exit_epoch=spec.FAR_FUTURE_EPOCH,
            withdrawable_epoch=spec.FAR_FUTURE_EPOCH)
        for i in range(n)]
    state.balances = [int(b) for b in
                      max_eb + rng.integers(-10**9, 10**9, n)]
    state.block_roots = [rng.bytes(32)
                         for _ in range(spec.SLOTS_PER_HISTORICAL_ROOT)]
    state.state_roots = [rng.bytes(32)
                         for _ in range(spec.SLOTS_PER_HISTORICAL_ROOT)]
    state.slashings = [int(x) for x in
                       rng.integers(0, 2**40, spec.EPOCHS_PER_SLASHINGS_VECTOR)]
    state.slot = START_SLOT
    # an empty header state root: process_slot fills it on the first slot
    state.latest_block_header = spec.BeaconBlockHeader(
        slot=START_SLOT - 1, proposer_index=5, parent_root=rng.bytes(32),
        body_root=rng.bytes(32))
    return spec, state


def test_state_root_and_process_slots_match_jax():
    ref_spec, ref = _reference_state(97, N_VALIDATORS)
    spec = get_spec("phase0", "mainnet")
    state = state_from_ssz(spec, ref.encode_bytes())

    plain_before = sha256_cuda.hash_pairs_cuda.plain_calls
    merkle.reset_stats()
    assert bytes(spec.hash_tree_root(state)) == bytes(ref_spec.hash_tree_root(ref))
    assert sha256_cuda.hash_pairs_cuda.plain_calls > plain_before
    assert merkle.stats["device_pairs"] > 0

    end = START_SLOT + 3
    ref_spec.process_slots(ref, end)
    spec.process_slots(state, end)
    assert state.slot == end
    assert state.encode_bytes() == ref.encode_bytes()
    assert bytes(spec.hash_tree_root(state)) == bytes(ref_spec.hash_tree_root(ref))


def test_incremental_process_slots_match_jax():
    """process_slots tracks the state: with incremental mode on in both
    packages, the cache build (one fused sweep in the port, through the
    gather-hash wrapper) and the per-slot diff re-roots give the
    reference's bytes, roots and sweep counts."""
    ref_spec, ref = _reference_state(98, N_VALIDATORS)
    spec = get_spec("phase0", "mainnet")
    state = state_from_ssz(spec, ref.encode_bytes())
    end = START_SLOT + 3
    jinc.enable()
    tinc.enable()
    JMETRICS.reset()
    TMETRICS.reset()
    try:
        plain_before = sha256_cuda.hash_gather_pairs_cuda.plain_calls
        ref_spec.process_slots(ref, end)
        spec.process_slots(state, end)
        assert tinc.is_tracked(state)
        assert sha256_cuda.hash_gather_pairs_cuda.plain_calls > plain_before
        assert state.encode_bytes() == ref.encode_bytes()
        root = bytes(spec.hash_tree_root(state))
        assert root == bytes(ref_spec.hash_tree_root(ref))
        for name in ("merkle_cache_builds", "merkle_sweep_dispatches",
                     "merkle_chunks_hashed", "merkle_dirty_nodes"):
            assert TMETRICS.count(name) == JMETRICS.count(name), name
        assert TMETRICS.count("merkle_cache_builds") == 1
    finally:
        jinc.disable()
        tinc.disable()


def test_process_slots_stops_at_the_epoch_slice():
    """The minimal-preset state of the slice-1 check, which raised at its
    epoch boundary before the epoch slice was ported, now crosses it: the
    port's process_slots runs process_epoch at the last slot of epoch 0
    and gives the JAX package's bytes and root."""
    spec = get_spec("phase0", "minimal")
    state = spec.BeaconState(slot=spec.SLOTS_PER_EPOCH - 1)
    ref_spec = reference_spec("phase0", "minimal")
    ref = ref_spec.BeaconState.decode_bytes(state.encode_bytes())
    spec.process_slots(state, spec.SLOTS_PER_EPOCH)
    ref_spec.process_slots(ref, ref_spec.SLOTS_PER_EPOCH)
    assert state.slot == spec.SLOTS_PER_EPOCH
    assert state.encode_bytes() == ref.encode_bytes()
    assert bytes(spec.hash_tree_root(state)) == \
        bytes(ref_spec.hash_tree_root(ref))
