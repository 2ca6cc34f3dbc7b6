"""The port's per-slot transition against the JAX package.

A mainnet-preset phase0 BeaconState with 4,096 validators is built from a
seed in the JAX package and carried across as SSZ bytes.  The bulk and
subtree thresholds are lowered so that the port's device hashers, which on
the CPU run the plain torch SHA-256, take the big levels; the state root and
three `process_slots` steps inside one epoch must match byte for byte.
"""
import numpy as np
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.specs import get_spec as reference_spec
from consensus_specs_tpu_torch.convert import state_from_ssz
from consensus_specs_tpu_torch.ops import sha256_cuda
from consensus_specs_tpu_torch.specs import get_spec
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


def test_process_slots_stops_at_the_epoch_slice():
    """An epoch boundary needs the epoch slice, which is not ported: the
    port raises rather than computing an epoch some other way."""
    spec = get_spec("phase0", "minimal")
    state = spec.BeaconState(slot=spec.SLOTS_PER_EPOCH - 1)
    with pytest.raises(NotImplementedError, match="epoch"):
        spec.process_slots(state, spec.SLOTS_PER_EPOCH)
