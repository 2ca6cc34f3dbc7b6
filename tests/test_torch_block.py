"""The port's phase0 block processing with BLS on, against the JAX package.

Signed blocks are built by the JAX package's `test_infra` on a minimal
genesis state with real keys, applied there with its native BLS, and
carried into the port as SSZ bytes (state and signed block).  The port's
`state_transition` must give the same post-state bytes and root:

- an empty block and a block with one attestation, on the port's default
  device backend (the ladder and pairing kernels' plain versions on the
  CPU: 2 and 3 signature checks);
- a proposer slashing, an attester slashing and deposits with a valid and
  with an invalid proof of possession (skipped, not raised), on the
  port's native backend;
- a block whose attestation carries the wrong signature raises
  AssertionError in both packages, at `process_attestation`.

`chip_smoke.py`'s block recipe (`block_case`: 8 full committees, a
proposer and an attester slashing) at 4,096 mainnet validators gives the
JAX package's post-state, with BLS off on both sides; its tampered copy is
rejected at the first attestation by the port's native backend, and under
`slow` the valid block passes it with BLS on.  Exact comparisons (bytes,
roots).
"""
import importlib.util
import os
import traceback

import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu import resilience
from consensus_specs_tpu.specs import get_spec as reference_spec
from consensus_specs_tpu.test_infra.attestations import get_valid_attestation
from consensus_specs_tpu.test_infra.blocks import (
    build_empty_block_for_next_slot, next_slot, sign_block,
    state_transition_and_sign_block)
from consensus_specs_tpu.test_infra.context import (
    _genesis_state, default_activation_threshold, default_balances)
from consensus_specs_tpu.test_infra.deposits import prepare_state_and_deposit
from consensus_specs_tpu.test_infra.slashings import (
    get_valid_attester_slashing, get_valid_proposer_slashing)
from consensus_specs_tpu.utils import bls as jbls
from consensus_specs_tpu_torch.ops import bls381_cuda
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz import merkle
from consensus_specs_tpu_torch.utils import bls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _clean():
    port.set_device("cpu")
    merkle.use_host_hashing()
    resilience.disable()
    bls.use_backend("cuda")
    bls.bls_active = True
    jbls.bls_active = True
    yield
    bls.use_backend("cuda")
    bls.bls_active = True
    jbls.bls_active = True
    merkle.use_device_hashing()


@pytest.fixture(scope="module")
def genesis():
    ref = reference_spec("phase0", "minimal")
    return ref, _genesis_state(ref, default_balances,
                               default_activation_threshold, "default")


def _at_slot_1(ref, genesis_state):
    state = genesis_state.copy()
    next_slot(ref, state)
    return state


def _port_apply(pre_bytes, signed_bytes, backend):
    spec = get_spec("phase0", "minimal")
    state = spec.BeaconState.decode_bytes(pre_bytes)
    signed = spec.SignedBeaconBlock.decode_bytes(signed_bytes)
    bls.use_backend(backend)
    spec.state_transition(state, signed)
    return state


def _check_block(ref, pre, build, backend):
    """Build the block on a copy of `pre` in the reference (which applies
    it), then apply its bytes in the port; equal bytes and roots."""
    ref_state = pre.copy()
    signed = build(ref, ref_state)
    state = _port_apply(pre.encode_bytes(), signed.encode_bytes(), backend)
    assert state.encode_bytes() == ref_state.encode_bytes()
    assert bytes(state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
    return state, signed


def test_empty_block_on_the_device_backend(genesis):
    ref, g = genesis
    before = bls381_cuda.miller.plain_calls

    def build(ref, state):
        block = build_empty_block_for_next_slot(ref, state)
        return state_transition_and_sign_block(ref, state, block)
    _check_block(ref, g, build, "cuda")
    # the block signature and the randao reveal, one check each
    assert bls381_cuda.miller.plain_calls == before + 2


def test_attestation_block_on_the_device_backend(genesis):
    ref, g = genesis
    pre = _at_slot_1(ref, g)
    ladders = bls381_cuda.g2_ladder.plain_calls

    def build(ref, state):
        attestation = get_valid_attestation(ref, state, signed=True)
        next_slot(ref, state)
        block = build_empty_block_for_next_slot(ref, state)
        block.body.attestations.append(attestation)
        return state_transition_and_sign_block(ref, state, block)
    state, _ = _check_block(ref, pre, build, "cuda")
    assert len(state.previous_epoch_attestations) + \
        len(state.current_epoch_attestations) == 1
    assert bls381_cuda.g2_ladder.plain_calls == ladders + 3


def test_proposer_slashing_block(genesis):
    ref, g = genesis
    pre = _at_slot_1(ref, g)

    def build(ref, state):
        victim = len(state.validators) - 1
        slashing = get_valid_proposer_slashing(ref, state,
                                               proposer_index=victim)
        block = build_empty_block_for_next_slot(ref, state)
        block.body.proposer_slashings.append(slashing)
        return state_transition_and_sign_block(ref, state, block)
    state, _ = _check_block(ref, pre, build, "native")
    assert state.validators[len(state.validators) - 1].slashed


def test_attester_slashing_block(genesis):
    ref, g = genesis
    pre = _at_slot_1(ref, g)

    def build(ref, state):
        slashing = get_valid_attester_slashing(ref, state, signed_1=True,
                                               signed_2=True)
        block = build_empty_block_for_next_slot(ref, state)
        block.body.attester_slashings.append(slashing)
        return state_transition_and_sign_block(ref, state, block)
    state, _ = _check_block(ref, pre, build, "native")
    assert sum(v.slashed for v in state.validators) > 0


@pytest.mark.parametrize("signed", [True, False],
                         ids=["valid_proof", "invalid_proof"])
def test_deposit_block(genesis, signed):
    ref, g = genesis
    pre = _at_slot_1(ref, g)
    new_index = len(pre.validators)
    deposit = prepare_state_and_deposit(ref, pre, new_index,
                                        int(ref.MAX_EFFECTIVE_BALANCE),
                                        signed=signed)

    def build(ref, state):
        block = build_empty_block_for_next_slot(ref, state)
        block.body.deposits.append(deposit)
        return state_transition_and_sign_block(ref, state, block)
    state, _ = _check_block(ref, pre, build, "native")
    assert int(state.eth1_deposit_index) == 1
    assert len(state.validators) == new_index + (1 if signed else 0)


def test_bad_attestation_signature_raises_in_both(genesis):
    ref, g = genesis
    state = _at_slot_1(ref, g)
    attestation = get_valid_attestation(ref, state, signed=True)
    attestation.signature = jbls.Sign(1, b"not the attestation")
    pre = state.copy()
    next_slot(ref, state)
    block = build_empty_block_for_next_slot(ref, state)
    block.body.attestations.append(attestation)
    signed = sign_block(ref, state, block)
    with pytest.raises(AssertionError):
        ref.state_transition(pre.copy(), signed)
    with pytest.raises(AssertionError) as err:
        _port_apply(pre.encode_bytes(), signed.encode_bytes(), "native")
    frames = [f.name for f in traceback.extract_tb(err.value.__traceback__)]
    assert "process_attestation" in frames


@pytest.fixture(scope="module")
def mainnet_block():
    """chip_smoke's block recipe at 4,096 mainnet validators."""
    port.set_device("cpu")
    merkle.use_host_hashing()
    cs = _chip_smoke()
    spec = get_spec("phase0", "mainnet")
    state, signed, facts = cs.block_case(spec, 4096)
    return cs, spec, state, signed, facts


def test_chip_smoke_block_recipe_equals_the_reference(mainnet_block):
    _cs, spec, state, signed, facts = mainnet_block
    assert len(facts["committees"]) == 8
    assert all(size == 128 for _s, _i, size in facts["committees"])
    ref = reference_spec("phase0", "mainnet")
    ref_state = ref.BeaconState.decode_bytes(state.encode_bytes())
    ref_signed = ref.SignedBeaconBlock.decode_bytes(signed.encode_bytes())
    post = state.copy()
    bls.bls_active = False
    jbls.bls_active = False
    spec.state_transition(post, signed)
    ref.state_transition(ref_state, ref_signed)
    assert post.encode_bytes() == ref_state.encode_bytes()
    assert bytes(post.hash_tree_root()) == bytes(ref_state.hash_tree_root())
    assert sum(v.slashed for v in post.validators) == 2
    assert len(post.current_epoch_attestations) == 2
    assert len(post.previous_epoch_attestations) == 6


def test_chip_smoke_tampered_block_is_rejected_at_its_attestation(
        mainnet_block):
    cs, spec, state, signed, facts = mainnet_block
    bls.use_backend("native")
    with pytest.raises(AssertionError) as err:
        spec.state_transition(state.copy(),
                              cs.tampered_block(spec, signed, facts))
    frames = [f.name for f in traceback.extract_tb(err.value.__traceback__)]
    assert frames[-1] == "process_attestation"


@pytest.mark.slow
def test_chip_smoke_block_passes_the_native_backend(mainnet_block):
    _cs, spec, state, signed, _facts = mainnet_block
    bls.use_backend("native")
    post = state.copy()
    spec.state_transition(post, signed)
    assert int(post.slot) == 98
