"""Phase0 beacon-chain spec (partial port).

Counterpart of consensus_specs_tpu/specs/phase0.py, which implements the
consensus-specs phase0 rules (specs/phase0/beacon-chain.md) function by
function.  This slice ports the constants, the SSZ containers, the math
helpers, the predicates and accessors that need neither shuffling nor BLS,
and the per-slot transition (`process_slots` / `process_slot`), whose state
root is the port's main path.  Block processing, the fork-choice and
validator-duty mixins, shuffling and BLS come with later slices of the port
(ROADMAP.md); `process_epoch` raises until the epoch slice lands.

NOTE: no `from __future__ import annotations` here — SSZ Container fields
are declared via class annotations and must stay live types (PEP 563 would
stringify them).
"""
from ..ssz import (
    uint8, uint32, uint64, boolean, Bitlist, Bitvector, ByteVector, ByteList,
    Vector, List, Container, Bytes4, Bytes32, Bytes48, Bytes96,
    hash_tree_root, serialize, uint_to_bytes,
)
from ..ssz.merkle import is_valid_merkle_branch as _merkle_branch_ok
from ..utils.hash import hash as sha256_hash
from .base import BaseSpec


def integer_squareroot(n: int) -> int:
    """Largest x with x*x <= n (beacon-chain.md "integer_squareroot")."""
    if n < 0:
        raise ValueError("negative input")
    x = int(n)
    y = (x + 1) // 2
    while y < x:
        x = y
        y = (x + n // x) // 2
    return uint64(x)


def xor(a: bytes, b: bytes) -> Bytes32:
    return Bytes32(bytes(x ^ y for x, y in zip(a, b)))


def bytes_to_uint64(data: bytes) -> uint64:
    return uint64(int.from_bytes(data, "little"))


class Phase0Spec(BaseSpec):
    fork = "phase0"

    # ------------------------------------------------------------------
    # constants (beacon-chain.md "Constants" tables)
    # ------------------------------------------------------------------
    def _build_constants(self) -> None:
        super()._build_constants()
        self.GENESIS_SLOT = uint64(0)
        self.GENESIS_EPOCH = uint64(0)
        self.FAR_FUTURE_EPOCH = uint64(2**64 - 1)
        self.BASE_REWARDS_PER_EPOCH = uint64(4)
        self.DEPOSIT_CONTRACT_TREE_DEPTH = 2**5
        self.JUSTIFICATION_BITS_LENGTH = 4
        self.ENDIANNESS = "little"
        self.BLS_WITHDRAWAL_PREFIX = b"\x00"
        self.ETH1_ADDRESS_WITHDRAWAL_PREFIX = b"\x01"
        self.DOMAIN_BEACON_PROPOSER = Bytes4("0x00000000")
        self.DOMAIN_BEACON_ATTESTER = Bytes4("0x01000000")
        self.DOMAIN_RANDAO = Bytes4("0x02000000")
        self.DOMAIN_DEPOSIT = Bytes4("0x03000000")
        self.DOMAIN_VOLUNTARY_EXIT = Bytes4("0x04000000")
        self.DOMAIN_SELECTION_PROOF = Bytes4("0x05000000")
        self.DOMAIN_AGGREGATE_AND_PROOF = Bytes4("0x06000000")
        self.DOMAIN_APPLICATION_MASK = Bytes4("0x00000001")
        # validator.md
        self.TARGET_AGGREGATORS_PER_COMMITTEE = 2**4
        # p2p-interface.md
        self.ATTESTATION_SUBNET_COUNT = 64
        self.EPOCHS_PER_SUBNET_SUBSCRIPTION = 2**8
        self.SUBNETS_PER_NODE = 2
        self.NODE_ID_BITS = 256
        # custom "types" (aliases; all uint64 / bytes)
        self.Slot = uint64
        self.Epoch = uint64
        self.CommitteeIndex = uint64
        self.ValidatorIndex = uint64
        self.Gwei = uint64
        self.Root = Bytes32
        self.Hash32 = Bytes32
        self.Version = Bytes4
        self.DomainType = Bytes4
        self.ForkDigest = Bytes4
        self.Domain = Bytes32
        self.BLSPubkey = Bytes48
        self.BLSSignature = Bytes96

    # ------------------------------------------------------------------
    # SSZ containers (beacon-chain.md "Containers")
    # ------------------------------------------------------------------
    def _build_types(self) -> None:
        super()._build_types()
        p = self

        class Fork(Container):
            previous_version: Bytes4
            current_version: Bytes4
            epoch: uint64

        class ForkData(Container):
            current_version: Bytes4
            genesis_validators_root: Bytes32

        class Checkpoint(Container):
            epoch: uint64
            root: Bytes32

        class Validator(Container):
            pubkey: Bytes48
            withdrawal_credentials: Bytes32
            effective_balance: uint64
            slashed: boolean
            activation_eligibility_epoch: uint64
            activation_epoch: uint64
            exit_epoch: uint64
            withdrawable_epoch: uint64

        class AttestationData(Container):
            slot: uint64
            index: uint64
            beacon_block_root: Bytes32
            source: Checkpoint
            target: Checkpoint

        class IndexedAttestation(Container):
            attesting_indices: List[uint64, p.MAX_VALIDATORS_PER_COMMITTEE]
            data: AttestationData
            signature: Bytes96

        class PendingAttestation(Container):
            aggregation_bits: Bitlist[p.MAX_VALIDATORS_PER_COMMITTEE]
            data: AttestationData
            inclusion_delay: uint64
            proposer_index: uint64

        class Eth1Data(Container):
            deposit_root: Bytes32
            deposit_count: uint64
            block_hash: Bytes32

        class HistoricalBatch(Container):
            block_roots: Vector[Bytes32, p.SLOTS_PER_HISTORICAL_ROOT]
            state_roots: Vector[Bytes32, p.SLOTS_PER_HISTORICAL_ROOT]

        class DepositMessage(Container):
            pubkey: Bytes48
            withdrawal_credentials: Bytes32
            amount: uint64

        class DepositData(Container):
            pubkey: Bytes48
            withdrawal_credentials: Bytes32
            amount: uint64
            signature: Bytes96

        class BeaconBlockHeader(Container):
            slot: uint64
            proposer_index: uint64
            parent_root: Bytes32
            state_root: Bytes32
            body_root: Bytes32

        class SigningData(Container):
            object_root: Bytes32
            domain: Bytes32

        class SignedBeaconBlockHeader(Container):
            message: BeaconBlockHeader
            signature: Bytes96

        class ProposerSlashing(Container):
            signed_header_1: SignedBeaconBlockHeader
            signed_header_2: SignedBeaconBlockHeader

        class AttesterSlashing(Container):
            attestation_1: IndexedAttestation
            attestation_2: IndexedAttestation

        class Attestation(Container):
            aggregation_bits: Bitlist[p.MAX_VALIDATORS_PER_COMMITTEE]
            data: AttestationData
            signature: Bytes96

        class Deposit(Container):
            proof: Vector[Bytes32, p.DEPOSIT_CONTRACT_TREE_DEPTH + 1]
            data: DepositData

        class VoluntaryExit(Container):
            epoch: uint64
            validator_index: uint64

        class SignedVoluntaryExit(Container):
            message: VoluntaryExit
            signature: Bytes96

        class BeaconBlockBody(Container):
            randao_reveal: Bytes96
            eth1_data: Eth1Data
            graffiti: Bytes32
            proposer_slashings: List[ProposerSlashing, p.MAX_PROPOSER_SLASHINGS]
            attester_slashings: List[AttesterSlashing, p.MAX_ATTESTER_SLASHINGS]
            attestations: List[Attestation, p.MAX_ATTESTATIONS]
            deposits: List[Deposit, p.MAX_DEPOSITS]
            voluntary_exits: List[SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS]

        class BeaconBlock(Container):
            slot: uint64
            proposer_index: uint64
            parent_root: Bytes32
            state_root: Bytes32
            body: BeaconBlockBody

        class SignedBeaconBlock(Container):
            message: BeaconBlock
            signature: Bytes96

        class BeaconState(Container):
            genesis_time: uint64
            genesis_validators_root: Bytes32
            slot: uint64
            fork: Fork
            latest_block_header: BeaconBlockHeader
            block_roots: Vector[Bytes32, p.SLOTS_PER_HISTORICAL_ROOT]
            state_roots: Vector[Bytes32, p.SLOTS_PER_HISTORICAL_ROOT]
            historical_roots: List[Bytes32, p.HISTORICAL_ROOTS_LIMIT]
            eth1_data: Eth1Data
            eth1_data_votes: List[Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH]
            eth1_deposit_index: uint64
            validators: List[Validator, p.VALIDATOR_REGISTRY_LIMIT]
            balances: List[uint64, p.VALIDATOR_REGISTRY_LIMIT]
            randao_mixes: Vector[Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR]
            slashings: Vector[uint64, p.EPOCHS_PER_SLASHINGS_VECTOR]
            previous_epoch_attestations: List[PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH]
            current_epoch_attestations: List[PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH]
            justification_bits: Bitvector[p.JUSTIFICATION_BITS_LENGTH]
            previous_justified_checkpoint: Checkpoint
            current_justified_checkpoint: Checkpoint
            finalized_checkpoint: Checkpoint

        class Eth1Block(Container):
            timestamp: uint64
            deposit_root: Bytes32
            deposit_count: uint64

        class AggregateAndProof(Container):
            aggregator_index: uint64
            aggregate: Attestation
            selection_proof: Bytes96

        class SignedAggregateAndProof(Container):
            message: AggregateAndProof
            signature: Bytes96

        for name, cls in list(locals().items()):
            if isinstance(cls, type) and issubclass(cls, Container):
                setattr(self, name, cls)


    # ------------------------------------------------------------------
    # math / crypto helpers
    # ------------------------------------------------------------------
    integer_squareroot = staticmethod(integer_squareroot)
    xor = staticmethod(xor)
    bytes_to_uint64 = staticmethod(bytes_to_uint64)
    uint_to_bytes = staticmethod(uint_to_bytes)
    hash = staticmethod(sha256_hash)
    hash_tree_root = staticmethod(hash_tree_root)
    serialize = staticmethod(serialize)

    @staticmethod
    def is_valid_merkle_branch(leaf, branch, depth, index, root) -> bool:
        return _merkle_branch_ok(bytes(leaf), [bytes(b) for b in branch],
                                 int(depth), int(index), bytes(root))

    # ------------------------------------------------------------------
    # predicates (beacon-chain.md "Predicates")
    # ------------------------------------------------------------------
    def is_active_validator(self, validator, epoch) -> bool:
        return validator.activation_epoch <= epoch < validator.exit_epoch

    def is_eligible_for_activation_queue(self, validator) -> bool:
        return (validator.activation_eligibility_epoch == self.FAR_FUTURE_EPOCH
                and validator.effective_balance == self.MAX_EFFECTIVE_BALANCE)

    def is_eligible_for_activation(self, state, validator) -> bool:
        return (validator.activation_eligibility_epoch
                <= state.finalized_checkpoint.epoch
                and validator.activation_epoch == self.FAR_FUTURE_EPOCH)

    def is_slashable_validator(self, validator, epoch) -> bool:
        return (not validator.slashed
                and validator.activation_epoch <= epoch < validator.withdrawable_epoch)

    def is_slashable_attestation_data(self, data_1, data_2) -> bool:
        # double vote or surround vote
        return ((data_1 != data_2 and data_1.target.epoch == data_2.target.epoch)
                or (data_1.source.epoch < data_2.source.epoch
                    and data_2.target.epoch < data_1.target.epoch))

    # ------------------------------------------------------------------
    # misc computations (beacon-chain.md "Misc" helpers)
    # ------------------------------------------------------------------
    def compute_epoch_at_slot(self, slot) -> int:
        return uint64(slot // self.SLOTS_PER_EPOCH)

    def compute_start_slot_at_epoch(self, epoch) -> int:
        return uint64(epoch * self.SLOTS_PER_EPOCH)

    def compute_activation_exit_epoch(self, epoch) -> int:
        return uint64(epoch + 1 + self.MAX_SEED_LOOKAHEAD)

    def compute_fork_data_root(self, current_version, genesis_validators_root):
        return hash_tree_root(self.ForkData(
            current_version=current_version,
            genesis_validators_root=genesis_validators_root))

    def compute_fork_digest(self, current_version, genesis_validators_root):
        return Bytes4(self.compute_fork_data_root(
            current_version, genesis_validators_root)[:4])

    def compute_fork_version(self, epoch):
        """Fork version active at `epoch`, over this spec's fork ladder
        (each fork's fork.md compute_fork_version, generalized)."""
        ladder = ["fulu", "electra", "deneb", "capella", "bellatrix",
                  "altair"]
        for name in ladder:
            if not self.is_post(name):
                continue
            fork_epoch = self.config.get(
                f"{name.upper()}_FORK_EPOCH", 2**64 - 1)
            if epoch >= fork_epoch:
                return Bytes4(
                    getattr(self.config, f"{name.upper()}_FORK_VERSION"))
        return Bytes4(self.config.GENESIS_FORK_VERSION)

    def compute_domain(self, domain_type, fork_version=None,
                       genesis_validators_root=None):
        if fork_version is None:
            fork_version = Bytes4(self.config.GENESIS_FORK_VERSION)
        if genesis_validators_root is None:
            genesis_validators_root = Bytes32()
        fork_data_root = self.compute_fork_data_root(
            fork_version, genesis_validators_root)
        return Bytes32(bytes(domain_type) + bytes(fork_data_root)[:28])

    def compute_signing_root(self, ssz_object, domain):
        return hash_tree_root(self.SigningData(
            object_root=hash_tree_root(ssz_object), domain=domain))

    # ------------------------------------------------------------------
    # accessors (beacon-chain.md "Beacon state accessors")
    # ------------------------------------------------------------------
    def get_current_epoch(self, state) -> int:
        return self.compute_epoch_at_slot(state.slot)

    def get_previous_epoch(self, state) -> int:
        current = self.get_current_epoch(state)
        return self.GENESIS_EPOCH if current == self.GENESIS_EPOCH \
            else uint64(current - 1)

    def get_block_root(self, state, epoch):
        return self.get_block_root_at_slot(
            state, self.compute_start_slot_at_epoch(epoch))

    def get_block_root_at_slot(self, state, slot):
        assert slot < state.slot <= slot + self.SLOTS_PER_HISTORICAL_ROOT
        return state.block_roots[slot % self.SLOTS_PER_HISTORICAL_ROOT]

    def get_randao_mix(self, state, epoch):
        return state.randao_mixes[epoch % self.EPOCHS_PER_HISTORICAL_VECTOR]

    def get_active_validator_indices(self, state, epoch):
        return [uint64(i) for i, v in enumerate(state.validators)
                if self.is_active_validator(v, epoch)]

    def get_validator_churn_limit(self, state) -> int:
        active = self.get_active_validator_indices(
            state, self.get_current_epoch(state))
        return uint64(max(self.config.MIN_PER_EPOCH_CHURN_LIMIT,
                          len(active) // self.config.CHURN_LIMIT_QUOTIENT))

    def get_seed(self, state, epoch, domain_type):
        mix = self.get_randao_mix(
            state, uint64(epoch + self.EPOCHS_PER_HISTORICAL_VECTOR
                          - self.MIN_SEED_LOOKAHEAD - 1))
        return self.hash(bytes(domain_type) + uint_to_bytes(uint64(epoch))
                         + bytes(mix))

    def get_committee_count_per_slot(self, state, epoch) -> int:
        active = len(self.get_active_validator_indices(state, epoch))
        return uint64(max(1, min(
            self.MAX_COMMITTEES_PER_SLOT,
            active // self.SLOTS_PER_EPOCH // self.TARGET_COMMITTEE_SIZE)))

    def get_total_balance(self, state, indices) -> int:
        return uint64(max(
            self.EFFECTIVE_BALANCE_INCREMENT,
            sum(int(state.validators[i].effective_balance) for i in indices)))

    def get_total_active_balance(self, state) -> int:
        return self.get_total_balance(
            state, set(self.get_active_validator_indices(
                state, self.get_current_epoch(state))))

    def get_domain(self, state, domain_type, epoch=None):
        epoch = self.get_current_epoch(state) if epoch is None else epoch
        fork_version = (state.fork.previous_version if epoch < state.fork.epoch
                        else state.fork.current_version)
        return self.compute_domain(domain_type, fork_version,
                                   state.genesis_validators_root)

    # ------------------------------------------------------------------
    # state transition (beacon-chain.md "Beacon chain state transition")
    # ------------------------------------------------------------------
    def process_slots(self, state, slot) -> None:
        assert state.slot < slot
        while state.slot < slot:
            self.process_slot(state)
            if (state.slot + 1) % self.SLOTS_PER_EPOCH == 0:
                self.process_epoch(state)
            state.slot = uint64(state.slot + 1)

    def process_slot(self, state) -> None:
        previous_state_root = hash_tree_root(state)
        state.state_roots[state.slot % self.SLOTS_PER_HISTORICAL_ROOT] = \
            previous_state_root
        if state.latest_block_header.state_root == Bytes32():
            state.latest_block_header.state_root = previous_state_root
        previous_block_root = hash_tree_root(state.latest_block_header)
        state.block_roots[state.slot % self.SLOTS_PER_HISTORICAL_ROOT] = \
            previous_block_root

    def process_epoch(self, state) -> None:
        raise NotImplementedError(
            "epoch processing is not ported yet: it comes with the epoch "
            "slice (ROADMAP.md queue A item 3, ops/epoch_sweep.py)")
