"""Phase0 beacon-chain spec (partial port).

Counterpart of consensus_specs_tpu/specs/phase0.py, which implements the
consensus-specs phase0 rules (specs/phase0/beacon-chain.md) function by
function.  Ported so far: the constants, the SSZ containers, the math
helpers, the predicates, the shuffle and committee accessors, the mutators,
the per-slot transition (`process_slots` / `process_slot`), whose state root
is the port's main path, and epoch processing.  `process_slots` tracks the
state for incremental merkleization as the reference does
(ssz/incremental.py).  `process_epoch` runs the fused engine
(specs/epoch_fast.py: one `ops.epoch_sweep` dispatch, on the CUDA kernel on
the card) and then the cheap tail resets; inside `epoch_fast.scalar_epoch()`
it runs the reference-shaped scalar pass list instead.  Block processing,
the fork-choice and validator-duty mixins, proposer selection and BLS come
with later slices of the port (ROADMAP.md).

NOTE: no `from __future__ import annotations` here — SSZ Container fields
are declared via class annotations and must stay live types (PEP 563 would
stringify them).
"""
from ..ssz import (
    uint8, uint32, uint64, boolean, Bitlist, Bitvector, ByteVector, ByteList,
    Vector, List, Container, Bytes4, Bytes32, Bytes48, Bytes96,
    hash_tree_root, serialize, uint_to_bytes,
)
from ..ssz import incremental as ssz_incremental
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
    def compute_shuffled_index(self, index: int, index_count: int, seed) -> int:
        """Swap-or-not shuffle, SHUFFLE_ROUND_COUNT rounds."""
        assert index < index_count
        for current_round in range(self.SHUFFLE_ROUND_COUNT):
            pivot = bytes_to_uint64(self.hash(
                bytes(seed) + uint_to_bytes(uint8(current_round)))[0:8]) % index_count
            flip = (pivot + index_count - index) % index_count
            position = max(index, flip)
            source = self.hash(
                bytes(seed) + uint_to_bytes(uint8(current_round))
                + uint_to_bytes(uint32(position // 256)))
            byte_val = source[(position % 256) // 8]
            bit = (byte_val >> (position % 8)) % 2
            index = flip if bit else index
        return uint64(index)

    _SHUFFLE_CACHE_SIZE = 8

    def _shuffle_permutation(self, seed, index_count: int):
        """Full swap-or-not permutation for (seed, n), LRU-cached per spec
        instance (the batched counterpart of the consensus-specs per-index
        LRU).  Bounded: a fresh seed per epoch would otherwise grow ~8n
        bytes per epoch forever."""
        from .shuffle import shuffle_permutation
        cache = self._caches.setdefault("shuffle_perm_lru", {})
        key = (bytes(seed), int(index_count))
        if key not in cache:
            if len(cache) >= self._SHUFFLE_CACHE_SIZE:
                cache.pop(next(iter(cache)))
            cache[key] = shuffle_permutation(
                bytes(seed), int(index_count), self.SHUFFLE_ROUND_COUNT)
        else:
            cache[key] = cache.pop(key)   # refresh LRU order
        return cache[key]

    def compute_committee(self, indices, seed, index: int, count: int):
        start = len(indices) * index // count
        end = len(indices) * (index + 1) // count
        perm = self._shuffle_permutation(seed, len(indices))
        return [indices[int(perm[i])] for i in range(start, end)]

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

    def get_beacon_committee(self, state, slot, index):
        epoch = self.compute_epoch_at_slot(slot)
        committees_per_slot = self.get_committee_count_per_slot(state, epoch)
        return self.compute_committee(
            indices=self.get_active_validator_indices(state, epoch),
            seed=self.get_seed(state, epoch, self.DOMAIN_BEACON_ATTESTER),
            index=(slot % self.SLOTS_PER_EPOCH) * committees_per_slot + index,
            count=committees_per_slot * self.SLOTS_PER_EPOCH)

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

    def get_attesting_indices(self, state, attestation):
        committee = self.get_beacon_committee(
            state, attestation.data.slot, attestation.data.index)
        return set(index for i, index in enumerate(committee)
                   if attestation.aggregation_bits[i])

    # ------------------------------------------------------------------
    # mutators (beacon-chain.md "Beacon state mutators")
    # ------------------------------------------------------------------
    def increase_balance(self, state, index, delta) -> None:
        state.balances[index] = uint64(state.balances[index] + delta)

    def decrease_balance(self, state, index, delta) -> None:
        bal = state.balances[index]
        state.balances[index] = uint64(0 if delta > bal else bal - delta)

    def initiate_validator_exit(self, state, index) -> None:
        validator = state.validators[index]
        if validator.exit_epoch != self.FAR_FUTURE_EPOCH:
            return
        exit_epochs = [int(v.exit_epoch) for v in state.validators
                       if v.exit_epoch != self.FAR_FUTURE_EPOCH]
        exit_queue_epoch = max(exit_epochs + [int(
            self.compute_activation_exit_epoch(self.get_current_epoch(state)))])
        exit_queue_churn = len([v for v in state.validators
                                if v.exit_epoch == exit_queue_epoch])
        if exit_queue_churn >= self.get_validator_churn_limit(state):
            exit_queue_epoch += 1
        validator.exit_epoch = uint64(exit_queue_epoch)
        validator.withdrawable_epoch = uint64(
            validator.exit_epoch
            + self.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)

    # ------------------------------------------------------------------
    # state transition (beacon-chain.md "Beacon chain state transition")
    # ------------------------------------------------------------------
    def process_slots(self, state, slot) -> None:
        assert state.slot < slot
        # opt-in incremental merkleization: track the state so each
        # hash_tree_root below re-hashes only the dirty cone (no-op while
        # the mode is disabled)
        ssz_incremental.track(state)
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

    # ------------------------------------------------------------------
    # epoch processing (beacon-chain.md "Epoch processing")
    # ------------------------------------------------------------------
    def process_epoch(self, state) -> None:
        from . import epoch_fast
        if epoch_fast.fused_epoch(self, state):
            # the fused ONE-dispatch sweep handled justification through
            # the effective-balance update; only the cheap tail resets
            # remain (eth1_data_reset commutes past the sweep: it clears
            # vote bookkeeping no fused pass reads or writes)
            self.process_eth1_data_reset(state)
            self.process_slashings_reset(state)
            self.process_randao_mixes_reset(state)
            self.process_historical_roots_update(state)
            self.process_participation_record_updates(state)
            return
        self.process_justification_and_finalization(state)
        self.process_rewards_and_penalties(state)
        self.process_registry_updates(state)
        self.process_slashings(state)
        self.process_eth1_data_reset(state)
        self.process_effective_balance_updates(state)
        self.process_slashings_reset(state)
        self.process_randao_mixes_reset(state)
        self.process_historical_roots_update(state)
        self.process_participation_record_updates(state)

    # -- attestation matching helpers
    def get_matching_source_attestations(self, state, epoch):
        assert epoch in (self.get_previous_epoch(state),
                         self.get_current_epoch(state))
        return (state.current_epoch_attestations
                if epoch == self.get_current_epoch(state)
                else state.previous_epoch_attestations)

    def get_matching_target_attestations(self, state, epoch):
        return [a for a in self.get_matching_source_attestations(state, epoch)
                if a.data.target.root == self.get_block_root(state, epoch)]

    def get_matching_head_attestations(self, state, epoch):
        return [a for a in self.get_matching_target_attestations(state, epoch)
                if a.data.beacon_block_root
                == self.get_block_root_at_slot(state, a.data.slot)]

    def get_unslashed_attesting_indices(self, state, attestations):
        output = set()
        for a in attestations:
            output |= self.get_attesting_indices(state, a)
        return set(filter(lambda i: not state.validators[i].slashed, output))

    def get_attesting_balance(self, state, attestations) -> int:
        return self.get_total_balance(
            state, self.get_unslashed_attesting_indices(state, attestations))

    def process_justification_and_finalization(self, state) -> None:
        # no processing within the first two epochs
        if self.get_current_epoch(state) <= self.GENESIS_EPOCH + 1:
            return
        previous_attestations = self.get_matching_target_attestations(
            state, self.get_previous_epoch(state))
        current_attestations = self.get_matching_target_attestations(
            state, self.get_current_epoch(state))
        total_active_balance = self.get_total_active_balance(state)
        previous_target_balance = self.get_attesting_balance(
            state, previous_attestations)
        current_target_balance = self.get_attesting_balance(
            state, current_attestations)
        self.weigh_justification_and_finalization(
            state, total_active_balance,
            previous_target_balance, current_target_balance)

    def weigh_justification_and_finalization(self, state, total_active_balance,
                                             previous_epoch_target_balance,
                                             current_epoch_target_balance):
        previous_epoch = self.get_previous_epoch(state)
        current_epoch = self.get_current_epoch(state)
        old_previous_justified = state.previous_justified_checkpoint
        old_current_justified = state.current_justified_checkpoint

        # process justifications
        state.previous_justified_checkpoint = state.current_justified_checkpoint
        bits = state.justification_bits
        for i in range(len(bits) - 1, 0, -1):
            bits[i] = bits[i - 1]
        bits[0] = False
        if previous_epoch_target_balance * 3 >= total_active_balance * 2:
            state.current_justified_checkpoint = self.Checkpoint(
                epoch=previous_epoch,
                root=self.get_block_root(state, previous_epoch))
            bits[1] = True
        if current_epoch_target_balance * 3 >= total_active_balance * 2:
            state.current_justified_checkpoint = self.Checkpoint(
                epoch=current_epoch,
                root=self.get_block_root(state, current_epoch))
            bits[0] = True

        # process finalizations
        # 2nd/3rd/4th most recent epochs justified, 2nd is source
        if all(bits[1:4]) and old_previous_justified.epoch + 3 == current_epoch:
            state.finalized_checkpoint = old_previous_justified
        if all(bits[1:3]) and old_previous_justified.epoch + 2 == current_epoch:
            state.finalized_checkpoint = old_previous_justified
        if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
            state.finalized_checkpoint = old_current_justified
        if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
            state.finalized_checkpoint = old_current_justified

    # -- rewards & penalties
    def get_base_reward(self, state, index) -> int:
        total_balance = self.get_total_active_balance(state)
        effective_balance = state.validators[index].effective_balance
        return uint64(effective_balance * self.BASE_REWARD_FACTOR
                      // integer_squareroot(total_balance)
                      // self.BASE_REWARDS_PER_EPOCH)

    def get_proposer_reward(self, state, attesting_index) -> int:
        return uint64(self.get_base_reward(state, attesting_index)
                      // self.PROPOSER_REWARD_QUOTIENT)

    def get_finality_delay(self, state) -> int:
        return uint64(self.get_previous_epoch(state)
                      - state.finalized_checkpoint.epoch)

    def is_in_inactivity_leak(self, state) -> bool:
        return self.get_finality_delay(state) \
            > self.MIN_EPOCHS_TO_INACTIVITY_PENALTY

    def get_eligible_validator_indices(self, state):
        previous_epoch = self.get_previous_epoch(state)
        return [uint64(index) for index, v in enumerate(state.validators)
                if self.is_active_validator(v, previous_epoch)
                or (v.slashed and previous_epoch + 1 < v.withdrawable_epoch)]

    def get_attestation_component_deltas(self, state, attestations):
        """Helper for source/target/head reward components."""
        n = len(state.validators)
        rewards = [uint64(0)] * n
        penalties = [uint64(0)] * n
        total_balance = self.get_total_active_balance(state)
        unslashed_attesting_indices = self.get_unslashed_attesting_indices(
            state, attestations)
        attesting_balance = self.get_total_balance(
            state, unslashed_attesting_indices)
        for index in self.get_eligible_validator_indices(state):
            if index in unslashed_attesting_indices:
                increment = self.EFFECTIVE_BALANCE_INCREMENT
                if self.is_in_inactivity_leak(state):
                    # optimal participation receives full base reward
                    # compensation here; the inactivity penalty cancels it
                    rewards[index] = uint64(
                        rewards[index] + self.get_base_reward(state, index))
                else:
                    reward_numerator = (self.get_base_reward(state, index)
                                        * (attesting_balance // increment))
                    rewards[index] = uint64(
                        rewards[index]
                        + reward_numerator // (total_balance // increment))
            else:
                penalties[index] = uint64(
                    penalties[index] + self.get_base_reward(state, index))
        return rewards, penalties

    def get_source_deltas(self, state):
        return self.get_attestation_component_deltas(
            state, self.get_matching_source_attestations(
                state, self.get_previous_epoch(state)))

    def get_target_deltas(self, state):
        return self.get_attestation_component_deltas(
            state, self.get_matching_target_attestations(
                state, self.get_previous_epoch(state)))

    def get_head_deltas(self, state):
        return self.get_attestation_component_deltas(
            state, self.get_matching_head_attestations(
                state, self.get_previous_epoch(state)))

    def get_inclusion_delay_deltas(self, state):
        n = len(state.validators)
        rewards = [uint64(0)] * n
        matching_source = self.get_matching_source_attestations(
            state, self.get_previous_epoch(state))
        for index in self.get_unslashed_attesting_indices(
                state, matching_source):
            attestation = min(
                (a for a in matching_source
                 if index in self.get_attesting_indices(state, a)),
                key=lambda a: a.inclusion_delay)
            rewards[attestation.proposer_index] = uint64(
                rewards[attestation.proposer_index]
                + self.get_proposer_reward(state, index))
            max_attester_reward = uint64(
                self.get_base_reward(state, index)
                - self.get_proposer_reward(state, index))
            rewards[index] = uint64(
                rewards[index]
                + max_attester_reward // attestation.inclusion_delay)
        return rewards, [uint64(0)] * n

    def get_inactivity_penalty_deltas(self, state):
        n = len(state.validators)
        penalties = [uint64(0)] * n
        if self.is_in_inactivity_leak(state):
            matching_target_attestations = \
                self.get_matching_target_attestations(
                    state, self.get_previous_epoch(state))
            matching_target_attesting_indices = \
                self.get_unslashed_attesting_indices(
                    state, matching_target_attestations)
            for index in self.get_eligible_validator_indices(state):
                base_reward = self.get_base_reward(state, index)
                penalties[index] = uint64(
                    penalties[index]
                    + self.BASE_REWARDS_PER_EPOCH * base_reward
                    - self.get_proposer_reward(state, index))
                if index not in matching_target_attesting_indices:
                    effective_balance = \
                        state.validators[index].effective_balance
                    penalties[index] = uint64(
                        penalties[index]
                        + effective_balance * self.get_finality_delay(state)
                        // self.INACTIVITY_PENALTY_QUOTIENT)
        return [uint64(0)] * n, penalties

    def get_attestation_deltas(self, state):
        source_rewards, source_penalties = self.get_source_deltas(state)
        target_rewards, target_penalties = self.get_target_deltas(state)
        head_rewards, head_penalties = self.get_head_deltas(state)
        inclusion_rewards, _ = self.get_inclusion_delay_deltas(state)
        _, inactivity_penalties = self.get_inactivity_penalty_deltas(state)
        rewards = [uint64(a + b + c + d) for a, b, c, d in zip(
            source_rewards, target_rewards, head_rewards, inclusion_rewards)]
        penalties = [uint64(a + b + c + d) for a, b, c, d in zip(
            source_penalties, target_penalties, head_penalties,
            inactivity_penalties)]
        return rewards, penalties

    def process_rewards_and_penalties(self, state) -> None:
        # no rewards in GENESIS_EPOCH (no previous epoch to attest to)
        if self.get_current_epoch(state) == self.GENESIS_EPOCH:
            return
        rewards, penalties = self.get_attestation_deltas(state)
        for index in range(len(state.validators)):
            self.increase_balance(state, index, rewards[index])
            self.decrease_balance(state, index, penalties[index])

    # -- registry & leftovers
    def process_registry_updates(self, state) -> None:
        # eligibility and ejections
        for index, validator in enumerate(state.validators):
            if self.is_eligible_for_activation_queue(validator):
                validator.activation_eligibility_epoch = uint64(
                    self.get_current_epoch(state) + 1)
            if (self.is_active_validator(validator,
                                         self.get_current_epoch(state))
                    and validator.effective_balance
                    <= self.config.EJECTION_BALANCE):
                self.initiate_validator_exit(state, index)

        # dequeue activations up to churn limit, ordered by eligibility epoch
        activation_queue = sorted(
            [index for index, validator in enumerate(state.validators)
             if self.is_eligible_for_activation(state, validator)],
            key=lambda index: (
                int(state.validators[index].activation_eligibility_epoch),
                index))
        for index in activation_queue[:self.get_validator_churn_limit(state)]:
            validator = state.validators[index]
            validator.activation_epoch = self.compute_activation_exit_epoch(
                self.get_current_epoch(state))

    def process_slashings(self, state) -> None:
        epoch = self.get_current_epoch(state)
        total_balance = self.get_total_active_balance(state)
        adjusted_total_slashing_balance = min(
            sum(int(x) for x in state.slashings)
            * self.proportional_slashing_multiplier(),
            int(total_balance))
        for index, validator in enumerate(state.validators):
            if (validator.slashed
                    and epoch + self.EPOCHS_PER_SLASHINGS_VECTOR // 2
                    == validator.withdrawable_epoch):
                increment = self.EFFECTIVE_BALANCE_INCREMENT
                penalty_numerator = (validator.effective_balance // increment
                                     * adjusted_total_slashing_balance)
                penalty = penalty_numerator // total_balance * increment
                self.decrease_balance(state, index, uint64(penalty))

    def proportional_slashing_multiplier(self) -> int:
        return self.PROPORTIONAL_SLASHING_MULTIPLIER

    def process_eth1_data_reset(self, state) -> None:
        next_epoch = uint64(self.get_current_epoch(state) + 1)
        if next_epoch % self.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
            state.eth1_data_votes = type(state.eth1_data_votes)()

    def process_effective_balance_updates(self, state) -> None:
        for index, validator in enumerate(state.validators):
            balance = state.balances[index]
            hysteresis_increment = uint64(
                self.EFFECTIVE_BALANCE_INCREMENT // self.HYSTERESIS_QUOTIENT)
            downward_threshold = uint64(
                hysteresis_increment * self.HYSTERESIS_DOWNWARD_MULTIPLIER)
            upward_threshold = uint64(
                hysteresis_increment * self.HYSTERESIS_UPWARD_MULTIPLIER)
            if (balance + downward_threshold < validator.effective_balance
                    or validator.effective_balance + upward_threshold
                    < balance):
                validator.effective_balance = uint64(min(
                    int(balance)
                    - int(balance) % self.EFFECTIVE_BALANCE_INCREMENT,
                    self.max_effective_balance_for_validator(validator)))

    def max_effective_balance_for_validator(self, validator) -> int:
        return self.MAX_EFFECTIVE_BALANCE

    def process_slashings_reset(self, state) -> None:
        next_epoch = uint64(self.get_current_epoch(state) + 1)
        state.slashings[next_epoch % self.EPOCHS_PER_SLASHINGS_VECTOR] = \
            uint64(0)

    def process_randao_mixes_reset(self, state) -> None:
        current_epoch = self.get_current_epoch(state)
        next_epoch = uint64(current_epoch + 1)
        state.randao_mixes[next_epoch % self.EPOCHS_PER_HISTORICAL_VECTOR] = \
            self.get_randao_mix(state, current_epoch)

    def process_historical_roots_update(self, state) -> None:
        next_epoch = uint64(self.get_current_epoch(state) + 1)
        if next_epoch % (self.SLOTS_PER_HISTORICAL_ROOT
                         // self.SLOTS_PER_EPOCH) == 0:
            historical_batch = self.HistoricalBatch(
                block_roots=list(state.block_roots),
                state_roots=list(state.state_roots))
            state.historical_roots.append(hash_tree_root(historical_batch))

    def process_participation_record_updates(self, state) -> None:
        state.previous_epoch_attestations = state.current_epoch_attestations
        state.current_epoch_attestations = \
            type(state.current_epoch_attestations)()
