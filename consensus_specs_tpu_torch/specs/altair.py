"""Altair spec: participation flags, sync committees, inactivity leak.

Counterpart of consensus_specs_tpu/specs/altair.py, which implements the
consensus-specs altair rules (specs/altair/beacon-chain.md, fork.md) as a
Phase0Spec subclass, each method override one fork delta.  Ported: the
constants, the containers (the validator.md message and contribution
containers among them, as types), the flag helpers, the sync-committee
selection and `eth_aggregate_pubkeys`, the accessors and rewards,
`process_epoch` (the fused engine's altair family, specs/epoch_fast.py,
then the tail resets) and its scalar passes, `process_block` with
`process_attestation` and `process_sync_aggregate`,
`add_validator_to_registry`, and the fork upgrade (`upgrade_from`).
The sync aggregate's check goes through the seam
`bls_fast_aggregate_verify` (specs/base.py) like every other check, so the
signature pipeline collects it (sigpipe/sets.py `_sync_aggregate`).

Not ported yet (ROADMAP.md): the light-client base the reference's class
inherits (`LightClientMixin`, specs/light_client.py), altair's
sync-committee duty methods (validator.md), and the phase0 fork-choice and
validator-duty mixins, which the port's Phase0Spec does not carry either.
No transition method reads any of them.

NOTE: SSZ Container fields must stay live annotations (no PEP 563 here).
"""
from ..ssz import (
    uint8, uint64, Bitvector, Vector, List, Container,
    Bytes4, Bytes32, Bytes48, Bytes96, uint_to_bytes,
)
from .phase0 import Phase0Spec, integer_squareroot


class AltairSpec(Phase0Spec):
    fork = "altair"

    # ------------------------------------------------------------------
    # constants (altair/beacon-chain.md tables)
    # ------------------------------------------------------------------
    def _build_constants(self) -> None:
        super()._build_constants()
        self.TIMELY_SOURCE_FLAG_INDEX = 0
        self.TIMELY_TARGET_FLAG_INDEX = 1
        self.TIMELY_HEAD_FLAG_INDEX = 2
        self.TIMELY_SOURCE_WEIGHT = uint64(14)
        self.TIMELY_TARGET_WEIGHT = uint64(26)
        self.TIMELY_HEAD_WEIGHT = uint64(14)
        self.SYNC_REWARD_WEIGHT = uint64(2)
        self.PROPOSER_WEIGHT = uint64(8)
        self.WEIGHT_DENOMINATOR = uint64(64)
        self.PARTICIPATION_FLAG_WEIGHTS = [
            self.TIMELY_SOURCE_WEIGHT,
            self.TIMELY_TARGET_WEIGHT,
            self.TIMELY_HEAD_WEIGHT,
        ]
        self.DOMAIN_SYNC_COMMITTEE = Bytes4("0x07000000")
        self.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = Bytes4("0x08000000")
        self.DOMAIN_CONTRIBUTION_AND_PROOF = Bytes4("0x09000000")
        self.G2_POINT_AT_INFINITY = Bytes96(b"\xc0" + b"\x00" * 95)
        self.ParticipationFlags = uint8
        # validator.md
        self.TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE = 2**4
        self.SYNC_COMMITTEE_SUBNET_COUNT = 4

    # ------------------------------------------------------------------
    # types (altair/beacon-chain.md "Containers")
    # ------------------------------------------------------------------
    def _build_types(self) -> None:
        super()._build_types()
        p = self

        class SyncAggregate(Container):
            sync_committee_bits: Bitvector[p.SYNC_COMMITTEE_SIZE]
            sync_committee_signature: Bytes96

        class SyncCommittee(Container):
            pubkeys: Vector[Bytes48, p.SYNC_COMMITTEE_SIZE]
            aggregate_pubkey: Bytes48

        class BeaconBlockBody(Container):
            randao_reveal: Bytes96
            eth1_data: p.Eth1Data
            graffiti: Bytes32
            proposer_slashings: List[p.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS]
            attester_slashings: List[p.AttesterSlashing, p.MAX_ATTESTER_SLASHINGS]
            attestations: List[p.Attestation, p.MAX_ATTESTATIONS]
            deposits: List[p.Deposit, p.MAX_DEPOSITS]
            voluntary_exits: List[p.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS]
            sync_aggregate: SyncAggregate

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
            fork: p.Fork
            latest_block_header: p.BeaconBlockHeader
            block_roots: Vector[Bytes32, p.SLOTS_PER_HISTORICAL_ROOT]
            state_roots: Vector[Bytes32, p.SLOTS_PER_HISTORICAL_ROOT]
            historical_roots: List[Bytes32, p.HISTORICAL_ROOTS_LIMIT]
            eth1_data: p.Eth1Data
            eth1_data_votes: List[p.Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH]
            eth1_deposit_index: uint64
            validators: List[p.Validator, p.VALIDATOR_REGISTRY_LIMIT]
            balances: List[uint64, p.VALIDATOR_REGISTRY_LIMIT]
            randao_mixes: Vector[Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR]
            slashings: Vector[uint64, p.EPOCHS_PER_SLASHINGS_VECTOR]
            previous_epoch_participation: List[uint8, p.VALIDATOR_REGISTRY_LIMIT]
            current_epoch_participation: List[uint8, p.VALIDATOR_REGISTRY_LIMIT]
            justification_bits: Bitvector[p.JUSTIFICATION_BITS_LENGTH]
            previous_justified_checkpoint: p.Checkpoint
            current_justified_checkpoint: p.Checkpoint
            finalized_checkpoint: p.Checkpoint
            inactivity_scores: List[uint64, p.VALIDATOR_REGISTRY_LIMIT]
            current_sync_committee: SyncCommittee
            next_sync_committee: SyncCommittee

        # validator.md containers
        class SyncCommitteeMessage(Container):
            slot: uint64
            beacon_block_root: Bytes32
            validator_index: uint64
            signature: Bytes96

        class SyncCommitteeContribution(Container):
            slot: uint64
            beacon_block_root: Bytes32
            subcommittee_index: uint64
            aggregation_bits: Bitvector[p.SYNC_COMMITTEE_SIZE // p.SYNC_COMMITTEE_SUBNET_COUNT]
            signature: Bytes96

        class ContributionAndProof(Container):
            aggregator_index: uint64
            contribution: SyncCommitteeContribution
            selection_proof: Bytes96

        class SignedContributionAndProof(Container):
            message: ContributionAndProof
            signature: Bytes96

        class SyncAggregatorSelectionData(Container):
            slot: uint64
            subcommittee_index: uint64

        for name, cls in list(locals().items()):
            if isinstance(cls, type) and issubclass(cls, Container):
                setattr(self, name, cls)

    # ------------------------------------------------------------------
    # participation-flag helpers
    # ------------------------------------------------------------------
    def add_flag(self, flags, flag_index):
        return uint8(flags | (2**flag_index))

    def has_flag(self, flags, flag_index) -> bool:
        flag = 2**flag_index
        return flags & flag == flag

    # ------------------------------------------------------------------
    # sync committee machinery
    # ------------------------------------------------------------------
    def get_next_sync_committee_indices(self, state):
        """Balance-weighted rejection sampling for the *next* period."""
        epoch = uint64(self.get_current_epoch(state) + 1)
        MAX_RANDOM_BYTE = 2**8 - 1
        active_validator_indices = self.get_active_validator_indices(
            state, epoch)
        active_validator_count = len(active_validator_indices)
        seed = self.get_seed(state, epoch, self.DOMAIN_SYNC_COMMITTEE)
        i = 0
        sync_committee_indices = []
        while len(sync_committee_indices) < self.SYNC_COMMITTEE_SIZE:
            shuffled_index = self.compute_shuffled_index(
                i % active_validator_count, active_validator_count, seed)
            candidate_index = active_validator_indices[shuffled_index]
            random_byte = self.hash(
                bytes(seed) + uint_to_bytes(uint64(i // 32)))[i % 32]
            effective_balance = \
                state.validators[candidate_index].effective_balance
            if (effective_balance * MAX_RANDOM_BYTE
                    >= self.MAX_EFFECTIVE_BALANCE * random_byte):
                sync_committee_indices.append(candidate_index)
            i += 1
        return sync_committee_indices

    def get_next_sync_committee(self, state):
        indices = self.get_next_sync_committee_indices(state)
        pubkeys = [state.validators[index].pubkey for index in indices]
        aggregate_pubkey = self.eth_aggregate_pubkeys(pubkeys)
        return self.SyncCommittee(pubkeys=pubkeys,
                                  aggregate_pubkey=aggregate_pubkey)

    def eth_aggregate_pubkeys(self, pubkeys):
        assert len(pubkeys) > 0
        # pure point addition (no pairing): always computed for real, so
        # the state's sync-committee aggregate pubkey is right even while
        # signature checks are off
        from ..crypto import bls12_381 as native
        return Bytes48(native.AggregatePKs([bytes(pk) for pk in pubkeys]))

    def eth_fast_aggregate_verify(self, pubkeys, message, signature) -> bool:
        if len(pubkeys) == 0 and signature == self.G2_POINT_AT_INFINITY:
            return True
        return self.bls_fast_aggregate_verify(pubkeys, message, signature)

    # ------------------------------------------------------------------
    # accessors / rewards
    # ------------------------------------------------------------------
    def get_base_reward_per_increment(self, state):
        return uint64(self.EFFECTIVE_BALANCE_INCREMENT
                      * self.BASE_REWARD_FACTOR
                      // integer_squareroot(
                          self.get_total_active_balance(state)))

    def get_base_reward(self, state, index):
        increments = state.validators[index].effective_balance \
            // self.EFFECTIVE_BALANCE_INCREMENT
        return uint64(increments * self.get_base_reward_per_increment(state))

    def get_unslashed_participating_indices(self, state, flag_index, epoch):
        assert epoch in (self.get_previous_epoch(state),
                         self.get_current_epoch(state))
        if epoch == self.get_current_epoch(state):
            epoch_participation = state.current_epoch_participation
        else:
            epoch_participation = state.previous_epoch_participation
        active_validator_indices = self.get_active_validator_indices(
            state, epoch)
        participating_indices = [
            i for i in active_validator_indices
            if self.has_flag(epoch_participation[i], flag_index)]
        return set(filter(
            lambda index: not state.validators[index].slashed,
            participating_indices))

    def get_attestation_participation_flag_indices(self, state, data,
                                                   inclusion_delay):
        if data.target.epoch == self.get_current_epoch(state):
            justified_checkpoint = state.current_justified_checkpoint
        else:
            justified_checkpoint = state.previous_justified_checkpoint

        is_matching_source = data.source == justified_checkpoint
        is_matching_target = (
            is_matching_source
            and data.target.root == self.get_block_root(state,
                                                        data.target.epoch))
        is_matching_head = (
            is_matching_target
            and data.beacon_block_root
            == self.get_block_root_at_slot(state, data.slot))
        assert is_matching_source

        participation_flag_indices = []
        if (is_matching_source and inclusion_delay
                <= integer_squareroot(self.SLOTS_PER_EPOCH)):
            participation_flag_indices.append(self.TIMELY_SOURCE_FLAG_INDEX)
        if self.is_timely_target(state, is_matching_target, inclusion_delay):
            participation_flag_indices.append(self.TIMELY_TARGET_FLAG_INDEX)
        if (is_matching_head
                and inclusion_delay == self.MIN_ATTESTATION_INCLUSION_DELAY):
            participation_flag_indices.append(self.TIMELY_HEAD_FLAG_INDEX)
        return participation_flag_indices

    def is_timely_target(self, state, is_matching_target,
                         inclusion_delay) -> bool:
        # deneb removes the inclusion-delay bound for target
        return is_matching_target and inclusion_delay <= self.SLOTS_PER_EPOCH

    def get_flag_index_deltas(self, state, flag_index):
        n = len(state.validators)
        rewards = [uint64(0)] * n
        penalties = [uint64(0)] * n
        previous_epoch = self.get_previous_epoch(state)
        unslashed_participating_indices = \
            self.get_unslashed_participating_indices(
                state, flag_index, previous_epoch)
        weight = self.PARTICIPATION_FLAG_WEIGHTS[flag_index]
        unslashed_participating_balance = self.get_total_balance(
            state, unslashed_participating_indices)
        unslashed_participating_increments = \
            unslashed_participating_balance \
            // self.EFFECTIVE_BALANCE_INCREMENT
        active_increments = self.get_total_active_balance(state) \
            // self.EFFECTIVE_BALANCE_INCREMENT
        for index in self.get_eligible_validator_indices(state):
            base_reward = self.get_base_reward(state, index)
            if index in unslashed_participating_indices:
                if not self.is_in_inactivity_leak(state):
                    reward_numerator = (base_reward * weight
                                        * unslashed_participating_increments)
                    rewards[index] = uint64(
                        rewards[index] + reward_numerator
                        // (active_increments * self.WEIGHT_DENOMINATOR))
            elif flag_index != self.TIMELY_HEAD_FLAG_INDEX:
                penalties[index] = uint64(
                    penalties[index]
                    + base_reward * weight // self.WEIGHT_DENOMINATOR)
        return rewards, penalties

    def get_inactivity_penalty_deltas(self, state):
        n = len(state.validators)
        rewards = [uint64(0)] * n
        penalties = [uint64(0)] * n
        previous_epoch = self.get_previous_epoch(state)
        matching_target_indices = self.get_unslashed_participating_indices(
            state, self.TIMELY_TARGET_FLAG_INDEX, previous_epoch)
        for index in self.get_eligible_validator_indices(state):
            if index not in matching_target_indices:
                penalty_numerator = (
                    state.validators[index].effective_balance
                    * state.inactivity_scores[index])
                penalty_denominator = (
                    self.config.INACTIVITY_SCORE_BIAS
                    * self.inactivity_penalty_quotient())
                penalties[index] = uint64(
                    penalties[index]
                    + penalty_numerator // penalty_denominator)
        return rewards, penalties

    def inactivity_penalty_quotient(self) -> int:
        return self.INACTIVITY_PENALTY_QUOTIENT_ALTAIR

    def min_slashing_penalty_quotient(self) -> int:
        return self.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR

    def proportional_slashing_multiplier(self) -> int:
        return self.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR

    def slashing_proposer_reward(self, whistleblower_reward):
        return uint64(whistleblower_reward * self.PROPOSER_WEIGHT
                      // self.WEIGHT_DENOMINATOR)

    # ------------------------------------------------------------------
    # epoch processing (altair ordering)
    # ------------------------------------------------------------------
    def process_epoch(self, state) -> None:
        from . import epoch_fast
        if epoch_fast.fused_epoch(self, state):
            # the fused sweep handled justification through the
            # effective-balance update; only the cheap tail resets remain
            # (eth1_data_reset commutes past the sweep: it clears vote
            # bookkeeping no fused pass reads or writes)
            self.process_eth1_data_reset(state)
            self.process_slashings_reset(state)
            self.process_randao_mixes_reset(state)
            self.process_historical_roots_update(state)
            self.process_participation_flag_updates(state)
            self.process_sync_committee_updates(state)
            return
        self.process_justification_and_finalization(state)
        self.process_inactivity_updates(state)
        self.process_rewards_and_penalties(state)
        self.process_registry_updates(state)
        self.process_slashings(state)
        self.process_eth1_data_reset(state)
        self.process_effective_balance_updates(state)
        self.process_slashings_reset(state)
        self.process_randao_mixes_reset(state)
        self.process_historical_roots_update(state)
        self.process_participation_flag_updates(state)
        self.process_sync_committee_updates(state)

    def process_justification_and_finalization(self, state) -> None:
        if self.get_current_epoch(state) <= self.GENESIS_EPOCH + 1:
            return
        previous_indices = self.get_unslashed_participating_indices(
            state, self.TIMELY_TARGET_FLAG_INDEX,
            self.get_previous_epoch(state))
        current_indices = self.get_unslashed_participating_indices(
            state, self.TIMELY_TARGET_FLAG_INDEX,
            self.get_current_epoch(state))
        total_active_balance = self.get_total_active_balance(state)
        previous_target_balance = self.get_total_balance(
            state, previous_indices)
        current_target_balance = self.get_total_balance(
            state, current_indices)
        self.weigh_justification_and_finalization(
            state, total_active_balance, previous_target_balance,
            current_target_balance)

    def process_inactivity_updates(self, state) -> None:
        # no inactivity accounting in the genesis epoch
        if self.get_current_epoch(state) == self.GENESIS_EPOCH:
            return
        previous_target_indices = self.get_unslashed_participating_indices(
            state, self.TIMELY_TARGET_FLAG_INDEX,
            self.get_previous_epoch(state))
        for index in self.get_eligible_validator_indices(state):
            if index in previous_target_indices:
                state.inactivity_scores[index] = uint64(
                    state.inactivity_scores[index]
                    - min(1, int(state.inactivity_scores[index])))
            else:
                state.inactivity_scores[index] = uint64(
                    state.inactivity_scores[index]
                    + self.config.INACTIVITY_SCORE_BIAS)
            if not self.is_in_inactivity_leak(state):
                state.inactivity_scores[index] = uint64(
                    state.inactivity_scores[index]
                    - min(self.config.INACTIVITY_SCORE_RECOVERY_RATE,
                          int(state.inactivity_scores[index])))

    def process_rewards_and_penalties(self, state) -> None:
        if self.get_current_epoch(state) == self.GENESIS_EPOCH:
            return
        flag_deltas = [
            self.get_flag_index_deltas(state, flag_index)
            for flag_index in range(len(self.PARTICIPATION_FLAG_WEIGHTS))]
        deltas = flag_deltas + [self.get_inactivity_penalty_deltas(state)]
        for rewards, penalties in deltas:
            for index in range(len(state.validators)):
                self.increase_balance(state, index, rewards[index])
                self.decrease_balance(state, index, penalties[index])

    def process_participation_flag_updates(self, state) -> None:
        state.previous_epoch_participation = \
            state.current_epoch_participation
        state.current_epoch_participation = type(
            state.current_epoch_participation)(
                [0] * len(state.validators))

    def process_sync_committee_updates(self, state) -> None:
        next_epoch = uint64(self.get_current_epoch(state) + 1)
        if next_epoch % self.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
            state.current_sync_committee = state.next_sync_committee
            state.next_sync_committee = self.get_next_sync_committee(state)

    # ------------------------------------------------------------------
    # block processing
    # ------------------------------------------------------------------
    def process_block(self, state, block) -> None:
        self.process_block_header(state, block)
        self.process_randao(state, block.body)
        self.process_eth1_data(state, block.body)
        self.process_operations(state, block.body)
        self.process_sync_aggregate(state, block.body.sync_aggregate)

    def process_attestation(self, state, attestation) -> None:
        data = attestation.data
        assert data.target.epoch in (self.get_previous_epoch(state),
                                     self.get_current_epoch(state))
        assert data.target.epoch == self.compute_epoch_at_slot(data.slot)
        assert data.slot + self.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot
        self.check_attestation_inclusion_window(state, data)
        assert data.index < self.get_committee_count_per_slot(
            state, data.target.epoch)

        committee = self.get_beacon_committee(state, data.slot, data.index)
        assert len(attestation.aggregation_bits) == len(committee)

        # participation flags for this (data, delay)
        participation_flag_indices = \
            self.get_attestation_participation_flag_indices(
                state, data, uint64(state.slot - data.slot))

        assert self.is_valid_indexed_attestation(
            state, self.get_indexed_attestation(state, attestation))

        if data.target.epoch == self.get_current_epoch(state):
            epoch_participation = state.current_epoch_participation
        else:
            epoch_participation = state.previous_epoch_participation

        proposer_reward_numerator = 0
        for index in self.get_attesting_indices(state, attestation):
            for flag_index, weight in enumerate(
                    self.PARTICIPATION_FLAG_WEIGHTS):
                if (flag_index in participation_flag_indices
                        and not self.has_flag(epoch_participation[index],
                                              flag_index)):
                    epoch_participation[index] = self.add_flag(
                        epoch_participation[index], flag_index)
                    proposer_reward_numerator += int(
                        self.get_base_reward(state, index) * weight)

        proposer_reward_denominator = (
            (self.WEIGHT_DENOMINATOR - self.PROPOSER_WEIGHT)
            * self.WEIGHT_DENOMINATOR // self.PROPOSER_WEIGHT)
        proposer_reward = uint64(
            proposer_reward_numerator // proposer_reward_denominator)
        self.increase_balance(
            state, self.get_beacon_proposer_index(state), proposer_reward)

    def check_attestation_inclusion_window(self, state, data) -> None:
        # deneb removes the upper bound; altair keeps it
        assert state.slot <= data.slot + self.SLOTS_PER_EPOCH

    def add_validator_to_registry(self, state, pubkey,
                                  withdrawal_credentials, amount) -> None:
        super().add_validator_to_registry(
            state, pubkey, withdrawal_credentials, amount)
        state.previous_epoch_participation.append(0)
        state.current_epoch_participation.append(0)
        state.inactivity_scores.append(0)

    def process_sync_aggregate(self, state, sync_aggregate) -> None:
        # verify the (possibly empty) aggregate over the previous slot root
        committee_pubkeys = state.current_sync_committee.pubkeys
        participant_pubkeys = [
            pubkey for pubkey, bit in zip(
                committee_pubkeys, sync_aggregate.sync_committee_bits)
            if bit]
        previous_slot = uint64(max(int(state.slot), 1) - 1)
        domain = self.get_domain(state, self.DOMAIN_SYNC_COMMITTEE,
                                 self.compute_epoch_at_slot(previous_slot))
        signing_root = self.compute_signing_root(
            self.get_block_root_at_slot(state, previous_slot), domain)
        assert self.eth_fast_aggregate_verify(
            participant_pubkeys, signing_root,
            sync_aggregate.sync_committee_signature)

        # participant / proposer rewards
        total_active_increments = self.get_total_active_balance(state) \
            // self.EFFECTIVE_BALANCE_INCREMENT
        total_base_rewards = uint64(
            self.get_base_reward_per_increment(state)
            * total_active_increments)
        max_participant_rewards = uint64(
            total_base_rewards * self.SYNC_REWARD_WEIGHT
            // self.WEIGHT_DENOMINATOR // self.SLOTS_PER_EPOCH)
        participant_reward = uint64(
            max_participant_rewards // self.SYNC_COMMITTEE_SIZE)
        proposer_reward = uint64(
            participant_reward * self.PROPOSER_WEIGHT
            // (self.WEIGHT_DENOMINATOR - self.PROPOSER_WEIGHT))

        all_pubkeys = [v.pubkey for v in state.validators]
        committee_indices = [all_pubkeys.index(pubkey)
                             for pubkey in committee_pubkeys]
        for participant_index, participation_bit in zip(
                committee_indices, sync_aggregate.sync_committee_bits):
            if participation_bit:
                self.increase_balance(state, participant_index,
                                      participant_reward)
                self.increase_balance(
                    state, self.get_beacon_proposer_index(state),
                    proposer_reward)
            else:
                self.decrease_balance(state, participant_index,
                                      participant_reward)

    # ------------------------------------------------------------------
    # fork upgrade (altair/fork.md)
    # ------------------------------------------------------------------
    def genesis_fork_versions(self):
        return (Bytes4(self.config.GENESIS_FORK_VERSION),
                Bytes4(self.config.ALTAIR_FORK_VERSION))

    def translate_participation(self, post, pre_pending_attestations) -> None:
        for attestation in pre_pending_attestations:
            data = attestation.data
            inclusion_delay = attestation.inclusion_delay
            participation_flag_indices = \
                self.get_attestation_participation_flag_indices(
                    post, data, inclusion_delay)
            for index in self.get_attesting_indices(post, attestation):
                for flag_index in participation_flag_indices:
                    post.previous_epoch_participation[index] = self.add_flag(
                        post.previous_epoch_participation[index], flag_index)

    def upgrade_from(self, pre):
        """upgrade_to_altair (altair/fork.md)."""
        epoch = self.get_current_epoch(pre)
        post = self.BeaconState(
            genesis_time=pre.genesis_time,
            genesis_validators_root=pre.genesis_validators_root,
            slot=pre.slot,
            fork=self.Fork(
                previous_version=pre.fork.current_version,
                current_version=Bytes4(self.config.ALTAIR_FORK_VERSION),
                epoch=epoch),
            latest_block_header=pre.latest_block_header,
            block_roots=list(pre.block_roots),
            state_roots=list(pre.state_roots),
            historical_roots=list(pre.historical_roots),
            eth1_data=pre.eth1_data,
            eth1_data_votes=list(pre.eth1_data_votes),
            eth1_deposit_index=pre.eth1_deposit_index,
            validators=list(pre.validators),
            balances=list(pre.balances),
            randao_mixes=list(pre.randao_mixes),
            slashings=list(pre.slashings),
            previous_epoch_participation=[0] * len(pre.validators),
            current_epoch_participation=[0] * len(pre.validators),
            justification_bits=list(pre.justification_bits),
            previous_justified_checkpoint=pre.previous_justified_checkpoint,
            current_justified_checkpoint=pre.current_justified_checkpoint,
            finalized_checkpoint=pre.finalized_checkpoint,
            inactivity_scores=[0] * len(pre.validators),
        )
        self.translate_participation(post, pre.previous_epoch_attestations)
        post.current_sync_committee = self.get_next_sync_committee(post)
        post.next_sync_committee = self.get_next_sync_committee(post)
        return post
