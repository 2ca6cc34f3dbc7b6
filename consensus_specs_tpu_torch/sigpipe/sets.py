"""Signature-set collection: one block in, every signature check out.

Counterpart of consensus_specs_tpu/sigpipe/sets.py, copied as it is: only
its phase0 branches are reachable in the port today (the `is_post(...)`
gates stay).

A `SignatureSet` is one BLS verification job — (pubkeys, signing_root,
signature) plus the kind/origin of the spec operation it came from.  The
collectors walk a `SignedBeaconBlock` against the post-`process_slots`
pre-block state and emit the same checks the inline spec path performs,
site by site:

  proposer signature, randao reveal, each attestation's aggregate, both
  headers of each proposer slashing, both indexed attestations of each
  attester slashing, each voluntary exit, each new-pubkey deposit (the
  valid-or-skip check of phase0 `apply_deposit`), capella+'s
  bls_to_execution_changes, altair+'s sync aggregate, and eip7732's signed
  execution payload header + payload attestations.

Collection is read-only and *best-effort*: any operation whose inputs are
malformed (bad indices, failing pre-asserts) is skipped here — the inline
spec path raises its own exception before ever reaching the signature
check, so nothing is lost, and the scalar fallback at the verification
seam keeps behavior identical for any set we fail to predict.

Semantics mirrored precisely:

* deposits are `required=False` — the spec skips invalid deposit
  signatures instead of raising (phase0 `apply_deposit`); a deposit set
  is only emitted for pubkeys not already in the registry, and for EVERY
  such deposit in the block (an earlier invalid deposit of the same
  pubkey leaves the registry unchanged, so the inline path re-checks).
* altair's `eth_fast_aggregate_verify` returns True for an empty
  participant set with the infinity signature — no set is emitted.
* phase0's `is_valid_indexed_attestation` returns False for empty or
  unsorted indices without touching BLS — no set is emitted.
* whisk's proposer comes from the opened tracker, not the shuffle: the
  randao collector uses `block.proposer_index` there (the value the
  post-header inline check reads).  Whisk's shuffle / registration /
  opening proofs are *intentionally not collected*: they are
  curdleproofs-style arguments (crypto/whisk_proofs.py), not BLS
  (pubkeys, root, signature) triples, so they never reach the bls
  seams and cannot ride the pairing-product batch.  The per-fork audit
  (tests/test_sigpipe.py::test_whisk_block_pipeline) pins that a whisk
  block's *BLS* surface is fully collected — zero `collector_miss`
  fallbacks — with the proof checks running inline as before.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..ssz import uint64
from .metrics import METRICS


@dataclass(frozen=True)
class SignatureSet:
    pubkeys: tuple          # tuple of compressed 48-byte pubkeys
    signing_root: bytes
    signature: bytes
    kind: str               # "proposer" | "randao" | "attestation" | ...
    origin: tuple = ()      # e.g. ("attestation", 3)
    required: bool = True   # False: valid-or-skip (deposit semantics)
    hint: tuple = field(default=(), compare=False)  # aggregate-cache label

    def key(self):
        """Content identity — what the verification seam looks up."""
        return (self.pubkeys, self.signing_root, self.signature)


def _set(pubkeys, signing_root, signature, kind, origin=(),
         required=True, hint=()):
    return SignatureSet(
        pubkeys=tuple(bytes(pk) for pk in pubkeys),
        signing_root=bytes(signing_root), signature=bytes(signature),
        kind=kind, origin=tuple(origin), required=required, hint=hint)


def _guarded(out, kind, fn):
    """Run one collector; a failure means the inline path raises before
    its signature check, so skip the set and count it."""
    try:
        fn(out)
    except Exception:
        METRICS.inc("collect_skipped")
        METRICS.inc(f"collect_skipped_{kind}")


# -- per-operation collectors ----------------------------------------------

def _proposer(spec, state, signed_block, out):
    proposer = state.validators[signed_block.message.proposer_index]
    root = spec.compute_signing_root(
        signed_block.message,
        spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER))
    out.append(_set([proposer.pubkey], root, signed_block.signature,
                    "proposer"))


def _randao(spec, state, signed_block, out):
    body = signed_block.message.body
    epoch = spec.get_current_epoch(state)
    if spec.is_post("whisk"):
        # whisk replaces the computed proposer index with whoever opened
        # the tracker: get_beacon_proposer_index reads the block header,
        # which is not processed yet at collection time.  The inline
        # path verifies randao AFTER process_block_header pinned the
        # proposer to block.proposer_index, so that field is exactly the
        # index the scalar check will use.
        proposer_index = signed_block.message.proposer_index
    else:
        proposer_index = spec.get_beacon_proposer_index(state)
    proposer = state.validators[proposer_index]
    root = spec.compute_signing_root(
        uint64(epoch), spec.get_domain(state, spec.DOMAIN_RANDAO))
    out.append(_set([proposer.pubkey], root, body.randao_reveal, "randao"))


def indexed_attestation_parts(spec, state, indexed):
    """(indices, pubkeys, signing_root) that
    `is_valid_indexed_attestation` will feed into BLS, or None when the
    inline check returns False before touching BLS (empty or unsorted
    indices).  THE single mirror of that derivation — the block
    collector below and the gossip collector (gossip/collect.py) both
    ride it, so a fork that changes indexed-attestation validity only
    has one place to update."""
    indices = [int(i) for i in indexed.attesting_indices]
    if len(indices) == 0 or indices != sorted(set(indices)):
        return None
    pubkeys = [state.validators[i].pubkey for i in indices]
    domain = spec.get_domain(state, spec.DOMAIN_BEACON_ATTESTER,
                             indexed.data.target.epoch)
    root = spec.compute_signing_root(indexed.data, domain)
    return indices, pubkeys, root


def _indexed_attestation_set(spec, state, indexed, kind, origin):
    parts = indexed_attestation_parts(spec, state, indexed)
    if parts is None:
        return None     # inline is_valid_indexed_attestation: False, no BLS
    _indices, pubkeys, root = parts
    return _set(pubkeys, root, indexed.signature, kind, origin)


def _attestations(spec, state, body, out):
    for i, attestation in enumerate(body.attestations):
        def one(out, i=i, attestation=attestation):
            indexed = spec.get_indexed_attestation(state, attestation)
            s = _indexed_attestation_set(
                spec, state, indexed, "attestation", ("attestation", i))
            if s is not None:
                data = attestation.data
                out.append(_set(
                    s.pubkeys, s.signing_root, s.signature, s.kind,
                    s.origin,
                    hint=("att", int(data.target.epoch), int(data.index))))
        _guarded(out, "attestation", one)


def _proposer_slashings(spec, state, body, out):
    for i, slashing in enumerate(body.proposer_slashings):
        def one(out, i=i, slashing=slashing):
            proposer = state.validators[
                slashing.signed_header_1.message.proposer_index]
            for j, signed_header in enumerate(
                    (slashing.signed_header_1, slashing.signed_header_2)):
                domain = spec.get_domain(
                    state, spec.DOMAIN_BEACON_PROPOSER,
                    spec.compute_epoch_at_slot(signed_header.message.slot))
                root = spec.compute_signing_root(
                    signed_header.message, domain)
                out.append(_set([proposer.pubkey], root,
                                signed_header.signature,
                                "proposer_slashing",
                                ("proposer_slashing", i, j)))
        _guarded(out, "proposer_slashing", one)


def _attester_slashings(spec, state, body, out):
    for i, slashing in enumerate(body.attester_slashings):
        for j, indexed in enumerate((slashing.attestation_1,
                                     slashing.attestation_2)):
            def one(out, i=i, j=j, indexed=indexed):
                s = _indexed_attestation_set(
                    spec, state, indexed, "attester_slashing",
                    ("attester_slashing", i, j))
                if s is not None:
                    out.append(s)
            _guarded(out, "attester_slashing", one)


def _deposits(spec, state, body, out):
    if not len(body.deposits):
        return      # skip the O(registry) pubkey snapshot below
    registry = {bytes(v.pubkey) for v in state.validators}
    for i, deposit in enumerate(body.deposits):
        def one(out, i=i, deposit=deposit):
            pubkey = bytes(deposit.data.pubkey)
            if pubkey in registry:
                return      # top-up: the inline path never checks it
            message = spec.DepositMessage(
                pubkey=deposit.data.pubkey,
                withdrawal_credentials=deposit.data.withdrawal_credentials,
                amount=deposit.data.amount)
            domain = spec.compute_domain(spec.DOMAIN_DEPOSIT)
            root = spec.compute_signing_root(message, domain)
            out.append(_set([deposit.data.pubkey], root,
                            deposit.data.signature, "deposit",
                            ("deposit", i), required=False))
        _guarded(out, "deposit", one)


def _voluntary_exits(spec, state, body, out):
    for i, signed_exit in enumerate(body.voluntary_exits):
        def one(out, i=i, signed_exit=signed_exit):
            exit_msg = signed_exit.message
            validator = state.validators[exit_msg.validator_index]
            domain = spec.voluntary_exit_domain(state, exit_msg)
            root = spec.compute_signing_root(exit_msg, domain)
            out.append(_set([validator.pubkey], root,
                            signed_exit.signature, "voluntary_exit",
                            ("voluntary_exit", i)))
        _guarded(out, "voluntary_exit", one)


def _bls_changes(spec, state, body, out):
    for i, signed_change in enumerate(body.bls_to_execution_changes):
        def one(out, i=i, signed_change=signed_change):
            change = signed_change.message
            domain = spec.compute_domain(
                spec.DOMAIN_BLS_TO_EXECUTION_CHANGE,
                genesis_validators_root=state.genesis_validators_root)
            root = spec.compute_signing_root(change, domain)
            out.append(_set([change.from_bls_pubkey], root,
                            signed_change.signature,
                            "bls_to_execution_change",
                            ("bls_to_execution_change", i)))
        _guarded(out, "bls_to_execution_change", one)


def _sync_aggregate(spec, state, body, out):
    aggregate = body.sync_aggregate
    committee_pubkeys = state.current_sync_committee.pubkeys
    participants = [pk for pk, bit in zip(
        committee_pubkeys, aggregate.sync_committee_bits) if bit]
    signature = aggregate.sync_committee_signature
    if not participants and bytes(signature) == bytes(
            spec.G2_POINT_AT_INFINITY):
        return      # inline eth_fast_aggregate_verify: True, no BLS
    previous_slot = uint64(max(int(state.slot), 1) - 1)
    domain = spec.get_domain(state, spec.DOMAIN_SYNC_COMMITTEE,
                             spec.compute_epoch_at_slot(previous_slot))
    root = spec.compute_signing_root(
        spec.get_block_root_at_slot(state, previous_slot), domain)
    epoch = int(spec.get_current_epoch(state))
    period = epoch // int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    out.append(_set(participants, root, signature, "sync_aggregate",
                    hint=("sync", period)))


def _payload_header(spec, state, body, out):
    signed_header = body.signed_execution_payload_header
    builder = state.validators[signed_header.message.builder_index]
    root = spec.compute_signing_root(
        signed_header.message,
        spec.get_domain(state, spec.DOMAIN_BEACON_BUILDER))
    out.append(_set([builder.pubkey], root, signed_header.signature,
                    "payload_header"))


def _payload_attestations(spec, state, body, out):
    for i, payload_attestation in enumerate(body.payload_attestations):
        def one(out, i=i, payload_attestation=payload_attestation):
            indexed = spec.get_indexed_payload_attestation(
                state, payload_attestation.data.slot, payload_attestation)
            indices = [int(x) for x in indexed.attesting_indices]
            if len(indices) == 0 or indices != sorted(set(indices)):
                return
            pubkeys = [state.validators[x].pubkey for x in indices]
            domain = spec.get_domain(state, spec.DOMAIN_PTC_ATTESTER, None)
            root = spec.compute_signing_root(indexed.data, domain)
            out.append(_set(pubkeys, root, indexed.signature,
                            "payload_attestation",
                            ("payload_attestation", i)))
        _guarded(out, "payload_attestation", one)


def collect_pending_deposit_sets(spec, state):
    """Every deposit signature check electra's `process_pending_deposits`
    MAY perform this epoch (EIP-6110: deposits are queued on-block and
    applied during epoch processing, outside the block window), as
    valid-or-skip SignatureSets — the spec skips an invalid pending
    deposit exactly like a block deposit.

    Only unknown-pubkey deposits reach `is_valid_deposit_signature` (a
    registered pubkey takes the top-up branch), and the loop stops at the
    first deposit past the finalized slot / eth1-bridge drain point / the
    per-epoch cap — all statically decidable here.  The churn-limit break
    depends on registry state mutated mid-loop, so collection
    over-approximates it: an unused verdict is one wasted pairing inside
    an already-batched dispatch, never a semantic difference.  A deposit
    whose pubkey an *earlier in-batch deposit* registers is collected too
    and simply never looked up.
    """
    out: list = []
    pending = getattr(state, "pending_deposits", None)
    if pending is None or not len(pending):
        return out
    registry = {bytes(v.pubkey) for v in state.validators}
    finalized_slot = spec.compute_start_slot_at_epoch(
        state.finalized_checkpoint.epoch)
    for i, deposit in enumerate(pending):
        if i >= int(spec.MAX_PENDING_DEPOSITS_PER_EPOCH):
            break
        if (deposit.slot > spec.GENESIS_SLOT
                and state.eth1_deposit_index
                < state.deposit_requests_start_index):
            break
        if deposit.slot > finalized_slot:
            break

        def one(out, i=i, deposit=deposit):
            if bytes(deposit.pubkey) in registry:
                return      # top-up: the inline path never checks it
            message = spec.DepositMessage(
                pubkey=deposit.pubkey,
                withdrawal_credentials=deposit.withdrawal_credentials,
                amount=deposit.amount)
            domain = spec.compute_domain(spec.DOMAIN_DEPOSIT)
            root = spec.compute_signing_root(message, domain)
            out.append(_set([deposit.pubkey], root, deposit.signature,
                            "pending_deposit", ("pending_deposit", i),
                            required=False))
        _guarded(out, "pending_deposit", one)
    METRICS.observe("pending_deposit_sets", len(out))
    return out


def collect_block_sets(spec, state, signed_block):
    """Every signature check `state_transition(state, signed_block)` will
    perform, as SignatureSets.  `state` must already be advanced to the
    block's slot (post-`process_slots`), exactly where the inline path
    verifies; collection never mutates it."""
    out: list = []
    body = signed_block.message.body
    _guarded(out, "proposer",
             lambda o: _proposer(spec, state, signed_block, o))
    _guarded(out, "randao",
             lambda o: _randao(spec, state, signed_block, o))
    if spec.is_post("eip7732"):
        _guarded(out, "payload_header",
                 lambda o: _payload_header(spec, state, body, o))
    _proposer_slashings(spec, state, body, out)
    _attester_slashings(spec, state, body, out)
    _attestations(spec, state, body, out)
    _deposits(spec, state, body, out)
    _voluntary_exits(spec, state, body, out)
    if spec.is_post("capella"):
        _bls_changes(spec, state, body, out)
    if spec.is_post("eip7732"):
        _payload_attestations(spec, state, body, out)
    if spec.is_post("altair"):
        _guarded(out, "sync_aggregate",
                 lambda o: _sync_aggregate(spec, state, body, o))
    METRICS.observe("sets_per_block", len(out))
    return out
