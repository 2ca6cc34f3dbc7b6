"""The port's signature pipeline (sigpipe/) against the JAX package's.

The same signature sets (bytes) go through the port's
`scheduler.verify_sets` and the JAX package's, and give the same verdicts,
the same `miller_loops_per_flush` (N + 1 folded, 2N unfolded) and the same
bisection counts:

- the shapes of the JAX package's tests/test_sigpipe.py and
  tests/test_fold.py (one bad set in four, a single-set flush valid and,
  unfolded, invalid; under `slow`, for their native pairings' seconds
  here: one bad set in six folded and unfolded, all invalid, an infinity
  signature through the G2 fold), on both packages' native backends: the
  port's staged chain (its weighting and G2 fold on the kernels' plain
  versions);
- the leg counts at N = 1, 16 and 1,024 with the heavy steps stubbed,
  the JAX package's own monkeypatch idiom (tests/test_fold.py), in both
  packages; and the port's one-launch fold, which the JAX package takes
  only on its device backend, counted alone.

With `sigpipe.enable()` in both packages, a minimal phase0 block with an
attestation built by the JAX package's `test_infra` gives the same
post-state bytes and root, the port on its device backend (the one-launch
fold's plain version: three checks, one fold, no scalar ladder); the same
block with a wrong attestation signature raises at `process_attestation`
in both, after one failed product and bisection, with the same partial
state.  A failure inside the port's pipeline raises: it never reruns the
block on the scalar path.
"""
import traceback

import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu import resilience
from consensus_specs_tpu import sigpipe as ref_sigpipe
from consensus_specs_tpu.ops import g1_sweep as ref_sweep
from consensus_specs_tpu.crypto import curve as ref_cv
from consensus_specs_tpu.sigpipe import cache as ref_cache
from consensus_specs_tpu.sigpipe import fold as ref_fold
from consensus_specs_tpu.sigpipe import scheduler as ref_scheduler
from consensus_specs_tpu.sigpipe.sets import SignatureSet as RefSet
from consensus_specs_tpu.specs import get_spec as reference_spec
from consensus_specs_tpu.test_infra.attestations import get_valid_attestation
from consensus_specs_tpu.test_infra.blocks import (
    build_empty_block_for_next_slot, next_slot, sign_block,
    state_transition_and_sign_block)
from consensus_specs_tpu.test_infra.context import (
    _genesis_state, default_activation_threshold, default_balances)
from consensus_specs_tpu.test_infra.keys import privkeys, pubkeys
from consensus_specs_tpu.utils import bls as jbls
from consensus_specs_tpu_torch import sigpipe
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.ops import bls381_cuda, pairing_torch
from consensus_specs_tpu_torch.parallel import shard_verify
from consensus_specs_tpu_torch.sigpipe import METRICS, cache, fold, scheduler
from consensus_specs_tpu_torch.sigpipe.sets import SignatureSet
from consensus_specs_tpu_torch.specs import get_spec
from consensus_specs_tpu_torch.ssz import merkle
from consensus_specs_tpu_torch.utils import bls


def _reset():
    for mod in (fold, ref_fold):
        mod.reset_mode()
    pairing_torch.reset_mode()
    sigpipe.disable()
    ref_sigpipe.disable()
    METRICS.reset()
    ref_sigpipe.METRICS.reset()
    cache.clear()
    ref_cache.clear()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    port.set_device("cpu")
    merkle.use_host_hashing()
    resilience.disable()
    monkeypatch.setattr(ref_sweep, "G1_SWEEP_MODE", "oracle")
    bls.use_backend("native")
    jbls.use_backend("native")
    bls.bls_active = jbls.bls_active = True
    _reset()
    yield
    _reset()
    bls.use_backend("cuda")
    merkle.use_device_hashing()


# ---------------------------------------------------------------------------
# verify_sets: the JAX package's shapes, both packages
# ---------------------------------------------------------------------------

INF_SIG = b"\xc0" + b"\x00" * 95


def _triples(n, bad=(), inf_sig=False):
    """(pubkey, root, signature) bytes of n single-pubkey sets; the
    signatures at `bad` sign another message; `inf_sig` appends a set
    with the infinity signature (tests/test_fold.py's shapes)."""
    out = []
    for i in range(n):
        msg = i.to_bytes(8, "little") + b"\x3c" * 24
        signed = msg if i not in bad else b"\x01" * 32
        out.append((bytes(pubkeys[i % 16]), msg,
                    bytes(jbls.Sign(privkeys[i % 16], signed))))
    if inf_sig:
        out.append((bytes(pubkeys[5]), b"\x09" * 32, INF_SIG))
    return out


def _run(set_cls, sched, fold_mod, metrics, triples, fold_mode):
    fold_mod.FOLD_MODE = fold_mode
    verdicts = sched.verify_sets([
        set_cls(pubkeys=(pk,), signing_root=root, signature=sig,
                kind="fold", origin=("fold", i))
        for i, (pk, root, sig) in enumerate(triples)], mode="fused")
    snap = metrics.snapshot()
    return verdicts, {name: snap.get(name) for name in (
        "miller_loops_per_flush", "fused_batch_failures",
        "bisect_dispatches", "dispatches", "fold_dispatches",
        "fold_enabled", "signatures_scheduled")}


@pytest.mark.parametrize("shape,fold_mode", [
    ("one bad in four", "on"), ("single valid", "on"),
    ("single invalid", "off"),
    pytest.param("one bad in six", "on", marks=pytest.mark.slow),
    pytest.param("one bad in six", "off", marks=pytest.mark.slow),
    pytest.param("all invalid", "on", marks=pytest.mark.slow),
    pytest.param("infinity signature", "on", marks=pytest.mark.slow),
])
def test_verify_sets_equals_the_reference(shape, fold_mode):
    triples = {
        "one bad in four": lambda: _triples(4, bad={2}),
        "one bad in six": lambda: _triples(6, bad={3}),
        "single valid": lambda: _triples(1),
        "single invalid": lambda: _triples(1, bad={0}),
        "all invalid": lambda: _triples(4, bad={0, 1, 2, 3}),
        "infinity signature": lambda: _triples(3, inf_sig=True),
    }[shape]()
    got = _run(SignatureSet, scheduler, fold, METRICS, triples, fold_mode)
    want = _run(RefSet, ref_scheduler, ref_fold, ref_sigpipe.METRICS,
                triples, fold_mode)
    assert got == want
    n = len(triples)
    assert got[1]["miller_loops_per_flush"]["total"] \
        == (n + 1 if fold_mode == "on" else 2 * n)


@pytest.mark.parametrize("n", [1, 16, 1024])
def test_miller_loops_per_flush_counts_equal_the_reference(n, monkeypatch):
    """The legs of an N-set flush with the heavy steps stubbed (one shared
    pubkey, constant hash, signature and weighted points, the product
    forced True), in both packages, fold on and off: N + 1 against 2N."""
    snaps = {}
    for name, sched, fold_mod, g1, g2, metrics, set_cls in (
            ("port", scheduler, fold, cv.g1_generator(), cv.g2_generator(),
             METRICS, SignatureSet),
            ("reference", ref_scheduler, ref_fold, ref_cv.g1_generator(),
             ref_cv.g2_generator(), ref_sigpipe.METRICS, RefSet)):
        seen = {}

        def product(pairs, seen=seen):
            seen["pairs"] = len(pairs)
            return True
        monkeypatch.setattr(sched, "_hash_roots",
                            lambda roots, g2=g2: [g2] * len(roots))
        monkeypatch.setattr(sched, "_load_signature", lambda b, g2=g2: g2)
        monkeypatch.setattr(sched, "_weighted_g1",
                            lambda pts, cs, g1=g1: [g1] * len(pts))
        monkeypatch.setattr(sched, "_pairing_product", product)
        inf = (cv if name == "port" else ref_cv).g2_infinity()
        if name == "port":
            monkeypatch.setattr(fold, "fold_signatures",
                                lambda sigs, cs: (METRICS.inc(
                                    "fold_dispatches"), inf)[1])
        else:
            monkeypatch.setattr(ref_fold, "_fold_sweep",
                                lambda sigs, cs: inf)
        sets = [set_cls(pubkeys=(bytes(pubkeys[0]),),
                        signing_root=b"\x11" * 32, signature=b"\x22" * 96,
                        kind="fold") for _ in range(n)]
        for mode in ("on", "off"):
            fold_mod.FOLD_MODE = mode
            metrics.reset()
            (cache if name == "port" else ref_cache).clear()
            seen.clear()
            assert sched.verify_sets(sets, mode="fused") == [True] * n
            snap = metrics.snapshot()
            snaps[name, mode] = (seen["pairs"],
                                 snap["miller_loops_per_flush"],
                                 snap["fold_enabled"],
                                 snap.get("fold_dispatches", 0))
    for mode, legs in (("on", n + 1), ("off", 2 * n)):
        assert snaps["port", mode] == snaps["reference", mode]
        assert snaps["port", mode][0] == legs


def test_one_launch_flush_counts(monkeypatch):
    """The device backend's default flush is one `pairing_fold` of N + 1
    legs, with no host hash-to-G2 and no staged step."""
    n = 16
    calls = []
    monkeypatch.setattr(shard_verify, "pairing_fold",
                        lambda aggs, cs, roots, sigs: calls.append(
                            (len(aggs), len(cs), len(roots),
                             len(sigs))) or True)
    for name in ("_hash_roots", "_weighted_g1", "_pairing_product"):
        monkeypatch.setattr(scheduler, name, None)    # must not be called
    monkeypatch.setattr(scheduler, "_load_signature",
                        lambda b: cv.g2_generator())
    bls.use_backend("cuda")
    assert fold.one_launch_live()
    sets = [SignatureSet(pubkeys=(bytes(pubkeys[i % 4]),),
                         signing_root=bytes([i]) * 32,
                         signature=b"\x22" * 96, kind="fold")
            for i in range(n)]
    assert scheduler.verify_sets(sets) == [True] * n
    assert calls == [(n, n, n, n)]
    snap = METRICS.snapshot()
    assert snap["miller_loops_per_flush"]["total"] == n + 1
    assert snap["fold_dispatches"] == snap["dispatches"] == 1
    pairing_torch.PAIRING_MODE = "staged"
    assert not fold.one_launch_live()


# ---------------------------------------------------------------------------
# state_transition with the pipeline on, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attestation_block():
    """A minimal phase0 state at slot 1 and a signed block at slot 2 with
    one attestation of slot 1, built and applied by the JAX package; and
    the same block with a wrong attestation signature (re-signed by the
    proposer)."""
    ref = reference_spec("phase0", "minimal")
    genesis = _genesis_state(ref, default_balances,
                             default_activation_threshold, "default")
    state = genesis.copy()
    next_slot(ref, state)
    attestation = get_valid_attestation(ref, state, signed=True)
    pre = state.copy()
    next_slot(ref, state)
    block = build_empty_block_for_next_slot(ref, state)
    block.body.attestations.append(attestation)
    signed = state_transition_and_sign_block(ref, pre.copy(), block.copy())
    bad_block = block.copy()
    bad_block.body.attestations[0].signature = jbls.Sign(
        1, b"not the attestation")
    bad = sign_block(ref, state, bad_block)
    return ref, pre, signed, bad


def _plain_calls():
    return {name: sum(w.plain_calls for w in ws)
            for name, ws in bls381_cuda.WRAPPERS.items()}


def _frames(err):
    return [f.name for f in traceback.extract_tb(err.__traceback__)]


def test_block_with_sigpipe_equals_the_reference(attestation_block):
    ref, pre, signed, _bad = attestation_block
    ref_state = pre.copy()
    ref_sigpipe.enable()
    ref.state_transition(ref_state, signed)

    spec = get_spec("phase0", "minimal")
    state = spec.BeaconState.decode_bytes(pre.encode_bytes())
    bls.use_backend("cuda")
    counts = _plain_calls()
    sigpipe.enable()
    spec.state_transition(
        state, spec.SignedBeaconBlock.decode_bytes(signed.encode_bytes()))
    assert state.encode_bytes() == ref_state.encode_bytes()
    assert bytes(state.hash_tree_root()) == bytes(ref_state.hash_tree_root())
    snap = METRICS.snapshot()
    assert (snap["seam_hits"], snap.get("seam_misses", 0)) == (3, 0)
    assert snap["signatures_scheduled"] == 3
    assert snap["dispatches"] == snap["fold_dispatches"] == 1
    assert snap["miller_loops_per_flush"]["total"] == 4
    after = _plain_calls()
    delta = {name: after[name] - counts[name] for name in counts}
    # one fold (its Miller loops, product and final exponentiation), the
    # committee sum; no scalar check's ladder
    assert delta == {"bls381_pairing": 3, "bls381_g2": 0, "bls381_field": 0,
                     "bls381_segment_sum": 1, "bls381_g1_ladder": 0,
                     "bls381_fold": 1, "bls381_cofactor": 0,
                     "bls381_check": 0, "bls381_pippenger": 0}


def test_tampered_block_raises_at_the_same_operation(attestation_block):
    ref, pre, _signed, bad = attestation_block
    ref_state = pre.copy()
    ref_sigpipe.enable()
    with pytest.raises(AssertionError) as ref_err:
        ref.state_transition(ref_state, bad)
    spec = get_spec("phase0", "minimal")
    state = spec.BeaconState.decode_bytes(pre.encode_bytes())
    sigpipe.enable()
    with pytest.raises(AssertionError) as err:
        spec.state_transition(
            state, spec.SignedBeaconBlock.decode_bytes(bad.encode_bytes()))
    assert _frames(err.value)[-1] == _frames(ref_err.value)[-1] \
        == "process_attestation"
    assert state.encode_bytes() == ref_state.encode_bytes()
    for metrics in (METRICS, ref_sigpipe.METRICS):
        assert metrics.count("fused_batch_failures") == 1
        assert metrics.count("bisect_dispatches") > 0
        assert metrics.count("seam_misses") == 0
    assert METRICS.count("bisect_dispatches") \
        == ref_sigpipe.METRICS.count("bisect_dispatches")


def test_a_pipeline_failure_raises(attestation_block, monkeypatch):
    """A device failure inside the flush propagates out of
    state_transition: no quiet rerun on the scalar path."""
    _ref, pre, signed, _bad = attestation_block

    def broken(*args):
        raise RuntimeError("bls381_fold launch failed")
    monkeypatch.setattr(shard_verify, "pairing_fold", broken)
    spec = get_spec("phase0", "minimal")
    state = spec.BeaconState.decode_bytes(pre.encode_bytes())
    bls.use_backend("cuda")
    sigpipe.enable()
    with pytest.raises(RuntimeError, match="bls381_fold"):
        spec.state_transition(
            state, spec.SignedBeaconBlock.decode_bytes(signed.encode_bytes()))
    assert METRICS.count("seam_hits") == METRICS.count("seam_misses") == 0
