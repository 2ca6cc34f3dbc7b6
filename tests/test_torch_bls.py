"""The port's BLS shim on its default device backend (plain torch on the
CPU) against the JAX package's native verdicts on the cases of
`consensus_specs_tpu/gen/runners/bls.py`.

Each verify, fast_aggregate_verify and aggregate_verify case of the runner
(valid, wrong key, tampered, infinity and undecodable encodings, empty
lists) is one job of one batched call per handler (`VerifyBatch`,
`FastAggregateVerifyBatch`, `AggregateVerifyBatch`: one ladder and one
pairing dispatch each); each case's verdict must equal the runner's
output, which the reference's native suite computed.  Every case whose
points fail to decode costs no device work; of the cases that reach the
device, one valid and one invalid case of each handler run here, and the
rest under `slow` (each decodable job adds seconds of plain-torch ladder
and pairing on the CPU).  A valid and an invalid case go through the
scalar API too.  `Sign`, `Aggregate`,
`AggregatePKs`, `SkToPk` and `KeyValidate` are host-only and must give the
reference's bytes.  Exact comparisons throughout.
"""
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.gen.runners import bls as runner
from consensus_specs_tpu.utils import bls as jbls
from consensus_specs_tpu_torch.ops import bls381_cuda
from consensus_specs_tpu_torch.utils import bls

HANDLERS = ("verify", "fast_aggregate_verify", "aggregate_verify",
            "sign", "aggregate")


def _bytes(h):
    return bytes.fromhex(h[2:]) if h is not None else None


@pytest.fixture(scope="module")
def cases():
    """handler -> {case name: payload} from the reference's runner."""
    out = {h: {} for h in HANDLERS}
    for provider in runner.providers():
        for case in provider.make_cases():
            if case.handler_name in out:
                (_name, _kind, payload), = list(case.case_fn())
                out[case.handler_name][case.case_name] = payload
    return out


@pytest.fixture(autouse=True)
def _device_backend():
    port.set_device("cpu")
    bls.use_backend("cuda")
    bls.bls_active = True
    yield
    bls.use_backend("cuda")
    bls.bls_active = True


def _batch(handler, cases):
    payloads = cases[handler]
    names = sorted(payloads)
    ins = [payloads[n]["input"] for n in names]
    if handler == "verify":
        got = bls.VerifyBatch([_bytes(i["pubkey"]) for i in ins],
                              [_bytes(i["message"]) for i in ins],
                              [_bytes(i["signature"]) for i in ins])
    elif handler == "fast_aggregate_verify":
        got = bls.FastAggregateVerifyBatch(
            [[_bytes(p) for p in i["pubkeys"]] for i in ins],
            [_bytes(i["message"]) for i in ins],
            [_bytes(i["signature"]) for i in ins])
    else:
        got = bls.AggregateVerifyBatch(
            [[_bytes(p) for p in i["pubkeys"]] for i in ins],
            [[_bytes(m) for m in i["messages"]] for i in ins],
            [_bytes(i["signature"]) for i in ins])
    return dict(zip(names, got))


VERIFY_HANDLERS = ("verify", "fast_aggregate_verify", "aggregate_verify")

# the runner's cases whose points all decode, so that they reach the
# device; all others are rejected on the host at no device cost
DECODABLE = {
    "verify": {f"verify_{kind}_{i}_{j}" for kind in ("valid", "wrong_pubkey")
               for i in range(3) for j in range(3)}
    | {f"verify_wrong_message_{j}" for j in range(3)},
    "fast_aggregate_verify": {
        f"fast_aggregate_verify_{kind}_{i}"
        for kind in ("valid", "extra_pubkey", "wrong_message")
        for i in range(3)} | {"fast_aggregate_verify_single_pubkey"},
    "aggregate_verify": {
        "aggregate_verify_valid", "aggregate_verify_wrong_message_order"}
    | {f"aggregate_verify_{kind}_{i}"
       for kind in ("wrong_pubkey_position", "missing_signer")
       for i in range(3)},
}
# one valid and one invalid decodable case of each handler for tier 1
TIER1_DECODABLE = {
    "verify": {"verify_valid_0_0", "verify_wrong_pubkey_0_0"},
    "fast_aggregate_verify": {"fast_aggregate_verify_valid_1",
                              "fast_aggregate_verify_wrong_message_1"},
    "aggregate_verify": {"aggregate_verify_valid",
                         "aggregate_verify_wrong_message_order"},
}


def _case_ids():
    names = []
    for provider in runner.providers():
        for case in provider.make_cases():
            if case.handler_name in VERIFY_HANDLERS:
                names.append((case.handler_name, case.case_name))
    return names


_VERIFY_CASES = _case_ids()
_TIER1 = [(h, n) for h, n in _VERIFY_CASES
          if n not in DECODABLE[h] or n in TIER1_DECODABLE[h]]
_SLOW = [(h, n) for h, n in _VERIFY_CASES if (h, n) not in _TIER1]


def _device_verdicts(cases, picked):
    """The picked cases through the device backend, one batched call a
    handler; the kernels' plain versions ran, no kernel launched."""
    port.set_device("cpu")
    bls.use_backend("cuda")
    launches = sum(w.launches for ws in bls381_cuda.WRAPPERS.values()
                   for w in ws)
    out = {h: _batch(h, {h: {n: cases[h][n] for hh, n in picked if hh == h}})
           for h in VERIFY_HANDLERS}
    assert sum(w.launches for ws in bls381_cuda.WRAPPERS.values()
               for w in ws) == launches
    return out


@pytest.fixture(scope="module")
def tier1_verdicts(cases):
    clears = bls381_cuda.clear_cofactor_g2.plain_calls
    out = _device_verdicts(cases, _TIER1)
    assert bls381_cuda.clear_cofactor_g2.plain_calls == clears + 3
    return out


@pytest.mark.parametrize("handler,name", _TIER1,
                         ids=[f"{h}:{n}" for h, n in _TIER1])
def test_device_verdict_equals_the_reference(tier1_verdicts, cases,
                                             handler, name):
    assert tier1_verdicts[handler][name] is cases[handler][name]["output"]


def test_decodable_split_is_the_runners(cases):
    """DECODABLE names exactly the runner's cases whose points decode."""
    from consensus_specs_tpu_torch.crypto import bls12_381 as native
    from consensus_specs_tpu_torch.crypto.curve import DecodeError

    def decodes(pks, sig):
        try:
            for pk in pks:
                native._load_pubkey(_bytes(pk))
            native._load_signature(_bytes(sig))
        except (DecodeError, ValueError):
            return False
        return bool(pks)
    for h in VERIFY_HANDLERS:
        found = set()
        for name, payload in cases[h].items():
            i = payload["input"]
            pks = [i["pubkey"]] if h == "verify" else i["pubkeys"]
            if decodes(pks, i["signature"]):
                found.add(name)
        assert found == DECODABLE[h], h


@pytest.mark.slow
def test_every_decodable_case_on_the_device_backend(cases):
    out = _device_verdicts(cases, _SLOW)
    for h, n in _SLOW:
        assert out[h][n] is cases[h][n]["output"], (h, n)


def test_scalar_api_valid_and_invalid(cases):
    """The scalar API on both backends; the device backend's valid check
    runs in the block tests (the spec's seams), so here it rejects on the
    host and the native backend takes both."""
    valid = cases["verify"]["verify_valid_0_0"]["input"]
    tampered = cases["verify"]["verify_tampered_signature_0_0"]["input"]
    for payload, want in ((valid, True), (tampered, False)):
        args = (_bytes(payload["pubkey"]), _bytes(payload["message"]),
                _bytes(payload["signature"]))
        if not want:
            assert bls.Verify(*args) is False
        bls.use_backend("native")
        assert bls.Verify(*args) is want
        assert jbls.Verify(*args) is want
        bls.use_backend("cuda")


def test_stubbed_bls_reads_every_job_as_valid():
    bls.bls_active = False
    assert bls.Verify(b"\x00" * 48, b"", b"\x00" * 96) is True
    assert bls.FastAggregateVerifyBatch([[b"\x00"]] * 2, [b""] * 2,
                                        [b"\x00"] * 2) == [True, True]
    assert bls.Sign(1, b"m") == bls.STUB_SIGNATURE


def test_backend_names_and_aliases():
    for name in ("tpu", "fastest", "cuda"):
        bls.use_backend(name)
        assert bls.current_backend() == "cuda"
    bls.use_backend("native")
    assert bls.current_backend() == "native"
    with pytest.raises(ValueError):
        bls.use_backend("milagro")


@pytest.mark.parametrize("handler", VERIFY_HANDLERS)
def test_native_backend_equals_the_reference(cases, handler):
    bls.use_backend("native")
    picked = {n: cases[handler][n] for h, n in _TIER1 if h == handler}
    got = _batch(handler, {handler: picked})
    assert got == {n: p["output"] for n, p in picked.items()}


def test_sign_and_sk_to_pk_bytes_equal_the_reference(cases):
    for name, payload in sorted(cases["sign"].items()):
        sk = int.from_bytes(_bytes(payload["input"]["privkey"]), "big")
        msg = _bytes(payload["input"]["message"])
        want = _bytes(payload["output"])
        if want is None:
            with pytest.raises(ValueError):
                bls.Sign(sk, msg)
            continue
        assert bls.Sign(sk, msg) == want, name
    for sk in runner.PRIVKEYS:
        assert bls.SkToPk(sk) == jbls.SkToPk(sk)


def test_aggregate_bytes_equal_the_reference(cases):
    for name, payload in sorted(cases["aggregate"].items()):
        sigs = [_bytes(s) for s in payload["input"]]
        want = _bytes(payload["output"])
        if want is None:
            with pytest.raises(ValueError):
                bls.Aggregate(sigs)
        else:
            assert bls.Aggregate(sigs) == want, name


def test_aggregate_pks_and_key_validate_equal_the_reference():
    pks = list(runner.PUBKEYS)
    assert bls.AggregatePKs(pks) == jbls.AggregatePKs(pks)
    encodings = pks + [runner.ZERO_PUBKEY, runner.G1_POINT_AT_INFINITY,
                       runner.X40_PUBKEY, pks[0][:47], b"\xff" * 48]
    for pk in encodings:
        assert bls.KeyValidate(pk) is jbls.KeyValidate(pk)
    with pytest.raises(ValueError):
        bls.AggregatePKs([])


def test_pairing_check_seam():
    g1, g2 = bls.G1(), bls.G2()
    assert bls.pairing_check([(g1, g2), (bls.neg(g1), g2)]) is True
    assert bls.pairing_check([(bls.Z1(), g2)]) is True
