"""The port's SSZ engine against the JAX package, byte for byte.

Values are built in the JAX package, carried across as SSZ bytes and
decoded into the port's types; roots and re-serialized bytes must match.
Merkleization runs with the bulk and subtree thresholds lowered, so the
port's device hashers (the plain torch version, on the CPU) take the big
levels of these small trees.
"""
import numpy as np
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu import ssz as jssz
from consensus_specs_tpu.ssz import merkle as jmerkle
from consensus_specs_tpu_torch import ssz as tssz
from consensus_specs_tpu_torch.ssz import merkle as tmerkle


@pytest.fixture(autouse=True)
def _low_thresholds_on_cpu():
    port.set_device("cpu")
    tmerkle.use_device_hashing(threshold=64, subtree_threshold=256)
    tmerkle.reset_stats()
    yield
    tmerkle.use_device_hashing()


def _chunks(seed, n):
    rng = np.random.default_rng(seed)
    data = rng.bytes(32 * n)
    return [data[32 * i:32 * (i + 1)] for i in range(n)]


@pytest.mark.parametrize("count, limit", [
    (1, None), (3, None), (5, None), (127, None), (128, None), (129, None),
    (257, None), (1000, None), (1 << 12, None), (0, 8), (3, 8), (100, 1 << 10),
    (511, 1 << 20), (4100, 1 << 40),
])
def test_merkleize_chunks_matches_jax(count, limit):
    chunks = _chunks(count, count)
    got = tmerkle.merkleize_chunks(chunks, limit=limit)
    assert got == jmerkle.merkleize_chunks(chunks, limit=limit)
    if count >= 128:
        assert tmerkle.stats["device_pairs"] > 0


def test_merkleize_chunks_over_limit_raises():
    with pytest.raises(ValueError):
        tmerkle.merkleize_chunks(_chunks(0, 9), limit=8)


def _types(ssz):
    """The same SSZ shapes, built from one package's type system."""
    class Inner(ssz.Container):
        a: ssz.uint64
        b: ssz.Bytes32
        flag: ssz.boolean

    class Outer(ssz.Container):
        slot: ssz.uint64
        small: ssz.uint8
        wide: ssz.uint256
        root: ssz.Bytes32
        key: ssz.Bytes48
        inner: Inner
        balances: ssz.List[ssz.uint64, 1 << 20]
        inners: ssz.List[Inner, 1 << 13]
        bits: ssz.Bitlist[2048]
        fixed_bits: ssz.Bitvector[4]
        roots: ssz.Vector[ssz.Bytes32, 256]
        blob: ssz.ByteList[1 << 12]
    return Inner, Outer


def _reference_value(seed, n):
    Inner, Outer = _types(jssz)
    rng = np.random.default_rng(seed)
    return Outer(
        slot=int(rng.integers(0, 2**63)),
        small=7,
        wide=2**255 + 12345,
        root=rng.bytes(32),
        key=rng.bytes(48),
        inner=Inner(a=3, b=rng.bytes(32), flag=True),
        balances=[int(x) for x in rng.integers(0, 2**63, n)],
        inners=[Inner(a=i, b=rng.bytes(32), flag=bool(i % 2))
                for i in range(n // 4)],
        bits=[bool(x) for x in rng.integers(0, 2, min(n, 2048))],
        fixed_bits=[True, False, True, True],
        roots=[rng.bytes(32) for _ in range(256)],
        blob=rng.bytes(min(n, 4096)))


@pytest.mark.parametrize("n", [0, 1, 33, 1000, 20000])
def test_container_roots_and_bytes_match_jax(n):
    ref = _reference_value(n, n)
    data = ref.encode_bytes()
    _, Outer = _types(tssz)
    got = Outer.decode_bytes(data)
    assert got.encode_bytes() == data
    assert bytes(tssz.hash_tree_root(got)) == bytes(jssz.hash_tree_root(ref))
    for name in ("inner", "balances", "inners", "bits", "fixed_bits",
                 "roots", "blob"):
        assert (bytes(tssz.hash_tree_root(getattr(got, name)))
                == bytes(jssz.hash_tree_root(getattr(ref, name)))), name
