"""The port's generalized-index proofs against the JAX package.

The shapes of tests/test_ssz_proofs.py, declared in both packages' type
systems: generalized indices must be equal, every branch the port computes
must equal the reference's branch byte for byte, and it must verify against
the view's own root with `is_valid_merkle_branch`.
"""
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu import ssz as jssz
from consensus_specs_tpu.ssz import proofs as jproofs
from consensus_specs_tpu_torch import ssz as tssz
from consensus_specs_tpu_torch.ssz import proofs as tproofs


@pytest.fixture(autouse=True)
def _on_cpu():
    port.set_device("cpu")


def _outer(ssz):
    class Inner(ssz.Container):
        a: ssz.uint64
        b: ssz.Bytes32

    class Outer(ssz.Container):
        x: ssz.uint64
        inner: Inner
        items: ssz.List[Inner, 8]
        raw: ssz.List[ssz.uint64, 16]
        bits: ssz.Bitlist[20]

    view = Outer(
        x=7,
        inner=Inner(a=1, b=b"\x22" * 32),
        items=[Inner(a=2, b=b"\x33" * 32), Inner(a=3, b=b"\x44" * 32)],
        raw=[9, 8, 7],
        bits=[True, False, True])
    return Outer, view


REF_OUTER, _ = _outer(jssz)
PORT_OUTER, _ = _outer(tssz)

RAW_CHUNK = b"".join(int(v).to_bytes(8, "little") for v in [9, 8, 7]) \
    + b"\x00" * 8


@pytest.mark.parametrize("path, leaf", [
    (("x",), lambda ssz, v: ssz.hash_tree_root(ssz.uint64(7))),
    (("inner",), lambda ssz, v: ssz.hash_tree_root(v.inner)),
    (("inner", "b"), lambda ssz, v: b"\x22" * 32),
    (("items", 1), lambda ssz, v: ssz.hash_tree_root(v.items[1])),
    (("items", 5), lambda ssz, v: b"\x00" * 32),
    (("items", "__len__"), lambda ssz, v: (2).to_bytes(32, "little")),
    (("raw", 0), lambda ssz, v: RAW_CHUNK),
    (("items", 0, "a"), lambda ssz, v: ssz.hash_tree_root(ssz.uint64(2))),
    (("bits", 3), lambda ssz, v: None),
], ids=lambda p: "-".join(map(str, p)) if isinstance(p, tuple) else "")
def test_proof_matches_jax_and_verifies(path, leaf):
    _, ref_view = _outer(jssz)
    _, view = _outer(tssz)
    g = tproofs.get_generalized_index(PORT_OUTER, *path)
    assert g == jproofs.get_generalized_index(REF_OUTER, *path)
    branch = tproofs.compute_merkle_proof(view, g)
    assert branch == jproofs.compute_merkle_proof(ref_view, g)
    want = leaf(tssz, view)
    if want is not None:
        assert tssz.is_valid_merkle_branch(
            bytes(want), branch, tproofs.get_generalized_index_length(g),
            tproofs.get_subtree_index(g), bytes(tssz.hash_tree_root(view)))


def test_mutation_invalidates_proof():
    _, view = _outer(tssz)
    g = tproofs.get_generalized_index(PORT_OUTER, "inner", "b")
    branch = tproofs.compute_merkle_proof(view, g)
    view.x = 8  # mutate an unrelated field
    assert not tssz.is_valid_merkle_branch(
        b"\x22" * 32, branch, tproofs.get_generalized_index_length(g),
        tproofs.get_subtree_index(g), bytes(tssz.hash_tree_root(view)))


@pytest.mark.parametrize("indices", [(1,), (2, 3), (5, 6, 7), (8, 1, 13)])
def test_generalized_index_arithmetic_matches_jax(indices):
    assert tproofs.concat_generalized_indices(*indices) \
        == jproofs.concat_generalized_indices(*indices)
    for g in indices:
        for name in ("get_generalized_index_length", "get_subtree_index",
                     "generalized_index_sibling", "generalized_index_parent"):
            assert getattr(tproofs, name)(g) == getattr(jproofs, name)(g)


@pytest.mark.parametrize("path, exc", [
    (("nope",), KeyError),
    (("raw", 0, 1), TypeError),
    (("items", 9), IndexError),
    (("x", "__len__"), TypeError),
])
def test_bad_paths_raise_like_jax(path, exc):
    with pytest.raises(exc):
        jproofs.get_generalized_index(REF_OUTER, *path)
    with pytest.raises(exc):
        tproofs.get_generalized_index(PORT_OUTER, *path)
