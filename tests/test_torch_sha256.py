"""The port's plain torch SHA-256 against the JAX package, byte for byte.

consensus_specs_tpu_torch/ops/sha256.py is the plain version the CUDA kernel
is held against on the card; here it is held against the JAX XLA twin
(ops/sha256.py), the Pallas kernel's round math run as plain jnp (the way
tests/test_sha256_pallas.py runs it), and hashlib.  Hashing has no
tolerance: every comparison is exact.
"""
import hashlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.ops import sha256 as jsha
from consensus_specs_tpu.ops import sha256_pallas as psha
from consensus_specs_tpu_torch.ops import sha256 as tsha
from consensus_specs_tpu_torch.ops import sha256_cuda


@pytest.fixture(autouse=True)
def _on_cpu():
    port.set_device("cpu")


# words that hit the int32 sign bit and the all-ones pattern
EDGE_WORDS = (0x00000000, 0xFFFFFFFF, 0x80000000)


def _blocks(seed, n):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, 16), dtype=np.uint32)
    for i, v in enumerate(EDGE_WORDS):
        words[i % n, :] = v           # whole rows of each edge word
        words[(i + 3) % n, 5 + i] = v   # and single edge words
    return words


def _pallas_rows(words):
    """The Pallas kernel body's compression math, twice, as plain jnp."""
    lanes = words.shape[0]
    iv = [jnp.full((lanes,), int(v), jnp.uint32) for v in jsha._IV]
    mid = psha._compress_rows(iv, [jnp.asarray(words[:, i]) for i in range(16)])
    pad = [jnp.full((lanes,), int(v), jnp.uint32) for v in jsha._PAD_BLOCK]
    out = psha._compress_rows(mid, pad)
    return np.stack([np.asarray(x) for x in out], axis=1)


def test_sha256_64byte_matches_jax_pallas_and_hashlib():
    words = _blocks(1, 16)
    got = tsha.words_to_numpy(tsha.sha256_64byte(tsha.words_from_numpy(words)))
    np.testing.assert_array_equal(
        got, np.asarray(jsha.sha256_64byte(jnp.asarray(words))))
    np.testing.assert_array_equal(got, _pallas_rows(words))
    data = words.astype(">u4").tobytes()
    for i in range(words.shape[0]):
        assert (got[i].astype(">u4").tobytes()
                == hashlib.sha256(data[i * 64:(i + 1) * 64]).digest()), i


def test_sha256_compress_matches_jax():
    rng = np.random.default_rng(2)
    state = rng.integers(0, 2**32, size=(5, 8), dtype=np.uint32)
    state[0] = 0xFFFFFFFF
    block = _blocks(3, 5)
    got = tsha.sha256_compress(tsha.words_from_numpy(state),
                               tsha.words_from_numpy(block))
    np.testing.assert_array_equal(
        tsha.words_to_numpy(got),
        np.asarray(jsha.sha256_compress(jnp.asarray(state),
                                        jnp.asarray(block))))


@pytest.mark.parametrize("n_pairs", [1, 3, 255, 256, 257, 4097])
def test_hash_pairs_matches_jax(n_pairs):
    chunks = _blocks(100 + n_pairs, n_pairs).reshape(2 * n_pairs, 8)
    got = sha256_cuda.hash_pairs_cuda(tsha.words_from_numpy(chunks))
    assert got.shape == (n_pairs, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(
        tsha.words_to_numpy(got),
        np.asarray(jsha.hash_pairs(jnp.asarray(chunks))))


def test_merkle_tree_root_depth_10_matches_jax():
    rng = np.random.default_rng(10)
    chunks = rng.integers(0, 2**32, size=(1 << 10, 8), dtype=np.uint32)
    want = np.asarray(jsha.merkle_tree_root(jnp.asarray(chunks), 10))
    plain = tsha.merkle_tree_root(tsha.words_from_numpy(chunks), 10)
    wrapped = sha256_cuda.merkle_tree_root_cuda(tsha.words_from_numpy(chunks),
                                                10)
    np.testing.assert_array_equal(tsha.words_to_numpy(plain), want)
    np.testing.assert_array_equal(tsha.words_to_numpy(wrapped), want)
    data = chunks.astype(">u4").tobytes()
    assert tsha.merkle_root(data) == jsha.merkle_root_jax(data)
    assert sha256_cuda.merkle_root_cuda(data, "cpu") == jsha.merkle_root_jax(data)
    assert tsha.hash_level(data) == jsha.hash_level_jax(data)


def test_wrapper_counts_plain_calls_on_cpu_and_never_launches():
    before = (sha256_cuda.hash_pairs_cuda.launches,
              sha256_cuda.hash_pairs_cuda.plain_calls)
    sha256_cuda.hash_pairs_cuda(torch.zeros((4, 8), dtype=torch.int32))
    assert sha256_cuda.hash_pairs_cuda.launches == before[0]
    assert sha256_cuda.hash_pairs_cuda.plain_calls == before[1] + 1


@pytest.mark.parametrize("bad, exc", [
    (torch.zeros((3, 8), dtype=torch.int32), ValueError),      # odd rows
    (torch.zeros((4, 4), dtype=torch.int32), ValueError),      # not 8 words
    (torch.zeros((4, 8), dtype=torch.int64), TypeError),       # dtype
    (torch.zeros((8, 4), dtype=torch.int32).t(), ValueError),  # strided
    (torch.zeros((4, 8), dtype=torch.int32, device="meta"), ValueError),
])
def test_wrapper_rejects_bad_input(bad, exc):
    with pytest.raises(exc):
        sha256_cuda.hash_pairs_cuda(bad)


def _c_table(name):
    src = open(sha256_cuda.KERNEL_SOURCE).read()
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]


def test_kernel_constant_tables_match_the_spec():
    """The kernel's constant tables (it cannot run here): K, the IV, and
    the pad block's expanded schedule folded with K."""
    assert _c_table("kK") == [int(k) for k in jsha._K]
    assert _c_table("kIV") == [int(v) for v in jsha._IV]
    w = [int(v) for v in jsha._PAD_BLOCK]
    m = 0xFFFFFFFF

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & m
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & m)
    assert _c_table("kPadKW") == [(int(k) + x) & m
                                  for k, x in zip(jsha._K, w)]
