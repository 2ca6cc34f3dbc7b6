"""The port's fused multi-round sweep against the JAX package.

consensus_specs_tpu_torch/ops/sha256.py `fused_rounds` runs a whole hash-job
DAG of an incremental re-root; on the CPU each round is the plain
`hash_gather_pairs`, through the gather-hash kernel's wrapper.  Here it is
held against the reference's `fused_rounds` (its XLA program on the CPU, as
tests/test_pipeline_async.py runs it) and hashlib, and its device literal
pool against the reference's contract.  Hashing has no tolerance: every
comparison is exact.
"""
import hashlib

import numpy as np
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.ops import sha256 as jsha
from consensus_specs_tpu_torch.ops import sha256 as tsha
from consensus_specs_tpu_torch.ops import sha256_cuda


@pytest.fixture(autouse=True)
def _on_cpu_with_fresh_pools():
    port.set_device("cpu")
    tsha.reset_literal_pool()
    jsha.reset_literal_pool()
    yield
    tsha.reset_literal_pool()
    jsha.reset_literal_pool()


def _h(a, b):
    return hashlib.sha256(a + b).digest()


SIX = [bytes([i]) * 32 for i in range(6)]
SIX_ROUNDS = [([0, 2, 4], [1, 3, 5]), ([6], [7])]


def test_six_literal_dag_matches_jax_and_hashlib_and_hits_the_pool():
    out = tsha.fused_rounds(b"".join(SIX), SIX_ROUNDS)
    e0 = _h(SIX[0], SIX[1]) + _h(SIX[2], SIX[3]) + _h(SIX[4], SIX[5])
    assert out == [e0, _h(e0[:32], e0[32:64])]
    assert out == jsha.fused_rounds(b"".join(SIX), SIX_ROUNDS)
    # the second identical run finds every literal in the pool
    stats, jstats = {}, {}
    assert tsha.fused_rounds(b"".join(SIX), SIX_ROUNDS, stats=stats) == out
    jsha.fused_rounds(b"".join(SIX), SIX_ROUNDS, stats=jstats)
    assert stats == jstats == {"uploaded": 0, "skipped": 6}


def _seeded_dag(seed, n_lits, sizes):
    """Literals with repeats, and rounds whose indices reach across every
    earlier round (each round reads at least one output of the one before)."""
    rng = np.random.default_rng(seed)
    lits = [rng.bytes(32) for _ in range(n_lits)]
    rounds, avail = [], n_lits
    for r, n in enumerate(sizes):
        il = rng.integers(0, avail, n).tolist()
        ir = rng.integers(0, avail, n).tolist()
        if r:
            il[0] = avail - 1
        rounds.append((il, ir))
        avail += n
    return lits, rounds


def _hashlib_rounds(lits, rounds):
    rows = list(lits)
    out = []
    for il, ir in rounds:
        digests = [_h(rows[a], rows[b]) for a, b in zip(il, ir)]
        rows += digests
        out.append(b"".join(digests))
    return out


@pytest.mark.parametrize("seed, n_lits, sizes", [
    (1, 37, (13, 9, 3)),
    (2, 50, (16, 11, 4)),
])
def test_seeded_cross_round_dags_match_jax(seed, n_lits, sizes):
    """Both DAGs pad to one reference signature, so XLA compiles once."""
    lits, rounds = _seeded_dag(seed, n_lits, sizes)
    stats, jstats = {}, {}
    got = tsha.fused_rounds(b"".join(lits), rounds, stats=stats)
    assert got == jsha.fused_rounds(b"".join(lits), rounds, stats=jstats)
    assert got == _hashlib_rounds(lits, rounds)
    assert stats == jstats
    # a second sweep over the same literals plus the first one's outputs
    # uploads nothing, in both packages
    again = [lits[0], got[0][:32], got[-1][-32:]]
    stats, jstats = {}, {}
    second = tsha.fused_rounds(b"".join(again), [([0, 1], [2, 0])],
                               stats=stats)
    jsecond = jsha.fused_rounds(b"".join(again), [([0, 1], [2, 0])],
                                stats=jstats)
    assert second == jsecond
    assert stats == jstats == {"uploaded": 0, "skipped": 3}


def test_sweep_larger_than_the_pool_bypasses_it():
    n = tsha._POOL_CAP + 1
    rng = np.random.default_rng(7)
    data = rng.bytes(32 * n)
    lits = [data[32 * i:32 * (i + 1)] for i in range(n)]
    rounds = [([0, n - 1, 5], [n - 2, 3, 5]), ([n, n + 1], [n + 2, 0])]
    tsha.fused_rounds(b"".join(SIX), SIX_ROUNDS)      # seed the pool
    stats = {}
    out = tsha.fused_rounds(data, rounds, stats=stats)
    assert out == _hashlib_rounds(lits, rounds)
    assert stats == {"uploaded": n, "skipped": 0}
    # the bypass dropped the pool: the six literals are fresh again
    stats = {}
    tsha.fused_rounds(b"".join(SIX), SIX_ROUNDS, stats=stats)
    assert stats == {"uploaded": 6, "skipped": 0}


def test_pool_overflow_drops_and_reseeds():
    rng = np.random.default_rng(8)
    n = tsha._POOL_CAP // 2 + 1
    first = rng.bytes(32 * n)
    second = rng.bytes(32 * n)
    tsha.fused_rounds(first, [([0], [1])])
    stats = {}
    out = tsha.fused_rounds(second, [([0], [1])], stats=stats)
    assert out == [_h(second[:32], second[32:64])]
    assert stats == {"uploaded": n, "skipped": 0}


@pytest.mark.parametrize("rounds", [
    [([0], [6])],               # reads its own round's first output
    [([0, 1], [1])],            # left and right counts differ
    [([0], [1]), ([-1], [0])],  # negative index
])
def test_bad_rounds_raise(rounds):
    with pytest.raises(ValueError):
        tsha.fused_rounds(b"".join(SIX), rounds)


def test_hash_gather_pairs_matches_hashlib_on_sign_bit_words():
    rng = np.random.default_rng(9)
    pool = rng.integers(0, 2**32, size=(12, 8), dtype=np.uint32)
    pool[0] = 0x80000000
    pool[1] = 0xFFFFFFFF
    pool[2, ::2] = 0x80000000
    pool[2, 1::2] = 0xFFFFFFFF
    idx_l = np.array([0, 1, 2, 0, 11, 5], dtype=np.int32)
    idx_r = np.array([1, 0, 2, 0, 3, 11], dtype=np.int32)
    got = tsha.hash_gather_pairs(tsha.words_from_numpy(pool),
                                 torch.from_numpy(idx_l),
                                 torch.from_numpy(idx_r))
    rows = [r.astype(">u4").tobytes() for r in pool]
    want = b"".join(_h(rows[a], rows[b]) for a, b in zip(idx_l, idx_r))
    assert tsha.words_to_bytes(got) == want


def test_gather_wrapper_writes_in_place_and_counts_plain_calls():
    pool = torch.zeros((6, 8), dtype=torch.int32)
    pool[:2] = torch.arange(16, dtype=torch.int32).view(2, 8)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    before = (sha256_cuda.hash_gather_pairs_cuda.launches,
              sha256_cuda.hash_gather_pairs_cuda.plain_calls)
    out = sha256_cuda.hash_gather_pairs_cuda(pool, idx, idx.flip(0), 3)
    assert out.data_ptr() == pool[3].data_ptr()
    want = tsha.hash_gather_pairs(pool, idx, idx.flip(0))
    assert torch.equal(pool[3:5], want)
    assert torch.equal(pool[5], torch.zeros(8, dtype=torch.int32))
    assert sha256_cuda.hash_gather_pairs_cuda.launches == before[0]
    assert sha256_cuda.hash_gather_pairs_cuda.plain_calls == before[1] + 1


_I = torch.tensor([0, 1], dtype=torch.int32)


@pytest.mark.parametrize("pool, idx_l, idx_r, offset, exc", [
    (torch.zeros((6, 4), dtype=torch.int32), _I, _I, 2, ValueError),
    (torch.zeros((6, 8), dtype=torch.int64), _I, _I, 2, TypeError),
    (torch.zeros((6, 8), dtype=torch.int32), _I.long(), _I, 2, TypeError),
    (torch.zeros((6, 8), dtype=torch.int32), _I, _I[:1], 2, ValueError),
    (torch.zeros((8, 6), dtype=torch.int32).t(), _I, _I, 2, ValueError),
    (torch.zeros((6, 8), dtype=torch.int32), _I, _I, 5, ValueError),
    (torch.zeros((6, 8), dtype=torch.int32), _I, _I, -1, ValueError),
    (torch.zeros((6, 8), dtype=torch.int32, device="meta"),
     _I.to("meta"), _I.to("meta"), 2, ValueError),
    (torch.zeros((6, 8), dtype=torch.int32, device="meta"), _I, _I, 2,
     ValueError),
])
def test_gather_wrapper_rejects_bad_input(pool, idx_l, idx_r, offset, exc):
    with pytest.raises(exc):
        sha256_cuda.hash_gather_pairs_cuda(pool, idx_l, idx_r, offset)


def test_fused_rounds_on_the_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="set_device"):
            tsha.fused_rounds(b"".join(SIX), SIX_ROUNDS)
    finally:
        port.set_device("cpu")
