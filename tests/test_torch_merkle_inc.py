"""The port's incremental merkleization against the JAX package.

The same SSZ shapes as tests/test_merkle_inc.py are declared in both
packages' type systems, built and mutated by the same seeded sequence, and
re-rooted with incremental mode on.  Roots must equal the reference's
incremental roots and its `oracle_root` byte for byte, and the sweep
counters must equal the reference's: with hashlib in both packages, except
for the fused-sweep tests, which run the port's fused path on the CPU (the
plain gather-hash, through the kernel's wrapper) against the reference's
XLA program on the CPU.
"""
from random import Random
from types import SimpleNamespace

import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu import resilience
from consensus_specs_tpu import ssz as jssz
from consensus_specs_tpu.ops import sha256 as jsha
from consensus_specs_tpu.sigpipe import METRICS as JMETRICS
from consensus_specs_tpu.ssz import incremental as jinc
from consensus_specs_tpu.ssz import merkle as jmerkle
from consensus_specs_tpu_torch import ssz as tssz
from consensus_specs_tpu_torch.ops import sha256 as tsha
from consensus_specs_tpu_torch.ops import sha256_cuda
from consensus_specs_tpu_torch.sigpipe import METRICS as TMETRICS
from consensus_specs_tpu_torch.ssz import incremental as tinc
from consensus_specs_tpu_torch.ssz import merkle as tmerkle

COUNTERS = ("merkle_sweep_dispatches", "merkle_sweep_levels",
            "merkle_chunks_hashed", "merkle_dirty_nodes",
            "merkle_device_round_trips", "merkle_sibling_uploads",
            "merkle_sibling_uploads_skipped")


@pytest.fixture(autouse=True)
def _clean():
    port.set_device("cpu")
    tmerkle.use_host_hashing()
    jmerkle.set_bulk_level_hasher(None)
    for inc in (tinc, jinc):
        inc.disable()
    resilience.disable()
    TMETRICS.reset()
    JMETRICS.reset()
    yield
    for inc in (tinc, jinc):
        inc.disable()
    tmerkle.use_device_hashing()
    jmerkle.set_bulk_level_hasher(None)
    tsha.reset_literal_pool()
    jsha.reset_literal_pool()


def _side(ssz, inc, metrics):
    """One package's Zoo of tests/test_merkle_inc.py, its incremental
    module and its metrics registry."""
    class Checkpoint(ssz.Container):
        epoch: ssz.uint64
        root: ssz.Bytes32

    class Inner(ssz.Container):
        a: ssz.uint64
        cps: ssz.List[Checkpoint, 16]
        bits: ssz.Bitlist[300]
        bv: ssz.Bitvector[10]

    Opt = ssz.Union[None, ssz.uint64, Checkpoint]

    class Zoo(ssz.Container):
        x: ssz.uint64
        inner: Inner
        bal: ssz.List[ssz.uint64, 1 << 20]
        small: ssz.List[ssz.uint8, 100]
        vec: ssz.Vector[ssz.Bytes32, 8]
        cvec: ssz.Vector[Checkpoint, 4]
        u: Opt

    class Small(ssz.Container):
        a: ssz.List[ssz.uint64, 1024]
        b: ssz.Bytes32
        c: ssz.uint64

    return SimpleNamespace(ssz=ssz, inc=inc, metrics=metrics,
                           Checkpoint=Checkpoint, Opt=Opt, Zoo=Zoo,
                           Small=Small)


REF = _side(jssz, jinc, JMETRICS)
PORT = _side(tssz, tinc, TMETRICS)
SIDES = (REF, PORT)


def oracle(s, view) -> bytes:
    """Fully independent root: serialize -> deserialize -> legacy hash on a
    fresh, never-tracked object."""
    return bytes(type(view).deserialize(view.serialize()).hash_tree_root())


def counters(s) -> dict:
    return {name: s.metrics.count(name) for name in COUNTERS}


def random_zoo(s, rng: Random):
    z = s.Zoo(x=rng.randrange(1 << 32))
    for _ in range(rng.randrange(0, 9)):
        z.bal.append(rng.randrange(1 << 50))
    for _ in range(rng.randrange(0, 20)):
        z.small.append(rng.randrange(256))
    for _ in range(rng.randrange(0, 5)):
        z.inner.cps.append(s.Checkpoint(epoch=rng.randrange(100),
                                        root=s.ssz.Bytes32(rng.randbytes(32))))
    for _ in range(rng.randrange(0, 40)):
        z.inner.bits.append(rng.random() < 0.5)
    sel = rng.randrange(3)
    z.u = s.Opt(sel, None if sel == 0 else
                (s.ssz.uint64(rng.randrange(1000)) if sel == 1
                 else s.Checkpoint(epoch=rng.randrange(50))))
    return z


def _mutate_once(s, rng: Random, z) -> None:
    """One random mutation drawn from every mutation family the type system
    supports (tests/test_merkle_inc.py `_mutate_once`)."""
    uint64, Bytes32, Checkpoint, Opt = (s.ssz.uint64, s.ssz.Bytes32,
                                        s.Checkpoint, s.Opt)
    ops = []
    ops.append(lambda: setattr(z, "x", uint64(rng.randrange(1 << 32))))
    ops.append(lambda: setattr(z.inner, "a", uint64(rng.randrange(1 << 20))))
    ops.append(lambda: z.vec.__setitem__(
        rng.randrange(8), Bytes32(rng.randbytes(32))))
    ops.append(lambda: setattr(
        z.cvec[rng.randrange(4)], "epoch", uint64(rng.randrange(1000))))
    if len(z.bal) < 9:
        ops.append(lambda: z.bal.append(rng.randrange(1 << 50)))
    if len(z.bal):
        ops.append(lambda: z.bal.__setitem__(
            rng.randrange(len(z.bal)), uint64(rng.randrange(1 << 50))))
        ops.append(lambda: z.bal.pop())
    if len(z.small) < 100:
        ops.append(lambda: z.small.append(rng.randrange(256)))
    if len(z.small):
        ops.append(lambda: z.small.pop(rng.randrange(len(z.small))))
    if len(z.inner.cps) < 16:
        ops.append(lambda: z.inner.cps.append(
            Checkpoint(epoch=rng.randrange(100))))
    if len(z.inner.cps):
        ops.append(lambda: setattr(
            z.inner.cps[rng.randrange(len(z.inner.cps))],
            "root", Bytes32(rng.randbytes(32))))
        ops.append(lambda: z.inner.cps.pop(rng.randrange(len(z.inner.cps))))
    if len(z.inner.bits) < 300:
        ops.append(lambda: z.inner.bits.append(rng.random() < 0.5))
    if len(z.inner.bits):
        ops.append(lambda: z.inner.bits.__setitem__(
            rng.randrange(len(z.inner.bits)), rng.random() < 0.5))
    ops.append(lambda: z.inner.bv.__setitem__(
        rng.randrange(10), rng.random() < 0.5))
    sel = rng.randrange(3)
    ops.append(lambda: setattr(z, "u", Opt(
        sel, None if sel == 0 else
        (uint64(rng.randrange(1000)) if sel == 1
         else Checkpoint(epoch=rng.randrange(50))))))
    if z.u.selector == 2:
        ops.append(lambda: setattr(
            z.u.value, "epoch", uint64(rng.randrange(1000))))
    rng.choice(ops)()


def _both(fn):
    """fn(side) on the reference, then on the port; both results."""
    return fn(REF), fn(PORT)


def _same_roots(ref_view, port_view) -> bytes:
    """The port's incremental root equals the reference's incremental root,
    both oracles, and the re-serialized bytes; returns the root."""
    assert port_view.serialize() == ref_view.serialize()
    got = bytes(port_view.hash_tree_root())
    assert got == bytes(ref_view.hash_tree_root())
    assert got == tinc.oracle_root(port_view) == jinc.oracle_root(ref_view)
    assert got == oracle(PORT, port_view)
    return got


# ---------------------------------------------------------------------------
# randomized mutation parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_randomized_mutation_parity(seed):
    rngs = {id(s): Random(f"merkle-inc-{seed}") for s in SIDES}
    views = {}
    for s in SIDES:
        s.inc.enable()
        views[id(s)] = s.inc.track(random_zoo(s, rngs[id(s)]))
    ref, got = views[id(REF)], views[id(PORT)]
    _same_roots(ref, got)
    checks = Random(f"checks-{seed}")
    for _step in range(40):
        for s in SIDES:
            _mutate_once(s, rngs[id(s)], views[id(s)])
        if checks.random() < 0.4:   # re-root mid-sequence, not only at the end
            _same_roots(ref, got)
    _same_roots(ref, got)
    # the cached fast path answers without hashing
    before = TMETRICS.count("merkle_chunks_hashed")
    assert bytes(got.hash_tree_root()) == bytes(ref.hash_tree_root())
    assert TMETRICS.count("merkle_chunks_hashed") == before
    assert counters(PORT) == counters(REF)
    assert counters(PORT)["merkle_sweep_dispatches"] > 0


def test_pop_to_empty_and_regrow():
    def run(s):
        s.inc.enable()
        z = s.inc.track(s.Zoo())
        roots = []
        z.bal.append(1)
        z.inner.cps.append(s.Checkpoint(epoch=3))
        roots.append(bytes(z.hash_tree_root()))
        z.bal.pop()
        z.inner.cps.pop()
        roots.append(bytes(z.hash_tree_root()))
        z.bal.append(7)
        roots.append(bytes(z.hash_tree_root()))
        assert roots[-1] == oracle(s, z)
        return roots
    ref, got = _both(run)
    assert got == ref
    assert counters(PORT) == counters(REF)


def test_untracked_views_keep_legacy_path():
    def run(s):
        s.inc.enable()
        z = s.Zoo(x=3)
        return bytes(z.hash_tree_root())
    ref, got = _both(run)
    assert got == ref
    assert TMETRICS.count("merkle_sweep_dispatches") == 0
    assert not tinc.is_tracked(PORT.Zoo())


def test_copy_shares_cache_copy_on_write():
    def run(s):
        s.inc.enable()
        rng = Random("cow")
        z = s.inc.track(random_zoo(s, rng))
        base_root = bytes(z.hash_tree_root())
        c = z.copy()
        before = s.metrics.count("merkle_chunks_hashed")
        assert bytes(c.hash_tree_root()) == base_root   # cached, no rehash
        assert s.metrics.count("merkle_chunks_hashed") == before
        # mutate the COPY: the base cache stays intact (rollback)
        for _ in range(10):
            _mutate_once(s, rng, c)
        copy_root = bytes(c.hash_tree_root())
        assert copy_root == oracle(s, c)
        assert bytes(z.hash_tree_root()) == base_root == oracle(s, z)
        # mutate the BASE: the copy keeps its own root (commit)
        for _ in range(10):
            _mutate_once(s, rng, z)
        assert bytes(z.hash_tree_root()) == oracle(s, z)
        assert bytes(c.hash_tree_root()) == copy_root == oracle(s, c)
        return base_root, copy_root, bytes(z.hash_tree_root())
    ref, got = _both(run)
    assert got == ref
    assert counters(PORT) == counters(REF)


def test_one_dispatch_per_reroot_with_diff_sized_chunk_count():
    def run(s):
        s.inc.enable()
        z = s.Zoo()
        for i in range(512):
            z.bal.append(i)
        s.inc.track(z)
        z.hash_tree_root()
        built = s.metrics.count("merkle_chunks_hashed")
        height = s.inc.type_tree_height(s.Zoo)
        s.metrics.reset()
        z.bal[17] = s.ssz.uint64(12345)      # k = 1 dirty leaf
        one = (bytes(z.hash_tree_root()), counters(s))
        assert one[1]["merkle_sweep_dispatches"] == 1
        assert one[1]["merkle_sweep_levels"] <= height
        assert 0 < one[1]["merkle_chunks_hashed"] <= height
        assert one[1]["merkle_chunks_hashed"] < built // 4
        s.metrics.reset()
        for i in range(8):                   # k = 8 scattered leaves
            z.bal[i * 60] = s.ssz.uint64(i)
        eight = (bytes(z.hash_tree_root()), counters(s))
        assert eight[1]["merkle_sweep_dispatches"] == 1
        assert eight[1]["merkle_chunks_hashed"] <= 8 * height
        occupancy = s.metrics.hist_counts("merkle_dirty_occupancy")
        assert sum(occupancy.values()) == 1
        assert eight[0] == oracle(s, z)
        return built, height, one, eight
    ref, got = _both(run)
    assert got == ref


def test_bulk_set_basic():
    def run(s):
        s.inc.enable()
        z = s.Zoo()
        for i in range(700):
            z.bal.append(i)
        s.inc.track(z)
        z.hash_tree_root()
        s.metrics.reset()
        idx = list(range(0, 700, 3))
        assert s.inc.bulk_set_basic(z.bal, idx, [7 * i + 1 for i in idx]) \
            == len(idx)
        root = bytes(z.hash_tree_root())
        assert root == oracle(s, z) == s.inc.oracle_root(z)
        with pytest.raises(IndexError):
            s.inc.bulk_set_basic(z.bal, [700], [1])
        with pytest.raises(TypeError):
            s.inc.bulk_set_basic(z.vec, [0], [1])
        return root, counters(s)
    ref, got = _both(run)
    assert got == ref
    # every chunk of `bal`, and `bal`'s own chunk in the Zoo
    assert got[1]["merkle_dirty_nodes"] == (700 * 8 + 31) // 32 + 1


# ---------------------------------------------------------------------------
# the fused path and its device literal pool
# ---------------------------------------------------------------------------

def _small(s):
    v = s.Small(b=s.ssz.Bytes32(b"\x22" * 32), c=s.ssz.uint64(3))
    for i in range(200):
        v.a.append(s.ssz.uint64(i * 7))
    return v


def test_fused_sweep_sibling_pool_skips_clean_reuploads():
    """tests/test_pipeline_async.py's sibling-pool contract, with the
    port's device hashing at threshold 1 on the CPU: the second re-root
    uploads at most the dirty chunk and the length mix-in, every clean
    sibling hits the pool, and the counters equal the reference's."""
    def run(s, device_hashing):
        s.inc.enable()
        device_hashing()
        view = s.inc.track(_small(s))
        roots = [bytes(view.hash_tree_root())]            # cache build
        build_uploads = s.metrics.count("merkle_sibling_uploads")
        assert build_uploads > 0
        view.a[3] = s.ssz.uint64(424242)
        roots.append(bytes(view.hash_tree_root()))        # re-root
        second = s.metrics.count("merkle_sibling_uploads") - build_uploads
        assert s.metrics.count("merkle_sibling_uploads_skipped") > 0
        assert second <= 2
        skipped = s.metrics.count("merkle_sibling_uploads_skipped")
        view.a[3] = s.ssz.uint64(424243)
        roots.append(bytes(view.hash_tree_root()))
        assert s.metrics.count("merkle_sibling_uploads_skipped") > skipped
        sweeps = counters(s)
        assert roots[-1] == s.inc.oracle_root(view)
        return roots, sweeps

    plain_calls = sha256_cuda.hash_gather_pairs_cuda.plain_calls
    tmerkle.reset_stats()
    got = run(PORT, lambda: tmerkle.use_device_hashing(threshold=1))
    ref = run(REF, lambda: jmerkle.use_tpu_hashing(threshold=1))
    assert got == ref
    assert got[1]["merkle_device_round_trips"] == 3
    # every sweep went through the gather-hash wrapper, one call a round,
    # and its pairs count as device pairs
    assert sha256_cuda.hash_gather_pairs_cuda.plain_calls - plain_calls \
        == got[1]["merkle_sweep_levels"]
    assert tmerkle.stats["device_pairs"] >= got[1]["merkle_chunks_hashed"]


# ---------------------------------------------------------------------------
# the differential guard
# ---------------------------------------------------------------------------

def test_guard_passes_clean_sweeps():
    tinc.enable(guard_sample_rate=1.0, guard_seed=3)
    rng = Random("guard-clean")
    z = tinc.track(random_zoo(PORT, rng))
    z.hash_tree_root()
    for _ in range(5):
        _mutate_once(PORT, rng, z)
    assert bytes(z.hash_tree_root()) == oracle(PORT, z)
    assert TMETRICS.count("merkle_guard_samples") >= 2
    assert TMETRICS.count("merkle_guard_mismatches") == 0


def test_guard_raises_on_a_corrupt_sweep(monkeypatch):
    tinc.enable(guard_sample_rate=1.0, guard_seed=11)
    rng = Random("fault-corrupt")
    z = tinc.track(random_zoo(PORT, rng))
    z.hash_tree_root()
    for _ in range(5):
        _mutate_once(PORT, rng, z)
    run_rounds = tinc._run_rounds

    def corrupt(sw):
        outs = run_rounds(sw)
        last = outs[-1]
        last[-1] = bytes([last[-1][0] ^ 1]) + last[-1][1:]
        return outs

    monkeypatch.setattr(tinc, "_run_rounds", corrupt)
    with pytest.raises(RuntimeError, match="full-rebuild"):
        z.hash_tree_root()
    assert TMETRICS.count("merkle_guard_mismatches") == 1
    # the mismatch dropped every cache: the view is no longer tracked,
    # and the next root (legacy path) is right
    monkeypatch.undo()
    assert not tinc.is_tracked(z)
    assert bytes(z.hash_tree_root()) == oracle(PORT, z)
