"""Incremental device merkleization: dirty-subtree tracked hash_tree_root.

A mirror of consensus_specs_tpu/ssz/incremental.py, with the same names,
cache layout, planner, counters and hook contract; what differs is listed
under "In the port" at the end of this docstring.

The legacy merkleization (types.py `_htr_full` + merkle.merkleize_chunks)
recomputes every chunk of a view on every `hash_tree_root` call — O(state)
hashing per `process_slot` even though a block touches a tiny fraction of
the BeaconState.  This module gives composite SSZ views a cached chunk
tree with a dirty-gindex tracker so a re-root after k leaf mutations
hashes only the touched root-to-leaf paths — O(k · log state) chunks —
and batches ALL dirty nodes of the diff into ONE layer-parallel sweep:
levels are grouped bottom-up by dependency height.  A sweep of at least
the bulk threshold's pairs runs all its rounds on the port's device in one
call (ops/sha256.fused_rounds: one gather-hash kernel launch a round on the
card); a smaller one hashes its rounds with hashlib, as in the reference.
The reference's per-level device path (MERKLE_FUSED=0) is not mirrored.

Cache layout (per tracked composite view, stored at ``view._mcache``):

* ``levels[d]`` — the populated nodes of the view's data subtree at
  height d (``levels[0]`` = leaf chunks, ``levels[depth][0]`` = data
  root).  Zero-padding stays virtual: a missing right sibling at height
  d reads ``ZERO_HASHES[d]``, exactly like merkleize_chunks.
* ``dirty`` — set of leaf-chunk indices whose content changed since the
  last successful sweep.  Mutation hooks in types.py mark the touched
  chunk and propagate up through ``_mc_parent`` links (child position in
  the parent's chunk layer), so the state root's whole dirty cone is
  known without walking the object graph.
* ``root`` — the view's full root (after length/selector mix-ins);
  ``None`` while dirty.
* copy-on-write: ``copy()`` / ``coerce_assign`` share the level arrays
  between the copies (``shared`` flag); the first sweep that needs to
  write into a shared cache clones the arrays first, so transactional
  state copies (txn/ overlay discipline) can never corrupt each other's
  caches — a rolled-back copy just drops its private dirty set.

In the port: the resilience supervisor is not mirrored.  `_recompute`
plans the sweep, runs its hash rounds directly and commits them; there is
no full-rebuild fallback, so a failed build or launch on the card raises.
The differential guard re-checks sampled incremental roots against the
full-rebuild oracle; on a mismatch it drops every cache (epoch bump) and
raises RuntimeError instead of answering with the oracle's root, because a
mismatch means a wrong kernel or a wrong cache.

Observability (sigpipe metrics registry): ``merkle_sweep_dispatches``,
``merkle_sweep_levels``, ``merkle_chunks_hashed``, ``merkle_dirty_nodes``
(+ power-of-two ``merkle_dirty_occupancy`` histogram),
``merkle_cache_builds``, ``merkle_cached_roots``,
``merkle_guard_samples`` / ``merkle_guard_mismatches``; the fused path adds
``merkle_device_round_trips``, ``merkle_sibling_uploads`` and
``merkle_sibling_uploads_skipped``, and its pairs to
``ssz.merkle.stats["device_pairs"]``.
"""
from __future__ import annotations

import random
import threading

from ..sigpipe.metrics import METRICS as _METRICS
from . import merkle as _merkle
from . import types as _types
from .merkle import ZERO_CHUNK, ZERO_HASHES, chunk_depth
from .types import (
    Bitlist, Bits, Bitvector, Container, List, Union, Vector,
    _MUTABLE_VIEW_BASES, _Sequence, is_basic_type,
)

_ON = False
_EPOCH = 0          # bumped on enable/disable/guard mismatch: stale caches die
_GUARD_RATE = 0.0
_GUARD_RNG = random.Random(0)
_TL = threading.local()   # .oracle: full-rebuild recursion depth


def enabled() -> bool:
    return _ON


def enable(guard_sample_rate: float = 0.0, guard_seed: int = 0) -> None:
    """Turn incremental merkleization on.  Only *tracked* views (see
    `track`) get caches; everything else keeps the legacy path.  A fresh
    cache epoch starts, so caches from a previous enable (whose
    mutations may have gone unhooked while disabled) are discarded.

    `guard_sample_rate` is the differential-guard probability per sweep
    of re-checking the incremental root against the full-rebuild oracle
    (production would run low single-digit percent).  A mismatch raises
    RuntimeError."""
    global _ON, _EPOCH, _GUARD_RATE, _GUARD_RNG
    if not 0.0 <= guard_sample_rate <= 1.0:
        raise ValueError(f"guard_sample_rate {guard_sample_rate} not in [0, 1]")
    _EPOCH += 1
    _GUARD_RATE = guard_sample_rate
    _GUARD_RNG = random.Random(guard_seed)
    _ON = True
    _types._inc_root_hook = _root_hook
    _types._inc_mut = _Hooks


def disable() -> None:
    global _ON, _EPOCH
    _ON = False
    _EPOCH += 1
    _types._inc_root_hook = None
    _types._inc_mut = None


def track(view):
    """Mark `view` (a mutable composite, typically a BeaconState) for
    incremental merkleization: its first hash_tree_root builds the chunk
    tree, later ones sweep only the dirty cone.  No-op when the mode is
    disabled or the view is already tracked.  Returns the view."""
    if _ON and isinstance(view, _MUTABLE_VIEW_BASES):
        c = view.__dict__.get("_mcache")
        if c is None or c.epoch != _EPOCH:
            view.__dict__["_mcache"] = _MCache()
    return view


def is_tracked(view) -> bool:
    c = view.__dict__.get("_mcache") if isinstance(
        view, _MUTABLE_VIEW_BASES) else None
    return c is not None and c.epoch == _EPOCH


def oracle_root(view) -> bytes:
    """Full-rebuild root: recompute every chunk, bypassing every cache
    (the differential-guard oracle)."""
    _TL.oracle = getattr(_TL, "oracle", 0) + 1
    try:
        return bytes(view.hash_tree_root())
    finally:
        _TL.oracle -= 1


def bulk_set_basic(view, indices, values) -> int:
    """Batched element assignment on a basic-element sequence view: ONE
    Python-level writeback call replaces len(indices) `__setitem__`
    round trips (the fused epoch engine's balances / inactivity-scores
    columns — a mainnet everyone's-balance-changed epoch is one call,
    not 1M).  Semantically identical to the per-element path: values are
    coerced through `ELEM_TYPE.coerce_assign`, and when the view is
    tracked every touched leaf chunk is marked dirty (the whole cone in
    one pass), so the next re-root stays the O(dirty) fused sweep.

    `indices` / `values` are parallel sequences (numpy arrays welcome);
    indices must be in-range and non-negative.  Returns the element
    count written."""
    t = view.ELEM_TYPE
    if not isinstance(view, _Sequence) or not is_basic_type(t):
        raise TypeError(
            f"bulk_set_basic needs a basic-element sequence view, "
            f"got {type(view).__name__}")
    idx = [int(i) for i in
           (indices.tolist() if hasattr(indices, "tolist") else indices)]
    vals = (values.tolist() if hasattr(values, "tolist")
            else list(values))
    if len(idx) != len(vals):
        raise ValueError(
            f"{len(idx)} indices vs {len(vals)} values")
    if not idx:
        return 0
    elems = view._elems
    n = len(elems)
    if min(idx) < 0 or max(idx) >= n:
        raise IndexError(f"bulk index outside [0, {n})")
    coerce = t.coerce_assign
    for i, v in zip(idx, vals):
        elems[i] = coerce(v)
    if _types._inc_mut is not None and _cache_of(view) is not None:
        esz = t.type_byte_length()
        for ci in {(i * esz) // 32 for i in idx}:
            _mark(view, ci)
    return len(idx)


def type_tree_height(typ) -> int:
    """Static height of the padded merkle tree of `typ` =
    ceil(log2(total padded chunk capacity)): the upper bound on sweep
    level-calls for any diff of a view of this type."""
    if is_basic_type(typ):
        return 0
    if issubclass(typ, (_types.ByteVector,)):
        return chunk_depth((typ.LENGTH + 31) // 32)
    if issubclass(typ, (_types.ByteList,)):
        return chunk_depth((typ.LIMIT + 31) // 32) + 1
    if issubclass(typ, Bitvector):
        return chunk_depth((typ.LENGTH + 255) // 256)
    if issubclass(typ, Bitlist):
        return chunk_depth((typ.LIMIT + 255) // 256) + 1
    if issubclass(typ, Vector):
        if is_basic_type(typ.ELEM_TYPE):
            return chunk_depth(
                (typ.LENGTH * typ.ELEM_TYPE.type_byte_length() + 31) // 32)
        return chunk_depth(typ.LENGTH) + type_tree_height(typ.ELEM_TYPE)
    if issubclass(typ, List):
        if is_basic_type(typ.ELEM_TYPE):
            return chunk_depth(
                (typ.LIMIT * typ.ELEM_TYPE.type_byte_length() + 31) // 32) + 1
        return chunk_depth(typ.LIMIT) + 1 + type_tree_height(typ.ELEM_TYPE)
    if issubclass(typ, Container):
        kids = max((type_tree_height(t) for t in typ._field_types), default=0)
        return chunk_depth(max(1, len(typ._field_names))) + kids
    if issubclass(typ, Union):
        kids = max((type_tree_height(t) for t in typ.OPTIONS
                    if t is not None), default=0)
        return 1 + kids
    raise TypeError(f"no tree height for {typ}")


# ---------------------------------------------------------------------------
# cache object
# ---------------------------------------------------------------------------

class _MCache:
    __slots__ = ("levels", "root", "dirty", "built", "shared",
                 "leaf_count", "epoch")

    def __init__(self):
        self.levels = None      # list[list[bytes|None]] once built
        self.root = None        # full root incl. mix-ins, None while dirty
        self.dirty = set()      # dirty leaf-chunk indices
        self.built = False
        self.shared = False     # levels arrays shared with a copy (CoW)
        self.leaf_count = 0     # chunk count at last successful sweep
        self.epoch = _EPOCH

    def cow_copy(self) -> "_MCache":
        n = _MCache.__new__(_MCache)
        n.levels = self.levels
        n.root = self.root
        n.dirty = set(self.dirty)
        n.built = self.built
        n.leaf_count = self.leaf_count
        n.epoch = self.epoch
        n.shared = True
        if self.levels is not None:
            self.shared = True
        return n

    def unshare(self) -> None:
        if self.shared:
            if self.levels is not None:
                self.levels = [list(lv) for lv in self.levels]
            self.shared = False


def _cache_of(view) -> _MCache | None:
    c = view.__dict__.get("_mcache")
    if c is not None and c.epoch == _EPOCH:
        return c
    return None


# ---------------------------------------------------------------------------
# mutation hooks (installed into types.py while enabled)
# ---------------------------------------------------------------------------

def _mark(view, chunk_idx: int) -> None:
    """Mark leaf `chunk_idx` of `view` dirty and propagate up the parent
    links.  Early exit when the chunk is already dirty AND the root is
    already invalidated: by induction every ancestor is then dirty too."""
    while True:
        cache = view.__dict__.get("_mcache")
        if cache is None or cache.epoch != _EPOCH:
            return
        if cache.root is None and chunk_idx in cache.dirty:
            return
        cache.dirty.add(chunk_idx)
        cache.root = None
        parent = view.__dict__.get("_mc_parent")
        if parent is None:
            return
        view, chunk_idx = parent


def _invalidate_root(view) -> None:
    """Invalidate `view`'s root (no specific leaf chunk — e.g. a pop to
    empty, where only the length mix-in changes) and propagate."""
    cache = _cache_of(view)
    if cache is None:
        return
    cache.root = None
    parent = view.__dict__.get("_mc_parent")
    if parent is not None:
        _mark(parent[0], parent[1])


def _attach(parent, idx: int, child) -> None:
    if isinstance(child, _MUTABLE_VIEW_BASES):
        child.__dict__["_mc_parent"] = (parent, idx)


def _detach(parent, child) -> None:
    if isinstance(child, _MUTABLE_VIEW_BASES):
        link = child.__dict__.get("_mc_parent")
        if link is not None and link[0] is parent:
            child.__dict__["_mc_parent"] = None


class _Hooks:
    """Mutation hooks types.py calls while incremental mode is on.  Every
    hook is a no-op for untracked views (one dict lookup)."""

    @staticmethod
    def on_container_set(view, idx, old, new):
        if _cache_of(view) is None:
            return
        if old is not new:
            _detach(view, old)
        _attach(view, idx, new)
        _mark(view, idx)

    @staticmethod
    def on_seq_set(view, i, old, new):
        if _cache_of(view) is None:
            return
        n = len(view._elems)
        if i < 0:
            i += n
        t = view.ELEM_TYPE
        if is_basic_type(t):
            ci = (i * t.type_byte_length()) // 32
        else:
            ci = i
            if old is not new:
                _detach(view, old)
            _attach(view, i, new)
        _mark(view, ci)

    @staticmethod
    def on_seq_append(view):
        if _cache_of(view) is None:
            return
        n = len(view._elems)
        t = view.ELEM_TYPE
        if is_basic_type(t):
            ci = ((n - 1) * t.type_byte_length()) // 32
        else:
            ci = n - 1
            _attach(view, n - 1, view._elems[n - 1])
        _mark(view, ci)

    @staticmethod
    def on_seq_pop(view, popped, i, old_len):
        cache = _cache_of(view)
        if cache is None:
            return
        _detach(view, popped)
        new_len = old_len - 1
        t = view.ELEM_TYPE
        if is_basic_type(t):
            esz = t.type_byte_length()
            n_chunks = (new_len * esz + 31) // 32
            first = (i * esz) // 32
        else:
            n_chunks = new_len
            first = i
            # a middle pop shifts every later element down one slot:
            # their parent links carry positions, so re-index them
            for j in range(i, new_len):
                _attach(view, j, view._elems[j])
        if n_chunks == 0:
            _invalidate_root(view)
            return
        for ci in range(min(first, n_chunks - 1), n_chunks):
            _mark(view, ci)

    @staticmethod
    def on_bits_set(view, i):
        if _cache_of(view) is None:
            return
        if i < 0:
            i += len(view._bits)
        _mark(view, i // 256)

    @staticmethod
    def on_bits_append(view):
        if _cache_of(view) is None:
            return
        _mark(view, (len(view._bits) - 1) // 256)

    @staticmethod
    def on_union_set(view, old_value):
        if _cache_of(view) is None:
            return
        value = view.__dict__.get("value")
        if old_value is not value:
            _detach(view, old_value)
        if value is not None:
            _attach(view, 0, value)
        _mark(view, 0)

    @staticmethod
    def on_copy(src, dst):
        """Called by _structural_copy after `dst`'s object graph is
        built: share the cache copy-on-write and point dst's composite
        children at dst (their copies carry their own shared caches
        from their own on_copy calls)."""
        cache = _cache_of(src)
        if cache is None:
            return
        dst.__dict__["_mcache"] = cache.cow_copy()
        if isinstance(dst, Container):
            for j, name in enumerate(type(dst)._field_names):
                _attach(dst, j, dst._values[name])
        elif isinstance(dst, _Sequence):
            if not is_basic_type(dst.ELEM_TYPE):
                for j, child in enumerate(dst._elems):
                    _attach(dst, j, child)
        elif isinstance(dst, Union):
            if dst.value is not None:
                _attach(dst, 0, dst.value)


# ---------------------------------------------------------------------------
# shape helpers
# ---------------------------------------------------------------------------

def _view_shape(view):
    """(n_chunks, depth, mix) for the view's data subtree; mix is None,
    ("len", n) or ("sel", s)."""
    if isinstance(view, Container):
        n = len(type(view)._field_names)
        return n, chunk_depth(n), None
    if isinstance(view, Bitlist):
        bits = len(view._bits)
        return ((bits + 255) // 256,
                chunk_depth((view.LIMIT + 255) // 256), ("len", bits))
    if isinstance(view, Bitvector):
        n = (view.LENGTH + 255) // 256
        return n, chunk_depth(n), None
    if isinstance(view, Union):
        return 1, 0, ("sel", view.selector)
    t = view.ELEM_TYPE
    count = len(view._elems)
    if isinstance(view, Vector):
        if is_basic_type(t):
            n = (count * t.type_byte_length() + 31) // 32
            return n, chunk_depth(n), None
        return count, chunk_depth(view.LENGTH), None
    # List
    if is_basic_type(t):
        n = (count * t.type_byte_length() + 31) // 32
        cap = (view.LIMIT * t.type_byte_length() + 31) // 32
        return n, chunk_depth(cap), ("len", count)
    return count, chunk_depth(view.LIMIT), ("len", count)


def _packed_chunk(view, ci: int) -> bytes:
    if isinstance(view, Bits):
        bits = view._bits[ci * 256:(ci + 1) * 256]
        out = bytearray(32)
        for j, b in enumerate(bits):
            if b:
                out[j // 8] |= 1 << (j % 8)
        return bytes(out)
    t = view.ELEM_TYPE
    per = 32 // t.type_byte_length()
    data = b"".join(e.serialize()
                    for e in view._elems[ci * per:(ci + 1) * per])
    return data.ljust(32, b"\x00")


def _lvl_len(n: int, d: int) -> int:
    return (n + (1 << d) - 1) >> d


# ---------------------------------------------------------------------------
# sweep planner + executor
# ---------------------------------------------------------------------------

class _Sweep:
    """Global hash-job DAG, grouped bottom-up by dependency height.

    A job is one 2-to-1 hash; its inputs are literal 32-byte chunks or
    outputs of lower rounds.  Round r collects every job whose inputs
    are all available after round r-1, so the executor issues exactly
    one (ragged) batched level-call per round — across ALL dirty
    subtrees of the view graph at once.  A job ref is (round, index);
    a literal ref is the bytes themselves (round 0)."""

    __slots__ = ("rounds", "writebacks", "finals", "dirty_leaves")

    def __init__(self):
        self.rounds = []       # rounds[r] = [(left_ref, right_ref), ...]
        self.writebacks = []   # (cache, level, idx, ref)
        self.finals = []       # (cache, leaf_count, root_ref)
        self.dirty_leaves = 0

    def job(self, left, right):
        r = 0
        if type(left) is tuple:
            r = left[0]
        if type(right) is tuple and right[0] > r:
            r = right[0]
        while len(self.rounds) <= r:
            self.rounds.append([])
        self.rounds[r].append((left, right))
        return (r + 1, len(self.rounds[r]) - 1)

    def resolve(self, outs, ref):
        if type(ref) is tuple:
            return outs[ref[0] - 1][ref[1]]
        return ref


def _plan_view(sw: _Sweep, view):
    """Plan the re-root of `view`: append this view's hash jobs to the
    sweep and return a ref for its full root (a literal when the cached
    root is still valid).  Builds missing caches (all leaves dirty) and
    installs parent links on composite children as it descends."""
    cache = view.__dict__.get("_mcache")
    if cache is None or cache.epoch != _EPOCH:
        cache = _MCache()
        view.__dict__["_mcache"] = cache
    if cache.built and not cache.dirty and cache.root is not None:
        return cache.root

    n, depth, mix = _view_shape(view)
    cache.unshare()
    if not cache.built or cache.levels is None:
        cache.levels = [[None] * _lvl_len(n, d) for d in range(depth + 1)]
        dirty = set(range(n))
    else:
        levels = cache.levels
        for d in range(depth + 1):
            want = _lvl_len(n, d)
            have = len(levels[d])
            if want < have:
                del levels[d][want:]
            elif want > have:
                levels[d].extend([None] * (want - have))
        dirty = {i for i in cache.dirty if i < n}
        if cache.leaf_count != n and n > 0:
            # the last node at every level is the only one whose
            # (virtual-zero) sibling set can change with the count
            dirty.add(n - 1)
    sw.dirty_leaves += len(dirty)

    cur = {}
    for i in dirty:
        ref = _leaf_ref(sw, view, i)
        sw.writebacks.append((cache, 0, i, ref))
        cur[i] = ref
    for d in range(depth):
        if not cur:
            break
        cur_level = cache.levels[d]
        cur_len = len(cur_level)
        nxt = {}
        for p in sorted({i >> 1 for i in cur}):
            li, ri = 2 * p, 2 * p + 1
            left = cur[li] if li in cur else cur_level[li]
            if ri in cur:
                right = cur[ri]
            elif ri < cur_len:
                right = cur_level[ri]
            else:
                right = ZERO_HASHES[d]
            ref = sw.job(left, right)
            sw.writebacks.append((cache, d + 1, p, ref))
            nxt[p] = ref
        cur = nxt

    if n == 0:
        data_ref = ZERO_HASHES[depth]
    elif 0 in cur:
        data_ref = cur[0]
    else:
        data_ref = cache.levels[depth][0]

    if mix is None:
        root_ref = data_ref
    else:  # ("len", n) and ("sel", s) mix in the same way
        root_ref = sw.job(data_ref, int(mix[1]).to_bytes(32, "little"))
    sw.finals.append((cache, n, root_ref))
    return root_ref


def _leaf_ref(sw: _Sweep, view, i: int):
    """Ref for the content of leaf chunk `i` of `view`: a host-packed
    literal for basic/bit chunks, the (possibly planned) child root for
    composite positions, a host-computed root for immutable children."""
    if isinstance(view, Container):
        child = view._values[type(view)._field_names[i]]
    elif isinstance(view, Union):
        child = view.value
        if child is None:
            return ZERO_CHUNK
    elif isinstance(view, Bits):
        return _packed_chunk(view, i)
    else:  # Vector / List
        if is_basic_type(view.ELEM_TYPE):
            return _packed_chunk(view, i)
        child = view._elems[i]
    if isinstance(child, _MUTABLE_VIEW_BASES):
        _attach(view, i, child)
        return _plan_view(sw, child)
    return bytes(child.hash_tree_root())


def _hash_rounds(sw: _Sweep) -> list:
    """Run the sweep's hash rounds level-by-level with hashlib
    (`merkle._hash_level`, the reference's `_hash_level_python`) and
    return the per-round outputs.  Pure: every input is a literal chunk
    copied in by the planner or a lower round's output; nothing touches
    a cache."""
    outs = []
    for jobs in sw.rounds:
        buf = bytearray()
        for left, right in jobs:
            buf += left if type(left) is bytes else outs[left[0] - 1][left[1]]
            buf += right if type(right) is bytes else outs[right[0] - 1][right[1]]
        hashed = _merkle._hash_level(bytes(buf))
        outs.append([hashed[k * 32:(k + 1) * 32] for k in range(len(jobs))])
    return outs


def _hash_rounds_fused(sw: _Sweep) -> list:
    """Run ALL the sweep's rounds in ONE device call
    (ops/sha256.fused_rounds, a gather-hash kernel launch a round on the
    card): literal inputs are deduped and uploaded once, every round's
    dirty-index gather and batched hash stays in device memory, and the
    per-round outputs come back in a single download — one host<->device
    round-trip per re-root instead of one per tree level.  Between
    consecutive sweeps the device literal pool keeps the clean-sibling
    level buffers (and the previous sweep's outputs) resident, so a
    re-root uploads only the DIRTY literals — pool hits land in
    `merkle_sibling_uploads_skipped`, the sibling counter next to
    `merkle_device_round_trips`.  Pure, like `_hash_rounds`: inputs are
    copied into the job plan, nothing touches a cache (the pool is
    content-addressed device residency, never consulted for roots)."""
    from ..ops import sha256 as _sha
    lits: list = []
    lit_pos: dict = {}
    for jobs in sw.rounds:
        for ref in (r for job in jobs for r in job):
            if type(ref) is bytes and ref not in lit_pos:
                lit_pos[ref] = len(lits)
                lits.append(ref)
    n_lits = len(lits)
    cum = [0]
    for jobs in sw.rounds:
        cum.append(cum[-1] + len(jobs))

    def idx(ref):
        if type(ref) is bytes:
            return lit_pos[ref]
        return n_lits + cum[ref[0] - 1] + ref[1]

    rounds = [([idx(left) for left, _r in jobs],
               [idx(right) for _l, right in jobs]) for jobs in sw.rounds]
    stats: dict = {}
    out_bytes = _sha.fused_rounds(b"".join(lits), rounds, stats=stats)
    _merkle.stats["device_pairs"] += cum[-1]
    _METRICS.inc("merkle_device_round_trips")
    if stats.get("skipped"):
        _METRICS.inc("merkle_sibling_uploads_skipped", stats["skipped"])
    _METRICS.inc("merkle_sibling_uploads", stats.get("uploaded", 0))
    return [[ob[k * 32:(k + 1) * 32] for k in range(len(jobs))]
            for ob, jobs in zip(out_bytes, sw.rounds)]


def _run_rounds(sw: _Sweep) -> list:
    """Pick the sweep execution engine: the fused device-resident
    program when bulk device hashing is installed and the sweep is big
    enough to be worth a dispatch, else hashlib.  Every round of a sweep
    below the bulk threshold is below it too, so the reference's
    per-level device path (its MERKLE_FUSED=0 escape hatch) never runs
    here and is not mirrored."""
    total = sum(len(jobs) for jobs in sw.rounds)
    if (_merkle._bulk_hash_level is not None
            and total >= _merkle._bulk_threshold):
        return _hash_rounds_fused(sw)
    return _hash_rounds(sw)


def _commit(sw: _Sweep, outs: list) -> None:
    """Write the sweep's results into the caches and clear the dirty
    cones, on the caller's thread, after every round came back."""
    for cache, level, idx, ref in sw.writebacks:
        cache.levels[level][idx] = sw.resolve(outs, ref)
    for cache, leaf_count, root_ref_i in sw.finals:
        cache.root = sw.resolve(outs, root_ref_i)
        cache.leaf_count = leaf_count
        cache.built = True
        cache.dirty.clear()


# ---------------------------------------------------------------------------
# the hash_tree_root hook
# ---------------------------------------------------------------------------

def _root_hook(view):
    """types.py calls this from every composite hash_tree_root while the
    mode is on.  Returns None to fall through to the legacy path
    (untracked view, or full-rebuild oracle mode)."""
    if getattr(_TL, "oracle", 0):
        return None
    cache = _cache_of(view)
    if cache is None:
        return None
    if cache.built and not cache.dirty and cache.root is not None:
        _METRICS.inc("merkle_cached_roots")
        return cache.root
    return _recompute(view, cache)


def _recompute(view, cache: _MCache) -> bytes:
    global _EPOCH
    if not cache.built:
        # first root of a tracked view: the sweep IS the cache build
        # (every leaf dirty) — not a degradation, counted separately
        _METRICS.inc("merkle_cache_builds")

    sw = _Sweep()
    root_ref = _plan_view(sw, view)
    _METRICS.inc("merkle_sweep_dispatches")
    outs = _run_rounds(sw)
    root = sw.resolve(outs, root_ref)
    _METRICS.inc("merkle_chunks_hashed",
                 sum(len(jobs) for jobs in sw.rounds))
    _METRICS.inc("merkle_sweep_levels", len(sw.rounds))
    _METRICS.inc("merkle_dirty_nodes", sw.dirty_leaves)
    _METRICS.observe_hist("merkle_dirty_occupancy", sw.dirty_leaves)
    _commit(sw, outs)

    if _GUARD_RATE > 0.0 and _GUARD_RNG.random() < _GUARD_RATE:
        _METRICS.inc("merkle_guard_samples")
        expect = oracle_root(view)
        if bytes(root) != expect:
            # the caches hold the wrong digests: drop them all, and fail
            # loudly rather than answer with the oracle's root
            _METRICS.inc("merkle_guard_mismatches")
            _EPOCH += 1
            raise RuntimeError(
                f"incremental root {bytes(root).hex()} != full-rebuild "
                f"root {expect.hex()}")
    return root
