"""The port's G1 aggregation sweep against the JAX package's.

`ops/g1_sweep.g1_add_sweep` sums ragged lists of G1 points: the committee
pubkey sums of a signature flush.  The same seeded points, crossing the
package line as affine integers, go through the port (the segment-sum
kernel's plain version on the CPU) and through the JAX package's
`g1_add_sweep` (its host engine on the CPU); the sums must be the same
points, byte for byte once compressed.  The lists are ragged and include
empty and single-point lists, infinity, a point and its double's halves
(the doubling branch of the complete add) and a point with its negation
(the identity branch).
"""
import numpy as np
import pytest

import consensus_specs_tpu_torch as port
from consensus_specs_tpu.crypto import curve as ref_cv
from consensus_specs_tpu.ops import g1_sweep as ref_sweep
from consensus_specs_tpu_torch.crypto import curve as cv
from consensus_specs_tpu_torch.ops import bls381_cuda, g1_sweep

SEED = 2026


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    port.set_device("cpu")
    monkeypatch.setattr(ref_sweep, "G1_SWEEP_MODE", "oracle")


def _lists(lengths, rng):
    """Affine (x, y) integers of G1 points (None for infinity): each list
    a run of seeded multiples of G (a seeded start, then a seeded step),
    with the infinity point, a repeated point and the negation of the
    list's first point where a list is long enough."""
    g = cv.g1_generator()
    out = []
    for n in lengths:
        start, step = (int(s) for s in rng.integers(1, 2**62, size=2))
        p, d = g * start, g * step
        pts = []
        for _ in range(n):
            pts.append(p)
            p = p + d
        if n >= 4:
            pts[1] = cv.g1_infinity()
            pts[3] = pts[2]
            pts[-1] = -pts[0]
        out.append([None if q.is_infinity()
                    else tuple(c.v for c in q.affine()) for q in pts])
    return out


def _points(module, xy_lists):
    """The lists as `module`'s (the port's or the reference's) oracle
    points."""
    def point(xy):
        if xy is None:
            return module.g1_infinity()
        f = module.Fq1
        return module.Point(f(xy[0]), f(xy[1]), f(1), module.B1)
    return [[point(xy) for xy in pts] for pts in xy_lists]


@pytest.mark.parametrize("lengths", [
    (0, 1, 3, 128, 5, 2),          # ragged, empty and single lists
    (4, 4, 4),                     # equal lengths, no padding of the axis
    (1,),                          # one point
    (0, 0),                        # only empty lists: two infinities
    (2048, 7),                     # an attester slashing's longest list
], ids=["ragged", "equal", "one point", "empty", "max committee"])
def test_g1_add_sweep_equals_the_reference(lengths):
    rng = np.random.default_rng([SEED, len(lengths), sum(lengths)])
    lists = _lists(lengths, rng)
    before = bls381_cuda.segment_sum.plain_calls
    got = g1_sweep.g1_add_sweep(_points(cv, lists))
    want = ref_sweep.g1_add_sweep(_points(ref_cv, lists))
    assert [cv.g1_to_bytes(p) for p in got] \
        == [ref_cv.g1_to_bytes(p) for p in want]
    assert bls381_cuda.segment_sum.plain_calls == before + 1


def test_g1_add_sweep_of_no_lists_is_empty():
    assert g1_sweep.g1_add_sweep([]) == ref_sweep.g1_add_sweep([]) == []
