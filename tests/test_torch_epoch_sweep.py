"""The port's epoch sweep against the JAX package's, lane for lane.

The reference's `SweepInputs` are captured from real minimal-preset states
(the `_edge_state` and `_leak_state` shapes of tests/test_epoch_sweep.py)
for phase0, altair and electra, by wrapping the reference's
`ops.epoch_sweep.run_sweep` while its `process_epoch` runs.  Carried into
the port with `convert.sweep_inputs_from_numpy`, they must give the port's
`run_sweep` (on the CPU: the plain torch version behind the kernel's
wrapper) lanes equal to the reference's XLA program on the CPU and to its
`numpy_sweep`.  Seeded synthetic inputs of 4,096 lanes cover FAR epochs,
proposer collisions, rewards off and both slashing forms.  The kernel's
lane math (`ops/csrc/epoch_sweep.cuh`) compiles as host C++: built with
g++ and run over the same synthetic lanes through the wrapper's parameter
array, it must equal `plain_sweep`, and its division by reciprocals must
equal Python's `//` on seeded and edge int64 pairs.  Every tolerance is
exact: the lanes are integers and bools.
"""
import ctypes
import functools
import os
import random
import re
import shutil
import subprocess
from math import isqrt

import numpy as np
import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu import resilience
from consensus_specs_tpu.ops import epoch_sweep as jsweep
from consensus_specs_tpu.specs import epoch_fast as jfast
from consensus_specs_tpu.specs import get_spec as reference_spec
from consensus_specs_tpu.ssz import uint64 as juint64
from consensus_specs_tpu.test_infra import disable_bls
from consensus_specs_tpu.test_infra.attestations import (
    next_epoch_with_attestations)
from consensus_specs_tpu.test_infra.blocks import next_epoch
from consensus_specs_tpu.test_infra.genesis import (
    build_mock_validator, create_genesis_state, default_balances)
from consensus_specs_tpu_torch.convert import sweep_inputs_from_numpy
from consensus_specs_tpu_torch.ops import cuda_build, epoch_sweep
from consensus_specs_tpu_torch.ops import epoch_sweep_cuda

FORKS = ("phase0", "altair", "electra")
FAR = (1 << 64) - 1
N_SYNTHETIC = 4096


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    resilience.disable()
    yield


def _edge_state(spec):
    """tests/test_epoch_sweep.py `_edge_state`: live attestations or
    participation, a slashed validator inside the correlated-penalty
    window, an ejectable validator, an exited validator, and a fresh one
    headed for the activation queue."""
    state = create_genesis_state(spec, default_balances(spec))
    next_epoch(spec, state)
    _, state = next_epoch_with_attestations(spec, state, True, False)
    _, state = next_epoch_with_attestations(spec, state, True, True)
    epoch = int(spec.get_current_epoch(state))
    v = state.validators[3]
    v.slashed = True
    v.withdrawable_epoch = juint64(
        epoch + int(spec.EPOCHS_PER_SLASHINGS_VECTOR) // 2)
    state.slashings[epoch % int(spec.EPOCHS_PER_SLASHINGS_VECTOR)] = \
        juint64(10**9)
    state.validators[5].effective_balance = juint64(
        spec.config.EJECTION_BALANCE)
    state.validators[7].exit_epoch = juint64(max(epoch, 1))
    state.validators[7].withdrawable_epoch = juint64(epoch + 2)
    fresh = build_mock_validator(
        spec, len(state.validators), spec.MAX_EFFECTIVE_BALANCE)
    state.validators.append(fresh)
    state.balances.append(spec.MAX_EFFECTIVE_BALANCE)
    if spec.is_post("altair"):
        state.previous_epoch_participation.append(0)
        state.current_epoch_participation.append(0)
        state.inactivity_scores.append(0)
    return state


def _leak_state(spec):
    """tests/test_epoch_sweep.py `_leak_state`: a finality delay past
    MIN_EPOCHS_TO_INACTIVITY_PENALTY, so the leak formulas are live."""
    state = create_genesis_state(spec, default_balances(spec))
    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 3):
        next_epoch(spec, state)
    _, state = next_epoch_with_attestations(spec, state, True, False)
    assert spec.is_in_inactivity_leak(state)
    return state


@functools.lru_cache(maxsize=None)
def reference_state_bytes(fork: str, leaking: bool) -> bytes:
    """The SSZ bytes of a minimal-preset edge or leak state, built once a
    process by the JAX package (the slow part of these tests)."""
    spec = reference_spec(fork, "minimal")
    with disable_bls():
        state = _leak_state(spec) if leaking else _edge_state(spec)
    return state.encode_bytes()


@functools.lru_cache(maxsize=None)
def _captured(fork: str, leaking: bool):
    """(SweepInputs, XLA lanes) of the reference's process_epoch on the
    state, captured around the reference's run_sweep."""
    spec = reference_spec(fork, "minimal")
    state = spec.BeaconState.decode_bytes(reference_state_bytes(fork, leaking))
    seen = []
    real = jsweep.run_sweep

    def recording(inp):
        out = real(inp)
        seen.append((inp, out))
        return out
    jsweep.run_sweep = recording
    try:
        with disable_bls():
            spec.process_epoch(state)
    finally:
        jsweep.run_sweep = real
    assert len(seen) == 1
    return seen[0]


def _port_inputs(inp):
    return sweep_inputs_from_numpy(inp.family, inp.n, inp.cols, inp.scalars,
                                   inp.statics)


def _assert_lanes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("fork", FORKS)
@pytest.mark.parametrize("leaking", [False, True],
                         ids=["finalizing", "leaking"])
def test_run_sweep_matches_jax_on_real_states(fork, leaking):
    inp, xla_lanes = _captured(fork, leaking)
    assert dict(inp.statics)["leak"] == leaking
    plain_before = epoch_sweep_cuda.epoch_sweep_cuda.plain_calls
    got = epoch_sweep.run_sweep(_port_inputs(inp))
    assert epoch_sweep_cuda.epoch_sweep_cuda.plain_calls == plain_before + 1
    _assert_lanes_equal(got, xla_lanes)
    _assert_lanes_equal(got, jfast.numpy_sweep(inp))


def _synthetic(family: str, *, leak=False, do_rewards=True, electra=False,
               seed=0):
    """A reference SweepInputs of N_SYNTHETIC seeded lanes: FAR epochs in
    every epoch column, slashed validators in and out of the slashings
    window, balances around the hysteresis thresholds, and source
    attesters whose best inclusion keys name 32 proposers."""
    rng = np.random.default_rng(seed)
    n = N_SYNTHETIC
    incr = 10**9
    cur, prev, finalized = 10, 9, 7
    slash_epoch = cur + 4096

    def epochs(far_share, lo, hi):
        e = rng.integers(lo, hi, n).astype(np.uint64)
        e[rng.random(n) < far_share] = np.uint64(FAR)
        return e

    max_eff = np.full(n, 32 * incr, np.int64)
    if electra:
        max_eff[rng.random(n) < 0.3] = 2048 * incr
    eff = (rng.integers(0, 33, n) * incr).astype(np.int64)
    eff[rng.random(n) < 0.05] = 16 * incr        # at the ejection balance
    if electra:
        big = max_eff > 32 * incr
        eff[big] = rng.integers(32, 2049, int(big.sum())) * incr
    slashed = rng.random(n) < 0.08
    withdrawable = epochs(0.5, 0, 20)
    withdrawable[slashed & (rng.random(n) < 0.5)] = np.uint64(slash_epoch)
    balances = np.maximum(
        eff + rng.integers(-2 * incr, 2 * incr, n), 0).astype(np.int64)
    balances[rng.random(n) < 0.02] = 0
    cols = {
        "eff": eff, "slashed": slashed,
        "activation": epochs(0.1, 0, 12),
        "exit_epoch": epochs(0.7, 0, 14),
        "act_elig": epochs(0.2, 0, 12),
        "withdrawable": withdrawable,
        "balances": balances, "max_eff": max_eff,
    }
    tb = max(incr, int(eff.sum()))
    scalars = {"cur": np.uint64(cur), "prev": np.uint64(prev),
               "finalized": np.uint64(finalized),
               "slash_epoch": np.uint64(slash_epoch),
               "tb": np.int64(tb), "adj": np.int64(min(3 * 10**15, tb))}
    statics = {"do_rewards": do_rewards, "leak": leak, "incr": incr,
               "max_eb": 32 * incr, "ejection": 16 * incr, "hyst_q": 4,
               "hyst_down": 1, "hyst_up": 5}
    if family == "phase0":
        src = rng.random(n) < 0.8
        tgt = src & (rng.random(n) < 0.9)
        head = tgt & (rng.random(n) < 0.9)
        order = rng.integers(0, 1 << 20, n)
        best_key = np.where(
            src, (rng.integers(1, 33, n) << 24) | order,
            np.iinfo(np.int64).max).astype(np.int64)
        proposers = rng.choice(n, 32, replace=False)
        best_prop = np.where(src, rng.choice(proposers, n), 0)
        cols.update(src=src, tgt=tgt, head=head, best_key=best_key,
                    best_prop=best_prop.astype(np.int64))
        scalars.update(sqrt_tb=np.int64(isqrt(tb)),
                       finality_delay=np.int64(prev - finalized))
        statics.update(brf=64, brpe=4, prop_q=8, inact_q=1 << 26)
    else:
        scores = rng.integers(0, 50, n).astype(np.int64)
        scores[rng.random(n) < 0.05] = 10**6
        cols.update(part_prev=rng.integers(0, 8, n).astype(np.int64),
                    scores=scores)
        scalars.update(base_per_incr=np.int64(incr * 64 // isqrt(tb)),
                       bias=np.int64(4), recovery=np.int64(16),
                       inact_denom=np.int64(4 * 50331648))
        statics.update(electra=electra, wd=64, target_flag=1,
                       flags=((0, 14, False), (1, 26, False), (2, 14, True)))
    return jfast.SweepInputs(family, n, cols, scalars,
                             tuple(sorted(statics.items())))


SYNTHETIC = {
    "phase0": dict(family="phase0"),
    "phase0-leak": dict(family="phase0", leak=True, seed=1),
    "phase0-no-rewards": dict(family="phase0", do_rewards=False, seed=2),
    "altair": dict(family="altair", seed=3),
    "altair-leak": dict(family="altair", leak=True, seed=4),
    "altair-no-rewards": dict(family="altair", do_rewards=False, seed=5),
    "electra": dict(family="altair", electra=True, seed=6),
    "electra-leak": dict(family="altair", electra=True, leak=True, seed=7),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_run_sweep_matches_numpy_sweep_on_synthetic_lanes(case):
    inp = _synthetic(**SYNTHETIC[case])
    c = inp.cols
    assert (c["activation"] == np.uint64(FAR)).any()
    assert (c["exit_epoch"] == np.uint64(FAR)).any()
    assert (c["slashed"]
            & (c["withdrawable"] == inp.scalars["slash_epoch"])).any()
    if inp.family == "phase0":
        src_props = c["best_prop"][c["src"]]
        assert len(np.unique(src_props)) <= 32 < len(src_props)
    want = jfast.numpy_sweep(inp)
    got = epoch_sweep.run_sweep(_port_inputs(inp))
    _assert_lanes_equal(got, want)
    # the sweep moves something in every case
    assert not np.array_equal(got[0], c["balances"]) or case.endswith(
        "no-rewards")


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    inp = _port_inputs(_synthetic("phase0"))
    cols = epoch_sweep.host_columns(inp)
    wrapper = epoch_sweep_cuda.epoch_sweep_cuda
    launches, plain = wrapper.launches, wrapper.plain_calls
    lanes = wrapper(cols, inp.scalars, inp.statics)
    assert wrapper.plain_calls == plain + 1
    assert wrapper.launches == launches
    want = epoch_sweep.plain_sweep(cols, inp.scalars, inp.statics)
    for g, w in zip(lanes, want):
        assert torch.equal(g, w)
    # another device is refused, and nothing runs on the host for it
    meta = {k: v.to("meta") for k, v in cols.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(meta, inp.scalars, inp.statics)
    # a lane of the wrong dtype is refused before anything runs
    bad = dict(cols, eff=cols["eff"].to(torch.int32))
    with pytest.raises(TypeError):
        wrapper(bad, inp.scalars, inp.statics)
    assert wrapper.plain_calls == plain + 1
    assert wrapper.launches == launches
    assert cuda_build._kernels is None


def test_run_sweep_on_the_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = _port_inputs(_synthetic("altair"))
    plain = epoch_sweep_cuda.epoch_sweep_cuda.plain_calls
    port.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="set_device"):
            epoch_sweep.run_sweep(inp)
    finally:
        port.set_device("cpu")
    assert epoch_sweep_cuda.epoch_sweep_cuda.plain_calls == plain


def test_kernel_parameter_slots_match_the_wrapper():
    """The kernel cannot run here: its parameter slots, read from the
    source (its lane header), are the wrapper's PARAMS in the same
    order."""
    src = open(os.path.join(cuda_build.CSRC, "epoch_sweep.cuh")).read()
    body = re.search(r"enum Param : int \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    slots = [s.strip() for s in body.split(",") if s.strip()]
    assert slots[-1] == "P_COUNT"
    assert slots[:-1] == ["P_" + p.upper() for p in epoch_sweep_cuda.PARAMS]
    assert "kOrderBits = 24;" in src
    assert epoch_sweep.ORDER_BITS == jsweep.ORDER_BITS == 24


def test_column_and_scalar_names_match_the_reference():
    for name in ("FAR", "PHASE0_COLS", "ALTAIR_COLS", "PHASE0_SCALARS",
                 "ALTAIR_SCALARS"):
        assert getattr(epoch_sweep, name) == getattr(jsweep, name), name


HARNESS = r"""
#include "epoch_sweep.cuh"
#include <string.h>
// epoch_sweep.cu's two passes, lane after lane: the masked sums and the
// proposer scatter, then the lanes
extern "C" void sweep(const int64_t* params) {
  const Sweep s = sweep_from_params(params);
  memset(s.sums, 0, (3 + (sweep_scatters(s) ? s.n : 0)) * sizeof(u64));
  u64 acc[3] = {0, 0, 0};
  for (i64 i = 0; i < s.n; ++i) {
    if (sweep_sums(s)) sums_lane(s, i, acc);
    i64 proposer;
    u64 gain;
    if (sweep_scatters(s) && proposer_share(s, i, &proposer, &gain))
      s.proposer_gain[proposer] += gain;
  }
  for (int k = 0; k < 3; ++k) s.sums[k] = acc[k];
  i64 pincr[3];
  for (int k = 0; k < 3; ++k) pincr[k] = participating_incr(s, k);
  for (i64 i = 0; i < s.n; ++i) {
    if (s.altair) altair_lane(s, pincr, i);
    else phase0_lane(s, pincr, i);
  }
}
// rdiv by (m[i], l[i]) and floor_div by d[i], element by element
extern "C" void divide(const int64_t* n, const int64_t* m, const int64_t* l,
                       const int64_t* d, int64_t* q, int64_t* q_delay,
                       int64_t count) {
  for (int64_t i = 0; i < count; ++i) {
    Recip r;
    r.m = static_cast<u64>(m[i]);
    r.l = static_cast<int>(l[i]);
    q[i] = rdiv(n[i], r);
    q_delay[i] = floor_div(n[i], d[i]);
  }
}
"""


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build epoch_sweep.cuh with")
    out = tmp_path_factory.mktemp("epoch_sweep_host")
    src = out / "harness.cpp"
    src.write_text(HARNESS)
    lib_path = out / "libepoch_sweep_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-w",
                    "-I", cuda_build.CSRC, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    lib.sweep.argtypes = [p]
    lib.divide.argtypes = [p] * 6 + [ctypes.c_int64]
    return lib


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_lane_header_matches_the_plain_sweep(lane_lib, case):
    """epoch_sweep.cuh's lanes on the host, through the wrapper's parameter
    array (its reciprocals among them), equal plain_sweep lane for lane."""
    inp = _port_inputs(_synthetic(**SYNTHETIC[case]))
    cols = epoch_sweep.host_columns(inp)
    altair = inp.family == "altair"
    st = dict(inp.statics)
    want = epoch_sweep.plain_sweep(cols, inp.scalars, st)
    _buf, out = epoch_sweep.lane_buffers(altair, inp.n, "cpu")
    scratch = torch.zeros(3 + inp.n, dtype=torch.int64)
    params = epoch_sweep_cuda._params(cols, inp.scalars, st, out, scratch,
                                      inp.n, altair)
    lane_lib.sweep(params.ctypes.data)
    for name, g, w in zip(epoch_sweep.ALTAIR_OUT if altair
                          else epoch_sweep.PHASE0_OUT, out, want):
        assert torch.equal(g, w), name


EDGE_NUMERATORS = (0, 1, -1, -(1 << 63), (1 << 63) - 1)
EDGE_DIVISORS = (1, 2, 3, (1 << 32) - 1, (1 << 32) + 1, 1 << 62,
                 (1 << 63) - 1)


@pytest.mark.parametrize("divisor", list(EDGE_DIVISORS) + ["seeded"])
def test_reciprocal_division_equals_floor_division(lane_lib, divisor):
    """`rdiv` with the wrapper's reciprocal, and the inclusion delay's
    `floor_div`, against Python's floor division: the edge numerators, the
    multiples of the divisor and their neighbours, and seeded int64s, over
    one edge divisor or seeded divisors of every width."""
    rng = random.Random(f"2026-{divisor}")
    count = 4096
    lo, hi = -(1 << 63), (1 << 63) - 1
    divs = ([rng.randrange(1 << (w - 1), 1 << w)
             for w in (rng.randrange(1, 64) for _ in range(count))]
            if divisor == "seeded" else [divisor] * count)
    nums = [rng.randint(lo, hi) for _ in range(count)]
    nums[:len(EDGE_NUMERATORS)] = EDGE_NUMERATORS
    # multiples of the divisor and their neighbours
    for j in range(len(EDGE_NUMERATORS), count // 2):
        k = rng.randint(lo // divs[j], hi // divs[j])
        nums[j] = min(max(k * divs[j] + j % 3 - 1, lo), hi)
    recips = [epoch_sweep_cuda._reciprocal(d) for d in divs]
    assert all(0 < m < 1 << 64 for m, _ in recips)
    i64 = functools.partial(np.array, dtype=np.int64)
    n_arr = i64(nums)
    m_arr = np.array([m for m, _ in recips], dtype=np.uint64).view(np.int64)
    l_arr = i64([shift for _, shift in recips])
    d_arr = i64(divs)
    q, q_delay = np.empty(count, np.int64), np.empty(count, np.int64)
    lane_lib.divide(n_arr.ctypes.data, m_arr.ctypes.data, l_arr.ctypes.data,
                    d_arr.ctypes.data, q.ctypes.data, q_delay.ctypes.data,
                    count)
    want = [n // d for n, d in zip(nums, divs)]
    assert q.tolist() == want
    assert q_delay.tolist() == want
