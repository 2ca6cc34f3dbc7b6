"""The CUDA epoch sweep kernel: parameters, launch and count.

Counterpart of the XLA program of consensus_specs_tpu/ops/epoch_sweep.py
(`_build`, run by `run_sweep`).  The kernel, csrc/epoch_sweep.cu (sm_90a;
its lane math csrc/epoch_sweep.cuh), runs one sweep as up to two launches
on the current stream: the masked sums with phase0's proposer scatter,
then the lanes.  It is built at first use with the port's other kernels
(ops/cuda_build.py).  The wrapper passes a reciprocal for each divisor
that every lane shares (`_reciprocal`), so a lane divides with two 64-bit
products.

`epoch_sweep_cuda` is the wrapper.  On CUDA tensors it launches the kernel
or raises; on CPU tensors it runs the plain version
(ops/epoch_sweep.py plain_sweep), and only for that reason.
`.launches` counts the kernels it launched (up to two a sweep) and
`.plain_calls` the calls that took the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_build, epoch_sweep

# the host parameter array's slots, in the order of csrc/epoch_sweep.cuh's
# `enum Param` (P_<NAME>): device addresses, lanes and switches, scalars
# (epochs as uint64 bit patterns), statics, and the reciprocals (m, l) of
# RECIPROCALS
PARAMS = (
    "eff", "slashed", "activation", "exit_epoch", "act_elig", "withdrawable",
    "balances", "max_eff", "src", "tgt", "head", "best_key", "best_prop",
    "part_prev", "scores",
    "out_balances", "out_scores", "out_eff", "out_elig_q", "out_eject",
    "out_ready", "scratch",
    "n", "altair", "do_rewards", "leak", "electra",
    "cur", "prev", "finalized", "slash_epoch", "tb", "adj", "sqrt_tb",
    "finality_delay", "base_per_incr", "bias", "recovery", "inact_denom",
    "incr", "max_eb", "ejection", "hyst_q", "hyst_down", "hyst_up", "brf",
    "brpe", "prop_q", "inact_q", "wd", "target_flag",
    "flag0", "weight0", "is_head0", "flag1", "weight1", "is_head1",
    "flag2", "weight2", "is_head2")
# the divisors every lane shares: tb // incr (phase0's participating
# increments' divisor; electra's slashing quotient) and (tb // incr) * wd
# (altair's flag rewards) beside the scalars and statics of those names
RECIPROCALS = ("incr", "sqrt_tb", "brpe", "prop_q", "total_incr", "inact_q",
               "tb", "hyst_q", "wd", "incr_wd", "inact_denom")
PARAMS += tuple(f"{name}_{part}" for name in RECIPROCALS
                for part in ("m", "l"))
_SLOT = {name: i for i, name in enumerate(PARAMS)}
_STATICS = ("incr", "max_eb", "ejection", "hyst_q", "hyst_down", "hyst_up",
            "brf", "brpe", "prop_q", "inact_q", "wd", "target_flag")


def _bits(v) -> int:
    """An int as the int64 word with the same low 64 bits."""
    v = int(v) % (1 << 64)
    return v - (1 << 64) if v >= 1 << 63 else v


def _reciprocal(d: int) -> tuple:
    """(m, l) with which csrc/epoch_sweep.cuh `rdiv` floor-divides any
    int64 by d >= 1: l = ceil(log2 d), m = floor(2^(63 + l) / d) + 1, so
    that 2^(63 + l) < m d <= 2^(63 + l) + 2^l and floor(u / d) =
    floor(m u / 2^(63 + l)) for 0 <= u < 2^63 (Granlund and Montgomery,
    round-up method); m < 2^64."""
    shift = (d - 1).bit_length()
    return (1 << (63 + shift)) // d + 1, shift


def _divisors(scalars, st, altair) -> dict:
    """The family's RECIPROCALS divisors, as the kernel computes them."""
    tb, incr = int(scalars["tb"]), int(st["incr"])
    total_incr = tb // incr if incr > 0 else 0
    d = {"incr": incr, "tb": tb, "hyst_q": st["hyst_q"],
         "total_incr": total_incr}
    if altair:
        d.update(wd=st["wd"], incr_wd=_bits(total_incr * int(st["wd"])),
                 inact_denom=scalars["inact_denom"])
    else:
        d.update(sqrt_tb=scalars["sqrt_tb"], brpe=st["brpe"],
                 prop_q=st["prop_q"], inact_q=st["inact_q"])
    return {k: int(v) for k, v in d.items()}


def _params(cols, scalars, st, out, scratch, n, altair) -> np.ndarray:
    p = np.zeros(len(PARAMS), dtype=np.int64)

    def put(name, value):
        p[_SLOT[name]] = _bits(value)
    for name, t in cols.items():
        put(name, t.data_ptr())
    out_names = epoch_sweep.ALTAIR_OUT if altair else epoch_sweep.PHASE0_OUT
    for name, t in zip(out_names, out):
        put("out_eff" if name == "new_eff" else "out_" + name, t.data_ptr())
    put("scratch", scratch.data_ptr())
    put("n", n)
    put("altair", altair)
    for name in ("do_rewards", "leak", "electra"):
        put(name, bool(st.get(name, False)))
    for name, value in scalars.items():
        put(name, value)
    for name in _STATICS:
        put(name, st.get(name, 0))
    if altair:
        for k, (flag, weight, is_head) in enumerate(st["flags"]):
            put(f"flag{k}", flag)
            put(f"weight{k}", weight)
            put(f"is_head{k}", is_head)
    for name, d in _divisors(scalars, st, altair).items():
        if d < 1:
            raise ValueError(f"epoch sweep: divisor {name} = {d} is not "
                             f"positive")
        m, shift = _reciprocal(d)
        put(f"{name}_m", m)
        put(f"{name}_l", shift)
    return p


def _check(name, t, n, dtype, device) -> None:
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: expected a vector of {n} lanes, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, eff on {device}")


def epoch_sweep_cuda(cols: dict, scalars: dict, statics, out=None) -> tuple:
    """One epoch sweep: the output lanes (PHASE0_OUT or ALTAIR_OUT order)
    of the columns `cols` (see ops/epoch_sweep.py plain_sweep), written
    into `out` when given (a tuple of lanes of the right dtypes and
    length, e.g. from `epoch_sweep.lane_buffers`).

    CUDA tensors go through the kernel, CPU tensors through the plain
    version.  Rejects a column set of neither family, a lane of another
    length, dtype or device, a non-contiguous lane, an altair sweep
    without exactly three participation flags, and a device other than
    cpu or cuda; on the card also a shared divisor below one."""
    altair = "part_prev" in cols
    names = epoch_sweep.ALTAIR_COLS if altair else epoch_sweep.PHASE0_COLS
    if set(cols) != set(names):
        raise ValueError(f"expected the columns {names}, got {tuple(cols)}")
    st = dict(statics)
    if altair and len(st["flags"]) != 3:
        raise ValueError(f"expected three participation flags, got "
                         f"{st['flags']}")
    eff = cols["eff"]
    n = eff.shape[0] if eff.dim() == 1 else -1
    device = eff.device
    for name in names:
        _check(name, cols[name], n,
               torch.bool if name in epoch_sweep.BOOL_COLS else torch.int64,
               device)
    out_names = epoch_sweep.ALTAIR_OUT if altair else epoch_sweep.PHASE0_OUT
    if out is not None:
        if len(out) != len(out_names):
            raise ValueError(f"expected {len(out_names)} output lanes, got "
                             f"{len(out)}")
        for name, t in zip(out_names, out):
            _check(f"output {name}", t, n,
                   torch.bool if name in epoch_sweep.BOOL_OUT
                   else torch.int64, device)
    if device.type == "cpu":
        epoch_sweep_cuda.plain_calls += 1
        lanes = epoch_sweep.plain_sweep(cols, scalars, st)
        if out is None:
            return lanes
        for o, lane in zip(out, lanes):
            o.copy_(lane)
        return out
    if device.type != "cuda":
        raise ValueError(f"columns on unsupported device {device}")
    kernels = cuda_build.build()
    if out is None:
        _buf, out = epoch_sweep.lane_buffers(altair, n, device)
    scatter = not altair and bool(st["do_rewards"])
    scratch = torch.empty(3 + (n if scatter else 0), dtype=torch.int64,
                          device=device)
    if n:
        params = _params(cols, scalars, st, out, scratch, n, altair)
        epoch_sweep_cuda.launches += kernels.epoch(params, scratch)
    return out


epoch_sweep_cuda.launches = 0
epoch_sweep_cuda.plain_calls = 0
