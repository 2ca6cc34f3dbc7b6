"""The CUDA epoch sweep kernel: parameters, launch and count.

Counterpart of the XLA program of consensus_specs_tpu/ops/epoch_sweep.py
(`_build`, run by `run_sweep`).  The kernel, csrc/epoch_sweep.cu (sm_90a),
runs one sweep as up to three launches on the current stream: masked sums,
the lane pass, and phase0's finish after the proposer scatter.  It is built
at first use with the port's other kernels (ops/cuda_build.py).

`epoch_sweep_cuda` is the wrapper.  On CUDA tensors it launches the kernel
or raises; on CPU tensors it runs the plain version
(ops/epoch_sweep.py plain_sweep), and only for that reason.
`.launches` counts the kernels it launched (up to three a sweep) and
`.plain_calls` the calls that took the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_build, epoch_sweep

# the host parameter array's slots, in the order of csrc/epoch_sweep.cu's
# `enum Param` (P_<NAME>): device addresses, lanes and switches, scalars
# (epochs as uint64 bit patterns) and statics
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
_SLOT = {name: i for i, name in enumerate(PARAMS)}
_STATICS = ("incr", "max_eb", "ejection", "hyst_q", "hyst_down", "hyst_up",
            "brf", "brpe", "prop_q", "inact_q", "wd", "target_flag")


def _bits(v) -> int:
    """An int as the int64 word with the same low 64 bits."""
    v = int(v) % (1 << 64)
    return v - (1 << 64) if v >= 1 << 63 else v


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
    cpu or cuda."""
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
