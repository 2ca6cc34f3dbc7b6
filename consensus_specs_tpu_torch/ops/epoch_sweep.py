"""The per-validator epoch sweep: one launch sequence per `process_epoch`.

Counterpart of consensus_specs_tpu/ops/epoch_sweep.py, whose `_build`
compiles every hot per-validator pass of epoch processing (attestation and
participation-flag deltas, inactivity scores, the slashings penalty,
effective-balance hysteresis and the registry-eligibility masks) into one
XLA program over the validator axis.  Here the same function has two
versions:

- the CUDA kernel `csrc/epoch_sweep.cu`, behind the wrapper
  `epoch_sweep_cuda.epoch_sweep_cuda`, which the card path runs;
- `plain_sweep`, the same lane math in plain torch on int64 tensors, which
  the wrapper runs for CPU tensors, and against which the tests and the
  differential guard of specs/epoch_fast.py hold the kernel.

`run_sweep(inp)` takes a `specs.epoch_fast.SweepInputs`, makes ONE upload of
every column to the port's device (`consensus_specs_tpu_torch.get_device()`),
one launch sequence and ONE download, and returns numpy lanes in the
reference's order and dtypes: phase0 -> (balances, new_eff, elig_q, eject,
ready), altair -> (balances, scores, new_eff, elig_q, eject, ready), int64
lanes and bool masks.  The reference's mesh padding (`_PAD`,
`parallel.shard_verify.shard_jobs`) belongs to the multi-device layer and
is not ported.

Epochs are uint64 with FAR = 2^64 - 1.  They travel as int64 bit patterns;
torch has no uint64 `<=`, so `plain_sweep` compares them after an
order-preserving map to int64 (flip the sign bit), and the kernel compares
them as unsigned long long.
"""
from __future__ import annotations

import numpy as np
import torch

# inclusion-delay keys pack (delay << ORDER_BITS) | attestation order;
# must match specs/epoch_fast.py's _ORDER_BITS
ORDER_BITS = 24
FAR = (1 << 64) - 1

# column orders of the two families (epoch_fast builds SweepInputs.cols
# with exactly these keys)
PHASE0_COLS = ("eff", "slashed", "activation", "exit_epoch", "act_elig",
               "withdrawable", "balances", "max_eff",
               "src", "tgt", "head", "best_key", "best_prop")
ALTAIR_COLS = ("eff", "slashed", "activation", "exit_epoch", "act_elig",
               "withdrawable", "balances", "max_eff",
               "part_prev", "scores")
PHASE0_SCALARS = ("cur", "prev", "finalized", "slash_epoch",
                  "tb", "sqrt_tb", "adj", "finality_delay")
ALTAIR_SCALARS = ("cur", "prev", "finalized", "slash_epoch",
                  "tb", "adj", "base_per_incr", "bias", "recovery",
                  "inact_denom")
# the bool columns; every other column is int64 (epochs: uint64 bits)
BOOL_COLS = frozenset({"slashed", "src", "tgt", "head"})
# output lanes of the two families, and the bool ones among them
PHASE0_OUT = ("balances", "new_eff", "elig_q", "eject", "ready")
ALTAIR_OUT = ("balances", "scores", "new_eff", "elig_q", "eject", "ready")
BOOL_OUT = frozenset({"elig_q", "eject", "ready"})

_SIGN = 1 << 63


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """uint64 bit patterns in an int64 tensor -> int64 of the same order."""
    return t ^ -_SIGN


def _ordered_value(v) -> int:
    """A uint64 value (taken modulo 2^64) -> the int64 `_ordered` gives it."""
    return int(v) % (1 << 64) - _SIGN


def plain_sweep(cols: dict, scalars: dict, statics) -> tuple:
    """The sweep's lane math in plain torch, on any device.

    `cols` maps the family's column names to 1-D tensors of one length:
    torch.bool for BOOL_COLS, int64 for the others (epochs as uint64 bit
    patterns); the family is altair when `part_prev` is present.
    `scalars` maps the family's scalar names to ints (epochs as uint64
    values); `statics` is the SweepInputs statics (pairs or a dict).
    Returns new tensors in PHASE0_OUT / ALTAIR_OUT order.  Integer math is
    int64 with numpy's wrap and floor division, as in the reference."""
    st = dict(statics)
    altair = "part_prev" in cols
    incr = st["incr"]
    leak = st["leak"]
    eff = cols["eff"]
    slashed = cols["slashed"]
    activation = _ordered(cols["activation"])
    exit_epoch = _ordered(cols["exit_epoch"])
    act_elig = _ordered(cols["act_elig"])
    withdrawable = _ordered(cols["withdrawable"])
    cur = _ordered_value(scalars["cur"])
    prev = _ordered_value(scalars["prev"])
    finalized = _ordered_value(scalars["finalized"])
    slash_epoch = _ordered_value(scalars["slash_epoch"])
    far = _ordered_value(FAR)
    tb = int(scalars["tb"])
    adj = int(scalars["adj"])

    active_prev = (activation <= prev) & (prev < exit_epoch)
    active_cur = (activation <= cur) & (cur < exit_epoch)
    eligible = active_prev | (
        slashed & (_ordered_value(int(scalars["prev"]) + 1) < withdrawable))
    unsl = ~slashed
    bal = cols["balances"]
    new_scores = None

    if not altair:
        if st["do_rewards"]:
            base = eff * st["brf"] // int(scalars["sqrt_tb"]) // st["brpe"]
            prop_reward = base // st["prop_q"]
            rewards = torch.zeros_like(eff)
            penalties = torch.zeros_like(eff)
            for mask in (cols["src"], cols["tgt"], cols["head"]):
                m = mask & unsl
                if leak:
                    comp = base
                else:
                    att_bal = max(incr, int(torch.where(m, eff, 0).sum()))
                    comp = base * (att_bal // incr) // (tb // incr)
                rewards = rewards + torch.where(eligible & m, comp, 0)
                penalties = penalties + torch.where(eligible & ~m, base, 0)
            # inclusion-delay rewards (no eligibility filter) and the
            # proposer scatter; lanes that are not unslashed source
            # attesters divide by 1 and add 0
            unsl_src = cols["src"] & unsl
            delays = torch.where(unsl_src, cols["best_key"] >> ORDER_BITS, 1)
            rewards = rewards + torch.where(
                unsl_src, (base - prop_reward) // delays, 0)
            rewards = rewards + torch.zeros_like(eff).index_add_(
                0, cols["best_prop"], torch.where(unsl_src, prop_reward, 0))
            if leak:
                unsl_tgt = cols["tgt"] & unsl
                penalties = penalties + torch.where(
                    eligible, st["brpe"] * base - prop_reward, 0)
                penalties = penalties + torch.where(
                    eligible & ~unsl_tgt,
                    eff * int(scalars["finality_delay"]) // st["inact_q"], 0)
            bal = torch.clamp(bal + rewards - penalties, min=0)
    else:
        new_scores = cols["scores"].clone()
        if st["do_rewards"]:
            part_prev = cols["part_prev"]
            tgt_unsl = (active_prev
                        & (((part_prev >> st["target_flag"]) & 1) == 1)
                        & unsl)
            # inactivity scores first: the penalty below reads them
            new_scores = torch.where(
                eligible & tgt_unsl,
                new_scores - torch.clamp(new_scores, max=1), new_scores)
            new_scores = torch.where(
                eligible & ~tgt_unsl, new_scores + int(scalars["bias"]),
                new_scores)
            if not leak:
                rec = int(scalars["recovery"])
                new_scores = torch.where(
                    eligible, new_scores - torch.clamp(new_scores, max=rec),
                    new_scores)
            # per-flag delta sets, each with its own floor at 0
            active_incr = tb // incr
            base = (eff // incr) * int(scalars["base_per_incr"])
            for flag_idx, weight, is_head in st["flags"]:
                funsl = (active_prev
                         & (((part_prev >> flag_idx) & 1) == 1) & unsl)
                if leak:
                    r = 0
                else:
                    part_incr = max(
                        incr, int(torch.where(funsl, eff, 0).sum())) // incr
                    r = torch.where(
                        eligible & funsl,
                        base * weight * part_incr // (active_incr * st["wd"]),
                        0)
                if is_head:
                    p = 0
                else:
                    p = torch.where(eligible & ~funsl,
                                    base * weight // st["wd"], 0)
                bal = torch.clamp(bal + r - p, min=0)
            pen = eff * new_scores // int(scalars["inact_denom"])
            bal = torch.clamp(
                bal - torch.where(eligible & ~tgt_unsl, pen, 0), min=0)

    # slashings: correlation penalty at the halfway-window epoch
    eff_incr = eff // incr
    if st.get("electra"):
        pen = eff_incr * (adj // (tb // incr))
    else:
        pen = eff_incr * adj // tb * incr
    slash_mask = slashed & (withdrawable == slash_epoch)
    bal = torch.clamp(bal - torch.where(slash_mask, pen, 0), min=0)
    # effective-balance hysteresis (reads the post-deltas balance)
    h = incr // st["hyst_q"]
    cond = ((bal + h * st["hyst_down"] < eff)
            | (eff + h * st["hyst_up"] < bal))
    new_eff = torch.where(
        cond, torch.minimum(bal - bal % incr, cols["max_eff"]), eff)
    # registry-update eligibility masks
    elig_q = (act_elig == far) & (eff == st["max_eb"])
    eject = active_cur & (eff <= st["ejection"])
    ready = (act_elig <= finalized) & (activation == far)
    if new_scores is None:
        return bal, new_eff, elig_q, eject, ready
    return bal, new_scores, new_eff, elig_q, eject, ready


# ---------------------------------------------------------------------------
# packed buffers: one upload, one download
# ---------------------------------------------------------------------------

def _layout(names, bools, n: int):
    """Byte offsets of the named lanes in one packed buffer (the int64
    lanes first, so each starts 8-byte aligned, then the bool lanes) and
    the buffer's size."""
    offsets = {}
    pos = 0
    for name in sorted(names, key=lambda k: k in bools):
        offsets[name] = pos
        pos += n if name in bools else 8 * n
    return offsets, pos


def _split(buf: torch.Tensor, names, bools, n: int) -> dict:
    """Typed views of the named lanes of a packed uint8 buffer."""
    offsets, _size = _layout(names, bools, n)
    return {k: (buf[o:o + n].view(torch.bool) if k in bools
                else buf[o:o + 8 * n].view(torch.int64))
            for k, o in offsets.items()}


def lane_buffers(altair: bool, n: int, device):
    """One uint8 buffer for every output lane of a sweep, and the lanes as
    a tuple of typed views in PHASE0_OUT / ALTAIR_OUT order."""
    names = ALTAIR_OUT if altair else PHASE0_OUT
    _offsets, size = _layout(names, BOOL_OUT, n)
    buf = torch.empty(size, dtype=torch.uint8, device=device)
    lanes = _split(buf, names, BOOL_OUT, n)
    return buf, tuple(lanes[k] for k in names)


def host_columns(inp) -> dict:
    """The SweepInputs' columns as CPU tensors (no copy): int64 for the
    integer columns (uint64 epochs as their bit patterns), bool for
    BOOL_COLS."""
    out = {}
    for name, a in inp.cols.items():
        a = np.ascontiguousarray(a)
        out[name] = torch.from_numpy(
            a if name in BOOL_COLS else a.view(np.int64))
    return out


def _check_columns(inp, names) -> None:
    if set(inp.cols) != set(names):
        raise ValueError(f"{inp.family} sweep needs columns {names}, got "
                         f"{tuple(inp.cols)}")
    for name in names:
        a = inp.cols[name]
        want = "bool" if name in BOOL_COLS else "a 64-bit integer"
        ok = (a.dtype == np.bool_ if name in BOOL_COLS
              else a.dtype in (np.int64, np.uint64))
        if not ok or a.shape != (inp.n,):
            raise ValueError(f"column {name!r}: expected {want} vector of "
                             f"{inp.n}, got {a.dtype} {a.shape}")


def run_sweep(inp):
    """The fused epoch sweep on the port's device: ONE upload of every
    column, one launch sequence (the kernel's wrapper), ONE download.
    Returns numpy lanes in the reference's order and dtypes."""
    from .. import get_device
    from . import epoch_sweep_cuda
    from .cuda_build import require_device

    altair = inp.family == "altair"
    if inp.family not in ("phase0", "altair"):
        raise ValueError(f"unknown sweep family {inp.family!r}")
    names = ALTAIR_COLS if altair else PHASE0_COLS
    n = inp.n
    _check_columns(inp, names)
    if not altair and n:
        prop = inp.cols["best_prop"]
        if prop.min() < 0 or prop.max() >= n:
            raise ValueError(f"best_prop outside [0, {n})")
    device = require_device(get_device())

    offsets, size = _layout(names, BOOL_COLS, n)
    host = np.empty(size, dtype=np.uint8)
    for name, o in offsets.items():
        lane = np.ascontiguousarray(inp.cols[name]).view(np.uint8)
        host[o:o + lane.size] = lane
    cols = _split(torch.from_numpy(host).to(device), names, BOOL_COLS, n)
    buf, lanes = lane_buffers(altair, n, device)
    epoch_sweep_cuda.epoch_sweep_cuda(
        cols, {k: int(v) for k, v in inp.scalars.items()}, inp.statics,
        out=lanes)
    out = buf.cpu().numpy()
    out_names = ALTAIR_OUT if altair else PHASE0_OUT
    offsets, _size = _layout(out_names, BOOL_OUT, n)
    return tuple(out[offsets[k]:offsets[k] + n].view(np.bool_)
                 if k in BOOL_OUT
                 else out[offsets[k]:offsets[k] + 8 * n].view(np.int64)
                 for k in out_names)
