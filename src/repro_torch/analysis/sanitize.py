"""Sanitizer mode: runtime invariants on the §IV.A/§IV.B state machine,
switched on with ``REPRO_SANITIZE=1``.

Counterpart of ``repro/analysis/sanitize.py``, whose invariants are traced
into the jitted programs by ``checkify``. Here they are eager torch
reductions on the device of the state they check, run where the
reference runs its checks:

- **window monotonicity** — every valid availability window has
  ``t1 <= t2`` (a corrupted window order is exactly the silent
  scheduler-state corruption a racy kernel write would produce);
- **availability conservation** — placements only ever *consume*
  availability (total valid window length is non-increasing across a
  commit);
- **capacity sanity** — ``0 <= link_used <= link_cap``, ``link_free``
  non-negative, victim-cache windows ordered.

The checks are read-only: they never write into the state, which the CUDA
placement kernel updates in place. Each reads one scalar (its predicate)
back to the host, and that synchronisation is the whole cost of the flag;
a payload is computed only when its check trips. With the flag off the
call sites compute nothing. A trip raises ``SanitizeError`` with the
failing invariant named and its payload formatted.
"""

from __future__ import annotations

import math
import os

import torch

ENV_VAR = "REPRO_SANITIZE"

#: relative + absolute slack for f32 availability totals (window ends sit
#: at BIG=1e30, where one ulp is ~1e23 — conservation can only be judged
#: relative to the total's magnitude).
REL_TOL = 1e-5
ABS_TOL = 1e-3


class SanitizeError(RuntimeError):
    """An invariant of the scheduler state tripped under ``REPRO_SANITIZE``."""


def enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set to anything but ''/'0'."""
    return os.environ.get(ENV_VAR, "0") not in ("", "0")


def _value(v):
    v = v() if callable(v) else v
    return v.tolist() if isinstance(v, torch.Tensor) else v


def check(pred, msg: str, **fmt) -> None:
    """Raise ``SanitizeError(msg)`` unless ``pred`` (a bool tensor or a
    bool) holds. Each payload is a tensor or a function returning one; it
    is read, and ``msg`` formatted with it, only on a trip."""
    if not bool(pred):
        raise SanitizeError(msg.format(
            **{k: _value(v) for k, v in fmt.items()}))


# ---------------------------------------------------------------------------
# invariants over SchedState-shaped window tensors
# ---------------------------------------------------------------------------

def total_availability(t1, t2, valid, *, batch_axes: int = 0):
    """Total valid window length, reduced over everything but the leading
    ``batch_axes`` axes."""
    axes = tuple(range(batch_axes, t1.ndim))
    return torch.where(valid, t2 - t1, 0.0).sum(axes)


def check_windows(t1, t2, valid, where: str) -> None:
    """Window monotonicity: valid ⇒ t1 <= t2."""
    check(
        (~valid | (t1 <= t2)).all(),
        "window order violated (" + where + "): a valid availability "
        "window has t1 > t2 — scheduler window state is corrupt; "
        "min t2-t1 = {gap}",
        gap=lambda: torch.where(valid, t2 - t1, math.inf).min(),
    )


def check_sched_state(state, where: str) -> None:
    """Full §IV invariant set on one (possibly batched) SchedState."""
    check_windows(state.win_t1, state.win_t2, state.win_valid, where)
    check(
        (state.min_dur > 0).all(),
        "non-positive min_dur (" + where + "): {md}", md=state.min_dur,
    )
    check(
        ((state.link_used >= 0) & (state.link_used <= state.link_cap)).all(),
        "link capacity violated (" + where + "): used outside [0, cap], "
        "max used = {u}", u=lambda: state.link_used.max(),
    )


def check_no_avail_increase(before, after, where: str) -> None:
    """Availability conservation: totals may only shrink (placements
    consume windows; housekeeping expires them; nothing creates them)."""
    bound = before * (1.0 + REL_TOL) + ABS_TOL
    check(
        (after <= bound).all(),
        "availability increased (" + where + "): a commit/compaction "
        "manufactured window time; max excess = {x}",
        x=lambda: (after - before).max(),
    )


def check_avail_conserved(before, after, where: str) -> None:
    """Exact (to f32) conservation, e.g. across compaction."""
    slack = before.abs() * REL_TOL + ABS_TOL
    check(
        ((after - before).abs() <= slack).all(),
        "availability not conserved (" + where + "): max |delta| = {x}",
        x=lambda: (after - before).abs().max(),
    )
