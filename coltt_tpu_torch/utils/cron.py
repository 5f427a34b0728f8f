"""Five-field cron expression parser + next-fire computation.

Reference parity: ``diskv/options.go:55-62`` (AutoMergeCronExpr) wires a
user-supplied cron spec through robfig/cron to schedule merges
(``diskv/merge.go:239-330``). This is the same standard 5-field dialect
(minute hour day-of-month month day-of-week) with ``*``, lists ``a,b``,
ranges ``a-b``, and steps ``*/n`` / ``a-b/n``; day-of-month and
day-of-week combine as a union when both are restricted, per POSIX/Vixie
cron (and robfig's standard parser).

A copy of ``coltt_tpu/utils/cron.py`` (importing that package would load
JAX).
"""

from __future__ import annotations

import datetime as _dt
from typing import FrozenSet, Tuple

_FIELDS: Tuple[Tuple[int, int], ...] = (
    (0, 59),   # minute
    (0, 23),   # hour
    (1, 31),   # day of month
    (1, 12),   # month
    (0, 6),    # day of week (0 = Sunday)
)

_MONTHS = {m: i + 1 for i, m in enumerate(
    "jan feb mar apr may jun jul aug sep oct nov dec".split())}
_DOWS = {d: i for i, d in enumerate("sun mon tue wed thu fri sat".split())}


class CronError(ValueError):
    pass


def _atom(tok: str, lo: int, hi: int, names) -> int:
    t = tok.strip().lower()
    if t in names:
        return names[t]
    try:
        v = int(t)
    except ValueError as e:
        raise CronError(f"bad cron atom {tok!r}") from e
    if not lo <= v <= hi and not (hi == 6 and v == 7):
        raise CronError(f"cron value {v} out of range [{lo}, {hi}]")
    return 0 if (hi == 6 and v == 7) else v  # 7 == Sunday


def _parse_field(spec: str, lo: int, hi: int, names) -> FrozenSet[int]:
    out = set()
    for part in spec.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, s = part.rsplit("/", 1)
            try:
                step = int(s)
            except ValueError as e:
                raise CronError(f"bad cron step {s!r}") from e
            if step <= 0:
                raise CronError(f"cron step must be positive: {step}")
        if part in ("*", ""):
            a, b = lo, hi
        elif "-" in part:
            x, y = part.split("-", 1)
            a, b = _atom(x, lo, hi, names), _atom(y, lo, hi, names)
            if b < a:
                raise CronError(f"inverted cron range {part!r}")
        else:
            a = b = _atom(part, lo, hi, names)
        out.update(range(a, b + 1, step))
    if not out:
        raise CronError(f"empty cron field {spec!r}")
    return frozenset(out)


class CronSchedule:
    """Parsed 5-field cron expression with next-fire computation."""

    def __init__(self, expr: str):
        self.expr = expr
        fields = expr.split()
        if len(fields) != 5:
            raise CronError(
                f"cron expression needs 5 fields, got {len(fields)}: {expr!r}"
            )
        lists = []
        for spec, (lo, hi), names in zip(
            fields, _FIELDS, ({}, {}, {}, _MONTHS, _DOWS)
        ):
            lists.append(_parse_field(spec, lo, hi, names))
        self.minutes, self.hours, self.doms, self.months, self.dows = lists
        # Vixie-cron day semantics: if both dom and dow are restricted the
        # match is a UNION; if only one is restricted, only it applies.
        # A field starting with '*' (incl. "*/n") counts as unrestricted
        # for this rule, per Vixie/robfig behavior.
        self._dom_star = fields[2].startswith("*")
        self._dow_star = fields[4].startswith("*")

    def _day_match(self, dt: _dt.datetime) -> bool:
        dom_ok = dt.day in self.doms
        dow_ok = ((dt.weekday() + 1) % 7) in self.dows  # Monday=0 -> Sun=0
        if self._dom_star and self._dow_star:
            return True
        if self._dom_star:
            return dow_ok
        if self._dow_star:
            return dom_ok
        return dom_ok or dow_ok

    def matches(self, dt: _dt.datetime) -> bool:
        return (
            dt.minute in self.minutes
            and dt.hour in self.hours
            and dt.month in self.months
            and self._day_match(dt)
        )

    def next_after(self, now: _dt.datetime) -> _dt.datetime:
        """First fire time strictly after ``now`` (minute resolution)."""
        dt = (now + _dt.timedelta(minutes=1)).replace(second=0, microsecond=0)
        # bounded scan: minute-steps within matching days; day-steps else.
        # 4 years covers every 5-field pattern incl. Feb 29.
        limit = now + _dt.timedelta(days=4 * 366)
        while dt <= limit:
            if dt.month not in self.months or not self._day_match(dt):
                dt = (dt + _dt.timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if dt.hour not in self.hours:
                dt = (dt + _dt.timedelta(hours=1)).replace(minute=0)
                continue
            if dt.minute not in self.minutes:
                dt += _dt.timedelta(minutes=1)
                continue
            return dt
        raise CronError(f"cron expression {self.expr!r} never fires")

    def seconds_until_next(self, now: float) -> float:
        """Seconds from unix time ``now`` to the next fire (local time)."""
        base = _dt.datetime.fromtimestamp(now)
        return max(0.0, (self.next_after(base) - base).total_seconds())
