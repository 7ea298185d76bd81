"""Time quantums: YMDH view generation (reference time.go)."""

from __future__ import annotations

import datetime as dt
from typing import Union

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}


def validate_quantum(q: str) -> None:
    if q not in VALID_QUANTUMS:
        raise ValueError(f"invalid time quantum: {q!r}")


def view_by_time_unit(name: str, t: dt.datetime, unit: str) -> str:
    """View name for one quantum unit (reference time.go viewByTimeUnit)."""
    if unit == "Y":
        return f"{name}_{t.strftime('%Y')}"
    if unit == "M":
        return f"{name}_{t.strftime('%Y%m')}"
    if unit == "D":
        return f"{name}_{t.strftime('%Y%m%d')}"
    if unit == "H":
        return f"{name}_{t.strftime('%Y%m%d%H')}"
    return ""


def views_by_time(name: str, t: dt.datetime, q: str) -> list[str]:
    """All views a timestamped bit lands in (reference time.go viewsByTime)."""
    return [v for v in (view_by_time_unit(name, t, u) for u in q) if v]


def _next_year(t: dt.datetime) -> dt.datetime:
    return t.replace(year=t.year + 1)


def _add_month(t: dt.datetime) -> dt.datetime:
    """reference time.go addMonth: clamp to month start past day 28 to avoid
    Jan 31 + 1mo = Mar 2 style double-advances."""
    if t.day > 28:
        t = t.replace(day=1)
    if t.month == 12:
        return t.replace(year=t.year + 1, month=1)
    return t.replace(month=t.month + 1)


def _next_month_raw(t: dt.datetime) -> dt.datetime:
    # time.AddDate(0,1,0) semantics: overflow normalizes (Jan 31 -> Mar 2/3).
    y, m = (t.year + 1, 1) if t.month == 12 else (t.year, t.month + 1)
    try:
        return t.replace(year=y, month=m)
    except ValueError:
        # Normalize like Go: day overflow rolls into the following month.
        days_in = (dt.datetime(y, m % 12 + 1, 1) - dt.datetime(y, m, 1)).days if m != 12 else 31
        overflow = t.day - days_in
        base = dt.datetime(y, m, days_in, t.hour)
        return base + dt.timedelta(days=overflow)


def _next_year_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = t.replace(year=t.year + 1)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _next_month_raw(t)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _next_day_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = t + dt.timedelta(days=1)
    return (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day) or end > nxt


def views_by_time_range(name: str, start: dt.datetime, end: dt.datetime, q: str) -> list[str]:
    """Minimal view set covering [start, end) (reference time.go viewsByTimeRange)."""
    has_y, has_m, has_d, has_h = ("Y" in q), ("M" in q), ("D" in q), ("H" in q)
    t = start
    results: list[str] = []

    # Walk up from the smallest unit to aligned boundaries.
    if has_h or has_d or has_m:
        while t < end:
            if has_h:
                if not _next_day_gte(t, end):
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t += dt.timedelta(hours=1)
                    continue
            if has_d:
                if not _next_month_gte(t, end):
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t += dt.timedelta(days=1)
                    continue
            if has_m:
                if not _next_year_gte(t, end):
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk down from the largest unit.
    while t < end:
        if has_y and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _next_year(t)
        elif has_m and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_month(t)
        elif has_d and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t += dt.timedelta(days=1)
        elif has_h:
            results.append(view_by_time_unit(name, t, "H"))
            t += dt.timedelta(hours=1)
        else:
            break

    return results


def parse_time(v: Union[str, int, dt.datetime]) -> dt.datetime:
    """Parse PQL timestamp (reference time.go parseTime): '2006-01-02T15:04'
    strings or unix seconds."""
    if isinstance(v, dt.datetime):
        return v
    if isinstance(v, int):
        return dt.datetime.fromtimestamp(v, dt.timezone.utc).replace(tzinfo=None)
    if isinstance(v, str):
        return dt.datetime.strptime(v, "%Y-%m-%dT%H:%M")
    raise ValueError(f"cannot parse time: {v!r}")
