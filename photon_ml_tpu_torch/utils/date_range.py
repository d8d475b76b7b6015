"""Date ranges as dataset coordinates (a copy of
photon_ml_tpu/utils/date_range.py:1-137; reference: ml/util/DateRange.scala,
ml/util/DateRangeUtils and the daily-directory resolution in
ml/util/IOUtils.getInputPathsWithinDateRange:85-131 — train/validate input
dirs may hold date-partitioned subdirectories `daily/yyyy/MM/dd`)."""

from __future__ import annotations

import dataclasses
import datetime
from pathlib import Path
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DateRange:
    """Inclusive [start, end] date range (ml/util/DateRange.scala)."""

    start: datetime.date
    end: datetime.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"Invalid range: start date {self.start} comes after end "
                f"date {self.end}")

    def __str__(self) -> str:
        return f"{self.start}-{self.end}"

    def days(self) -> List[datetime.date]:
        n = (self.end - self.start).days
        return [self.start + datetime.timedelta(days=i) for i in range(n + 1)]

    @classmethod
    def from_dates(cls, start: str, end: str,
                   pattern: str = "%Y%m%d") -> "DateRange":
        try:
            s = datetime.datetime.strptime(start, pattern).date()
            e = datetime.datetime.strptime(end, pattern).date()
        except ValueError as exc:
            raise ValueError(
                f"Couldn't parse the date range: {start}-{end}") from exc
        return cls(s, e)

    @classmethod
    def from_string(cls, range_str: str) -> "DateRange":
        """'yyyyMMdd-yyyyMMdd' (DateRange.fromDates(range))."""
        parts = range_str.split("-")
        if len(parts) != 2:
            raise ValueError(
                f"Couldn't parse the date range: {range_str!r} "
                "(expected 'yyyyMMdd-yyyyMMdd')")
        return cls.from_dates(parts[0], parts[1])

    @classmethod
    def from_days_ago(cls, start_days_ago: int, end_days_ago: int,
                      today: Optional[datetime.date] = None) -> "DateRange":
        """Range ending `end_days_ago` before today
        (DateRange.fromDaysAgo)."""
        if start_days_ago < 0 or end_days_ago < 0:
            raise ValueError("days ago cannot be negative")
        today = today or datetime.date.today()
        return cls(today - datetime.timedelta(days=start_days_ago),
                   today - datetime.timedelta(days=end_days_ago))

    @classmethod
    def from_days_ago_string(cls, range_str: str,
                             today: Optional[datetime.date] = None
                             ) -> "DateRange":
        """'start-end' in days ago, e.g. '90-1'
        (GameParams trainDateRangeDaysAgo)."""
        parts = range_str.split("-")
        if len(parts) != 2:
            raise ValueError(
                f"Couldn't parse days-ago range: {range_str!r}")
        try:
            start, end = int(parts[0]), int(parts[1])
        except ValueError as e:
            raise ValueError(
                f"Couldn't parse days-ago range: {range_str!r}") from e
        # Semantic errors (reversed order, negative) propagate untouched.
        return cls.from_days_ago(start, end, today)


def resolve_paths_within_date_range(
    input_dirs: Sequence, date_range: DateRange,
    error_on_missing: bool = False,
) -> List[Path]:
    """For each input dir, collect `<dir>/daily/yyyy/MM/dd` subdirectories
    that exist within the range (IOUtils.getInputPathsWithinDateRange:105-131).
    Raises if a whole input dir yields nothing (or any day is missing with
    error_on_missing)."""
    out: List[Path] = []
    for input_dir in input_dirs:
        daily = Path(input_dir) / "daily"
        found = []
        for day in date_range.days():
            p = daily / f"{day.year:04d}" / f"{day.month:02d}" \
                / f"{day.day:02d}"
            if p.is_dir():
                found.append(p)
            elif error_on_missing:
                raise FileNotFoundError(f"Missing data folder {p}")
        if not found:
            raise FileNotFoundError(
                f"No data folder found between {date_range.start} and "
                f"{date_range.end} in {daily}")
        out.extend(found)
    return out


def resolve_input_dirs(
    input_dirs,
    date_range: Optional[str] = None,
    date_range_days_ago: Optional[str] = None,
    today: Optional[datetime.date] = None,
) -> List[Path]:
    """Driver-facing resolution: with neither range flag the dirs pass
    through unchanged; otherwise daily subdirectories are expanded
    (reference: GameParams trainDateRangeOpt / trainDateRangeDaysAgoOpt,
    applied in cli/game/GAMEDriver). input_dirs: a list, or the raw
    comma-separated CLI string (blank segments dropped)."""
    if isinstance(input_dirs, (str, Path)):
        input_dirs = [s.strip() for s in str(input_dirs).split(",")
                      if s.strip()]
    if not input_dirs:
        raise ValueError("no input directories given")
    if date_range is not None and date_range_days_ago is not None:
        raise ValueError(
            "specify at most one of date-range and date-range-days-ago")
    if date_range is not None:
        rng = DateRange.from_string(date_range)
    elif date_range_days_ago is not None:
        rng = DateRange.from_days_ago_string(date_range_days_ago, today)
    else:
        return [Path(d) for d in input_dirs]
    return resolve_paths_within_date_range(input_dirs, rng)
