"""Model clock and alarms (noleap calendar).

JAX replacement for the mpass_timekeeping framework consumed by
the reference core (`mpas_seaice_core.F:147-189,306-371`): a plain
Python clock advanced by the host run loop; jitted kernels receive the
derived scalars (day-of-year, seconds-of-day) as inputs.
"""

from __future__ import annotations

import dataclasses

DAYS_PER_MONTH_NOLEAP = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
SECONDS_PER_DAY = 86400.0
DAYS_PER_YEAR = 365


@dataclasses.dataclass
class ModelClock:
    """Noleap-calendar clock; time tracked as seconds since year start
    plus an integer year.  calendar: only the reference default
    'gregorian_noleap'/'noleap' is supported — others hard-error
    rather than silently running noleap."""
    year: int = 1
    seconds: float = 0.0       # seconds since start of `year`
    calendar: str = "noleap"

    def __post_init__(self):
        if self.calendar not in ("noleap", "gregorian_noleap"):
            raise ValueError(
                f"unsupported calendar={self.calendar!r} (noleap only)")

    def copy(self) -> "ModelClock":
        return ModelClock(self.year, self.seconds)

    def advance(self, dt: float):
        self.seconds += dt
        year_len = DAYS_PER_YEAR * SECONDS_PER_DAY
        while self.seconds >= year_len:
            self.seconds -= year_len
            self.year += 1

    @property
    def day_of_year(self) -> int:
        """1-based day of year."""
        return int(self.seconds // SECONDS_PER_DAY) + 1

    @property
    def seconds_today(self) -> float:
        return self.seconds % SECONDS_PER_DAY

    @property
    def month(self) -> int:
        """1-based month."""
        d = self.day_of_year
        for m, nd in enumerate(DAYS_PER_MONTH_NOLEAP, start=1):
            if d <= nd:
                return m
            d -= nd
        return 12

    @property
    def year_fraction(self) -> float:
        return self.seconds / (DAYS_PER_YEAR * SECONDS_PER_DAY)

    def timestamp(self) -> str:
        d = self.day_of_year
        m = self.month
        day = d - sum(DAYS_PER_MONTH_NOLEAP[:m - 1])
        s = int(self.seconds_today)
        return (f"{self.year:04d}-{m:02d}-{day:02d}_"
                f"{s // 3600:02d}:{(s // 60) % 60:02d}:{s % 60:02d}")


class Alarm:
    """Periodic alarm (reference stream/coupling alarms)."""

    def __init__(self, interval_seconds: float, offset: float = 0.0):
        self.interval = interval_seconds
        self.offset = offset
        self._last_fire = None

    def is_ringing(self, clock: ModelClock) -> bool:
        t = clock.year * DAYS_PER_YEAR * SECONDS_PER_DAY + clock.seconds
        k = int((t - self.offset) // self.interval)
        if t - self.offset >= 0 and k != self._last_fire:
            self._last_fire = k
            return True
        return False
