"""Timing / metrics registry.

Rebuild of the reference's global `statistics` singleton
(`statistics.h:38`, `statistics.cpp:6-51`): named value streams with
mean/sigma/count reporting, kept host-side. Stage names match the reference
("Filtering", "compensate", "build_normals", "register", ...) so timing
tables are directly comparable.

The port's own copy of the reference's
`cfear_radarodometry_code_public_tpu/utils/stats.py` (framework-free; the
port imports nothing of the reference package). The two are held equal by
`tests/test_torch_selfcontained.py`: `timing` and `Statistics` report what
the reference's do.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from typing import Dict, List


class Statistics:
    def __init__(self) -> None:
        self._data: Dict[str, List[float]] = {}

    def document(self, name: str, value: float) -> None:
        self._data.setdefault(name, []).append(float(value))

    # reference spelling (`statistics.cpp:10-14`)
    Document = document

    def clear(self) -> None:
        self._data.clear()

    def mean(self, name: str) -> float:
        v = self._data.get(name, [])
        return sum(v) / len(v) if v else float("nan")

    def sigma(self, name: str) -> float:
        v = self._data.get(name, [])
        if len(v) < 2:
            return 0.0
        m = self.mean(name)
        return math.sqrt(sum((x - m) ** 2 for x in v) / (len(v) - 1))

    def count(self, name: str) -> int:
        return len(self._data.get(name, []))

    def present(self) -> str:
        """Human-readable report (`statistics.cpp:31-38`)."""
        lines = ["--Statistics--"]
        for name in sorted(self._data):
            lines.append(
                f"{name}: mean={self.mean(name):.4f} sigma={self.sigma(name):.4f} "
                f"N={self.count(name)}"
            )
        return "\n".join(lines)

    def csv(self) -> str:
        """pars.txt-style CSV report (`statistics.cpp:40-51`)."""
        lines = []
        for name in sorted(self._data):
            lines.append(f"{name}, {self.mean(name)}, {self.sigma(name)}, "
                         f"{self.count(name)}")
        return "\n".join(lines)

    @contextmanager
    def timer(self, name: str):
        """Time a block in milliseconds under `name`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.document(name, (time.perf_counter() - t0) * 1e3)


# Global registry, mirroring `CFEAR_Radarodometry::timing`.
timing = Statistics()
