"""Per-stage wall timers.

Parity with Timings (/root/reference/include/Timings.h:4-49): the reference
tracks 12 float stage timers with += and /= operators, recorded via CUDA
events around each pipeline stage (Multiply.cu:36-49). The equivalent here
uses ``jax.block_until_ready`` + ``time.perf_counter`` wall timers; stage
names mirror the reference's printout (Multiply.cu:1099-1113).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional

STAGE_NAMES = (
    "init",            # buffer setup
    "countProducts",   # analysis pass (readOperations)
    "loadBalanceCounting",
    "globalMapsCounting",  # kept for stage-name parity; ~0 (no global maps)
    "spGEMMCounting",
    "allocC",
    "loadBalanceNumeric",
    "globalMapsNumeric",
    "spGEMMNumeric",
    "sorting",         # ~0: ESC/dense paths emit sorted rows
    "cleanup",
    "complete",
)


class Timings:
    """Accumulating stage->milliseconds map with += and /= semantics."""

    def __init__(self) -> None:
        self.ms: Dict[str, float] = {k: 0.0 for k in STAGE_NAMES}
        self.measure_all = False      # TrackIndividualTimes
        self.measure_complete = False  # TrackCompleteTimes

    def add(self, stage: str, ms: float) -> None:
        self.ms[stage] = self.ms.get(stage, 0.0) + ms

    def __iadd__(self, other: "Timings") -> "Timings":
        for k, v in other.ms.items():
            self.ms[k] = self.ms.get(k, 0.0) + v
        return self

    def __itruediv__(self, n: float) -> "Timings":
        for k in self.ms:
            self.ms[k] /= n
        return self

    def items(self) -> Iterator:
        return iter(self.ms.items())

    def report(self) -> str:
        lines = [f"{k}: {v:.4f} ms" for k, v in self.ms.items() if v != 0.0]
        return "\n".join(lines)


class StageTimer:
    """Context-manager stage timer; blocks on given arrays before stopping."""

    def __init__(self, timings: Optional[Timings], stage: str, enabled: bool = True):
        self.timings = timings
        self.stage = stage
        self.enabled = enabled and timings is not None
        self._t0 = 0.0

    def __enter__(self):
        if self.enabled:
            self._t0 = time.perf_counter()
        return self

    def stop(self, *block_on) -> None:
        if self.enabled:
            import jax

            for arr in block_on:
                jax.block_until_ready(arr)

    def __exit__(self, *exc):
        if self.enabled:
            self.timings.add(self.stage, (time.perf_counter() - self._t0) * 1e3)
        return False
