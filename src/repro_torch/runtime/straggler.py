"""Straggler detection driven by the calibrated performance model — the
counterpart of ``repro.runtime.straggler`` (pure Python, the same code).

The paper's use case "load balancing / job scheduling": rather than a fixed
timeout, the monitor compares each step's wall time against a *predicted*
step time (from the calibrated Perflex model, or a robust running median
when no model is installed).  Steps slower than ``slack ×`` the expectation
are flagged; in a multi-host deployment the flag feeds the coordinator's
exclude-and-rescale path (here: recorded + surfaced via callback).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class StragglerEvent:
    step: int
    wall_s: float
    expected_s: float
    ratio: float


@dataclass
class StragglerMonitor:
    slack: float = 2.0
    predicted_step_s: Optional[float] = None   # from the calibrated model
    on_straggler: Optional[Callable[[StragglerEvent], None]] = None
    window: int = 32

    _times: List[float] = field(default_factory=list)
    events: List[StragglerEvent] = field(default_factory=list)

    def expectation(self) -> Optional[float]:
        if self.predicted_step_s is not None:
            return self.predicted_step_s
        if len(self._times) >= 5:
            xs = sorted(self._times[-self.window:])
            return xs[len(xs) // 2]
        return None

    def observe(self, step: int, wall_s: float) -> Optional[StragglerEvent]:
        exp = self.expectation()
        if exp is not None and wall_s > self.slack * exp:
            # flagged samples stay OUT of the running-median window:
            # folding them in would inflate the expectation until
            # repeated stragglers look normal and mask themselves
            ev = StragglerEvent(step, wall_s, exp, wall_s / exp)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            return ev
        self._times.append(wall_s)
        return None
