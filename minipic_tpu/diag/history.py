"""Per-step observability (SURVEY.md §5: the reference has no runtime
metrics — proposed MPI_Wtime timing was never implemented).  Here every
step returns StepDiag scalars computed on device; this module accumulates
them on the host and adds wall-clock throughput."""
from __future__ import annotations

import json
import time
from typing import List, Optional


class RunHistory:
    """Collects StepDiag + timing into plain lists; serializable to JSON."""

    def __init__(self):
        self.steps: List[int] = []
        self.time: List[float] = []
        self.field_energy: List[float] = []
        self.kinetic_energy: List[list] = []
        self.overflow: List[int] = []
        self.wall: List[float] = []
        # max/mean of StepDiag.shard_live: the cross-chip work skew
        # (1.0 = perfectly balanced; occupancy-bounded kernels make the
        # slowest chip ~ the max entry).
        self.live_skew: List[float] = []
        self.rebinned: List[int] = []  # 1 where the step re-binned
        self._t0 = time.perf_counter()

    def record(self, step: int, dt: float, diag) -> None:
        self.steps.append(int(step))
        self.time.append(float(step * dt))
        self.field_energy.append(float(diag.field_energy))
        self.kinetic_energy.append([float(k) for k in diag.kinetic_energy])
        self.overflow.append(int(diag.overflow))
        self.rebinned.append(int(getattr(diag, "rebinned", 0)))
        live = getattr(diag, "shard_live", None)
        if live is not None and len(live) > 0:
            import numpy as _np

            arr = _np.asarray(live, dtype=_np.float64)
            mean = arr.mean()
            self.live_skew.append(float(arr.max() / mean) if mean > 0 else 1.0)
        self.wall.append(time.perf_counter() - self._t0)

    def total_energy(self) -> list:
        return [f + sum(k) for f, k in zip(self.field_energy, self.kinetic_energy)]

    def energy_drift(self) -> float:
        tot = self.total_energy()
        if not tot or tot[0] == 0:
            return 0.0
        return max(abs(t - tot[0]) for t in tot) / abs(tot[0])

    def steps_per_sec(self) -> Optional[float]:
        if len(self.wall) < 2:
            return None
        return (self.steps[-1] - self.steps[0]) / max(1e-9, self.wall[-1] - self.wall[0])

    def to_json(self) -> str:
        return json.dumps(
            {
                "steps": self.steps,
                "time": self.time,
                "field_energy": self.field_energy,
                "kinetic_energy": self.kinetic_energy,
                "overflow": self.overflow,
                "wall": self.wall,
                "live_skew": self.live_skew,
                "rebinned": self.rebinned,
            }
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
