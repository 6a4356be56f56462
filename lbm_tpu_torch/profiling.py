"""Phase timers: the init/compute/collate/total wall-clock breakdown of
:class:`lbm_tpu.profiling.PhaseTimers`, copied because that module
imports jax. A phase that ends on device work must synchronise the
device before it stops."""

from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class PhaseTimers:
    """init/compute/collate wall-clock phases."""

    _marks: dict = dataclasses.field(default_factory=dict)
    elapsed: dict = dataclasses.field(default_factory=dict)

    def start(self, phase: str) -> None:
        self._marks[phase] = time.perf_counter()

    def stop(self, phase: str) -> None:
        self.elapsed[phase] = time.perf_counter() - self._marks.pop(phase)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)
