"""The control: the plain reference in the scheduler's place, summing in
float32 where the system states exact integer sums.

It serves the window's requests at the newest epoch the writer has
logged, one at a time, so a run drives it as it drives the system; the
check must then find its answers wrong.  Only the control's own tests and
the chip run of ``bench/test_bench_control.py`` use it, never the
command.
"""
from __future__ import annotations

import threading
import types

from bench.reference.replay import Replay
from bench.reference.ssb import TEMPLATES


class _Done:
    def __init__(self, response):
        self.response = response

    def wait(self, timeout=None):
        return self.response


class ControlServer:
    """``submit(name, params)`` answered by ``replay`` in float32."""

    def __init__(self, replay: Replay):
        self.replay = replay
        self.stats = {"submitted": 0, "completed": 0, "batches": 0}
        self._mu = threading.Lock()

    def start(self, n_dispatchers: int = 1) -> None:
        pass

    def close(self) -> None:
        pass

    def submit(self, name: str, params):
        with self._mu:
            log = self.replay.log
            epoch = log[-1].epoch if log else self.replay.epoch
            self.replay.advance_to(max(epoch, self.replay.epoch))
            total, groups = self.replay.answer(TEMPLATES[name], params,
                                               acc="float32")
            for k in ("submitted", "completed", "batches"):
                self.stats[k] += 1
            return _Done(types.SimpleNamespace(
                status="ok", epoch=self.replay.epoch, total=total,
                groups=groups))
