"""The comparison that decides ``correct``: each sampled answer against the
reference at the epoch the answer reports."""
from __future__ import annotations

import dataclasses

import numpy as np

from bench.reference.replay import Replay
from bench.reference.ssb import TEMPLATES


@dataclasses.dataclass(frozen=True)
class Answer:
    """An ``ok`` answer as the system gave it."""

    name: str
    params: tuple[int, ...]
    epoch: int
    total: int
    groups: np.ndarray


def compare(answers: list[Answer], replay: Replay, *,
            acc: str = "int64") -> dict:
    """Hold every answer against ``replay`` at its epoch.

    Returns ``{"compared", "wrong", "examples"}``: an answer is wrong
    unless its total and every group equal the reference's exactly.
    ``acc`` is the reference's accumulation (``"float32"`` only for a
    control that computes in the system's place)."""
    wrong, examples = 0, []
    for a in sorted(answers, key=lambda a: a.epoch):
        replay.advance_to(a.epoch)
        total, groups = replay.answer(TEMPLATES[a.name], a.params, acc=acc)
        got = np.asarray(a.groups)
        if a.total == total and got.shape == groups.shape and \
                np.array_equal(got, groups):
            continue
        wrong += 1
        if len(examples) < 3:
            diff = int(np.count_nonzero(got != groups)) \
                if got.shape == groups.shape else -1
            examples.append(f"{a.name}{a.params}@{a.epoch}: total "
                            f"{a.total} vs {total}, {diff} groups differ")
    return {"compared": len(answers), "wrong": wrong, "examples": examples}
