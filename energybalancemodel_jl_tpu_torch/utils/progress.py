"""Throttled terminal progress meter.

Rebuild of the reference's ``Progress``/``update!``
(EnergyBalanceModel.jl src/utilities.jl:18-55,173-279): a title line, a
current/total bar with percentage, elapsed/remaining time, a steps-per-second
throughput meter, a spinner, and an optional user info line. Doubles as the
framework's throughput observability hook — ``integrate`` feeds it once per
simulated year and it reports model steps/sec (the reference updates per step;
the fused year kernel runs a whole year per launch, so per-year is the
natural host-visible granularity).
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["Progress", "update"]

_RUNNERS = ("◓", "◑", "◒", "◐")  # same glyphs as reference :51


def _display_time(seconds: float) -> str:
    """``m:ss`` or ``-:--`` when unknown (EnergyBalanceModel.jl src/utilities.jl:173-182)."""
    if not (seconds == seconds) or seconds in (float("inf"), float("-inf")):
        return "-:--"
    t = int(round(seconds))
    return f"{t // 60}:{t % 60:02d}"


class Progress:
    """Throttled progress bar.

    Parameters mirror the reference constructor
    (EnergyBalanceModel.jl src/utilities.jl:33-54): ``total`` steps, a ``title``,
    an update throttle ``freq`` in seconds, display ``width``, and an
    ``infofeed`` callable rendering a custom info line from feed args.
    """

    def __init__(
        self,
        total: int,
        title: str = "Progress",
        freq: float = 1.0,
        width: int = 50,
        infofeed: Optional[Callable[..., str]] = None,
        stream=None,
    ):
        self.total = int(total)
        self.title = title
        self.freq = float(freq)
        self.width = width
        self.infofeed = infofeed or (lambda *a: "")
        self.stream = stream if stream is not None else sys.stdout
        self.current = -1
        self.last = 0
        self.started: Optional[float] = None
        self.updated: Optional[float] = None
        self.updates = 0
        self.lines = 0
        ndig = len(str(self.total))
        self.barwidth = max(width - (ndig * 2 + 1) - 2 - 5 - 3, 5)
        self.enabled = hasattr(self.stream, "isatty") and self.stream.isatty()
        # updates may arrive from more than one thread — serialize state +
        # rendering
        self._lock = threading.Lock()

    # -- rendering -------------------------------------------------------
    def _output(self, feedargs=()) -> None:
        now = time.time()
        if self.current > self.total or not self.enabled:
            return
        out = self.stream
        while self.lines > 0:
            out.write("\033[A\033[2K")
            self.lines -= 1
        out.write(f"\033[1;33m{self.title}\033[0m\n")
        self.lines += 1
        elapsed = _display_time(now - (self.started or now))
        ndig = len(str(self.total))
        done = self.current >= self.total
        if done:
            bar = "━" * self.barwidth
            pct = f"{round(self.current / self.total * 100):d}%"
            speed = self.current / max(now - (self.started or now), 1e-9)
            prompt = "\033[1;32mDone\033[0m ✓"
            barline = f"{self.current:>{ndig + 1}}/{self.total} [\033[32m{bar}\033[0m] {pct:>5}"
        else:
            filled = int(self.current / self.total * self.barwidth)
            bar = (
                "━" * filled
                + "❯"
                + "─" * max(self.barwidth - filled - 1, 0)
            )
            pct = f"{self.current / self.total * 100:.1f}%"
            dt = now - (self.updated or now)
            speed = (self.current - self.last) / dt if dt > 0 else float("nan")
            runner = _RUNNERS[self.updates % len(_RUNNERS)]
            prompt = f"\033[1;36mIn progress\033[0m {runner}"
            barline = f"{self.current:>{ndig + 1}}/{self.total} [\033[36m{bar}\033[0m] {pct:>5}"
        togo = _display_time(
            (self.total - self.current) / speed if speed and speed == speed else float("nan")
        )
        if speed != speed:
            spdstr = "-/sec"
        elif speed >= 1.0 or speed == 0.0:
            spdstr = f"{speed:.2f}/sec"
        else:
            spdstr = f"{1.0 / speed:.2f}sec/1"
        self.last = self.current
        self.updated = now
        self.updates += 1
        timespeed = f" {elapsed}/-{togo} {spdstr}"
        pad = " " * max(self.width - len(timespeed) - 13, 1)
        out.write(barline + "\n")
        self.lines += 1
        out.write(timespeed + pad + prompt + "\n")
        self.lines += 1
        user = str(self.infofeed(*feedargs))
        if user:
            for line in user.split("\n"):
                out.write(f" \033[2m{line}\033[0m\n")
                self.lines += 1
        out.flush()

    # -- public API ------------------------------------------------------
    def update(self, current: Optional[int] = None, feedargs=()) -> None:
        """Advance the meter (rebuild of ``update!``
        EnergyBalanceModel.jl src/utilities.jl:266-279); renders at most every
        ``freq`` seconds, and always on completion."""
        with self._lock:
            self.current = self.current + 1 if current is None else int(current)
            now = time.time()
            if self.started is None:
                self.started = now
                self.updated = now - self.freq  # force immediate first render
            if self.current >= self.total or now - self.updated >= self.freq:
                self._output(feedargs)

    @property
    def rate(self) -> float:
        """Overall steps/sec since start (throughput observability)."""
        if self.started is None or self.current <= 0:
            return float("nan")
        return self.current / max(time.time() - self.started, 1e-9)


def update(prog: Progress, current: Optional[int] = None, feedargs=()) -> None:
    """Functional alias matching the reference's exported ``update!``."""
    prog.update(current, feedargs)
