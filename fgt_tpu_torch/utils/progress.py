"""Terminal progress bar — the port's copy of
``fgt_tpu/utils/progress.py`` (reference FGT/utils/util.py:233-281
ProgressBar / tool/utils/common_utils.py:419-580 Progbar — one
implementation covers both surfaces). TTY-aware: on non-interactive
streams it degrades to periodic log lines instead of carriage-return
animation, so batch logs stay readable."""

from __future__ import annotations

import shutil
import sys
import time


class ProgressBar:
    def __init__(self, task_num: int = 0, bar_width: int = 50,
                 start: bool = True, stream=None):
        self.task_num = task_num
        self.stream = stream or sys.stdout
        cols = shutil.get_terminal_size((80, 24)).columns
        self.bar_width = max(10, min(bar_width, int(cols * 0.6),
                                     cols - 50))
        self.completed = 0
        self.start_time = time.time()
        self._tty = getattr(self.stream, "isatty", lambda: False)()
        self._last_log = 0.0
        if start:
            self.start()

    def start(self):
        self.start_time = time.time()
        if self._tty:
            if self.task_num > 0:
                self.stream.write(
                    f"[{' ' * self.bar_width}] 0/{self.task_num}, "
                    "elapsed: 0s, ETA:\nStart...\n")
            else:
                self.stream.write("completed: 0, elapsed: 0s")
            self.stream.flush()

    def update(self, msg: str = "In progress..."):
        self.completed += 1
        elapsed = max(time.time() - self.start_time, 1e-9)
        fps = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - pct) / max(pct, 1e-9) + 0.5)
            if self._tty:
                mark = int(self.bar_width * pct)
                bar = ">" * mark + "-" * (self.bar_width - mark)
                self.stream.write("\033[2F\033[J")
                self.stream.write(
                    f"[{bar}] {self.completed}/{self.task_num}, "
                    f"{fps:.1f} task/s, elapsed: {int(elapsed + 0.5)}s, "
                    f"ETA: {eta:5d}s\n{msg}\n")
                self.stream.flush()
            elif (time.time() - self._last_log > 5.0
                  or self.completed == self.task_num):
                self._last_log = time.time()
                self.stream.write(
                    f"{self.completed}/{self.task_num} "
                    f"({100 * pct:.0f}%), {fps:.1f} task/s, "
                    f"ETA {eta}s — {msg}\n")
                self.stream.flush()
        elif self._tty:
            self.stream.write(
                f"\rcompleted: {self.completed}, "
                f"elapsed: {int(elapsed + 0.5)}s, {fps:.1f} tasks/s")
            self.stream.flush()


class Progbar(ProgressBar):
    """Keras-style alias (reference common_utils.py Progbar): target-based
    constructor, ``add(n, values=...)`` interface."""

    def __init__(self, target: int, width: int = 30, stream=None):
        super().__init__(task_num=target, bar_width=width, start=True,
                         stream=stream)

    def add(self, n: int, values=None):
        msg = ", ".join(f"{k}: {v:.4g}" for k, v in (values or []))
        for _ in range(n):
            self.update(msg or "In progress...")
