"""Phase timers and argument logging for the command lines (port of
``piv_liteflownet_tpu/utils/timer.py``)."""

from __future__ import annotations

import time
from typing import Iterable


class TimerBlock:
    """Context manager printing ``  [t] msg`` lines and total elapsed time."""

    def __init__(self, title: str):
        print(f"{title}")
        self.start = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.end = time.perf_counter()
        self.interval = self.end - self.start
        status = "FAILED" if exc_type is not None else "Finished"
        print(f"  [{self.interval:.2f}s] {status}")

    def log(self, string: str) -> None:
        duration = time.perf_counter() - self.start
        print(f"  [{duration:.2f}s] {string}", flush=True)

    def log2file(self, fid: str, string: str) -> None:
        with open(fid, "a") as f:
            f.write(f"{string}\n")


def log_arguments(block: "TimerBlock", args, parser=None) -> None:
    """Log every parsed argument, those that differ from their default in magenta (when
    ``colorama`` is installed)."""
    try:
        import colorama

        reset = colorama.Style.RESET_ALL
        magenta = colorama.Fore.MAGENTA
    except ImportError:  # pragma: no cover
        reset = magenta = ""
    defaults = {}
    if parser is not None:
        for action in parser._actions:
            defaults[action.dest] = action.default
    for argument, value in sorted(vars(args).items()):
        is_default = argument in defaults and value == defaults[argument]
        color = reset if is_default else magenta
        block.log(f"{color}{argument}: {value}{reset}")


def set_proc_title(title: str) -> None:
    """Set the process title, when ``setproctitle`` is installed."""
    try:  # pragma: no cover
        import setproctitle

        setproctitle.setproctitle(title)
    except ImportError:
        pass


class IteratorTimer:
    """Wrap an iterable and record the last fetch latency."""

    def __init__(self, iterable: Iterable):
        self.iterable = iterable
        self.iterator = iter(self.iterable)
        self.last_duration = 0.0

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.iterable)

    def __next__(self):
        start = time.perf_counter()
        n = next(self.iterator)
        self.last_duration = time.perf_counter() - start
        return n

    next = __next__
