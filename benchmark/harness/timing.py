"""Device-side marks at the boundaries of passes and steps: CUDA events on
the card (read after the window, so they add no synchronisation), the
host clock on the CPU (for the CPU tests)."""
from __future__ import annotations

import time


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> int:
        """Record a mark; its index."""
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def ms(self, a: int, b: int) -> float:
        """Milliseconds from mark a to mark b (after a synchronisation)."""
        if self.cuda:
            return self.marks[a].elapsed_time(self.marks[b])
        return (self.marks[b] - self.marks[a]) * 1e3


class CallCounter:
    """Counts the calls of ``module.attr`` and keeps what ``record(*args,
    **kwargs)`` returns for each, while entered."""

    def __init__(self, module, attr: str, record):
        self.module, self.attr, self.record = module, attr, record
        self.calls = []

    def __enter__(self):
        self._orig = getattr(self.module, self.attr)

        def wrapped(*args, **kwargs):
            self.calls.append(self.record(*args, **kwargs))
            return self._orig(*args, **kwargs)

        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self._orig)
        return False
