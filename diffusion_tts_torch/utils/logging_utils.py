"""Tee logger and rank-0 printing (counterpart of
diffusion_tts_tpu/utils/logging_utils.py).

Counterparts of dnnlib.util.Logger (dnnlib/util.py:55-116) and
dist.print0 (torch_utils/distributed.py:55-57): ``print0`` prints on rank 0
of the process group only (in one process, always).
"""
from __future__ import annotations

import sys
from typing import TextIO

from diffusion_tts_torch.parallel.distributed import rank


class Logger:
    """Tee stdout/stderr to a log file."""

    def __init__(self, file_name: str | None = None, mode: str = "w", should_flush: bool = True):
        self.file: TextIO | None = open(file_name, mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None


def print0(*args, **kwargs) -> None:
    """Print on rank 0 only (distributed.py:55-57)."""
    if rank() == 0:
        print(*args, **kwargs)


def format_time(seconds: float) -> str:
    """dnnlib.util.format_time (dnnlib/util.py:138-152)."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 60 * 60:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 24 * 60 * 60:
        return f"{s // (60*60)}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return f"{s // (24*60*60)}d {(s // (60*60)) % 24:02d}h {(s // 60) % 60:02d}m"


__all__ = ["Logger", "print0", "format_time"]
