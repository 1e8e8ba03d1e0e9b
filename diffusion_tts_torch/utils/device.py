"""Device selection for the port's entry points: the card by default, the
CPU only when the caller asks for it; and the profiler trace their
``--profile DIR`` options write."""
from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no card is
    present, rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def profiled(trace_dir: str | None, name: str, device: torch.device):
    """With ``trace_dir``, a torch.profiler trace of the block (host, and
    the card's kernels on a CUDA ``device``) written to
    ``trace_dir/name.json``; without, nothing."""
    if trace_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))


__all__ = ["resolve_device", "profiled"]
