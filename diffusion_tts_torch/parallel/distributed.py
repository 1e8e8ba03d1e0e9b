"""Process-group start-up and rank gating (counterpart of
diffusion_tts_tpu/parallel/distributed.py).

``distributed_init()`` is the reference's ``dist.init()``
(edm/torch_utils/distributed.py:14-31): it starts a ``torch.distributed``
group when torchrun's environment is present (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) and otherwise returns
``False`` and touches nothing, so a single-process run, the CPU tests
included, passes through unchanged. The JAX package triggers on
``JAX_COORDINATOR_ADDRESS`` instead.

Each rank runs on ``cuda:{LOCAL_RANK}``. NCCL refuses two ranks on one
card, so a launch with more ranks than cards must ask for gloo, which
stages CUDA tensors through host memory; its ranks then share the cards
(``cuda:{LOCAL_RANK % count}``). Nothing falls back to the CPU.

``launch`` starts such a group itself: n processes of one command with
torchrun's environment (``entry.dryrun_multichip`` and the tests use it).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import random
import socket
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def distributed_init(backend: str | None = None, timeout: float | None = None,
                     device: torch.device | str = "cuda") -> bool:
    """Start the process group from torchrun's environment; True when a
    group is (already or newly) up, False when the environment is absent.

    ``backend``: "nccl" or "gloo"; by default NCCL for ``device`` "cuda"
    and gloo for "cpu". ``timeout`` (seconds) bounds every collective, so
    a rank that waits on a lost peer raises instead of hanging."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ENV):
        return False
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (and the gloo "
                               "backend) to run the ranks on the CPU")
        local, count = int(os.environ["LOCAL_RANK"]), torch.cuda.device_count()
        if local >= count:
            if backend == "nccl":
                raise RuntimeError(
                    f"LOCAL_RANK {local} needs card {local} and this machine has {count}: "
                    f"NCCL takes one rank per card; use the gloo backend to let ranks "
                    f"share cards")
            print(f"rank {os.environ['RANK']}: LOCAL_RANK {local} shares cuda:{local % count} "
                  f"({count} card(s), gloo)", flush=True)
        torch.cuda.set_device(local % count)
    elif backend == "nccl":
        raise ValueError("NCCL needs CUDA; use the gloo backend on the CPU")
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, **kwargs)
    return True


@contextlib.contextmanager
def process_group(backend: str | None = None, timeout: float | None = None,
                  device: torch.device | str = "cuda"):
    """``distributed_init`` for the block; a group it started is destroyed
    at the end, one that was already up is left as it was."""
    started = not dist.is_initialized() and distributed_init(backend, timeout, device)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gating (reference get_rank() == 0, distributed.py:35-38)."""
    return rank() == 0


def rank_device(device: torch.device | str = "cuda") -> torch.device:
    """``device`` as this rank sees it: a bare "cuda" becomes the card
    ``distributed_init`` chose for the rank; anything else is unchanged."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


# bind() to port 0 and every connect() take their ports from Linux's
# ephemeral range (32768-60999 by default), so a port found free there can be
# taken by another socket (a NCCL bootstrap, a store client) before rank 0's
# store listens on it. Ports are drawn below that range instead.
PORTS = range(20000, 32768)
ATTEMPTS = 3


def free_port() -> int:
    """A port of ``PORTS`` that no socket holds now, drawn at random."""
    draw = random.SystemRandom()
    for _ in range(64):
        port = draw.randrange(PORTS.start, PORTS.stop)
        with socket.socket() as s:
            try:
                s.bind(("", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {PORTS.start}-{PORTS.stop - 1} after 64 draws")


def _run_ranks(argv: list[str], nprocs: int, port: int, timeout: float, env: dict,
               cwd: str | None) -> list[tuple[int, str, str]]:
    """One try of ``launch`` on ``port``: each rank's exit code, output and errors."""
    with tempfile.TemporaryDirectory() as tmp:
        procs, files = [], []
        for r in range(nprocs):
            penv = dict(env, MASTER_ADDR="localhost",
                        MASTER_PORT=str(port), RANK=str(r), LOCAL_RANK=str(r),
                        WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
            out, err = (open(os.path.join(tmp, f"{r}.{k}"), "w+") for k in ("out", "err"))
            files.append((out, err))
            procs.append(subprocess.Popen(argv, env=penv, cwd=cwd, stdout=out, stderr=err,
                                          text=True))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        ranks = []
        for p, (out, err) in zip(procs, files):
            out.seek(0), err.seek(0)
            ranks.append((p.returncode, out.read(), err.read()))
            out.close(), err.close()
    return ranks


def launch(argv: list[str], nprocs: int, *, timeout: float, env: dict | None = None,
           cwd: str | None = None) -> list[str]:
    """Run ``argv`` as ``nprocs`` local ranks with torchrun's environment
    (``MASTER_ADDR=localhost``, a free port; one OpenMP thread a rank
    unless ``OMP_NUM_THREADS`` is set, as torchrun does) and return each
    rank's standard output. When a rank fails or ``timeout`` seconds pass,
    every rank still running is killed and this raises with their errors.
    A rank 0 whose store finds its port taken (EADDRINUSE) fails before any
    rank has done work: the ranks are then started again on another port,
    up to ``ATTEMPTS`` times in all."""
    env = dict(os.environ if env is None else env)
    env.setdefault("OMP_NUM_THREADS", "1")
    for attempt in range(1, ATTEMPTS + 1):
        port = free_port()
        ranks = _run_ranks(argv, nprocs, port, timeout, env, cwd)
        failed = [f"rank {r} exited {rc}:\n{o}\n{e}"
                  for r, (rc, o, e) in enumerate(ranks) if rc]
        if not failed:
            return [o for _, o, _ in ranks]
        if attempt == ATTEMPTS or "EADDRINUSE" not in ranks[0][2]:
            raise RuntimeError(f"{' '.join(argv[:3])} ... over {nprocs} ranks failed "
                               f"(time limit {timeout} s, port {port}, attempt {attempt}):\n"
                               + "\n".join(failed))
        print(f"launch: port {port} was taken (EADDRINUSE); starting the {nprocs} ranks "
              f"again on another port", flush=True)


__all__ = ["distributed_init", "process_group", "is_main_process", "rank", "world_size",
           "rank_device", "launch", "free_port", "PORTS"]
