"""A world of ranks: the port's stand-in for the JAX package's devices.

``launch(fn, n, device, args)`` starts ``n`` processes (the ``spawn``
start method: a parent that has touched CUDA cannot ``fork`` safely),
joins them in one gloo process group through a ``FileStore`` in a
temporary directory (no TCP port, so concurrent test workers cannot
collide), and calls ``fn(rank, device, *args)`` in each. Rank ``r`` runs
on ``cuda:(r % device_count)``, so the ranks of a one-card machine share
the card (NCCL refuses two ranks on one GPU; gloo does not), or on the
CPU with one thread when the caller asks for ``device="cpu"``; a CUDA
rank gets its share of the host's cores. A rank asked for CUDA that
finds none raises.

Each rank's return value comes back to the caller (``torch.save`` to a
file of the temporary directory, loaded on the CPU), in rank order. A rank
that raises or dies ends the world and ``launch`` raises with its
traceback. ``timeout`` (seconds, None by default: no limit) bounds the
world's run, and the wait of a collective for its peers: a world still
running then is killed and ``launch`` raises ``TimeoutError``. Without
one a collective waits torch's default for a process group (30 min).
``fn`` must be importable by name (a module-level function): the
children unpickle it.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def rank_device(rank, device):
    """The device of ``rank``: ``cuda:(rank % device_count)`` or the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: CUDA was requested but "
                           f"torch.cuda.is_available() is False")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, n, device, fn, args, tmp, timeout):
    dev = rank_device(rank, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        # the ranks share the host's cores: its host code (model build,
        # data, eager dispatch) would oversubscribe them
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=n,
        timeout=None if timeout is None else timedelta(seconds=timeout))
    try:
        result = fn(rank, dev, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time():.6f}\nrank {rank}:\n"
                    f"{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _errors(tmp):
    """The ranks' tracebacks, the first raised first (the others are
    mostly its echo: a peer's connection closed)."""
    found = []
    for name in os.listdir(tmp):
        if name.endswith(".err"):
            with open(os.path.join(tmp, name)) as f:
                stamp, text = f.read().split("\n", 1)
            found.append((float(stamp), text))
    return "".join(text for _, text in sorted(found))


def _build_kernels():
    """Build the CUDA libraries once in the parent: the ranks load them
    and do not start ``nvcc`` side by side."""
    from millieye_torch.ops import cuda_lib
    cuda_lib.build()


def launch(fn, n, device="cuda", args=(), timeout=None):
    """[fn(rank, rank's device, *args) for each rank], run in ``n``
    processes of one gloo world; raises if a rank fails or the world
    outlives ``timeout`` seconds (None: no limit)."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: CUDA was requested but "
                               "torch.cuda.is_available() is False")
        _build_kernels()
    tmp = tempfile.mkdtemp(prefix="millieye_world_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(n, str(device), fn, tuple(args), tmp,
                              timeout),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"launch: a world of {n} ranks still "
                                       f"ran after {timeout:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
            raise RuntimeError(f"launch: a rank of a world of {n} failed:\n"
                               f"{_errors(tmp) or err}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
