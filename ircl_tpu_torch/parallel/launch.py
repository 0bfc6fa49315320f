"""Start the ranks of a process group on this host, one process each.

The reference needs no launcher: one process drives every device. PyTorch
runs one process per device, so ``launch(fn, world_size, *args)`` spawns
``world_size`` ranks, joins them into one group and runs ``fn(*args)`` in
each:

- the ``spawn`` start method, never ``fork`` (CUDA cannot be initialized
  again in a forked child); ``fn`` must be a module-level function, and the
  module that holds it is imported afresh in every rank;
- rendezvous through a file in a temporary directory, so no TCP port is
  taken and launches running side by side cannot collide;
- the kernels are built once here, before the ranks start, so the ranks
  load one finished library instead of compiling it each;
- CPU ranks share the cores: each takes ``cpu_count // world_size`` torch
  threads;
- a rank that raises fails the launch with the traceback of every rank
  that failed (its peers' collectives break with it), and the other ranks
  are stopped.

Rank 0's result comes back (it must pickle: numpy arrays and Python values,
not tensors on the card). Under ``torchrun`` (``WORLD_SIZE`` in the
environment) or in a rank that is already in a group, ``launch`` joins that
group and runs ``fn`` in this process.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ircl_tpu_torch.parallel.mesh import DEFAULT_BACKENDS, in_process_group, join_env_group
from ircl_tpu_torch.utils.device import resolve_device

_GRACE_S = 10.0  # how long the other ranks may take to fail after the first


def backend_for(device, world_size: int) -> str:
    """The backend of ``world_size`` ranks on ``device``'s type (by default
    the card): gloo on the CPU; NCCL where the host has a card for every
    rank; otherwise gloo, whose collectives take CUDA tensors, so that
    several ranks share a card (NCCL cannot put two ranks on one card)."""
    if resolve_device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def launch(fn, world_size: int, *args, device=None, backend=None,
           timeout: float = 900.0):
    """``fn(*args)`` in ``world_size`` ranks on ``device``'s type (by
    default the card; ranks share the cards round robin), in a group of
    ``backend`` (NCCL on CUDA, gloo on the CPU unless named); rank 0's
    result. ``timeout`` seconds bound the whole launch."""
    device_type = resolve_device(device).type
    backend = backend or DEFAULT_BACKENDS[device_type]
    if in_process_group():
        join_env_group(device_type, backend)
        if dist.get_world_size() != world_size:
            raise ValueError(f"the group has {dist.get_world_size()} ranks, "
                             f"not {world_size}")
        return fn(*args)
    if device_type == "cuda":
        from ircl_tpu_torch.utils.kernel_build import load_kernels

        load_kernels()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ircl_ranks_") as tmp:
        # The call goes through a file: a start whose pickled arguments
        # exceed the pipe's buffer waits until that rank has imported
        # torch, which would start the ranks one after another.
        with open(os.path.join(tmp, "call"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [
            ctx.Process(target=_rank_main, name=f"rank{r}", args=(
                r, world_size, device_type, backend, tmp, timeout))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        try:
            _wait(procs, tmp, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        with open(os.path.join(tmp, "result"), "rb") as f:
            return pickle.load(f)


def _wait(procs, tmp: str, deadline: float) -> None:
    """Until every rank exits 0. Once one fails, the others get a moment to
    fail on their own (a rank's exception breaks the collectives its peers
    wait in, so the first rank to exit need not be the cause), and every
    failed rank's traceback is raised."""
    while True:
        if any(p.exitcode not in (None, 0) for p in procs):
            grace = time.monotonic() + _GRACE_S
            while any(p.exitcode is None for p in procs) and time.monotonic() < grace:
                time.sleep(0.02)
            raise RuntimeError("\n".join(_failures(procs, tmp)))
        if all(p.exitcode == 0 for p in procs):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"the ranks did not finish within the timeout: "
                               f"{[p.exitcode for p in procs]}")
        time.sleep(0.02)


def _failures(procs, tmp: str):
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"error{r}")
        if os.path.exists(err):
            with open(err) as f:
                yield f"rank {r} of {len(procs)} failed:\n{f.read()}"
        elif p.exitcode not in (None, 0):
            yield f"rank {r} of {len(procs)} failed: exit code {p.exitcode}"


def _rank_main(rank, world_size, device_type, backend, tmp, timeout):
    try:
        with open(os.path.join(tmp, "call"), "rb") as f:
            fn, args = pickle.load(f)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size))
        if device_type == "cuda":
            local = rank % torch.cuda.device_count()
            os.environ["LOCAL_RANK"] = str(local)
            torch.cuda.set_device(local)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dist.init_process_group(
            backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
            world_size=world_size, timeout=timedelta(seconds=timeout),
        )
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(tmp, "result.tmp"), "wb") as f:
                pickle.dump(out, f)
            os.replace(os.path.join(tmp, "result.tmp"), os.path.join(tmp, "result"))
        dist.barrier()
    except BaseException:
        # written before the group is torn down, which wakes the peers
        with open(os.path.join(tmp, f"error{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
