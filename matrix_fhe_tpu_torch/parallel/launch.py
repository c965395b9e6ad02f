"""Run a function in k ranks of a ``torch.distributed`` world.

The JAX package tests its multi-device code on 8 virtual CPU devices in one
process (``tests/conftest.py``) and rehearses a multi-host run with
``tools/multihost_rehearsal.py``; here each device is a process.  ``run(fn,
k, *args)`` starts k fresh interpreters (spawned, never forked: a forked
CUDA context is unusable), and in each:

  * joins a world of k ranks with ``init_process_group(backend,
    init_method="file://<a temporary file>", rank, world_size)``: a file
    store, so that concurrent worlds (test workers) never race for a TCP
    port;
  * sets ``torch.set_num_threads(1)``;
  * computes on ``cuda:(rank % cards)`` (``api.rank_device``), or on the CPU
    with ``device="cpu"``;
  * calls ``fn(*args)`` and sends its result back (pickled: return CPU
    tensors or numpy arrays);
  * destroys the process group.

``fn`` and ``args`` reach the ranks through a temporary file, pickled once:
a process spawned with a larger pickle in its start-up pipe blocks the next
start until it has read it, so the ranks would start one after another.

The backend is NCCL where every rank has a card of its own, else gloo (NCCL
refuses two ranks on one device: "Duplicate GPU detected").  ``fn`` must be
a module-level function, importable in a fresh interpreter.  Returns the
ranks' results in rank order.  A rank that raises makes ``run`` raise with
its traceback, after the other ranks are stopped; so does a rank that dies,
or a world that outlives ``timeout`` seconds.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch

from matrix_fhe_tpu_torch.utils.device import resolve_device


def default_backend(world_size: int, device: torch.device) -> str:
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(call: str, rank: int, world_size: int, backend: str, store: str,
               device_type: str, results) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world_size)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # pickled here, not by the queue, whose pickler would hand a tensor over as
        # shared memory that vanishes when this process exits
        results.put((rank, True, pickle.dumps(out)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def run(fn, world_size: int, *args, device="cuda", timeout: float = 600.0) -> list:
    """``fn(*args)`` in each of ``world_size`` ranks (see the module
    docstring); the results in rank order."""
    device = resolve_device(device)
    backend = default_backend(world_size, device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    fd, store = tempfile.mkstemp(prefix="mfhe_world_")
    os.close(fd)
    os.unlink(store)  # the file store creates it
    call = store + ".call"
    with open(call, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(call, r, world_size, backend, store, device.type, results))
             for r in range(world_size)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {world_size} died "
                                       f"(exit code {procs[dead[0]].exitcode})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks ran over {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} raised:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
        results.close()
        for path in (store, call):
            if os.path.exists(path):
                os.unlink(path)
    return [out[r] for r in range(world_size)]
