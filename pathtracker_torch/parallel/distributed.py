"""Multi-process bring-up (pathtracker_tpu/parallel/distributed.py:25-87).

The JAX package is one program over every device and joins hosts through
``jax.distributed``; here every process drives one card and the processes
join one ``torch.distributed`` process group. The environment contract is
the JAX package's:

    COORDINATOR_ADDRESS   host:port of rank 0 (a TCP rendezvous), or any
                          init_method URL, such as file:///shared/rendezvous
    NUM_PROCESSES         the world size (1 when unset)
    PROCESS_ID            this process's rank (0 when unset)
    LOCAL_RANK            the card of this process on its host (else
                          PROCESS_ID modulo the visible cards)

Usage (per process):
    from pathtracker_torch.parallel import distributed
    device = distributed.initialize()            # env-driven
    device = distributed.initialize("host0:1234", num_processes=4, process_id=rank)

The backend is NCCL on a card and gloo on the CPU unless named. Nothing falls
back: without a card, and without ``device="cpu"``, ``initialize`` raises.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from pathtracker_torch import resolve_device

_state = {"device": None}


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None,
               timeout_s: float = 1800.0) -> torch.device:
    """Join the process group once (later calls return the same device) and
    return this rank's device: ``cuda:<local rank>``, or the CPU where
    ``device`` asks for it. Arguments left None are read from the
    environment."""
    if dist.is_initialized():
        return _state["device"]
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not address:
        raise ValueError("no coordinator address: pass coordinator_address or set "
                         "COORDINATOR_ADDRESS")
    world = int(num_processes if num_processes is not None
                else os.environ.get("NUM_PROCESSES", 1))
    rank_ = int(process_id if process_id is not None
                else os.environ.get("PROCESS_ID", 0))
    if not 0 <= rank_ < world:
        raise ValueError(f"PROCESS_ID {rank_} outside a world of {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank_ % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=_init_method(address), world_size=world,
                            rank=rank_, timeout=datetime.timedelta(seconds=timeout_s))
    _state["device"] = dev
    return dev


def is_initialized() -> bool:
    return dist.is_initialized()


def device() -> torch.device | None:
    """This rank's device, once ``initialize`` has run."""
    return _state["device"] if dist.is_initialized() else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes logs and checkpoints."""
    return rank() == 0


def barrier(name: str, timeout_s: float = 600.0) -> None:
    """Align every rank at the point ``name`` names (the call site's label);
    a rank that does not arrive within ``timeout_s`` fails the barrier on
    gloo, whose monitored barrier names the missing ranks. A no-op without a
    group of more than one."""
    if world_size() <= 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.barrier(device_ids=[_state["device"].index])


def any_rank(flags) -> list[bool]:
    """For each flag, whether it is set on some rank: one collective, on
    every rank at the same point (a stop that one rank decides)."""
    flags = [bool(f) for f in flags]
    if world_size() <= 1:
        return flags
    t = torch.tensor(flags, dtype=torch.int32, device=_state["device"])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (picklable)."""
    if world_size() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_state["device"])
    return box[0]


def shutdown() -> None:
    """Leave the process group; ``initialize`` may join a new one after."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state["device"] = None
