"""Multi-process start-up for real deployments (port of
``repro.launch.distributed``).

The dry run proves the mesh and sharding plan with a fake process group of
256 or 512 ranks in one process; on real hardware each GPU runs one process
of this same entry point and ``torch.distributed.init_process_group``
stitches them into one group. Environment contract (set by the scheduler or
launch script), as the reference's:

  REPRO_COORDINATOR   host:port of process 0       (e.g. 10.0.0.1:8476)
  REPRO_NUM_PROCESSES total process count          (e.g. 256 GPUs)
  REPRO_PROCESS_ID    this process's index

Where the reference falls back to Cloud TPU's metadata
(``REPRO_TPU_AUTODETECT``), the port reads what ``torchrun`` sets:
``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT`` (the
``env://`` rendezvous).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def _backend(device: DeviceLike) -> str:
    """NCCL on the card; gloo when the caller names the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(device: DeviceLike = None) -> bool:
    """Start the default process group if the environment contract is
    present: NCCL when a card is used (the default), gloo when the caller
    names the CPU. Returns True when the group was started; False (and
    nothing done) on a single process without the contract."""
    coord = os.environ.get("REPRO_COORDINATOR")
    nproc = os.environ.get("REPRO_NUM_PROCESSES")
    pid = os.environ.get("REPRO_PROCESS_ID")
    if coord and nproc and pid:
        backend = _backend(device)
        if backend == "nccl":
            torch.cuda.set_device(int(pid) % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=int(nproc), rank=int(pid))
        return True
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        backend = _backend(device)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return True
    return False


def describe_topology() -> str:
    """This process's place in the group, and the devices it sees."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return f"process {rank}/{world} local_devices={local} global_devices={world}"
