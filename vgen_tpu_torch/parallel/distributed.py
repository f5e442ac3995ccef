"""Several processes, one scan: the torch.distributed bootstrap.

The counterpart of ``vgen_tpu/parallel/distributed.py``.  Run one process
per host with every card of the host visible, or one per card under
``torchrun``:

    # explicit bootstrap (any cluster), one process per host:
    VGEN_COORDINATOR=host0:8476 VGEN_NUM_PROCESSES=2 VGEN_PROCESS_ID=0 \\
        python -m vgen_tpu_torch generate -p '^1Cat' ...

    # torchrun sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK:
    torchrun --nproc-per-node 4 -m vgen_tpu_torch generate -p '^1Cat' ...

``VGEN_COORDINATOR`` is a host:port (a ``tcp://`` init method) or any
init method URL (``file://`` for processes of one machine).  The process
group uses NCCL when the process scans on the card and gloo on the CPU.
After initialization ``parallel.mesh.MeshScanner`` lays the windows of a
super-step over every process's devices in rank order, all-gathers the
packed rows, so every process re-derives (and can report) every match, and
draws a random scan's start on rank 0 for all.  Checkpoint files are
written by rank 0 only.

Unlike the reference, which warns and scans alone when
``jax.distributed.initialize`` fails (``vgen_tpu/cli.py:246-252``), a
failed initialization raises: a cluster that was asked for and not formed
would scan a fraction of the key space without a word.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

# set by torchrun (and torch.distributed.launch): the env:// init method
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# how long processes wait for each other to join, and on a collective:
# the reference's jax.distributed.initialize default
TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> bool:
    """Join the process group of a multi-process scan.

    Explicit arguments (or the VGEN_COORDINATOR / VGEN_NUM_PROCESSES /
    VGEN_PROCESS_ID variables) bootstrap any cluster; with neither, a
    ``torchrun`` launch is taken from its variables; with none of them this
    is a no-op.  ``device`` is what the process scans on: NCCL for the
    card, gloo for the CPU.  Safe to call again.  Returns True iff more
    than one process takes part; raises when the group cannot be formed.

    Call it before the first touch of the card (the CLI does, in
    ``resolve_device``)."""
    if is_initialized():
        return world_size() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("VGEN_COORDINATOR"))
    if num_processes is None and os.environ.get("VGEN_NUM_PROCESSES"):
        num_processes = int(os.environ["VGEN_NUM_PROCESSES"])
    if process_id is None and os.environ.get("VGEN_PROCESS_ID"):
        process_id = int(os.environ["VGEN_PROCESS_ID"])
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the number of processes "
                             "and this process's id (VGEN_NUM_PROCESSES, "
                             "VGEN_PROCESS_ID)")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    elif all(os.environ.get(k) for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        return False
    if backend == "nccl":
        # the collectives of this process run on its first card
        torch.cuda.set_device(local_cards()[0])
    return world_size() > 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_multi_host() -> bool:
    return world_size() > 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_cards() -> List[torch.device]:
    """The cards this process scans on: under torchrun (LOCAL_RANK set) its
    own card, else every visible card."""
    if os.environ.get("LOCAL_RANK") is not None:
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
