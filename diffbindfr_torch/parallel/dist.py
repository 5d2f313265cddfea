"""Multi-process runtime helpers: the port's counterpart of
diffbindfr_tpu/parallel/dist.py on torch.distributed.

`init_distributed` joins a process group when the caller gives a
coordinator (or the environment names one and a world size above 1):
`nccl` on the card, `gloo` when the caller asks for the CPU. With a world
size of 1 it does nothing. `shard_jobs_for_host` gives each process a
contiguous slice of the job table, the data-plane analogue of the
reference's SLURM job arrays.
"""
from __future__ import annotations

import os

# environment variables that name a coordinator (the JAX package's, plus
# torch's MASTER_ADDR)
_COORD_ENV = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "SLURM_JOB_NUM_NODES",
              "MEGASCALE_COORDINATOR_ADDRESS", "MASTER_ADDR")


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device: str = "cuda") -> tuple:
    """Join the process group (no-op for a single process). Returns
    (process_index, process_count).

    coordinator_address 'host:port' (else from the environment:
    COORDINATOR_ADDRESS / JAX_COORDINATOR_ADDRESS, or torch's MASTER_ADDR
    and MASTER_PORT); num_processes and process_id likewise (WORLD_SIZE /
    NUM_PROCESSES / SLURM_JOB_NUM_NODES and RANK / PROCESS_ID /
    SLURM_PROCID). device 'cuda' uses nccl, 'cpu' gloo."""
    import torch.distributed as td

    explicit = coordinator_address is not None
    env = any(k in os.environ for k in _COORD_ENV)
    world = num_processes if num_processes is not None else _env_world_size()
    if td.is_initialized():
        return td.get_rank(), td.get_world_size()
    if world <= 1 or not (explicit or env):
        return 0, 1
    if coordinator_address is None:
        coordinator_address = _env_address()
    rank = process_id if process_id is not None else _env_rank()
    backend = "gloo" if str(device) == "cpu" else "nccl"
    if backend == "nccl":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: nccl needs a CUDA device; pass device='cpu' "
                               "for gloo")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    td.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                          world_size=world, rank=rank)
    return td.get_rank(), td.get_world_size()


def _env_world_size() -> int:
    for k in ("SLURM_JOB_NUM_NODES", "NUM_PROCESSES", "WORLD_SIZE"):
        if k in os.environ:
            try:
                return int(os.environ[k])
            except ValueError:
                pass
    return 1


def _env_rank() -> int:
    for k in ("RANK", "PROCESS_ID", "SLURM_PROCID"):
        if k in os.environ:
            return int(os.environ[k])
    raise RuntimeError("init_distributed: no process_id given and none of RANK, PROCESS_ID, "
                       "SLURM_PROCID set")


def _env_address() -> str:
    for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
              "MEGASCALE_COORDINATOR_ADDRESS"):
        if k in os.environ:
            return os.environ[k]
    if "MASTER_ADDR" in os.environ:
        return f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    raise RuntimeError("init_distributed: no coordinator address given or set")


def _index_count() -> tuple:
    import torch.distributed as td

    if td.is_available() and td.is_initialized():
        return td.get_rank(), td.get_world_size()
    return 0, 1


def shard_jobs_for_host(jobs: list, process_index: int | None = None,
                        process_count: int | None = None) -> list:
    """Contiguous per-process slice of the job table."""
    pi, pc = _index_count()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    per = (len(jobs) + pc - 1) // pc
    return jobs[pi * per : (pi + 1) * per]


def is_main_process() -> bool:
    return _index_count()[0] == 0
