"""Process-group start-up and per-process data sharding. Mirrors
``imm_tpu.parallel.distributed``.

- ``cli.train`` calls :func:`initialize_multihost` before anything touches
  the device. Under ``torchrun --nproc_per_node=N -m imm_tpu_torch.cli.train``
  it forms the process group from the launcher's environment and pins each
  rank to its card (``LOCAL_RANK``); without a launcher it does nothing.
- ``build_experiment``'s file-backed path shards the dataset per process with
  :func:`process_shard_spec`: each rank loads and decodes only its slice of
  the files and feeds ``batch / world`` images a step.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from imm_tpu_torch.utils.device import get_device

# what torchrun (and torch.distributed.launch) set for every rank
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _env_int(name: str, default: int | None = None) -> int | None:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def initialize_multihost(
    device=None,
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    local_rank: int | None = None,
    timeout_s: float = 600.0,
) -> bool:
    """``torch.distributed.init_process_group`` from the launcher's
    environment, or from the arguments, which win over it.

    - ``world_size``/``rank``: default ``WORLD_SIZE``/``RANK``;
      ``init_method`` default ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``).
    - ``backend``: default ``nccl`` when ``device`` is CUDA (the default
      device), ``gloo`` on the CPU. ``gloo`` on CUDA is asked for by name:
      it lets ranks share one card, which NCCL refuses.
    - On CUDA the rank's card is ``local_rank`` (default ``LOCAL_RANK``,
      else 0), made the current device before the group forms.

    A no-op, returning False, when neither the environment nor the
    arguments give a world size, and when the group is up already (safe to
    call twice). Returns True when it formed the group. When a world of several
    processes is asked for and the group cannot form, it raises: N
    independent trainings must never run in silence.
    """
    if dist.is_available() and dist.is_initialized():
        return False
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    launched = all(os.environ.get(k) for k in _LAUNCHER_ENV) or init_method is not None
    if world is None or (world == 1 and not launched):
        return False  # no launcher, nothing asked for: one process
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this PyTorch build")
    rank = rank if rank is not None else _env_int("RANK", 0)
    dev = get_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank if local_rank is not None else _env_int("LOCAL_RANK", 0))
    try:
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    except Exception as e:
        raise RuntimeError(
            f"rank {rank} of {world}: the process group ({backend}) did not form; refusing "
            f"to train {world} independent models"
        ) from e
    return True


def process_shard_spec() -> tuple[int, int] | None:
    """(process_index, process_count) for dataset sharding; None unless
    ``torch.distributed`` is initialised with more than one process.

    Datasets slice their file/sequence lists as ``items[index::count]`` —
    interleaved, so sorted-by-subject orderings (e.g. H36M sequences) spread
    evenly across processes instead of giving each one a subject block.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return None
    count = dist.get_world_size()
    return (dist.get_rank(), count) if count > 1 else None


def shard_items(items, shard: tuple[int, int] | None):
    """Apply a (index, count) shard spec to a list (identity when None)."""
    if shard is None:
        return items
    index, count = shard
    if not 0 <= index < count:
        raise ValueError(f"bad shard spec: index {index} of {count}")
    return items[index::count]
