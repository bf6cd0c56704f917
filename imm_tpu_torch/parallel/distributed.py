"""Dataset sharding across processes. Mirrors the part of
``imm_tpu.parallel.distributed`` that the loaders use; the rest of that
module (process-group start-up, data-parallel steps) is ROADMAP.md, Queue 1
item 10.
"""

from __future__ import annotations

import torch.distributed as dist


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
