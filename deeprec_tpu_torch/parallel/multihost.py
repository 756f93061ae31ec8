"""Process-group set-up and input sharding for multi-rank runs.

Port of ``deeprec_tpu/parallel/multihost.py``. The JAX package runs one
SPMD program a host; here every rank is a process with one card, as
``torchrun`` starts them, and ranks talk through ``torch.distributed``:
NCCL between cards, gloo on the CPU. Each rank feeds its own slice of
the global batch, so there is no global array to assemble.

Typical launch, on each of N ranks (``torchrun --nproc_per_node=N``
sets the environment that ``initialize`` reads)::

    from deeprec_tpu_torch.parallel import multihost
    multihost.initialize()                       # NCCL, one card a rank
    mesh = multihost.global_data_mesh()
    group = EmbeddingGroup(cols, axis_name="data",
                           num_shards=mesh.size)
    ts = create_train_state(group, params, dopt, sopt, mesh=mesh)
    step = make_train_step(..., mesh=mesh)
    for local_batch in multihost.shard_iterator(files, parse):
        ts, m = step(ts, multihost.host_local_to_global(mesh, local_batch))
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from deeprec_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               device="cuda") -> None:
    """``torch.distributed.init_process_group`` for this rank.

    Arguments left out come from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``init_method`` ``env://``, which
    reads ``MASTER_ADDR`` and ``MASTER_PORT``). A single process with no
    ``init_method`` is a no-op. The backend is NCCL for
    ``device="cuda"``, which must then be there, and gloo for
    ``device="cpu"`` or ``backend="gloo"``. With NCCL the rank's card,
    ``LOCAL_RANK`` (else the rank), becomes the current device."""
    if dist.is_initialized():
        raise RuntimeError("the default process group is already "
                           "initialized")
    env = os.environ
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    if world_size == 1 and init_method is None:
        return
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: NCCL needs a CUDA card and "
                               "none is visible; pass device='cpu' for "
                               "gloo")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)


def global_data_mesh(axis_name: str = DATA_AXIS, device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the default group."""
    return Mesh(None, device, axis_name)


def _rank_and_size():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard(items: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> list:
    """Static per-rank partition of a work list (files, shards),
    round-robin: the simple alternative to the WorkQueue server."""
    r, n = _rank_and_size()
    pi = r if process_index is None else process_index
    pc = n if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]


def shard_iterator(items: Sequence, make_batches: Callable[[object],
                   Iterator], **shard_kw) -> Iterator:
    """Iterate batches from this rank's share of the work list."""
    for item in process_shard(items, **shard_kw):
        yield from make_batches(item)


def host_local_to_global(mesh: Mesh, host_batch):
    """This rank's batch onto its device. Each rank owns its slice of
    the global batch already, so nothing is assembled: the JAX
    package's global array is the ranks' slices taken together."""
    from deeprec_tpu_torch.feature_column.feature_column import batch_to
    return batch_to(host_batch, mesh.device)
