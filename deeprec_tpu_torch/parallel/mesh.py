"""The mesh: one axis of ranks that batches and table shards ride on.

Port of ``deeprec_tpu/parallel/mesh.py``. Where the JAX package builds a
``jax.sharding.Mesh`` over devices and runs the step inside
``shard_map``, here every rank is a process with one device, and a
:class:`Mesh` holds an initialized ``torch.distributed`` process group:
its rank and size, the rank's device and the axis name (``"data"``).
Rank ``r`` takes shard ``r`` of every row-sharded table and its own
slice of the global batch.

The collectives the sharded path needs are methods here, so the
backends' differences stay in one place: NCCL (the card, one rank a
card) takes ``all_gather_into_tensor``; gloo (the CPU tests) takes the
list form. A mesh whose ``trace`` is a list records each collective
there (its kind, the bytes this rank sends and, on a CUDA mesh, CUDA
events around it); ``trace = None``, the default, records nothing.

The tensor collectives can be captured in a CUDA graph on an NCCL mesh
(``train/loop.make_epoch_step(mesh=)``). While a capture is under way a
traced collective records its kind and bytes with no events, and
``"captured": True``: a captured event would time no replay. Replays
run no Python, so the trace holds each captured collective once.
``all_gather_object`` pickles on the host and raises inside a capture.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _capturing(device: torch.device) -> bool:
    """Whether this thread's current stream on ``device`` is capturing a
    CUDA graph."""
    return (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


class Mesh:
    """A 1-D mesh over the ranks of ``group`` (None: the default
    group), each on ``device`` (``"cuda"``: the rank's current card)."""

    def __init__(self, group=None, device="cuda",
                 axis_name: str = DATA_AXIS):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized process group "
                               "(parallel.multihost.initialize)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.axis_name = axis_name
        self.trace: Optional[list] = None

    def __repr__(self):
        return (f"Mesh({self.axis_name}: rank {self.rank} of {self.size}, "
                f"{self.backend}, {self.device})")

    @contextlib.contextmanager
    def _traced(self, kind: str, x: torch.Tensor):
        if self.trace is None:
            yield
            return
        rec = {"kind": kind, "bytes": x.numel() * x.element_size()}
        if _capturing(x.device):
            rec["captured"] = True
        elif x.device.type == "cuda":
            rec["events"] = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
            rec["events"][0].record()
        yield
        if "events" in rec:
            rec["events"][1].record()
        self.trace.append(rec)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Equal-split all-to-all along dim 0: ``x [S*K, ...]`` sends rows
        ``[j*K, (j+1)*K)`` to rank j; the result holds rank j's rows for
        this rank at ``[j*K, (j+1)*K)``. Its own transpose."""
        x = x.contiguous()
        out = torch.empty_like(x)
        with self._traced("all_to_all", x):
            dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x [n, ...]`` of every rank -> ``[S*n, ...]``, rank j's at
        ``[j*n, (j+1)*n)``."""
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with self._traced("all_gather", x):
            if self.backend == "nccl":
                dist.all_gather_into_tensor(out, x, group=self.group)
            else:
                dist.all_gather(list(out.chunk(self.size)), x,
                                group=self.group)
        return out

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns ``x``."""
        with self._traced("all_reduce", x):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (host data:
        checkpoint bookkeeping); never inside a CUDA graph capture."""
        if _capturing(self.device):
            raise RuntimeError("all_gather_object pickles on the host and "
                               "cannot run inside a CUDA graph capture")
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(group=None, device="cuda",
              axis_name: str = DATA_AXIS) -> Mesh:
    """A :class:`Mesh` over an initialized process group."""
    return Mesh(group, device, axis_name)


def data_mesh(n: Optional[int] = None, device="cuda") -> Mesh:
    """The 1-D data mesh over every rank of the default group; ``n``,
    where given, must be the group's size (a rank owns one device)."""
    mesh = Mesh(None, device, DATA_AXIS)
    if n is not None and n != mesh.size:
        raise ValueError(f"data_mesh({n}): the process group has "
                         f"{mesh.size} ranks")
    return mesh
