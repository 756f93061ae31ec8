"""Train state, the training step, the epoch step and the eval step.

Port of ``TrainState``, ``create_train_state``, ``make_train_step``
(micro-batches included), ``make_epoch_step``, ``stack_batches`` and
``make_eval_step`` from ``deeprec_tpu/train/loop.py``, single device
(``mesh=None``; the combine is ``group.combine`` or a ``combine_fn``
such as ``group.combine_tables``). Sharded steps are not ported yet.

The JAX package's ``make_epoch_step`` is one ``lax.scan`` over a stacked
batch pool: no host dispatch between steps. Here, on a CUDA card, the
step is captured once in a CUDA graph and replayed over the pool; on
the CPU it is a loop over the pool.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingGroup, SequenceEmbeddingColumn)
from deeprec_tpu_torch.utils import keys as keylib


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]      # dense model state dict
    ev: Dict[str, ev.EVState]            # EVState per table
    step: int = 0                        # global step
    slots: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dense_opt: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def create_train_state(group: EmbeddingGroup, params: Dict[str, torch.Tensor],
                       dense_opt=None, sparse_opt=None,
                       device="cuda") -> TrainState:
    """Fresh tables on ``device``, with the optimizers' state when they
    are given (a state that only serves needs neither)."""
    params = {k: v.to(device) for k, v in params.items()}
    return TrainState(
        params=params, ev=group.create_state(device),
        slots=(group.init_optimizer(sparse_opt, device)
               if sparse_opt is not None else {}),
        dense_opt=dense_opt.init(params) if dense_opt is not None else {})


def clone_state(x):
    """A deep copy of a ``TrainState`` (or of any of its parts): every
    tensor cloned on its device, so two runs can start from one state."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_state(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: clone_state(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def _micro(x, n: int, i: int):
    """Micro-batch ``i`` of ``n`` of a batch leaf (a tensor, or a
    ``SparseIds``/``CompactIds`` tuple of them) along its first axis."""
    if isinstance(x, tuple):
        return type(x)(*(_micro(f, n, i) for f in x))
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"into {n} micro-batches")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _train_body(group: EmbeddingGroup, apply_fn, loss_fn, sparse_opt,
                dense_opt, micro_batch_num: int, combine_fn):
    """``body(ts, batch, global_step) -> metrics``: one training step on
    ``ts``, in place, with ``global_step`` an int or a 0-dim int32
    tensor on the state's device (``ts.step`` is not touched)."""
    if combine_fn is not None and micro_batch_num != 1:
        raise ValueError("combine_fn requires micro_batch_num == 1")
    combine = combine_fn if combine_fn is not None else group.combine
    n_mb = micro_batch_num

    def grads_of(params, rows, batch, gl):
        out = apply_fn(params, combine(gl, rows), batch)
        per_ex = loss_fn(out, batch)
        loss = per_ex.sum() / (per_ex.shape[0] * n_mb)
        return loss, torch.autograd.grad(
            loss, list(params.values()) + list(rows.values()))

    def body(ts: TrainState, batch, gs):
        states, gl = group.lookup_train(ts.ev, batch, gs)
        rows = {t: lk.rows.detach().requires_grad_()
                for t, lk in gl.lks.items()}
        params = {k: v.detach().requires_grad_()
                  for k, v in ts.params.items()}
        if n_mb == 1:
            loss, grads = grads_of(params, rows, batch, gl)
        else:
            # The lookups ran once for the whole batch; the dense
            # forward and backward run per micro-batch, over its slice
            # of the batch leaves and of each column's inverse and mask,
            # and the gradients of the params and of the rows add up.
            loss = grads = None
            for i in range(n_mb):
                mb_gl = gl._replace(columns={
                    name: cl._replace(inverse=_micro(cl.inverse, n_mb, i),
                                      mask=_micro(cl.mask, n_mb, i))
                    for name, cl in gl.columns.items()})
                mb = {k: _micro(v, n_mb, i) for k, v in batch.items()}
                li, gi = grads_of(params, rows, mb, mb_gl)
                if grads is None:
                    loss, grads = li, gi
                else:
                    loss = loss + li
                    grads = [a + b for a, b in zip(grads, gi)]
        n_p = len(params)
        dense_opt.apply(ts.params, dict(zip(params, grads[:n_p])),
                        ts.dense_opt)
        group.apply_gradients(sparse_opt, ts.slots, states, gl,
                              dict(zip(rows, grads[n_p:])), gs)
        return {"loss": loss.detach(), "n_overflow": group.overflow_total(gl)}

    return body


def make_train_step(group: EmbeddingGroup, apply_fn: Callable,
                    loss_fn: Callable, sparse_opt, dense_opt,
                    micro_batch_num: int = 1,
                    combine_fn: Optional[Callable] = None):
    """``(TrainState, batch) -> (TrainState, metrics)``: lookup, combine,
    forward, loss ``sum(per_example) / B``, backward into the dense
    params and into each table's unique rows, dense and sparse applies.

    Unlike the JAX package's step, which returns new arrays, this step
    updates the state in place: the hash tables' key rows, the table
    rows, ``freqs`` and ``versions``, the optimizer slots (Adam's beta
    powers and count too) and the dense params all change in the
    tensors of the state passed in, and the returned state holds the
    same tensors with ``step`` advanced. It runs on the device the state
    lives on. ``metrics`` holds the loss and the ids the unique budgets
    dropped (``n_overflow``), as 0-dim tensors on that device.

    ``micro_batch_num > 1`` is the AutoMicroBatch role, as in the JAX
    package: the lookups run once for the whole batch, the dense forward
    and backward run on N sequential micro-batches whose gradients add
    up, and the loss is ``sum(per_example) / (B_mb * N)``.

    ``combine_fn`` overrides ``group.combine``: pass
    ``group.combine_tables`` with a matching fused ``apply_fn``
    (``wdl.apply_fn_fused``) to hand the model each table's occurrences
    in one tensor; it requires ``micro_batch_num == 1``.
    """
    body = _train_body(group, apply_fn, loss_fn, sparse_opt, dense_opt,
                       micro_batch_num, combine_fn)

    def _step(ts: TrainState, batch):
        metrics = body(ts, batch, ts.step)
        return ts.replace(step=ts.step + 1), metrics

    return _step


def stack_batches(batches):
    """Stack a list of same-shape batch dicts along a new leading axis
    (``SparseIds``/``CompactIds`` leaves field by field)."""
    out = {}
    for k, v in batches[0].items():
        vs = [b[k] for b in batches]
        if isinstance(v, tuple):
            out[k] = type(v)(*(torch.stack(f) for f in zip(*vs)))
        else:
            out[k] = torch.stack([torch.as_tensor(x) for x in vs])
    return out


def batch_at(stacked, k):
    """Batch ``k`` of a stacked pool (:func:`stack_batches`): ``k`` an
    int, or a one-element int64 tensor on the pool's device, read when
    the selection runs (no host read)."""
    def at(x):
        if isinstance(x, tuple):
            return type(x)(*(at(f) for f in x))
        if isinstance(k, torch.Tensor):
            return x.index_select(0, k)[0]
        return x[k]
    return {name: at(v) for name, v in stacked.items()}


def _pool_size(stacked) -> int:
    leaf = next(iter(stacked.values()))
    return (leaf[0] if isinstance(leaf, tuple) else leaf).shape[0]


@contextlib.contextmanager
def _no_host_sync():
    """Raise on any host synchronization inside (CUDA)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _capture(fn):
    """``fn`` captured in a CUDA graph (recorded, not run); returns the
    graph's replay."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


class EpochStep:
    """``epoch(ts, stacked) -> (ts, losses)``; see
    :func:`make_epoch_step`. After a call on the card, ``last_run``
    holds ``steps`` (E * K), ``replays`` (graph launches, E * K - 1),
    ``enqueue_s`` (host seconds spent enqueueing them) and ``events``
    (CUDA events recorded around them, read by :meth:`replay_ms`)."""

    def __init__(self, body, n_epochs: int):
        self.body = body
        self.n_epochs = n_epochs
        self.last_run: Dict[str, Any] = {}
        self._replay: Optional[Callable[[], None]] = None  # holds the graph

    def __call__(self, ts: TrainState, stacked):
        K = _pool_size(stacked)
        E = self.n_epochs
        dev = next(iter(ts.params.values())).device
        if dev.type == "cuda":
            self.release()
            losses = self._captured(ts, stacked, K, E, dev)
        else:
            losses = torch.stack([
                self.body(ts, batch_at(stacked, i % K),
                          ts.step + i)["loss"]
                for i in range(E * K)])
            self.last_run = {"steps": E * K, "replays": 0}
        ts = ts.replace(step=ts.step + E * K)
        return ts, (losses if E == 1 else losses.reshape(E, K))

    def _captured(self, ts, stacked, K: int, E: int, dev):
        n = E * K
        # Device counters: the global step, the pool index and the loss
        # slot, advanced in place by the step itself, so a replay needs
        # no host input.
        gs = torch.full((), ts.step, dtype=torch.int32, device=dev)
        k = torch.zeros(1, dtype=torch.int64, device=dev)
        pos = torch.zeros(1, dtype=torch.int64, device=dev)
        losses = torch.empty(n, dtype=torch.float32, device=dev)

        def one():
            m = self.body(ts, batch_at(stacked, k), gs)
            losses.index_copy_(0, pos, m["loss"].reshape(1))
            gs.add_(1)
            pos.add_(1)
            k.add_(1).remainder_(K)

        # Step 0 runs eagerly: it builds the kernels and warms the
        # libraries up, and it is the first of the E * K steps, so no
        # step is trained twice. Capture records and runs nothing; a
        # failed capture raises.
        one()
        self.last_run = {"steps": n, "replays": n - 1, "enqueue_s": 0.0,
                         "events": None}
        if n > 1:
            self._replay = _capture(one)
            events = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            t0 = time.perf_counter()
            with _no_host_sync():
                events[0].record()
                for _ in range(n - 1):
                    self._replay()
                events[1].record()
            self.last_run.update(enqueue_s=time.perf_counter() - t0,
                                 events=events)
        return losses

    def release(self):
        """Drop the last call's graph and return its private memory pool
        to the card, after its replays end (waits for them). Each call
        on the card does this first, so the card's reserved memory stays
        level from call to call."""
        if self._replay is None:
            return
        self.last_run["events"][1].synchronize()
        self._replay = None
        torch.cuda.empty_cache()

    def replay_ms(self) -> float:
        """Device milliseconds from the first replay of the last call on
        the card to the end of its last one (waits for the card)."""
        start, end = self.last_run["events"]
        end.synchronize()
        return start.elapsed_time(end)


def make_epoch_step(group: EmbeddingGroup, apply_fn: Callable,
                    loss_fn: Callable, sparse_opt, dense_opt,
                    n_epochs: int = 1, micro_batch_num: int = 1,
                    combine_fn: Optional[Callable] = None) -> EpochStep:
    """Whole passes over a stacked batch pool in one call.

    Returns ``epoch(ts, stacked) -> (ts, losses)``, where ``stacked``
    has a leading pool axis K on every leaf (:func:`stack_batches`
    builds it); ``losses`` is ``[K]`` for ``n_epochs == 1``, ``[E, K]``
    otherwise, and ``ts.step`` advances by E * K. The state updates in
    place, as in :func:`make_train_step`, which takes the same
    ``micro_batch_num`` and ``combine_fn``.

    On a CUDA card the first step runs eagerly; the step is then captured
    once in a CUDA graph that reads batch ``k`` of the pool through a
    device index, writes its loss into ``losses[e * K + k]`` and advances
    the global step and both indices itself, and the graph is replayed
    for the other E * K - 1 steps: one graph launch a step, no host
    read between the first replay and the last (the replays run under
    ``torch.cuda.set_sync_debug_mode("error")``). The same state and
    pool give the same bits as the eager loop. Each call captures anew,
    since the graph holds the addresses of the state and the pool; it
    first releases the previous call's graph and its memory pool
    (:meth:`EpochStep.release`). On the CPU it is a loop over the pool.
    """
    return EpochStep(_train_body(group, apply_fn, loss_fn, sparse_opt,
                                 dense_opt, micro_batch_num, combine_fn),
                     n_epochs)


@torch.no_grad()
def eval_embeddings(group: EmbeddingGroup, ts: TrainState, batch):
    """The embedding dict the eval step hands the model: every id
    occurrence looked up on its own (identity ``inverse``), bags
    combined, sequence columns as ``(rows, mask)``; no mutation."""
    embs = {}
    for tname, tcols in group._columns_by_table().items():
        cfg = group.tables[tname]
        ids_hi, ids_lo, widths = group._packed_view(batch, tname, tcols)
        mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
        B, L = ids_hi.shape
        rows = ev.lookup(cfg, ts.ev[tname], ids_hi.reshape(-1),
                         ids_lo.reshape(-1))
        inverse = torch.arange(B * L, device=rows.device).reshape(B, L)
        off = 0
        for c, w in zip(tcols, widths):
            inv_c, m_c = inverse[:, off:off + w], mask[:, off:off + w]
            if isinstance(c, SequenceEmbeddingColumn):
                embs[c.name] = (rows[inv_c] * m_c[..., None].to(rows.dtype),
                                m_c)
            else:
                embs[c.name] = lkup.combine_bags(rows, inv_c, m_c,
                                                 c.combiner)
            off += w
    return embs


def make_eval_step(group: EmbeddingGroup, apply_fn: Callable):
    """``(TrainState, batch) -> model outputs``, no mutation, over
    :func:`eval_embeddings`, as the JAX package's unsharded eval."""

    @torch.no_grad()
    def _eval(ts: TrainState, batch):
        return apply_fn(ts.params, eval_embeddings(group, ts, batch), batch)

    return _eval
