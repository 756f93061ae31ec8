"""Train state, the training step, the epoch step and the eval step.

Port of ``TrainState``, ``create_train_state``, ``make_train_step``
(micro-batches included), ``make_epoch_step``, ``stack_batches`` and
``make_eval_step`` from ``deeprec_tpu/train/loop.py`` (the combine is
``group.combine`` or a ``combine_fn`` such as ``group.combine_tables``).

With ``mesh`` (``parallel.mesh.Mesh``) the train and eval steps run on
every rank of the mesh, each on its local batch and its shard of each
sharded table, as the JAX package's ``shard_map`` branches do: the loss
is divided by ``B_local * S``; the dense gradients and the replicated
tables' row gradients are summed over the ranks in one all-reduce (the
sum that JAX's ``shard_map`` autodiff makes for device-invariant
inputs), so every rank applies the same dense update; the loss and
``n_overflow`` are summed too.

The JAX package's ``make_epoch_step`` is one ``lax.scan`` over a stacked
batch pool: no host dispatch between steps. Here, on a CUDA card, the
step is captured once in a CUDA graph and replayed over the pool, on an
NCCL mesh with its collectives inside the graph; on the CPU, and on a
gloo mesh (whose collectives cannot be captured), it is a loop over the
pool.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from deeprec_tpu_torch.embedding import adaptive as adlib
from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.embedding import sharded as shlib
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingGroup, SequenceEmbeddingColumn)
from deeprec_tpu_torch.utils import keys as keylib
from deeprec_tpu_torch.utils import trace


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
                       device="cuda", mesh=None) -> TrainState:
    """Fresh tables on ``device``, with the optimizers' state when they
    are given (a state that only serves needs neither). On a ``mesh``
    the sharded tables are this rank's shards; every rank must pass the
    same ``params``."""
    params = {k: v.to(device) for k, v in params.items()}
    shard = 0 if mesh is None else mesh.rank
    return TrainState(
        params=params, ev=group.create_state(device, shard),
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


def _all_reduce_flat(mesh, tensors) -> None:
    """Sum ``tensors`` over the ranks in place, one all-reduce a dtype
    over their concatenation."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = mesh.all_reduce_(torch.cat([t.reshape(-1) for t in ts]))
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def _train_body(group: EmbeddingGroup, apply_fn, loss_fn, sparse_opt,
                dense_opt, micro_batch_num: int, combine_fn, mesh=None):
    """``body(ts, batch, global_step) -> metrics``: one training step on
    ``ts``, in place, with ``global_step`` an int or a 0-dim int32
    tensor on the state's device (``ts.step`` is not touched)."""
    if combine_fn is not None and micro_batch_num != 1:
        raise ValueError("combine_fn requires micro_batch_num == 1")
    combine = combine_fn if combine_fn is not None else group.combine
    n_mb = micro_batch_num
    n_ranks = 1 if mesh is None else mesh.size

    def grads_of(params, rows, batch, gl):
        with trace.span("forward"):
            out = apply_fn(group.model_params(params),
                           combine(gl, rows, params), batch)
            per_ex = loss_fn(out, batch)
            loss = per_ex.sum() / (per_ex.shape[0] * n_mb * n_ranks)
        with trace.span("backward"):
            return loss, torch.autograd.grad(
                loss, list(params.values()) + list(rows.values()))

    def body(ts: TrainState, batch, gs):
        states, gl = group.lookup_train(ts.ev, batch, gs, mesh)
        # Adaptive tables: newly hot uniques take their static row as
        # this step's row (no-op without adaptive tables).
        states, gl = group.migrate_adaptive(states, gl, ts.params)
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
        dense_g = dict(zip(params, grads[:n_p]))
        row_g = dict(zip(rows, grads[n_p:]))
        loss = loss.detach()
        overflow = group.overflow_total(gl)
        if mesh is not None:
            _all_reduce_flat(mesh, list(dense_g.values()) + [
                g for t, g in row_g.items() if group._is_replicated(t)])
            tot = mesh.all_reduce_(torch.stack([loss.to(torch.float64),
                                                overflow.to(torch.float64)]))
            loss, overflow = tot[0].to(loss.dtype), tot[1].to(torch.int32)
        with trace.span("dense_apply"):
            dense_opt.apply(ts.params, dense_g, ts.dense_opt)
        group.apply_gradients(sparse_opt, ts.slots, states, gl, row_g, gs)
        return {"loss": loss, "n_overflow": overflow}

    return body


def make_train_step(group: EmbeddingGroup, apply_fn: Callable,
                    loss_fn: Callable, sparse_opt, dense_opt,
                    micro_batch_num: int = 1,
                    combine_fn: Optional[Callable] = None, mesh=None):
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

    ``mesh``: the step runs on each rank of it, on the rank's local
    batch and state (the module docstring says what is summed); the
    metrics are the global batch's on every rank.

    While tracing is on (``utils/trace.py``) the step records the spans
    ``lookup/<table>`` (with ``probe``, ``draw`` and ``fetch``),
    ``forward`` (combine, towers, loss), ``backward``, ``dense_apply``
    and ``sparse_apply/<table>``, and counts each table's counters
    (:meth:`EmbeddingGroup.lookup_train`); off, it does neither.
    """
    body = _train_body(group, apply_fn, loss_fn, sparse_opt, dense_opt,
                       micro_batch_num, combine_fn, mesh)

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


def _capture(fn, mesh=None):
    """``fn`` captured in a CUDA graph (recorded, not run); returns the
    graph's replay. With an NCCL ``mesh`` the graph holds the
    collectives: the card is drained first, so no collective of an
    eager step is still in flight, and the capture is checked on this
    thread alone ("thread_local"), as the process group's watchdog
    thread queries the events of its finished work meanwhile."""
    graph = torch.cuda.CUDAGraph()
    mode = "global"
    if mesh is not None:
        torch.cuda.synchronize()
        mode = "thread_local"
    with torch.cuda.graph(graph, capture_error_mode=mode):
        fn()
    return graph.replay


_MEMORY_COUNTS = ("num_device_alloc", "num_device_free",
                  "num_sync_all_streams")


def _memory_counts() -> Dict[str, int]:
    """The caching allocator's ``cudaMalloc`` and ``cudaFree`` calls and
    syncs of every stream so far (zeros before CUDA is initialised)."""
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in _MEMORY_COUNTS}


class EpochStep:
    """``epoch(ts, stacked) -> (ts, losses)``; see
    :func:`make_epoch_step`. After a call, ``last_run`` holds ``steps``
    (E * K), ``captured`` (whether the step ran as a CUDA graph) and
    ``replays`` (graph launches: E * K - 1 when captured, else 0).

    A captured call's ``last_run`` is its record, which
    ``utils.trace.recorder.calls`` also keeps:

    * ``call``: the call's sequence number in the process;
    * ``events``: CUDA events recorded around the replays (read by
      :meth:`replay_ms`; None for a call of one step), and
      ``enqueue_s``, the host seconds spent enqueueing the replays;
    * ``release_events``: CUDA events at the top and at the end of the
      :meth:`release` that ran since the previous call, whoever called
      it (None where none did), and ``step0_event``, at the end of eager
      step 0. All are recorded on the one stream outside the capture,
      so after the previous call's ``events[1]`` they split the device's
      gap up to this call's ``events[0]`` into the caller's work between
      the calls, the release, step 0 (with the call's own set-up) and
      the capture;
    * ``host_ns``: host nanoseconds of the phases ``epoch.release.wait``
      (the wait for the previous call's replays), ``epoch.release.free``
      (dropping its graph and ``torch.cuda.empty_cache()``),
      ``epoch.step0`` (from the release's end), ``epoch.capture.enter``
      (the ``torch.cuda.graph`` entry, up to the first line inside the
      block), ``epoch.capture.record`` (the step recorded),
      ``epoch.capture.instantiate`` (the block's exit) and
      ``epoch.enqueue`` (the replays'); while tracing is on each phase
      is also a span (``utils/trace.py``);
    * ``memory``: how much ``torch.cuda.memory_stats()``'s
      ``num_device_alloc``, ``num_device_free`` and
      ``num_sync_all_streams`` grew from the release (else the call's
      start) to the call's end;
    * ``counters``: with tracing on, the counters of the call's steps,
      eager step 0's and every replay's (``EmbeddingGroup.lookup_train``
      names them; read them after the call); else None.
    """

    def __init__(self, body, n_epochs: int, mesh=None):
        self.body = body
        self.n_epochs = n_epochs
        self.mesh = mesh
        self.last_run: Dict[str, Any] = {}
        self._replay: Optional[Callable[[], None]] = None  # holds the graph
        # The next captured call's record, opened by a release before it.
        self._next: Optional[Dict[str, Any]] = None

    def __call__(self, ts: TrainState, stacked):
        K = _pool_size(stacked)
        E = self.n_epochs
        dev = next(iter(ts.params.values())).device
        if dev.type == "cuda" and (self.mesh is None
                                   or self.mesh.backend == "nccl"):
            losses = self._captured(ts, stacked, K, E, dev)
        else:
            losses = torch.stack([
                self.body(ts, batch_at(stacked, i % K),
                          ts.step + i)["loss"]
                for i in range(E * K)])
            self.last_run = {"steps": E * K, "captured": False,
                             "replays": 0}
        ts = ts.replace(step=ts.step + E * K)
        return ts, (losses if E == 1 else losses.reshape(E, K))

    def _open(self) -> Dict[str, Any]:
        """The next captured call's record, opened by whichever comes
        first: a release or the call."""
        if self._next is None:
            self._next = {"call": trace.recorder.next_call(), "host_ns": {},
                          "release_events": None,
                          "memory": _memory_counts()}
        return self._next

    def _captured(self, ts, stacked, K: int, E: int, dev):
        rec = self._open()
        self.release()
        self._next = None
        phases = trace.Phases(rec["host_ns"], rec["call"])
        phases.next("epoch.step0")
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

        def recorded():
            # Runs once, while the graph records the step.
            phases.next("epoch.capture.record")
            one()
            phases.next("epoch.capture.instantiate")

        # Step 0 runs eagerly: it builds the kernels, warms the libraries
        # up, makes the counters' accumulators while tracing is on and,
        # on a mesh, creates the NCCL communicators; it is the first of
        # the E * K steps, so no step is trained twice. Capture records
        # and runs nothing; a failed capture raises. Every rank of a mesh
        # captures and replays its own graph, E * K - 1 times, in
        # lockstep with the others.
        with trace.recorder.call_counters() as counters:
            one()
            step0 = torch.cuda.Event(enable_timing=True)
            step0.record()
            rec.update(steps=n, captured=True, replays=n - 1,
                       enqueue_s=0.0, events=None, step0_event=step0,
                       counters=counters)
            self.last_run = rec
            if n > 1:
                phases.next("epoch.capture.enter")
                self._replay = _capture(recorded, self.mesh)
                events = tuple(torch.cuda.Event(enable_timing=True)
                               for _ in range(2))
                phases.next("epoch.enqueue")
                t0 = time.perf_counter()
                with _no_host_sync():
                    events[0].record()
                    for _ in range(n - 1):
                        self._replay()
                    events[1].record()
                rec.update(enqueue_s=time.perf_counter() - t0,
                           events=events)
        phases.stop()
        now = _memory_counts()
        rec["memory"] = {c: now[c] - rec["memory"][c] for c in now}
        trace.recorder.calls.append(rec)
        return losses

    def release(self):
        """Drop the last call's graph and return its private memory pool
        to the card, after its replays end (waits for them). Each call
        on the card does this first, so the card's reserved memory stays
        level from call to call. The next call's record holds this
        release's events and times."""
        if self._replay is None:
            return
        rec = self._open()
        top = torch.cuda.Event(enable_timing=True)
        top.record()
        phases = trace.Phases(rec["host_ns"], rec["call"])
        phases.next("epoch.release.wait")
        self.last_run["events"][1].synchronize()
        phases.next("epoch.release.free")
        self._replay = None
        torch.cuda.empty_cache()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        phases.stop()
        rec["release_events"] = (top, end)

    def replay_ms(self) -> float:
        """Device milliseconds from the first replay of the last call on
        the card to the end of its last one (waits for the card)."""
        start, end = self.last_run["events"]
        end.synchronize()
        return start.elapsed_time(end)


def make_epoch_step(group: EmbeddingGroup, apply_fn: Callable,
                    loss_fn: Callable, sparse_opt, dense_opt,
                    n_epochs: int = 1, micro_batch_num: int = 1,
                    combine_fn: Optional[Callable] = None,
                    mesh=None) -> EpochStep:
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
    (:meth:`EpochStep.release`). Each such call's phases, timed on the
    host and between CUDA events, and with tracing on its counters, are
    its record (:class:`EpochStep`). On the CPU it is a loop over the
    pool.

    ``mesh``: the step is :func:`make_train_step`'s on that mesh, each
    rank on its own pool of local batches. On an NCCL mesh the graph
    holds the step's collectives (the sharded tables' all-to-alls and
    all-gathers, the gradient and loss all-reduces); step 0, eager,
    creates the communicators, and every rank replays its graph in
    lockstep. A gloo mesh cannot capture collectives, so there the
    epoch runs its step loop uncaptured, on the CPU or on a card, and
    ``last_run["captured"]`` is False.
    """
    return EpochStep(_train_body(group, apply_fn, loss_fn, sparse_opt,
                                 dense_opt, micro_batch_num, combine_fn,
                                 mesh), n_epochs, mesh)


def _infer_rows(group: EmbeddingGroup, ts: TrainState, tname, ids_hi,
                ids_lo, mesh):
    """``(rows, inverse)`` of one physical table's read-only lookup:
    per unique id from the owners on a mesh (a sharded table), else per
    occurrence (identity ``inverse``). An adaptive table's cold or
    absent ids read their static bucket (on a mesh, merged on the
    owner)."""
    cfg = group.tables[tname]
    state = ts.ev[tname]
    B, L = ids_hi.shape
    if cfg.adaptive_hot_threshold is not None:
        kw = dict(hot_threshold=cfg.adaptive_hot_threshold,
                  num_buckets=cfg.adaptive_buckets, salt=group.salts[tname])
        static = group._adaptive_static(ts.params, tname)
        if group._is_stacked(tname):
            rows, inverse, _ = adlib.lookup_infer_rows_sharded(
                cfg, state, ids_hi, ids_lo, static, mesh=mesh, **kw)
            return rows, inverse
        rows = adlib.lookup_infer(cfg, state, ids_hi, ids_lo, static, **kw)
    elif group._is_stacked(tname):
        infer = (shlib.lookup_rows_infer_static if cfg.static_buckets
                 else shlib.lookup_rows_infer)
        rows, inverse, _ = infer(cfg, state, ids_hi, ids_lo, mesh=mesh)
        return rows, inverse
    else:
        rows = ev.lookup(cfg, state, ids_hi.reshape(-1), ids_lo.reshape(-1))
    return rows, torch.arange(B * L, device=rows.device).reshape(B, L)


@torch.no_grad()
def eval_embeddings(group: EmbeddingGroup, ts: TrainState, batch,
                    mesh=None):
    """The embedding dict the eval step hands the model: every id
    occurrence looked up on its own (identity ``inverse``), bags
    combined (weighted columns by their weights), sequence columns as
    ``(rows, mask)``; no mutation. On a ``mesh`` a sharded table's ids
    go to their owners and come back as rows per unique id
    (``sharded.lookup_rows_infer``, static: ``lookup_rows_infer_static``,
    adaptive: ``adaptive.lookup_infer_rows_sharded``); a replicated
    table is read locally. A dyn-dim split table's hot sibling is read
    with the same ids and its rows concatenated onto the base's."""
    group._check_mesh(mesh)
    embs = {}
    for tname, tcols in group._columns_by_table().items():
        ids_hi, ids_lo, widths = group._packed_view(batch, tname, tcols)
        mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
        for t in (tname, group._dyn_hot.get(tname)):
            if t is None:
                continue
            rows, inverse = _infer_rows(group, ts, t, ids_hi, ids_lo, mesh)
            off = 0
            for c, w in zip(tcols, widths):
                inv_c, m_c = inverse[:, off:off + w], mask[:, off:off + w]
                off += w
                if isinstance(c, SequenceEmbeddingColumn):
                    e = (rows[inv_c] * m_c[..., None].to(rows.dtype), m_c)
                else:
                    e = lkup.combine_bags(
                        rows, inv_c, m_c, c.combiner,
                        weights=batch[c.weight_name] if c.weight_name
                        else None)
                if t == tname:
                    embs[c.name] = e
                elif isinstance(e, tuple):
                    embs[c.name] = (torch.cat([embs[c.name][0], e[0]],
                                              dim=-1), m_c)
                else:
                    embs[c.name] = torch.cat([embs[c.name], e], dim=-1)
    return embs


def make_eval_step(group: EmbeddingGroup, apply_fn: Callable, mesh=None):
    """``(TrainState, batch) -> model outputs``, no mutation, over
    :func:`eval_embeddings`, as the JAX package's eval. On a ``mesh``
    each rank scores its local batch: its outputs are the rank's slice
    of the JAX package's global ones."""

    @torch.no_grad()
    def _eval(ts: TrainState, batch):
        return apply_fn(group.model_params(ts.params),
                        eval_embeddings(group, ts, batch, mesh), batch)

    return _eval
