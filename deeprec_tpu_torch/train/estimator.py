"""High-level training driver with hooks.

Port of ``deeprec_tpu/train/estimator.py`` (single device): a train loop
that owns the training step, runs hooks on a step cadence, and wires
checkpointing (full and incremental saves, eviction at save time),
logging, the profiler and the WorkQueue, plus evaluation with the
streaming AUC. The step updates the state in place (see
``train.loop.make_train_step``); ``Estimator.ts`` is the live state.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.train import loop as trainlib
from deeprec_tpu_torch.train import metrics as metricslib
from deeprec_tpu_torch.train.checkpoint import CheckpointManager


class Hook:
    """``after_step`` fires on every step; ``begin``/``end`` bracket the
    run."""

    def begin(self, estimator: "Estimator"):
        pass

    def after_step(self, estimator: "Estimator", step: int,
                   metrics: Dict[str, Any]):
        pass

    def end(self, estimator: "Estimator", step: int):
        pass


class LoggingHook(Hook):
    """Step, loss and throughput every ``every_steps`` steps (reads the
    loss from the card on those steps only)."""

    def __init__(self, every_steps: int = 100, batch_size: int = 0,
                 log_fn: Callable[[str], None] = print):
        self.every = every_steps
        self.batch = batch_size
        self.log = log_fn
        self._t0 = None
        self._last = 0

    def begin(self, est):
        self._t0 = time.perf_counter()
        self._last = int(est.ts.step)

    def after_step(self, est, step, metrics):
        if step % self.every:
            return
        dt = time.perf_counter() - self._t0
        steps = step - self._last
        tput = (steps * self.batch / dt) if (dt > 0 and self.batch) else 0.0
        loss = float(metrics.get("loss", math.nan))
        self.log(f"step {step} loss {loss:.5f} "
                 f"({steps / max(dt, 1e-9):.2f} steps/s"
                 + (f", {tput:.1f} samples/s" if self.batch else "") + ")")
        self._t0 = time.perf_counter()
        self._last = step


class CheckpointHook(Hook):
    """Full checkpoints every ``save_steps`` steps and at the end,
    incremental ones every ``incremental_save_steps`` steps between
    them, each after a journaled shrink (eviction) of the tables when
    ``shrink`` is set."""

    def __init__(self, manager: CheckpointManager, save_steps: int = 1000,
                 incremental_save_steps: Optional[int] = None,
                 shrink: bool = True):
        self.mgr = manager
        self.save_steps = save_steps
        self.incr_steps = incremental_save_steps
        self.shrink = shrink
        self._last_save = 0

    def _full(self, est, step):
        if self.shrink:
            est.ts = self.mgr.shrink_tables(est.ts, step)
        self.mgr.save(est.ts)
        self._last_save = step

    def after_step(self, est, step, metrics):
        if step and step % self.save_steps == 0:
            self._full(est, step)
        elif self.incr_steps and step and step % self.incr_steps == 0:
            if self.shrink:
                est.ts = self.mgr.shrink_tables(est.ts, step)
            self.mgr.save(est.ts, incremental=True,
                          since_step=self._last_save)

    def end(self, est, step):
        self._full(est, step)


class ProfilerHook(Hook):
    """Profile steps ``[start_step, stop_step)`` with ``torch.profiler``
    (CPU and, where there is a card, CUDA activity) and export a Chrome
    trace (``trace.json``) into ``logdir``."""

    def __init__(self, start_step: int, stop_step: int, logdir: str):
        self.start_step = start_step
        self.stop_step = stop_step
        self.logdir = logdir
        self._prof = None

    def _stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.logdir,
                                                    "trace.json"))
        self._prof = None

    def after_step(self, est, step, metrics):
        if step == self.start_step and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        if step >= self.stop_step and self._prof is not None:
            self._stop()

    def end(self, est, step):
        if self._prof is not None:
            self._stop()


class Estimator:
    """Owns the group, the model's apply, the optimizers and the state,
    on ``device``, and drives train, evaluate and predict."""

    def __init__(self, group: EmbeddingGroup, apply_fn, loss_fn, sparse_opt,
                 dense_opt, params: Dict[str, torch.Tensor],
                 micro_batch_num: int = 1,
                 model_dir: Optional[str] = None, work_queue=None,
                 device="cuda"):
        self.group = group
        self.apply_fn = apply_fn
        self.loss_fn = loss_fn
        self.sparse_opt = sparse_opt
        self.dense_opt = dense_opt
        self.device = torch.device(device)
        self.ts = trainlib.create_train_state(group, params, dense_opt,
                                              sparse_opt, self.device)
        self._step_fn = trainlib.make_train_step(
            group, apply_fn, loss_fn, sparse_opt, dense_opt,
            micro_batch_num=micro_batch_num)
        self._eval_fn = trainlib.make_eval_step(group, apply_fn)
        self.model_dir = model_dir
        self.manager = (CheckpointManager(model_dir, group)
                        if model_dir else None)
        self.work_queue = work_queue
        if work_queue is not None and self.manager is not None:
            # Checkpoints carry the remaining work; a restore resumes the
            # queue instead of re-reading consumed items.
            self.manager.register_aux("work_queue", work_queue.state,
                                      work_queue.restore_state)

    def restore_if_available(self) -> Optional[int]:
        """Restore the newest checkpoint of ``model_dir``, if any;
        returns its step."""
        if self.manager and self.manager.latest_step() is not None:
            self.ts = self.manager.restore(self.ts)
            return int(self.ts.step)
        return None

    def train(self, batches: Iterable[Dict], max_steps: int,
              hooks: Optional[List[Hook]] = None) -> Dict[str, float]:
        """Train until the global step reaches ``max_steps``. Returns
        the last step's metrics as floats."""
        hooks = hooks or []
        for h in hooks:
            h.begin(self)
        metrics: Dict[str, Any] = {}
        step = int(self.ts.step)
        it = iter(batches)
        while step < max_steps:
            self.ts, metrics = self._step_fn(self.ts, next(it))
            step += 1
            for h in hooks:
                h.after_step(self, step, metrics)
        for h in hooks:
            h.end(self, step)
        return {k: float(v) for k, v in metrics.items()}

    def evaluate(self, batches: Iterable[Dict], steps: int,
                 label_key: str = "label") -> Dict[str, float]:
        """Streaming AUC and mean per-batch accuracy over ``steps``
        batches."""
        auc = metricslib.auc_init(device=self.device)
        accs = []
        it = iter(batches)
        for _ in range(steps):
            b = next(it)
            logits = self._eval_fn(self.ts, b)
            auc = metricslib.auc_update(auc, logits, b[label_key])
            accs.append(metricslib.accuracy(logits, b[label_key]))
        total = float(torch.stack(accs).double().sum()) if accs else 0.0
        return {"auc": float(metricslib.auc_result(auc)),
                "accuracy": total / max(steps, 1)}

    def predict(self, batch: Dict):
        return self._eval_fn(self.ts, batch)
