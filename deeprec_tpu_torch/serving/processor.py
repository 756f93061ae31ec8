"""Serving: model loading, delta updates, scoring.

Port of ``deeprec_tpu/serving/processor.py``:

  * ``ServingModel`` holds the eval step and the restored state, applies
    full and delta (incremental-checkpoint) updates atomically, rolls
    back by restoring an older step, and warms up on sample requests.
    With ``mesh`` (``parallel.mesh.Mesh``) it serves from row-sharded
    tables: each rank restores its shards and scores its local batch
    (``make_eval_step(mesh=)``), so its outputs are the rank's slice of
    what the JAX package's single-controller ``ServingModel(mesh=)``
    returns for the global batch. Every rank calls ``predict``,
    ``full_update`` and ``delta_update`` together; an update first
    settles on one version for every rank (the least of the newest
    steps the ranks see), so no rank swaps in a delta another rank has
    not applied.
  * ``ModelWatcher`` polls the checkpoint directory and swaps new
    versions in from a thread (one process only: it refuses a mesh).
  * ``HttpScorer`` is a stdlib HTTP/JSON front over ``predict``.

Lookups never mutate tables. One device-resident state serves every
thread; requests are moved to the state's device before scoring.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deeprec_tpu_torch.feature_column.feature_column import (EmbeddingGroup,
                                                             batch_to)
from deeprec_tpu_torch.train import loop as trainlib
from deeprec_tpu_torch.train.checkpoint import CheckpointManager
from deeprec_tpu_torch.train.loop import TrainState


class ServingModel:
    """A servable model version with atomic full/delta updates."""

    def __init__(self, group: EmbeddingGroup, apply_fn: Callable,
                 ts_template: TrainState, ckpt_dir: str, mesh=None):
        self.group = group
        self.mesh = mesh
        self._mgr = CheckpointManager(ckpt_dir, group, mesh=mesh)
        self._eval = trainlib.make_eval_step(group, apply_fn, mesh=mesh)
        self._lock = threading.Lock()
        self._ts = ts_template
        self._device = next(iter(ts_template.params.values())).device
        self._version: Optional[int] = None

    @property
    def version(self) -> Optional[int]:
        return self._version

    # -- updates ----------------------------------------------------------
    def settle(self, step: Optional[int]) -> Optional[int]:
        """The least of every rank's ``step`` (None: no step) on a mesh,
        ``step`` itself off one: the version all ranks can reach."""
        if self.mesh is None:
            return step
        steps = self.mesh.all_gather_object(step)
        return None if None in steps else min(steps)

    def _newest(self) -> Optional[int]:
        steps = self._mgr._steps("full") + self._mgr._steps("incr")
        return max(steps) if steps else None

    def full_update(self, step: Optional[int] = None) -> int:
        """Load the newest (or a specific) full checkpoint and its
        deltas. Passing an older ``step`` is version rollback. On a mesh
        "newest" is the newest step every rank sees."""
        if step is None and self.mesh is not None:
            step = self.settle(self._newest())
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint every rank sees in {self._mgr.dir}")
        ts = self._mgr.restore(self._ts, step=step)
        with self._lock:
            self._ts = ts
            self._version = ts.step
        return self._version

    def delta_update(self) -> Optional[int]:
        """Apply incremental checkpoints newer than the current version
        without reloading the full model (on a mesh, up to the newest
        one every rank sees)."""
        cur = self._version
        if cur is None:
            return self.full_update()
        incrs = [s for s in self._mgr._steps("incr") if s > cur]
        if self.mesh is not None:
            last = self.settle(incrs[-1] if incrs else cur)
            incrs = [s for s in incrs if s <= last]
        if not incrs:
            return None
        ts = self._ts
        for s in incrs:
            ts = self._mgr._apply(ts, f"incr-{s}", full=False)
        with self._lock:
            self._ts = ts
            self._version = incrs[-1]
        return self._version

    # -- scoring ----------------------------------------------------------
    def predict(self, batch: Dict[str, Any]) -> torch.Tensor:
        with self._lock:
            ts = self._ts
        return self._eval(ts, batch_to(batch, self._device))

    def warmup(self, batches) -> float:
        """Score representative request batches before taking traffic;
        returns the seconds spent. On a card the first call also builds
        or loads the kernels (``ops/kernels/build.py``) and lets the
        allocator and cuBLAS settle, so live requests do not pay for
        it."""
        t0 = time.perf_counter()
        for b in batches:
            self.predict(b)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return time.perf_counter() - t0


class ModelWatcher:
    """Poll the checkpoint dir; full update on a new full checkpoint,
    delta update on new incremental ones. Not for a mesh model: the
    ranks' timers would run the update's collectives out of step with
    ``predict``'s; mesh ranks update from their own serving loop."""

    def __init__(self, model: ServingModel, interval_s: float = 10.0):
        if model.mesh is not None:
            raise ValueError(
                "ModelWatcher cannot drive a ServingModel with a mesh: "
                "every rank must call full_update/delta_update and "
                "predict together, in the same order")
        self._model = model
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self):
        latest_full = self._model._mgr.latest_step()
        cur = self._model.version
        if latest_full is not None and (cur is None or latest_full > cur):
            self._model.full_update()
        else:
            self._model.delta_update()

    def start(self):
        def run():
            while not self._stop.wait(self._interval):
                try:
                    self.poll_once()
                except Exception:  # keep serving on update failure
                    traceback.print_exc()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)


def sigmoid_scores(out: torch.Tensor) -> np.ndarray:
    """float64 ``1 / (1 + exp(-logits))`` on the host."""
    x = out.detach().to(torch.float64).cpu().numpy()
    return 1.0 / (1.0 + np.exp(-x))


def _sigmoid_scores(out: torch.Tensor) -> Dict[str, list]:
    return {"predictions": sigmoid_scores(out).tolist()}


class HttpScorer:
    """JSON scoring endpoint.

    POST /v1/predict  {"instances": [...]} -> {"predictions": [...]}
    GET  /healthz     -> {"status": "ok", "version": N}

    ``parse_request`` maps the decoded JSON to a batch dict;
    ``format_response`` maps model outputs to JSON-serializable data
    (default: sigmoid scores).
    """

    def __init__(self, model: ServingModel,
                 parse_request: Callable[[Any], Dict],
                 format_response: Optional[Callable] = None,
                 host: str = "127.0.0.1", port: int = 0):
        fmt = format_response or _sigmoid_scores

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok",
                                     "version": model.version})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/predict":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    batch = parse_request(json.loads(self.rfile.read(n)))
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, {"error": f"bad request: {e!r}"})
                    return
                try:
                    resp = fmt(model.predict(batch))
                except Exception as e:  # the server keeps serving
                    traceback.print_exc()
                    self._send(500, {"error": repr(e)})
                    return
                self._send(200, resp)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
