"""KServe v2 / Open Inference Protocol front end over ``ServingModel``.

Port of ``deeprec_tpu/serving/kserve.py``. Any Triton or KServe HTTP
client works against the port's serving runtime unchanged:

  GET  /v2                         server metadata
  GET  /v2/health/live|ready       liveness / readiness
  GET  /v2/models/{m}              model metadata (declared tensors)
  GET  /v2/models/{m}/ready        model readiness (a version loaded)
  POST /v2/models/{m}/infer        inference (v2 tensor payloads)

``TensorSpec`` declares how a request tensor maps to the batch dict:
'numeric' -> FP32 arrays, 'id' -> INT64 [B, L] -> ``SparseIds``,
'id_str' -> BYTES hashed to 64-bit ids (the hash bucket column's
behaviour): FNV-1a and the splitmix64 finalizer of the token's UTF-8
bytes, ``data/criteo._hash_token``, read as int64, as the JAX package's
``native.hash_bytes`` with salt 0 gives them. The batch is built on the
host; ``ServingModel.predict`` moves it to the model's device.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from deeprec_tpu_torch.data.criteo import _hash_token
from deeprec_tpu_torch.feature_column.feature_column import SparseIds
from deeprec_tpu_torch.serving.processor import ServingModel, sigmoid_scores

_PROTOCOL_DTYPES = {"numeric": "FP32", "id": "INT64", "id_str": "BYTES"}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Declared shape and kind of one request input tensor.

    kind: 'numeric' (FP32, [B] or [B, k]), 'id' (INT64 [B, L] ->
    SparseIds), 'id_str' (BYTES [B] -> 64-bit hash -> SparseIds [B, 1]).
    ``dims`` is the per-row shape (without the batch dim) for metadata.
    """

    name: str
    kind: str = "numeric"
    dims: Sequence[int] = ()
    key_offset: int = 0

    @property
    def datatype(self) -> str:
        return _PROTOCOL_DTYPES[self.kind]


def hash_tokens(tokens) -> np.ndarray:
    """int64 [n] 64-bit hashes of string tokens (None reads as "")."""
    return np.array([_hash_token("" if t is None else str(t))
                     for t in tokens], np.uint64).view(np.int64)


def _decode_input(spec: TensorSpec, entry: Dict[str, Any]):
    shape = entry.get("shape") or [len(entry["data"])]
    data = entry["data"]
    if spec.kind == "numeric":
        return np.asarray(data, np.float32).reshape(shape)
    if spec.kind == "id":
        arr = np.asarray(data, np.int64).reshape(shape)
        if arr.ndim == 1:
            arr = arr[:, None]
        return SparseIds.from_numpy(arr + spec.key_offset, "cpu")
    if spec.kind == "id_str":
        ids = hash_tokens(data)[:, None] + spec.key_offset
        return SparseIds.from_numpy(ids, "cpu")
    raise ValueError(f"unknown tensor kind {spec.kind!r}")


class KServeFrontend:
    """HTTP server speaking the Open Inference Protocol over a
    ``ServingModel``. Thread-per-request; ``predict`` is thread-safe.
    A single process: on a mesh every rank would have to score in step,
    which no front here arranges."""

    def __init__(self, model: ServingModel, model_name: str,
                 inputs: Sequence[TensorSpec],
                 output_name: str = "score",
                 format_output: Optional[Callable] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._model = model
        self._name = model_name
        self._inputs = {s.name: s for s in inputs}
        self._output_name = output_name
        self._fmt = format_output or sigmoid_scores
        front = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, obj) -> None:
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.rstrip("/")
                if path == "/v2":
                    self._send(200, front.server_metadata())
                elif path in ("/v2/health/live", "/v2/health/ready"):
                    self._send(200, {})
                elif path == f"/v2/models/{front._name}":
                    self._send(200, front.model_metadata())
                elif path == f"/v2/models/{front._name}/ready":
                    ready = front._model.version is not None
                    self._send(200 if ready else 503, {})
                else:
                    self._send(404, {"error": f"unknown path {path}"})

            def do_POST(self):
                if self.path.rstrip("/") != f"/v2/models/{front._name}/infer":
                    self._send(404, {"error": "unknown model or path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    self._send(200, front.infer(req))
                except Exception as e:
                    self._send(400, {"error": str(e)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    # ---------------------------------------------------------- protocol

    def server_metadata(self) -> Dict[str, Any]:
        return {"name": "deeprec-tpu-serving", "version": "2",
                "extensions": []}

    def model_metadata(self) -> Dict[str, Any]:
        v = self._model.version
        return {
            "name": self._name,
            "versions": [str(v)] if v is not None else [],
            "platform": "deeprec_tpu",
            "inputs": [{"name": s.name, "datatype": s.datatype,
                        "shape": [-1, *s.dims]}
                       for s in self._inputs.values()],
            "outputs": [{"name": self._output_name, "datatype": "FP32",
                         "shape": [-1]}],
        }

    def infer(self, req: Dict[str, Any]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        sizes = set()
        for entry in req.get("inputs", []):
            spec = self._inputs.get(entry.get("name"))
            if spec is None:
                raise ValueError(f"undeclared input {entry.get('name')!r}")
            val = _decode_input(spec, entry)
            shp = val.hi.shape if isinstance(val, SparseIds) else val.shape
            sizes.add(int(shp[0]))
            batch[spec.name] = val
        missing = set(self._inputs) - set(batch)
        if missing:
            raise ValueError(f"missing inputs {sorted(missing)}")
        if len(sizes) != 1:
            raise ValueError(f"inconsistent batch sizes {sorted(sizes)}")
        scores = np.asarray(self._fmt(self._model.predict(batch)),
                            np.float64).reshape(-1)
        return {
            "model_name": self._name,
            "model_version": str(self._model.version),
            "id": req.get("id", ""),
            "outputs": [{"name": self._output_name, "datatype": "FP32",
                         "shape": [scores.size],
                         "data": [float(x) for x in scores]}],
        }

    # ---------------------------------------------------------- lifecycle

    def start(self):
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
