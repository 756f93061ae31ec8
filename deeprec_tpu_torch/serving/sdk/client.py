"""Python client SDK for the serving endpoint (standard library only).

Port of ``deeprec_tpu/serving/sdk/client.py``, unchanged on the wire:
``POST /v1/predict`` with ``{"instances": [...]}`` returns
``{"predictions": [...]}``; ``GET /healthz`` returns ``{"status": "ok",
"version": N}``. It talks to the port's ``HttpScorer`` and to the
worker the C ABI processor spawns.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence


class ServingError(RuntimeError):
    """Server returned an error payload or a non-2xx status."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class Client:
    """Client of one serving endpoint.

    >>> c = Client("http://host:port")
    >>> c.predict([{"x": 0.5, "item": [1, 2]}])
    [0.53, ...]
    """

    def __init__(self, endpoint: str, timeout_s: float = 10.0):
        self._endpoint = endpoint.rstrip("/")
        self._timeout = timeout_s

    def _request(self, path: str, payload: Optional[Dict] = None) -> Dict:
        req = urllib.request.Request(
            self._endpoint + path,
            data=None if payload is None else json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:
                msg = str(e)
            raise ServingError(e.code, msg) from None

    def health(self) -> Dict[str, Any]:
        """``{"status": "ok", "version": N}`` or raises ServingError."""
        return self._request("/healthz")

    def model_version(self) -> Optional[int]:
        return self.health().get("version")

    def predict(self, instances: Sequence[Dict[str, Any]]) -> List:
        """Score a batch of instances; returns the predictions list."""
        return self._request("/v1/predict",
                             {"instances": list(instances)})["predictions"]

    def batch_predict(self, instances: Sequence[Dict[str, Any]],
                      max_batch: int = 1024) -> List:
        """`predict` in chunks of ``max_batch`` (the reference's
        ``batch_process`` entry point, `processor.h:10-12`)."""
        out: List = []
        for i in range(0, len(instances), max_batch):
            out.extend(self.predict(instances[i:i + max_batch]))
        return out
