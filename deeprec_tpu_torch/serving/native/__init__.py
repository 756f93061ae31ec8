"""The port's embeddable C ABI processor: ``processor.cc`` through ctypes.

Port of ``deeprec_tpu/serving/native``. The shared library is the
deliverable: any RPC framework can ``dlopen`` it and call
``initialize`` / ``process`` / ``batch_process`` /
``get_serving_model_info`` / ``get_serving_endpoint`` /
``deinitialize``. ``initialize`` spawns ``python3 -m
deeprec_tpu_torch.serving.worker <model_entry>`` (``deeprec_tpu_torch``
must be importable by that interpreter: the caller's ``PYTHONPATH``)
with the ``model_config`` JSON, whose ``device`` (``"cuda"`` by
default) the worker serves on; a worker asked for a card it does not
have exits, and ``initialize`` fails.

The library is built from this directory's ``processor.cc`` with
``g++`` at the first :func:`load` into ``build/native/`` at the
repository root, keyed by a hash of the source and flags and
file-locked (``ops/kernels/build.load_host_library``). A failed build
raises; there is no prebuilt library to fall back on. :class:`Processor`
is a thin Python wrapper over the ABI, what a native host would do in C.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import threading

from deeprec_tpu_torch.ops.kernels import build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "processor.cc")
_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """Build (once) and load the processor library, argtypes bound."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load_host_library("processor", SRC)
        vp = ctypes.c_void_p
        ip = ctypes.POINTER(ctypes.c_int)
        lib.initialize.restype = vp
        lib.initialize.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ip]
        lib.process.restype = ctypes.c_int
        lib.process.argtypes = [vp, ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(vp), ip]
        lib.batch_process.restype = ctypes.c_int
        lib.batch_process.argtypes = [
            vp, ctypes.POINTER(ctypes.c_char_p), ip, ctypes.c_int,
            ctypes.POINTER(vp), ip]
        lib.get_serving_model_info.restype = ctypes.c_int
        lib.get_serving_model_info.argtypes = [vp, ctypes.POINTER(vp), ip]
        lib.get_serving_endpoint.restype = ctypes.c_int
        lib.get_serving_endpoint.argtypes = [vp, ctypes.c_char_p,
                                             ctypes.c_int, ip]
        lib.deinitialize.restype = None
        lib.deinitialize.argtypes = [vp]
        _lib = lib
        return _lib


def _take_output(out_p: int, n: int) -> bytes:
    """The bytes of a malloc()-ed ABI output, freed after the copy."""
    data = ctypes.string_at(out_p, n)
    ctypes.CDLL(None).free(ctypes.c_void_p(out_p))
    return data


class Processor:
    """Python wrapper over the C ABI. ``model_config`` is the worker's
    config (``checkpoint_dir``, ``device``, the entry's keys); the
    worker runs under this interpreter unless it names ``python``."""

    def __init__(self, model_entry: str, model_config: dict):
        self._lib = load()
        cfg = dict(model_config)
        cfg.setdefault("python", sys.executable)
        state = ctypes.c_int(-1)
        self._h = self._lib.initialize(
            model_entry.encode(), json.dumps(cfg).encode(),
            ctypes.byref(state))
        if not self._h or state.value != 0:
            raise RuntimeError(f"processor initialize failed for "
                               f"{model_entry!r} (state {state.value})")

    def process(self, request: dict) -> dict:
        body = json.dumps(request).encode()
        out = ctypes.c_void_p()
        n = ctypes.c_int(0)
        rc = self._lib.process(self._h, body, len(body),
                               ctypes.byref(out), ctypes.byref(n))
        data = _take_output(out.value, n.value) if out.value else b""
        if rc != 0:
            raise RuntimeError(f"process rc={rc}: {data[:200]!r}")
        return json.loads(data)

    def batch_process(self, requests: list[dict]) -> list[dict]:
        bodies = [json.dumps(r).encode() for r in requests]
        n = len(bodies)
        ins = (ctypes.c_char_p * n)(*bodies)
        in_sizes = (ctypes.c_int * n)(*[len(b) for b in bodies])
        outs = (ctypes.c_void_p * n)()
        out_sizes = (ctypes.c_int * n)()
        rc = self._lib.batch_process(self._h, ins, in_sizes, n, outs,
                                     out_sizes)
        results = [json.loads(_take_output(outs[i], out_sizes[i]))
                   if outs[i] else None for i in range(n)]
        if rc != 0:
            raise RuntimeError(f"batch_process rc={rc}")
        return results

    def endpoint(self) -> tuple[str, int]:
        host = ctypes.create_string_buffer(256)
        port = ctypes.c_int(0)
        rc = self._lib.get_serving_endpoint(self._h, host, 256,
                                            ctypes.byref(port))
        if rc != 0:
            raise RuntimeError(f"get_serving_endpoint rc={rc}")
        return host.value.decode(), port.value

    def model_info(self) -> dict:
        out = ctypes.c_void_p()
        n = ctypes.c_int(0)
        rc = self._lib.get_serving_model_info(
            self._h, ctypes.byref(out), ctypes.byref(n))
        data = _take_output(out.value, n.value) if out.value else b""
        if rc != 0:
            raise RuntimeError(f"get_serving_model_info rc={rc}")
        return json.loads(data)

    def close(self):
        if self._h:
            self._lib.deinitialize(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
