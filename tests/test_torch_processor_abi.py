"""The port's embeddable C ABI processor and C client SDK.

``deeprec_tpu_torch/serving/native/processor.cc`` builds with ``g++``
into ``build/native/`` at first use; ``initialize`` with ``{"device":
"cpu", ...}`` spawns ``deeprec_tpu_torch.serving.worker`` over a
checkpoint the port trained (``tools/serving_benchmark_torch.
abi_checkpoint``: ``serving/wdl_entry.py``'s WDL at a tiny size);
``process`` and ``batch_process`` scores match in-process
``ServingModel.predict`` within rtol 1e-5, atol 1e-6;
``get_serving_model_info`` reports the version; the port's C client
(``serving/sdk/c``), compiled with ``gcc``, scores against the same
worker. One worker process for the module.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeprec_tpu_torch.serving import native as proc_native
from deeprec_tpu_torch.serving.processor import ServingModel, sigmoid_scores

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import serving_benchmark_torch as sb  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
CONFIG = {"device": "cpu", "dim": 4, "capacity": 256, "hidden": [16, 8],
          "dtype": "float32"}
STEPS = 3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("abi")
    ckpt = str(tmp / "ckpt")
    parts, ts, data = sb.abi_checkpoint(ckpt, CONFIG, steps=STEPS, batch=64,
                                        vocab=300)
    raw = data.next_batch_np(wide=False)
    serving = ServingModel(parts["group"], parts["apply_fn"],
                           parts["ts_template"], ckpt)
    assert serving.full_update() == STEPS
    return ckpt, parts, serving, raw


def _request(raw, rows):
    return {"instances": sb.instances(raw, rows)}


def _expected(parts, serving, raw, rows):
    return sigmoid_scores(serving.predict(parts["parse_request"](
        _request(raw, rows))))


@pytest.fixture(scope="module")
def processor(trained):
    ckpt = trained[0]
    env_pp = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env_pp] if env_pp else []))
    try:
        p = proc_native.Processor("deeprec_tpu_torch.serving.wdl_entry",
                                  {"checkpoint_dir": ckpt, **CONFIG})
    finally:
        os.environ["PYTHONPATH"] = env_pp
    yield p
    p.close()


def test_shim_builds_from_source_into_build_dir():
    lib = proc_native.load()
    path = pathlib.Path(lib._name)
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("processor-")
    for sym in ("initialize", "process", "batch_process",
                "get_serving_model_info", "get_serving_endpoint",
                "deinitialize"):
        assert hasattr(lib, sym)
    # No prebuilt library ships with the port.
    assert not list((REPO / "deeprec_tpu_torch").rglob("*.so"))


def test_process_scores_match_inprocess(processor, trained):
    _, parts, serving, raw = trained
    for rows in (range(2), range(5, 13)):
        resp = processor.process(_request(raw, rows))
        np.testing.assert_allclose(resp["predictions"],
                                   _expected(parts, serving, raw, rows),
                                   **TOL)


def test_batch_process_and_model_info(processor, trained):
    _, parts, serving, raw = trained
    outs = processor.batch_process([_request(raw, range(3)),
                                    _request(raw, range(3, 4))])
    np.testing.assert_allclose(outs[0]["predictions"],
                               _expected(parts, serving, raw, range(3)),
                               **TOL)
    np.testing.assert_allclose(outs[1]["predictions"],
                               _expected(parts, serving, raw, range(3, 4)),
                               **TOL)
    assert processor.model_info() == {"status": "ok", "version": STEPS}
    with pytest.raises(RuntimeError, match="rc=-4"):
        processor.process({"instances": []})


def test_c_client_sdk_against_abi_worker(processor, trained, tmp_path):
    _, parts, serving, raw = trained
    sdk = REPO / "deeprec_tpu_torch/serving/sdk/c"
    host, port = processor.endpoint()
    assert host == "127.0.0.1" and port > 0
    req = tmp_path / "req.json"
    req.write_text(json.dumps(_request(raw, range(4))))
    src = tmp_path / "main.c"
    src.write_text(r'''
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "deeprec_client.h"
int main(int argc, char** argv) {
  dr_client c;
  static char req[1 << 16], buf[1 << 16];
  FILE* f = fopen(argv[3], "rb");
  if (!f) return 6;
  size_t n = fread(req, 1, sizeof req - 1, f);
  fclose(f);
  req[n] = '\0';
  if (dr_client_init(&c, argv[1], atoi(argv[2]), 20000)) return 2;
  if (dr_health(&c, buf, sizeof buf)) return 3;
  if (!strstr(buf, "\"ok\"")) return 4;
  if (dr_predict(&c, req, buf, sizeof buf)) return 5;
  printf("%s\n", buf);
  return 0;
}
''')
    exe = tmp_path / "abi_client"
    subprocess.run(["gcc", "-O2", "-std=c99", "-I", str(sdk), "-o",
                    str(exe), str(src), str(sdk / "deeprec_client.c")],
                   check=True, capture_output=True)
    out = subprocess.run([str(exe), host, str(port), str(req)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    np.testing.assert_allclose(json.loads(out.stdout)["predictions"],
                               _expected(parts, serving, raw, range(4)),
                               **TOL)
