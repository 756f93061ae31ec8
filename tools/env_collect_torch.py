"""Environment facts for a bug report or a measurement of the PyTorch
port: the counterpart of ``tools/env_collect.py``. Prints one JSON
document: the versions (Python, torch and the CUDA it was built for,
numpy, the driver, ``nvcc``), the card (``nvidia-smi --query-gpu=name,
power.limit,clocks.max.sm``, the device count and capability as torch
sees them), ``CUDA_VISIBLE_DEVICES`` and the other ``CUDA_*`` and
``TORCH_*`` variables, host facts and the repository's git state.

Usage: python3 tools/env_collect_torch.py [--no-device]
(``--no-device`` touches no card: no CUDA call, no ``nvidia-smi``;
without it, a machine with no CUDA card exits non-zero after the
document.)
"""

from __future__ import annotations

import json
import os
import platform
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*cmd, cwd=None):
    """A command's stripped standard output, or None where it cannot
    run or fails."""
    try:
        r = subprocess.run(list(cmd), capture_output=True, text=True,
                           timeout=30, cwd=cwd)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def _nvcc():
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            out = _run(path, "--version")
            if out:
                return out.splitlines()[-1]
    return None


def _host_mem_gb():
    try:
        with open("/proc/meminfo") as f:
            mem = dict(ln.split(":", 1) for ln in f.read().splitlines())
        return round(int(mem["MemTotal"].split()[0]) / 2**20, 1)
    except (OSError, KeyError, ValueError):
        return None


def collect(touch_device: bool = True) -> dict:
    import numpy
    import torch

    info: dict = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "numpy": numpy.__version__,
        "nvcc": _nvcc(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "host_mem_gb": _host_mem_gb(),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k == "CUDA_VISIBLE_DEVICES"
                or k.startswith(("CUDA_", "TORCH_"))},
        "repo": {"commit": _run("git", "rev-parse", "--short", "HEAD",
                                cwd=ROOT),
                 "branch": _run("git", "rev-parse", "--abbrev-ref", "HEAD",
                                cwd=ROOT),
                 "dirty": bool(_run("git", "status", "--porcelain",
                                    cwd=ROOT))},
    }
    if touch_device:
        smi = _run("nvidia-smi", "--query-gpu=name,power.limit,"
                   "clocks.max.sm", "--format=csv,noheader")
        info["cards"] = smi.splitlines() if smi else None
        info["driver"] = _run("nvidia-smi", "--query-gpu=driver_version",
                              "--format=csv,noheader")
        info["cuda_available"] = torch.cuda.is_available()
        if info["cuda_available"]:
            info["device_count"] = torch.cuda.device_count()
            info["devices"] = [
                {"name": torch.cuda.get_device_name(i),
                 "capability": list(torch.cuda.get_device_capability(i))}
                for i in range(torch.cuda.device_count())]
    return info


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    touch = "--no-device" not in argv
    info = collect(touch)
    print(json.dumps(info, indent=2, sort_keys=True))
    if touch and not info["cuda_available"]:
        raise SystemExit("env_collect_torch: no CUDA card (torch.cuda."
                         "is_available() is false); pass --no-device")
    return info


if __name__ == "__main__":
    main()
