"""``combine_kernels_ms`` on a hand-made device trace: the ``occ_``
kernels of the port's embedding combine and its backward, by name, over
the traced steps; no other kernel, and None where the trace holds none
of them (a program without them)."""

import os
from types import SimpleNamespace

from benchmark import devtrace, manifest
from benchmark.tests.conftest import REPO


def _reader():
    return manifest.load_module(
        os.path.join(REPO, "benchmark", "metrics", "combine_kernels_ms.py"),
        "benchmark_metric_combine_kernels_ms")


def _trace(kernels):
    ev = [{"cat": "user_annotation", "name": "traced_window", "ph": "X",
           "ts": 0.0, "dur": 1000.0}]
    t = 0.0
    for name, dur in kernels:
        ev.append({"cat": "kernel", "name": name, "ph": "X", "ts": t,
                   "dur": dur})
        t += dur
    return devtrace.Trace(ev, ())


def test_occ_kernels_by_name():
    ns = "void (anonymous namespace)::"
    kernels = [
        (ns + "occ_combine_fwd_kernel<true>(float const*, long, int)", 30.0),
        (ns + "occ_segsum_kernel<false>(int const*, long const*)", 40.0),
        (ns + "occ_long_kernel(int const*, long const*)", 11.0),
        (ns + "occ_zero_rows_kernel<true>(unsigned char const*)", 9.0),
        # not the combine's
        ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int, "
         "long>(int*)", 5.0),
        ("void at::native::indexing_backward_kernel<float, 4>(long*)", 500.0),
        (ns + "gather_rows_kernel<unsigned int>(unsigned int const*)", 7.0),
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::FillFunctor<float>>(int, float*)", 11.0),
        ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize", 13.0),
    ]
    ctx = SimpleNamespace(trace=_trace(kernels), traced_steps=2)
    assert _reader().read(ctx) == (30 + 40 + 11 + 9) / 1e3 / 2


def test_none_without_the_kernels():
    read = _reader().read
    ctx = SimpleNamespace(trace=_trace([("indexing_backward_kernel", 5.0)]),
                          traced_steps=4)
    assert read(ctx) is None
    assert read(SimpleNamespace(trace=None, traced_steps=4)) is None
    assert read(SimpleNamespace(trace=_trace([]), traced_steps=0)) is None
