"""Port parity: the input pipeline against the JAX package.

Covers the Kaggle TSV readers (the Python line parser, the port's own
build of the C++ parser, ``criteo_file_batches``), the compact wire
format of ``pack_batch_np`` and its device-side unpacking, and the
``PrefetchIterator`` semantics of ``tests/test_data_pipeline.py``.
Everything is compared bit for bit: both packages run the same
arithmetic, and torch's float32 -> bfloat16 cast rounds to nearest
even as ``ml_dtypes`` does. The JAX package is imported inside the
parity tests, so the ``cuda`` test (batches staged on the card under
load) runs where JAX is not installed: ``python -m pytest --noconftest
tests/test_torch_input_pipeline.py -m cuda``.
"""

import queue
import time
import types

import numpy as np
import pytest
import torch

from deeprec_tpu_torch import bench
from deeprec_tpu_torch import native as tnative
from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.data.prefetch import PrefetchIterator, staged
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.models import wdl as twdl

torch.set_num_threads(1)

B = 64


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules under test (and ``ml_dtypes``)."""
    import ml_dtypes

    from deeprec_tpu import native
    from deeprec_tpu.data import criteo
    from deeprec_tpu.feature_column import feature_column
    from deeprec_tpu.models import wdl
    return types.SimpleNamespace(native=native, criteo=criteo,
                                 fc=feature_column, wdl=wdl,
                                 bf16=ml_dtypes.bfloat16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _odd_lines():
    """Lines with empty, negative, fractional, non-hex and short fields."""
    cats = ["68fd1e64", "", "zz!", "DEADBEEF", "-12", "0x1f", "ffffffffffff"]
    lines = []
    for r in range(9):
        ints = [str(r * 7 - 20), "", "3.25", "-0.5"] + [str(i) for i in
                                                         range(9)]
        cs = [cats[(r + i) % len(cats)] for i in range(26)]
        lines.append("\t".join([str(r % 2)] + ints + cs) + "\n")
    lines.append("1\t5\n")  # a short line
    return lines


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    """A small synthetic TSV (3 x 64 + 17 rows) as the bench writes it,
    plus the odd lines."""
    path = str(tmp_path_factory.mktemp("tsv") / "criteo.tsv")
    bench.write_tsv(path, 3 * B + 17,
                    tcriteo.SyntheticCriteo(B, vocab=200_000, seed=7))
    with open(path, "a") as f:
        f.writelines(_odd_lines())
    return path


@pytest.mark.parametrize("hash_mod", [None, 1000])
def test_parse_criteo_lines_matches_jax(jx, tsv, hash_mod):
    with open(tsv) as f:
        lines = f.readlines()[-40:]
    want = jx.criteo.parse_criteo_lines(lines, hash_mod)
    got = tcriteo.parse_criteo_lines(lines, hash_mod)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_parse_matches_jax_native(jx, tsv):
    with open(tsv, "rb") as f:
        data = f.read()
    for max_rows in (5, 1000):
        got = tnative.parse_criteo(data, max_rows)
        want = jx.native.parse_criteo(data, max_rows)
        assert got[0] == want[0] and got[4] == want[4]
        for a, b in zip(got[1:4], want[1:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    tokens = ["zz!", "", "68fd1e64", "ü"]
    np.testing.assert_array_equal(
        np.asarray([tcriteo._hash_token(t) for t in tokens],
                   np.uint64).view(np.int64),
        jx.native.hash_bytes(tokens))


def test_native_and_python_parsers_agree(tsv):
    """Labels and ids equal; numerics within one float32 ulp (the Python
    parser takes log1p in float32, the C++ one in double, as in the JAX
    package)."""
    with open(tsv) as f:
        lines = f.readlines()
    labels, ints, cats = tcriteo.parse_criteo_lines(lines)
    rows, nl, nd, nc, _ = tnative.parse_criteo(
        "".join(lines).encode(), len(lines))
    assert rows == len(lines)
    np.testing.assert_array_equal(nl, labels)
    np.testing.assert_array_equal(nc, cats)
    ulp = np.spacing(np.maximum(np.abs(ints), np.abs(nd)))
    assert (np.abs(ints - nd) <= ulp).all()


@pytest.mark.parametrize("use_native", [True, False])
def test_criteo_file_batches_match_jax(jx, tsv, use_native):
    kw = dict(use_native=use_native, as_numpy=True, wide=False, id_bits=31)
    got = list(tcriteo.criteo_file_batches(tsv, B, **kw))
    want = list(jx.criteo.criteo_file_batches(tsv, B, **kw))
    assert [g["label"].shape[0] for g in got] == [B, B, B, 27]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # Every id fits in 31 bits, and the batches carry no C*_wide columns.
    assert all(0 <= g["C3"].min() and g["C3"].max() < 2**31 for g in got)
    # SparseIds batches, on the device asked for.
    b0 = next(tcriteo.criteo_file_batches(tsv, B, use_native=use_native,
                                          device="cpu"))
    assert isinstance(b0["C1_wide"], tfc.SparseIds)
    assert b0["C1"].hi.device.type == "cpu"


def test_native_reader_without_hash_mod_only(tsv):
    with pytest.raises(ValueError, match="hash_mod"):
        next(tcriteo.criteo_file_batches(tsv, B, hash_mod=10))


def _group(**kw):
    return tfc.EmbeddingGroup(twdl.criteo_columns(**kw), coalesce=True)


@pytest.mark.parametrize("static", [False, True])
def test_compact_pack_matches_jax(jx, tsv, static):
    kw = dict(embedding_dim=8, capacity=1 << 10, wide_in_deep=True,
              static_buckets=static)
    jg = jx.fc.EmbeddingGroup(jx.wdl.criteo_columns(**kw), coalesce=True)
    tg = _group(**kw)
    raw = next(tcriteo.criteo_file_batches(tsv, B, as_numpy=True, wide=False,
                                           id_bits=31))
    raw["C5"][3, 0] = np.iinfo(np.int64).min  # EMPTY padding
    raw["row_id"] = np.arange(B, dtype=np.int64)
    jp = jg.pack_batch_np(raw, compact=True)
    tp = tg.pack_batch_np(raw, "cpu", compact=True)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        if isinstance(v, jx.fc.CompactIds):
            assert isinstance(tp[k], tfc.CompactIds)
            assert tp[k].ids.dtype == torch.int32
            np.testing.assert_array_equal(tp[k].ids.numpy(), np.asarray(v.ids))
        elif np.asarray(v).dtype == jx.bf16:
            assert tp[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tp[k].view(torch.int16).numpy(),
                np.asarray(v).view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v))
    assert tp[tg.NUMERIC_PLANE].shape == (B, 13)
    assert tp["row_id"].dtype == torch.int32
    # The device-side view of the compact plane equals the full pack's.
    full = tg.pack_batch_np(raw, "cpu")
    for tname, tcols in tg._columns_by_table().items():
        a = tg._packed_view(tp, tname, tcols)
        b = tg._packed_view(full, tname, tcols)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert a[2] == b[2]
    np.testing.assert_array_equal(
        tg.numeric_features(tp).numpy(),
        np.asarray(jg.numeric_features(jp)))


def test_bfloat16_of_rounds_as_ml_dtypes_and_torch(jx):
    """The compact pack's float32 -> bfloat16 cast (torch's; the pack's
    planes against JAX's are in ``test_compact_pack_matches_jax``) rounds
    as ``ml_dtypes`` does: bit for bit on every non-NaN, including
    infinities, subnormals and ties; a NaN stays a NaN (torch drops its
    sign)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=1 << 16, dtype=np.uint64).astype(
        np.uint32)
    bits[:7] = [0x7F800000, 0xFF800000, 0x7FC00001, 0xFF800001, 0x00000001,
                0x7F7FFFFF, 0x3F808000]  # inf, NaNs, subnormal, ties
    a = bits.view(np.float32)
    got = torch.from_numpy(a).to(torch.bfloat16)
    with np.errstate(invalid="ignore"):  # ml_dtypes warns at NaNs
        want = a.astype(jx.bf16)
    nan = np.isnan(a)
    np.testing.assert_array_equal(got.view(torch.int16).numpy()[~nan],
                                  want.view(np.int16)[~nan])
    assert torch.isnan(got[torch.from_numpy(nan)]).all()
    assert np.isnan(want[nan].astype(np.float32)).all()


def test_compact_pack_keeps_wide_ids_as_pairs():
    tg = _group(embedding_dim=8, capacity=1 << 10, wide_in_deep=True)
    raw = tcriteo.SyntheticCriteo(B, vocab=1000, seed=2).next_batch_np(
        wide=False)  # per-field offsets i << 40: not int32
    tp = tg.pack_batch_np(raw, "cpu", compact=True)
    packed = [v for k, v in tp.items() if k.startswith(tg.PACKED_PREFIX)]
    assert packed and all(isinstance(v, tfc.SparseIds) for v in packed)


def test_compact_step_equals_full_step(tsv):
    """One training step from a compact pack and one from the full pack
    of the same rows: bf16 towers read the numerics in bf16 either way,
    so loss and state are equal."""
    batch = next(tcriteo.criteo_file_batches(tsv, B, as_numpy=True,
                                             wide=False, id_bits=31))
    out = []
    for compact in (False, True):
        tr = bench._assemble(
            twdl.criteo_columns(embedding_dim=8, capacity=1 << 10,
                                wide_in_deep=True),
            (16, 8), torch.bfloat16, "cpu", "adagrad", None, wide=False,
            metric="")
        ts, m = tr.step(tr.ts, tr.group.pack_batch_np(batch, "cpu",
                                                      compact=compact))
        out.append((float(m["loss"]), ts))
    (la, a), (lb, b) = out
    assert la == lb
    for name in a.ev:
        assert torch.equal(a.ev[name].values, b.ev[name].values)
        assert torch.equal(a.ev[name].table.key_rows,
                           b.ev[name].table.key_rows)
        assert torch.equal(a.slots[name]["accum"], b.slots[name]["accum"])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


# -- PrefetchIterator -------------------------------------------------------

def test_prefetch_preserves_items_and_overlaps():
    produced = []

    def make_iter():
        for i in range(20):
            time.sleep(0.005)
            produced.append(i)
            yield {"x": np.full((4,), i)}

    it = staged(make_iter, buffer_size=4, device=None)
    got = [int(b["x"][0]) for b in it]
    assert got == list(range(20)) == produced
    with pytest.raises(StopIteration):  # stays exhausted
        next(it)


def test_prefetch_transform_and_device_applied():
    it = staged(lambda: iter([{"x": np.ones(2),
                               "ids": tfc.CompactIds(torch.ones(2, 3))}] * 3),
                transform=lambda b: {**b, "x": b["x"] * 5}, device="cpu")
    items = list(it)
    assert len(items) == 3
    for b in items:
        assert isinstance(b["x"], torch.Tensor) and b["x"][0] == 5.0
        assert isinstance(b["ids"], tfc.CompactIds)


def test_prefetch_worker_exception_reaches_consumer():
    def make_iter():
        yield {"x": np.zeros(1)}
        raise KeyError("bad record")

    it = PrefetchIterator(make_iter, device=None)
    assert next(it)["x"][0] == 0
    with pytest.raises(KeyError, match="bad record"):
        next(it)


def test_prefetch_close_stops_workers():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((2,), i)}
            i += 1

    it = PrefetchIterator(endless, buffer_size=2, num_threads=2,
                          device=None)
    next(it)
    it.close()
    assert not any(t.is_alive() for t in it._threads)
    with pytest.raises(StopIteration):
        next(it)


@pytest.mark.cuda
def test_prefetch_to_card_keeps_every_batch(cuda_device):
    """Large batches and a busy consumer stream: a copy the consumer
    does not wait for, or a pinned buffer refilled too early, shows as
    a wrong value."""
    n = 40
    src = [{"x": torch.full((1 << 22,), float(i)),
            "ids": tfc.CompactIds(torch.full((B, 26), i, dtype=torch.int32))}
           for i in range(n)]
    todo = queue.Queue()
    for i in range(n):
        todo.put(i)

    def make_iter():  # the two workers share the items between them
        while True:
            try:
                yield src[todo.get_nowait()]
            except queue.Empty:
                return

    it = PrefetchIterator(make_iter, buffer_size=3, num_threads=2,
                          device=cuda_device)
    seen = []
    busy = torch.randn(1 << 22, device=cuda_device)
    for b in it:
        for _ in range(20):
            busy = torch.sin(busy)  # keeps the consumer's stream behind
        assert b["x"].is_cuda and b["ids"].ids.is_cuda
        i = int(b["ids"].ids[0, 0])
        ok = (b["x"] == float(i)).all() & (b["ids"].ids == i).all()
        seen.append((i, bool(ok)))
    assert sorted(i for i, _ in seen) == list(range(n))
    assert all(ok for _, ok in seen)
