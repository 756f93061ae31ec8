"""Port parity: the native host ops (``deeprec_tpu_torch/native``).

``hash_bytes``, ``unique``, ``parse_idlist``, ``parse_kvlist`` and
``hash_offset_unique`` against the JAX package's ``deeprec_tpu.native``,
bit for bit (values, dtypes, shapes), on seeded inputs and on the
reference tests' edge cases (``tests/test_native.py``): empty input,
an id list longer than ``max_len`` (clipped), keys outside the column
range (dropped), a partial tail (no newline at the end), and the fused
``hash_offset_unique`` against ``hash64`` + offset + ``unique`` done
apart. ``hash_bytes`` equals ``data/criteo._hash_token``, the Python
token hash the KServe front uses. The port's library has no numpy
fallback: both packages' C++ paths run here.
"""

import numpy as np
import pytest
import torch

from deeprec_tpu import native as jn
from deeprec_tpu_torch import native as tn
from deeprec_tpu_torch.data import criteo as tcriteo

torch.set_num_threads(1)


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_jax_package_runs_its_native_path():
    assert jn.have_native(), jn.native_error()


TOKENS = [b"abc", b"", b"abd", "abc", "user_42", "été",
          "68fd1e64", bytes(range(256))]


@pytest.mark.parametrize("salt", [0, 7, -1, 2**63 + 5])
def test_hash_bytes(salt):
    rng = np.random.default_rng(0)
    toks = TOKENS + [rng.bytes(int(k)) for k in rng.integers(0, 40, 200)]
    _same(tn.hash_bytes(toks, salt), jn.hash_bytes(toks, salt))
    _same(tn.hash_bytes([], salt), jn.hash_bytes([], salt))


def test_hash_bytes_is_the_python_token_hash():
    toks = [t for t in TOKENS if isinstance(t, str)] + ["", "zz", "0x1"]
    got = tn.hash_bytes(toks).view(np.uint64)
    assert [int(h) for h in got] == [tcriteo._hash_token(t) for t in toks]


@pytest.mark.parametrize("case", ["small", "random", "wide", "empty",
                                  "one", "sentinels"])
def test_unique(case):
    rng = np.random.default_rng(1)
    ids = {"small": np.array([5, 3, 5, 5, 9, 3], np.int64),
           "random": rng.integers(0, 5000, 20000),
           "wide": rng.integers(-2**63, 2**63 - 1, 3000, dtype=np.int64),
           "empty": np.array([], np.int64),
           "one": np.array([[42]], np.int64),
           "sentinels": np.array([np.iinfo(np.int64).min, 0, -1,
                                  np.iinfo(np.int64).max, 0],
                                 np.int64)}[case]
    got = tn.unique(ids)
    _same(got, jn.unique(ids))
    uniq, inverse, counts = got
    np.testing.assert_array_equal(uniq[inverse], ids.reshape(-1))
    assert counts.sum() == ids.size


IDLIST = {
    "basic": (b"1|2|3,7\n4,8|9\n", dict(ncols=2, max_len=3, pad=-1)),
    "overflow_clips": (b"1|2|3|4|5\n", dict(ncols=1, max_len=2)),
    "partial_tail": (b"1|2,3\n4|5|6,7", dict(ncols=2, max_len=3, pad=-7)),
    "empty": (b"", dict(ncols=2, max_len=3)),
    "empty_fields": (b",\n|,||\n-3|12,\n", dict(ncols=2, max_len=2)),
    "max_rows": (b"1\n2\n3\n4\n", dict(ncols=1, max_len=1, max_rows=2)),
    "delims": (b"1;2 3\n4 5;6;7\n", dict(ncols=2, max_len=2,
                                        field_delim=" ", list_delim=";")),
}


@pytest.mark.parametrize("case", sorted(IDLIST))
def test_parse_idlist(case):
    data, kw = IDLIST[case]
    kw = dict(kw, max_rows=kw.get("max_rows", 16))
    _same(tn.parse_idlist(data, **kw), jn.parse_idlist(data, **kw))


def test_parse_idlist_seeded():
    rng = np.random.default_rng(2)
    lines = [",".join("|".join(str(int(v)) for v in
                               rng.integers(-10**12, 10**12,
                                            rng.integers(0, 7)))
                      for _ in range(4)) for _ in range(300)]
    data = "\n".join(lines).encode()
    kw = dict(ncols=4, max_len=5, pad=-1, max_rows=400)
    got = tn.parse_idlist(data, **kw)
    _same(got, jn.parse_idlist(data, **kw))
    assert got[0] == 300


KVLIST = {
    "basic": (b"0:1.5|3:2.25,1:4\n2:0.5\n", dict(ncols=4)),
    "out_of_range": (b"9:1|1:2\n-1:3|2:-0.5\n", dict(ncols=3)),
    "later_wins": (b"1:1|1:2,1:3\n", dict(ncols=2)),
    "partial_tail": (b"0:1\n1:2.5|0:7", dict(ncols=2)),
    "empty": (b"", dict(ncols=3)),
    "no_colon": (b"1|2:4|:5\n", dict(ncols=3)),
    "delims": (b"0=1;1=2 2=3\n", dict(ncols=3, field_delim=" ",
                                      list_delim=";", kv_delim="=")),
}


@pytest.mark.parametrize("case", sorted(KVLIST))
def test_parse_kvlist(case):
    data, kw = KVLIST[case]
    kw = dict(kw, max_rows=8)
    _same(tn.parse_kvlist(data, **kw), jn.parse_kvlist(data, **kw))


def test_parse_kvlist_seeded():
    rng = np.random.default_rng(3)
    lines = [",".join("|".join(f"{int(k)}:{float(v):.4f}" for k, v in zip(
        rng.integers(-2, 40, 6), rng.normal(size=6))) for _ in range(3))
        for _ in range(200)]
    data = "\n".join(lines).encode()
    _same(tn.parse_kvlist(data, 32, max_rows=256),
          jn.parse_kvlist(data, 32, max_rows=256))


@pytest.mark.parametrize("hash_", [False, True])
@pytest.mark.parametrize("salt", [0, 5])
def test_hash_offset_unique(hash_, salt):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 100, (64, 4)).astype(np.int64)
    got = tn.hash_offset_unique(ids, salt=salt, hash=hash_)
    _same(got, jn.hash_offset_unique(ids, salt=salt, hash=hash_))
    # Fused against separate: hash64 (when asked), + col << 40, unique.
    x = tn.hash64(ids, salt) if hash_ else ids
    x = x + (np.arange(4, dtype=np.int64) << 40)[None, :]
    _same(got, tn.unique(x))


def test_hash_offset_unique_edges():
    for ids in (np.zeros((0, 3), np.int64), np.array([[1, 1], [1, 2]]),
                np.full((5, 1), -1, np.int64)):
        _same(tn.hash_offset_unique(ids), jn.hash_offset_unique(ids))
    got = tn.hash_offset_unique(np.array([[1, 1], [1, 2]]))[0]
    assert set(got.tolist()) == {1, 1 + (1 << 40), 2 + (1 << 40)}
