"""The port's native C++ packer (``tempo_tpu_torch/native``) against the
numpy path, ``np.lexsort`` and the reference's engine (``tempo_tpu.
native``), on the same seeded inputs.

Every comparison is bitwise: layouts (``order``, ``starts``, sorted keys
and timestamps) and packed planes are selections and copies, with ties
kept in input order, NaN sequence values sorted last and int64
sequence ids above 2^53 compared exactly.  The two routes the engine
cannot express stay on numpy whatever ``TEMPO_TPU_NATIVE`` says (object
columns, ``uint64`` sequence values above 2^63), and a build that fails
raises instead of falling back.
"""

import os

import numpy as np
import pandas as pd
import pytest

from tempo_tpu import native as ref_native
from tempo_tpu import packing as ref_packing
from tempo_tpu_torch import native, packing


def _inputs(rng, n, n_keys, with_seq, with_ties):
    key_ids = rng.integers(0, n_keys, size=n).astype(np.int64)
    if with_ties:
        ts = rng.integers(0, max(n // 4, 2), size=n).astype(np.int64)
    else:
        ts = rng.permutation(n).astype(np.int64)
    seq = None
    if with_seq:
        seq = rng.standard_normal(n)
        seq[rng.random(n) < 0.2] = np.nan   # nulls sort last
    return key_ids, ts, seq


def _numpy_layout(key_ids, ts, seq, n_keys):
    order = (np.lexsort((seq, ts, key_ids)) if seq is not None
             else np.lexsort((ts, key_ids)))
    starts = np.concatenate([[0], np.cumsum(
        np.bincount(key_ids, minlength=n_keys))])
    return order, starts


@pytest.mark.parametrize("with_seq", [False, True])
@pytest.mark.parametrize("with_ties", [False, True])
@pytest.mark.parametrize("trial", range(3))
def test_sort_layout_is_lexsort_and_the_reference(with_seq, with_ties,
                                                  trial):
    rng = np.random.default_rng(100 + trial)
    n, n_keys = int(rng.integers(1, 500)), int(rng.integers(1, 16))
    key_ids, ts, seq = _inputs(rng, n, n_keys, with_seq, with_ties)
    order, starts = native.sort_layout(key_ids, ts, seq, n_keys)
    want_order, want_starts = _numpy_layout(key_ids, ts, seq, n_keys)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(starts, want_starts)
    r_order, r_starts = ref_native.sort_layout(key_ids, ts, seq, n_keys)
    np.testing.assert_array_equal(order, r_order)
    np.testing.assert_array_equal(starts, r_starts)


def test_sort_layout_empty_and_single():
    order, starts = native.sort_layout(np.zeros(0, np.int64),
                                       np.zeros(0, np.int64), None, 3)
    assert order.shape == (0,)
    np.testing.assert_array_equal(starts, [0, 0, 0, 0])
    order, starts = native.sort_layout(np.array([1], np.int64),
                                       np.array([7], np.int64), None, 2)
    np.testing.assert_array_equal(order, [0])
    np.testing.assert_array_equal(starts, [0, 0, 1])


@pytest.mark.parametrize("seq_dtype", [np.int64, np.uint64])
def test_integer_sequence_above_2_53_sorts_exactly(seq_dtype):
    """Ids that collide through float64 keep their integer order."""
    base = 1_700_000_000_000_000_000
    seq = np.array([base + 2, base + 1, base + 3], dtype=seq_dtype)
    zeros = np.zeros(3, dtype=np.int64)      # full (key, ts) tie
    for order, _ in (native.sort_layout(zeros, zeros, seq, 1),
                     packing._sort_layout(zeros, zeros, seq, 1),
                     ref_packing._sort_layout(zeros, zeros, seq, 1)):
        np.testing.assert_array_equal(order, [1, 0, 2])


def test_uint64_above_2_63_stays_on_numpy(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("uint64 above 2^63 reached the engine")

    monkeypatch.setattr(native, "sort_layout", refuse)
    seq = np.array([2**64 - 1, 2**63 + 5, 3], dtype=np.uint64)
    zeros = np.zeros(3, dtype=np.int64)
    order, starts = packing._sort_layout(zeros, zeros, seq, 1)
    np.testing.assert_array_equal(order, np.lexsort((seq, zeros, zeros)))
    np.testing.assert_array_equal(order, [2, 1, 0])


@pytest.mark.parametrize("dtype,fill", [
    (np.float32, np.nan), (np.float64, np.nan), (np.int64, packing.TS_PAD),
    (np.bool_, False), (np.int32, 0), ("datetime64[ns]", np.datetime64("NaT")),
])
def test_pack_unpack_match_numpy_and_the_reference(monkeypatch, dtype,
                                                   fill):
    rng = np.random.default_rng(7)
    n, n_keys = 333, 9
    key_ids = np.sort(rng.integers(0, n_keys, size=n)).astype(np.int64)
    lay = packing.build_layout_from_codes(
        key_ids, np.arange(n, dtype=np.int64), None, n_keys)
    L = packing.pad_length(int(lay.lengths.max()))
    vals = rng.integers(0, 1000, size=n).astype(dtype)
    packed = packing.pack_column(vals, lay, L, fill=fill)
    back = packing.unpack_column(packed, lay)
    ref = ref_native.pack(vals, lay.starts, L, fill)
    assert packed.tobytes() == ref.tobytes()
    monkeypatch.setenv("TEMPO_TPU_NATIVE", "0")
    want = packing.pack_column(vals, lay, L, fill=fill)
    assert packed.dtype == want.dtype and packed.shape == want.shape
    assert packed.tobytes() == want.tobytes()
    assert back.tobytes() == packing.unpack_column(want, lay).tobytes()
    assert back.tobytes() == vals.tobytes()


def test_take_matches_fancy_index_for_rows_and_planes():
    rng = np.random.default_rng(3)
    order = rng.permutation(100).astype(np.int64)
    flat = rng.standard_normal(100).astype(np.float32)
    rows = rng.integers(0, 9, size=(100, 3, 2))
    assert native.take(flat, order).tobytes() == flat[order].tobytes()
    assert native.take(rows, order).tobytes() == rows[order].tobytes()
    assert packing.take(flat, order).tobytes() == \
        ref_native.take(flat, order).tobytes()


def test_object_columns_stay_on_numpy(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an object column reached the engine")

    for name in ("take", "pack", "unpack"):
        monkeypatch.setattr(native, name, refuse)
    vals = np.array(["b", None, "a", "c"], dtype=object)
    order = np.array([2, 0, 3, 1])
    np.testing.assert_array_equal(packing.take(vals, order), vals[order])
    lay = packing.FlatLayout(key_ids=np.array([0, 0, 1, 1]),
                             ts_ns=np.arange(4), order=np.arange(4),
                             starts=np.array([0, 2, 4]), key_frame=None)
    packed = packing.pack_column(vals, lay, 8, fill=None)
    assert packed.shape == (2, 8) and packed[1, 1] == "c"
    np.testing.assert_array_equal(packing.unpack_column(packed, lay), vals)


def test_pack_overflow_raises():
    with pytest.raises(IndexError, match="padded_len"):
        native.pack(np.arange(5, dtype=np.float64),
                    np.array([0, 5], dtype=np.int64), 3, np.nan)


def _frame(seed=11, n=400):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 7, size=n).astype(str),
        "ts": pd.to_datetime(rng.integers(0, 10**6, size=n), unit="s"),
        "seq": np.where(rng.random(n) < 0.1, np.nan,
                        rng.integers(0, 5, size=n).astype(float)),
        "x": rng.standard_normal(n),
    })


@pytest.mark.parametrize("seq_col", [None, "seq"])
def test_flat_layout_is_the_same_both_ways_and_in_the_reference(
        monkeypatch, seq_col):
    df = _frame()
    calls = []
    real_sort = native.sort_layout
    monkeypatch.setattr(native, "sort_layout",
                        lambda *a: calls.append(1) or real_sort(*a))
    on = packing.build_flat_layout(df, "ts", ["k"], seq_col)
    assert calls, "TEMPO_TPU_NATIVE unset did not run the engine"
    monkeypatch.setenv("TEMPO_TPU_NATIVE", "0")
    off = packing.build_flat_layout(df, "ts", ["k"], seq_col)
    assert len(calls) == 1, "TEMPO_TPU_NATIVE=0 still ran the engine"
    ref = ref_packing.build_flat_layout(df, "ts", ["k"], seq_col)
    for other in (off, ref):
        for field in ("order", "starts", "key_ids", "ts_ns"):
            a, b = getattr(on, field), getattr(other, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("threads", ["1", "3"])
def test_thread_count_changes_no_bit(monkeypatch, threads):
    rng = np.random.default_rng(5)
    key_ids, ts, seq = _inputs(rng, 3000, 13, True, True)
    want = native.sort_layout(key_ids, ts, seq, 13)
    monkeypatch.setenv("TEMPO_TPU_NATIVE_THREADS", threads)
    assert native.threads() == int(threads)
    got = native.sort_layout(key_ids, ts, seq, 13)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("TEMPO_TPU_KERNEL_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="native packer build failed"):
        packing._sort_layout(np.zeros(2, np.int64), np.zeros(2, np.int64),
                             None, 1)
    assert not list(tmp_path.glob("*.so")), "a failed build left a file"


def test_a_compile_error_raises_with_the_compiler_output(monkeypatch,
                                                          tmp_path):
    bad = tmp_path / "packer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("TEMPO_TPU_KERNEL_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.lib()


def test_a_source_newer_than_the_library_rebuilds(monkeypatch, tmp_path):
    src = tmp_path / "packer.cpp"
    src.write_bytes(native.SRC.read_bytes())
    monkeypatch.setenv("TEMPO_TPU_KERNEL_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "SRC", src)
    lib_path = native.build()
    old = src.stat().st_mtime - 100
    os.utime(lib_path, (old, old))
    assert native.build().stat().st_mtime > old, "stale library kept"
    built = lib_path.stat().st_mtime_ns
    assert native.build().stat().st_mtime_ns == built, "rebuilt again"
