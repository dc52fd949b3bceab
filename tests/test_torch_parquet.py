"""The port's ``read_parquet`` / ``write_parquet`` against the JAX
package's (``tests/test_image.py``'s parquet tests restated): a file
written by either package reads back in the other with equal columns and
column types, both ways; the column-type dispatch follows the Arrow type;
ragged numeric lists and IMAGE columns are refused; a directory of part
files reads whole; an empty process shard keeps the real schema. Exact
equality throughout, except float32 vectors (rtol 1e-6, as the
reference's test holds them)."""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.io import readers as jreaders
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import (ColumnSchema, DType,
                                            ImageValue)
from mmlspark_tpu_torch.io import readers


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": np.arange(10.0),
        "i": np.arange(10, dtype=np.int64),
        "s": [f"w{i}" for i in range(10)],
        "v": rng.normal(size=(10, 3)).astype(np.float32),
        "tok": [["a", "b"], ["c"]] * 5,
        "raw": [bytes([i]) for i in range(10)],
    }


def _same_frames(got, want):
    """Equal column names, types and values (the two packages' schemas
    compared by their dtype names)."""
    assert got.columns == want.columns
    for c in want.columns:
        assert got.schema[c].dtype.name == want.schema[c].dtype.name, c
        assert got.schema[c].dim == want.schema[c].dim, c
        g, w = got.column(c), want.column(c)
        if want.schema[c].dtype.name == "VECTOR":
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-6)
        elif isinstance(w, np.ndarray) and w.dtype != object:
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == w.dtype, c
        else:
            assert list(g) == list(w), c


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_between_the_packages(tmp_path, writer):
    """A file written by one package reads equal in both (round trip,
    column projection included)."""
    p = str(tmp_path / "t.parquet")
    if writer == "port":
        readers.write_parquet(Frame.from_dict(_columns()), p)
    else:
        jreaders.write_parquet(JFrame.from_dict(_columns()), p)
    got, want = readers.read_parquet(p), jreaders.read_parquet(p)
    _same_frames(got, want)
    assert got.schema["v"].dim == 3
    assert got.schema["tok"].dtype == DType.TOKENS
    assert got.schema["raw"].dtype == DType.BINARY
    np.testing.assert_allclose(got.column("v"), _columns()["v"], rtol=1e-6)
    assert got.column("raw")[3] == b"\x03"
    sub = readers.read_parquet(p, columns=["x", "s"])
    assert sub.columns == ["x", "s"]
    _same_frames(sub, jreaders.read_parquet(p, columns=["x", "s"]))


def test_written_files_are_equal_tables(tmp_path):
    """Both writers give the same Arrow table for one frame."""
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    readers.write_parquet(Frame.from_dict(_columns()), a)
    jreaders.write_parquet(JFrame.from_dict(_columns()), b)
    ta, tb = pq.read_table(a), pq.read_table(b)
    assert ta.schema.equals(tb.schema)
    assert ta.equals(tb)


def test_image_columns_are_refused(tmp_path):
    imgs = np.empty(2, dtype=object)
    for i in range(2):
        imgs[i] = ImageValue(path="m", data=np.zeros((2, 2, 3), np.uint8))
    fi = Frame.from_dict({"a": [1.0, 2.0]}).with_column_values(
        ColumnSchema("image", DType.IMAGE), imgs)
    with pytest.raises(ValueError, match="IMAGE"):
        readers.write_parquet(fi, str(tmp_path / "bad.parquet"))


def test_directory_of_parts(tmp_path):
    """Parts written by the port read whole in both packages, and feed
    the port's training path."""
    d = tmp_path / "dataset"
    d.mkdir()
    for i in range(3):
        part = Frame.from_dict({"x": np.arange(4.0) + 4 * i,
                                "y": np.full(4, i)})
        readers.write_parquet(part, str(d / f"part-{i:05d}.parquet"))
    g = readers.read_parquet(str(d))
    assert g.count() == 12
    np.testing.assert_array_equal(np.sort(g.column("x")), np.arange(12.0))
    _same_frames(g, jreaders.read_parquet(str(d)))
    from mmlspark_tpu_torch.train.learners import LogisticRegression
    from mmlspark_tpu_torch.train.train_classifier import TrainClassifier
    from mmlspark_tpu_torch.utils import config
    config.set("runtime.device", "cpu")
    try:
        model = TrainClassifier(model=LogisticRegression(maxIter=20),
                                labelCol="y").fit(
            g.filter(lambda p: p["y"] < 2))
    finally:
        config.unset("runtime.device")
    assert model is not None


def test_type_dispatch_and_refusals(tmp_path):
    """Conversion follows the Arrow TYPE in both packages: ragged numeric
    lists are refused, lists of strings with empties and nulls stay
    TOKENS."""
    p = str(tmp_path / "e.parquet")
    pq.write_table(pa.table({
        "ragged": pa.array([[1.0, 2.0], None, [3.0]],
                           type=pa.list_(pa.float64())),
        "x": pa.array([1.0, 2.0, 3.0])}), p)
    for mod in (readers, jreaders):
        with pytest.raises(ValueError, match="ragged"):
            mod.read_parquet(p)

    pq.write_table(pa.table({
        "tok": pa.array([[], None, ["a"]], type=pa.list_(pa.string())),
        "b": pa.array([True, False, True]),
        "n": pa.array([1, 2, 3], type=pa.int32()),
        "x": pa.array([1.0, 2.0, 3.0])}), p)
    g = readers.read_parquet(p)
    assert g.schema["tok"].dtype == DType.TOKENS  # empties stay TOKENS
    _same_frames(g, jreaders.read_parquet(p))


def test_empty_shard_keeps_the_real_schema(tmp_path, monkeypatch):
    """More ranks than part files: a 0-row frame with the real schema,
    as the reference gives."""
    d = tmp_path / "parts"
    d.mkdir()
    pq.write_table(pa.table({"v": pa.array([[1.0, 2.0]],
                                           type=pa.list_(pa.float64())),
                             "y": pa.array([1])}),
                   str(d / "part-0.parquet"))
    monkeypatch.setattr(readers, "_process_slice", lambda items, shard: [])
    monkeypatch.setattr(jreaders, "_process_slice", lambda items, shard: [])
    empty = readers.read_parquet(str(d), process_shard=True)
    want = jreaders.read_parquet(str(d), process_shard=True)
    assert empty.count() == 0 == want.count()
    assert empty.columns == ["v", "y"] == want.columns
    assert [c.dtype.name for c in empty.schema] == \
        [c.dtype.name for c in want.schema]


def test_process_shard_keeps_the_ranks_part_files(tmp_path, monkeypatch):
    """``process_shard=True`` on a directory keeps this rank's slice of
    the sorted part list (``data_shard``'s block), as the reference keeps
    its host's."""
    d = tmp_path / "parts"
    d.mkdir()
    for i in range(4):
        readers.write_parquet(
            Frame.from_dict({"x": np.arange(2.0) + 2 * i}),
            str(d / f"part-{i}.parquet"))
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    monkeypatch.setattr(meshlib, "data_shard", lambda: (1, 2))
    got = readers.read_parquet(str(d), process_shard=True)
    np.testing.assert_array_equal(got.column("x"), [4.0, 5.0, 6.0, 7.0])
