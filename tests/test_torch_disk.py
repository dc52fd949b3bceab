"""The port's DiskFrame against the JAX package's, on the CPU.

One on-disk layout (``schema.json`` + ``chunkNNNNN/<col>.npy``): a
directory either package writes opens in the other with the same rows;
``shuffled_batches`` draws the reference's order from the same seed;
``CheckpointData(diskIncluded=True)`` stages the same frame; and
``DeepClassifier`` fitted on a DiskFrame tracks the JAX fit at the
tolerance of ``tests/test_torch_deep.py`` (rtol 1e-4: CPU matmuls sum in
other orders).
"""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmlspark_tpu.core.disk import DiskFrame as JDiskFrame
from mmlspark_tpu.core.disk import write_frame as jwrite_frame
from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.core.schema import ColumnSchema as JColumnSchema
from mmlspark_tpu.core.schema import DType as JDType
from mmlspark_tpu.core.schema import Schema as JSchema
from mmlspark_tpu.models.zoo import build_model as jax_build_model
from mmlspark_tpu.parallel.mesh import data_parallel_mesh
from mmlspark_tpu.stages.stages import CheckpointData as JCheckpointData
from mmlspark_tpu.train.deep import DeepClassifier as JDeepClassifier
from mmlspark_tpu_torch.core.disk import DiskFrame, write_frame
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import (
    ColumnSchema, DType, Schema, SchemaError,
)
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.stages.stages import CheckpointData
from mmlspark_tpu_torch.train import deep as tdeep
from mmlspark_tpu_torch.train.deep import DeepClassifier
from mmlspark_tpu_torch.utils import config as tconfig

TIME_LIMIT_S = 120


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test of this file fails after TIME_LIMIT_S seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TIME_LIMIT_S} s limit")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _data(n=1000, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    return {"features": X, "label": (X[:, 0] > 0).astype(np.int64)}


def _columns(frame, names=("features", "label")):
    return {n: np.asarray(frame.column(n)) for n in names}


def _listing(directory):
    out = {}
    for root, _dirs, files in os.walk(directory):
        for f in files:
            path = os.path.join(root, f)
            out[os.path.relpath(path, directory)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_opens_the_others_directory(tmp_path, writer):
    """The same frame written by each package gives byte-identical
    directories, and each package's DiskFrame reads the other's."""
    data = _data()
    jwrite_frame(JFrame.from_dict(data), str(tmp_path / "jax"),
                 rows_per_chunk=256)
    write_frame(Frame.from_dict(data), str(tmp_path / "port"),
                rows_per_chunk=256)
    assert _listing(tmp_path / "jax") == _listing(tmp_path / "port")
    other = str(tmp_path / ("port" if writer == "jax" else "jax"))
    opener = DiskFrame if writer == "jax" else JDiskFrame
    df = opener.open(other)
    assert df.count() == 1000 and df.num_partitions == 4
    assert df.schema.names == ["features", "label"]
    got = _columns(df)
    for n in data:
        np.testing.assert_array_equal(got[n], data[n])
    assert len(df.head(3)) == 3
    meta = json.load(open(os.path.join(other, "schema.json")))
    assert meta["chunk_rows"] == [256, 256, 256, 232]


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("window", [1, 4])
def test_shuffled_batches_give_the_reference_order(tmp_path, seed, window):
    data = _data(n=1117)
    jwrite_frame(JFrame.from_dict(data), str(tmp_path / "df"),
                 rows_per_chunk=128)
    kw = dict(window_chunks=window)
    got = list(DiskFrame.open(str(tmp_path / "df")).shuffled_batches(
        64, rng=np.random.default_rng(seed), **kw))
    want = list(JDiskFrame.open(str(tmp_path / "df")).shuffled_batches(
        64, rng=np.random.default_rng(seed), **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for n in ("features", "label"):
            np.testing.assert_array_equal(g[n], w[n])
    rows = np.sort(np.concatenate([b["features"][:, 0] for b in got]))
    np.testing.assert_array_equal(rows, np.sort(data["features"][:, 0]))


def test_streaming_writes_pin_dtypes_and_refuse_what_the_reference_refuses(
        tmp_path):
    schema = Schema([ColumnSchema("x", DType.VECTOR, 2),
                     ColumnSchema("y", DType.INT32)])
    jschema = JSchema([JColumnSchema("x", JDType.VECTOR, 2),
                       JColumnSchema("y", JDType.INT32)])

    def gen():  # float64 lists one batch, float32 arrays the next
        yield {"x": [[0.5, 1.5]], "y": [1]}
        yield {"x": np.zeros((3, 2), np.float32), "y": np.zeros(3, np.int64)}
    write_frame(gen(), str(tmp_path / "port"), rows_per_chunk=2,
                schema=schema)
    jwrite_frame(gen(), str(tmp_path / "jax"), rows_per_chunk=2,
                 schema=jschema)
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    for b in DiskFrame.open(str(tmp_path / "port")).batches(2):
        assert b["x"].dtype == np.float32 and b["y"].dtype == np.int32
    with pytest.raises(SchemaError, match="ragged batch"):
        write_frame(iter([{"x": np.zeros((2, 2), np.float32),
                           "y": np.zeros(3, np.int32)}]),
                    str(tmp_path / "r"), schema=schema)
    with pytest.raises(SchemaError, match="explicit schema"):
        write_frame(iter([]), str(tmp_path / "e"))
    with pytest.raises(SchemaError, match="numeric/vector"):
        write_frame(Frame.from_dict({"s": ["a", "b"], "v": [1.0, 2.0]}),
                    str(tmp_path / "o"))

    def uint8_then_float():
        yield {"x": np.full((3, 2), 7, np.uint8), "y": np.zeros(3)}
        yield {"x": np.full((3, 2), 0.5, np.float32), "y": np.zeros(3)}
    with pytest.raises(SchemaError, match="stored as uint8"):
        write_frame(uint8_then_float(), str(tmp_path / "u"),
                    rows_per_chunk=2, schema=schema)


def test_checkpoint_data_disk_included_matches_the_reference(tmp_path):
    """Staged into a given directory, the two packages write the same
    bytes; staged into a temp directory, ``removeCheckpoint`` brings the
    rows back in memory and deletes the staging."""
    data = _data(n=300)
    CheckpointData(diskIncluded=True, checkpointDir=str(
        tmp_path / "port")).transform(Frame.from_dict(data,
                                                      num_partitions=3))
    JCheckpointData(diskIncluded=True, checkpointDir=str(
        tmp_path / "jax")).transform(JFrame.from_dict(data,
                                                      num_partitions=3))
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    staged = CheckpointData(diskIncluded=True).transform(
        Frame.from_dict(data))
    assert isinstance(staged, DiskFrame) and staged._out_of_core
    directory = staged._checkpoint_dir
    back = CheckpointData(removeCheckpoint=True).transform(staged)
    assert type(back) is Frame and not os.path.exists(directory)
    for n in data:
        np.testing.assert_array_equal(back.column(n), data[n])


def test_validation_split_refuses_a_disk_frame(tmp_path):
    write_frame(Frame.from_dict(_data(n=200)), str(tmp_path / "df"),
                rows_per_chunk=64)
    learner = DeepClassifier(batchSize=64, epochs=1, validationSplit=0.2)
    learner.set_params(featuresCol="features", labelCol="label")
    with pytest.raises(ValueError, match="out-of-core"):
        learner.fit(DiskFrame.open(str(tmp_path / "df")))


def test_deep_classifier_on_a_disk_frame_tracks_the_jax_fit(tmp_path,
                                                            monkeypatch):
    """Both packages fit on the same DiskFrame directory, streaming
    (deviceCache 'off': the two-level DiskFrame shuffle from the same
    (seed, epoch) generators), fp32, from the JAX init: the final loss
    and the parameters within rtol 1e-4 (CPU matmuls sum in other
    orders), and the port's predictions separate the classes."""
    data = _data(n=1200, d=8, seed=5)
    jwrite_frame(JFrame.from_dict(data), str(tmp_path / "df"),
                 rows_per_chunk=256)
    kw = dict(architecture="mlp_tabular", architectureArgs={"hidden": [16]},
              batchSize=128, epochs=2, learningRate=1e-2,
              trainDtype="float32", deviceCache="off")
    jl = JDeepClassifier(meshSpec=data_parallel_mesh(jax.devices()[:1]),
                         **kw)
    jl.set_params(featuresCol="features", labelCol="label")
    jm = jl.fit(JDiskFrame.open(str(tmp_path / "df")))
    spec = jax_build_model("mlp_tabular", input_dim=8, hidden=[16],
                           num_classes=2, dtype="float32")
    jparams = jax.tree_util.tree_map(np.asarray, spec["module"].init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8))))
    monkeypatch.setattr(tdeep._DeepEstimatorBase, "_init_params",
                        lambda self, module, seed: from_jax_params(jparams))
    tl = DeepClassifier(**kw)
    tl.set_params(featuresCol="features", labelCol="label")
    frame = DiskFrame.open(str(tmp_path / "df"))
    tm = tl.fit(frame)
    np.testing.assert_allclose(float(tm._state["final_loss"]),
                               float(jm._state["final_loss"]), rtol=1e-4)
    want = from_jax_params(jm._state["params"])
    for k, v in want.items():
        np.testing.assert_allclose(tm._state["params"][k], v, rtol=1e-4,
                                   atol=1e-6)
    pred = np.asarray(tm.transform(frame).column("prediction"))
    assert (pred == data["label"]).mean() > 0.9
