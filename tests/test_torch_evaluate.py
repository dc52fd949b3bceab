"""The port's ComputeModelStatistics against its own numpy path and the
JAX package's module, on the CPU.

The device path (torch ops on ``runtime.device``, here the CPU) must give
the numpy path's metrics, the confusion matrix bit for bit, and fetch its
results in exactly one counted host sync. The numpy path is the JAX
package's own code, copied; it is held against that module on the same
frame.
"""
import numpy as np
import pytest

from mmlspark_tpu.core.frame import Frame as JaxFrame
from mmlspark_tpu.core.schema import (
    ColumnSchema as JaxColumnSchema, DType as JaxDType,
    ScoreKind as JaxScoreKind, set_score_column as jax_set_score_column,
)
from mmlspark_tpu.evaluate.compute_model_statistics import (
    ComputeModelStatistics as JaxComputeModelStatistics,
)
from mmlspark_tpu.utils import config as jconfig
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import (
    ColumnSchema, DType, ScoreKind, set_score_column,
)
from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
    ComputeModelStatistics, _device_eval,
)
from mmlspark_tpu_torch.observability import syncs
from mmlspark_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")
    tconfig.unset("evaluate.device_rows")


def _scored(n=5000, seed=7, k=2):
    """Labels, predictions and quantized scores (heavy ties)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n).astype(np.float64)
    s1 = np.round(np.clip(rng.normal(0.3 + 0.4 * (y > 0), 0.3, n), 0, 1), 2)
    scores = np.stack([1 - s1, s1], axis=1).astype(np.float32)
    if k == 2:
        pred = (s1 > 0.5).astype(np.float64)
    else:
        pred = np.where(rng.random(n) < 0.7, y,
                        rng.integers(0, k, n)).astype(np.float64)
    return y, pred, scores


def _frame(Fr, CS, DT, SK, stamp, y, pred, scores):
    frame = Fr.from_dict({"label": y, "scored_labels": pred})
    frame = frame.with_column_values(CS("scores", DT.VECTOR), scores)
    schema = stamp(frame.schema, "scores", "m1", SK.SCORES,
                   SK.CLASSIFICATION)
    schema = stamp(schema, "scored_labels", "m1", SK.SCORED_LABELS,
                   SK.CLASSIFICATION)
    return Fr(schema, frame.partitions)


def _port_frame(*cols):
    return _frame(Frame, ColumnSchema, DType, ScoreKind, set_score_column,
                  *cols)


def _run(frame, device_rows):
    tconfig.set("evaluate.device_rows", device_rows)
    ev = ComputeModelStatistics()
    row = ev.transform(frame).head(1)[0]
    return {k: float(v) for k, v in row.items()}, ev


@pytest.mark.parametrize("k", [2, 3])
def test_device_path_matches_numpy_under_heavy_ties(k):
    """The port of the JAX package's device-path test: quantized scores
    make massive tie groups (the staircase's distinct-threshold grouping).
    The confusion matrix is exact on both paths; AUC and areaUnderPR are
    float32 sums on the device against float64 numpy, so the metrics are
    held at rtol 1e-5, atol 1e-6, as the JAX test holds its device path."""
    frame = _port_frame(*_scored(k=k))
    host, ev_host = _run(frame, 10 ** 9)
    before = syncs.counts().get("evaluate.finalize", 0)
    dev, ev_dev = _run(frame, 0)
    assert syncs.counts().get("evaluate.finalize", 0) == before + 1
    assert host.keys() == dev.keys()
    for name in host:
        np.testing.assert_allclose(dev[name], host[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(ev_dev.confusion_matrix,
                                  ev_host.confusion_matrix)
    assert ev_dev.roc_curve is None   # not fetched on the device path
    if k == 2:
        assert ev_host.roc_curve is not None
        assert "AUC" in dev and 0.5 < dev["AUC"] < 1.0


def test_device_eval_makes_exactly_one_sync_and_drops_padding():
    """5000 rows pad to 8192 (two 4096-row chunks): the pad rows must not
    count, and the whole evaluation is one counted sync."""
    y, pred, scores = _scored()
    before = syncs.total()
    cm, (auc, aupr) = _device_eval(y, pred, 2, scores[:, 1])
    assert syncs.total() == before + 1
    assert cm.sum() == 5000
    want = np.zeros((2, 2), np.int64)
    np.add.at(want, (y.astype(int), pred.astype(int)), 1)
    np.testing.assert_array_equal(cm, want)
    cm_only, none = _device_eval(y, pred, 2)
    assert none is None
    np.testing.assert_array_equal(cm_only, want)


@pytest.mark.parametrize("k", [2, 3])
def test_numpy_path_matches_the_jax_module(k):
    """Below evaluate.device_rows both packages run the same numpy code on
    the same frame: every metric equal (rtol 1e-12), and the same
    confusion matrix and ROC curve."""
    cols = _scored(n=600, seed=3, k=k)
    jframe = _frame(JaxFrame, JaxColumnSchema, JaxDType, JaxScoreKind,
                    jax_set_score_column, *cols)
    jconfig.set("evaluate.device_rows", 10 ** 9)
    try:
        jev = JaxComputeModelStatistics()
        want = {k_: float(v) for k_, v in
                jev.transform(jframe).head(1)[0].items()}
    finally:
        jconfig.unset("evaluate.device_rows")
    got, ev = _run(_port_frame(*cols), 10 ** 9)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   err_msg=name)
    np.testing.assert_array_equal(ev.confusion_matrix, jev.confusion_matrix)
    if k == 2:
        np.testing.assert_array_equal(ev.roc_curve, jev.roc_curve)


def test_regression_metrics_match_the_jax_module():
    rng = np.random.default_rng(5)
    y = rng.normal(size=300)
    pred = y + rng.normal(0, 0.3, 300)

    def stamped(Fr, SK, stamp):
        frame = Fr.from_dict({"label": y, "scores": pred})
        schema = stamp(frame.schema, "scores", "m", SK.SCORES, SK.REGRESSION)
        return Fr(schema, frame.partitions)
    want = JaxComputeModelStatistics().transform(
        stamped(JaxFrame, JaxScoreKind, jax_set_score_column)).head(1)[0]
    got = ComputeModelStatistics().transform(
        stamped(Frame, ScoreKind, set_score_column)).head(1)[0]
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-12, err_msg=name)
