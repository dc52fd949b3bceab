"""The port's AutoML path on its own: read_csv -> TrainClassifier /
TrainRegressor -> ComputeModelStatistics / FindBestModel, held to the
repo's golden metrics.

This file imports no JAX, so the tests marked ``cuda`` can run on a card's
machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_automl.py

Without a card they skip. Everything else runs on the CPU
(``runtime.device="cpu"``).
"""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.serialization import load_stage, save_stage
from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
    ComputeModelStatistics,
)
from mmlspark_tpu_torch.evaluate.compute_per_instance_statistics import (
    ComputePerInstanceStatistics,
)
from mmlspark_tpu_torch.evaluate.find_best_model import BestModel, FindBestModel
from mmlspark_tpu_torch.io.readers import read_csv
from mmlspark_tpu_torch.observability import syncs
from mmlspark_tpu_torch.stages import SelectColumns
from mmlspark_tpu_torch.train.deep import DeepClassifier
from mmlspark_tpu_torch.train.learners import (
    LinearRegression, LogisticRegression, MLPClassifier, MLPRegressor,
    NaiveBayes,
)
from mmlspark_tpu_torch.train.train_classifier import (
    TrainClassifier, TrainedClassifierModel, TrainRegressor,
)
from mmlspark_tpu_torch.train.trees import (
    DecisionTreeClassifier, GBTClassifier, GBTRegressor,
    RandomForestClassifier,
)
from mmlspark_tpu_torch.utils import config as tconfig

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN = os.path.join(DATA, "benchmark_metrics.json")
TOL = 5e-3   # the golden harness's (tests/test_golden_metrics.py)
DATASETS = {
    "banknote_like.csv": ("class", True),
    "abalone_like.csv": ("rings_band", False),
    "pima_like.csv": ("diabetes", True),
    "car_eval_like.csv": ("grade", False),
}
# the golden harness's constructors (tests/test_golden_metrics.py)
LEARNERS = {
    "LogisticRegression": lambda: LogisticRegression(maxIter=60),
    "DecisionTreeClassification": lambda: DecisionTreeClassifier(maxDepth=5),
    "RandomForestClassification": lambda: RandomForestClassifier(
        numTrees=16, maxDepth=5, seed=7),
    "GradientBoostedTreesClassification": lambda: GBTClassifier(
        maxIter=20, maxDepth=3),
    "NaiveBayesClassifier": lambda: NaiveBayes(),
    "MultilayerPerceptronClassifier": lambda: MLPClassifier(
        maxIter=200, layers=[16], seed=3),
}
BINARY_ONLY = {"GradientBoostedTreesClassification"}
# the golden cells the JAX package's own harness skips as toolchain-bound
# (tests/test_golden_metrics.py ENV_DRIFT); tests/test_torch_learners.py
# holds the port's fit of these two against the JAX fit in the same run
ENV_DRIFT = {
    ("abalone_like.csv", "MultilayerPerceptronClassifier"),
    ("banknote_like.csv", "MultilayerPerceptronClassifier"),
}


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


def _cells(dataset):
    return [n for n in sorted(LEARNERS)
            if DATASETS[dataset][1] or n not in BINARY_ONLY]


def _fit(dataset, learner):
    frame = read_csv(os.path.join(DATA, dataset), num_partitions=2)
    model = TrainClassifier(model=LEARNERS[learner](),
                            labelCol=DATASETS[dataset][0]).fit(frame)
    return model, frame


def _metrics(model, frame):
    return ComputeModelStatistics().transform(model.transform(frame)).head(
        1)[0]


@pytest.mark.parametrize("dataset,learner", [
    (d, l) for d in sorted(DATASETS) for l in _cells(d)
    if (d, l) not in ENV_DRIFT])
def test_golden_metrics_hold_on_the_port(dataset, learner):
    """Each (dataset x learner) cell of the golden file, within TOL."""
    model, frame = _fit(dataset, learner)
    got = _metrics(model, frame)
    for metric, want in _golden()[dataset][learner].items():
        assert abs(round(float(got[metric]), 4) - want) <= TOL, (
            dataset, learner, metric, want, float(got[metric]))


def test_golden_file_cells_are_all_held():
    """The cells above and the two ENV_DRIFT cells cover the golden file."""
    golden = _golden()
    assert sorted(golden) == sorted(DATASETS)
    for ds, cells in golden.items():
        assert sorted(cells) == _cells(ds)
    assert all(l in golden[d] for d, l in ENV_DRIFT)


def test_trained_classifier_output_columns_and_metadata():
    model, frame = _fit("car_eval_like.csv", "LogisticRegression")
    scored = model.transform(frame)
    for col in ("scored_labels", "scores", "scored_probabilities"):
        assert col in scored.schema
        assert scored.schema[col].metadata["score_value_kind"] \
            == "classification"
    assert "features" not in scored.schema
    levels = model.levels
    assert scored.schema["scored_labels"].categorical.levels == levels
    # scored labels are level indices; the metadata maps them to levels
    assert set(np.asarray(scored.column("scored_labels")).tolist()) \
        <= set(range(len(levels)))
    probs = np.asarray(scored.column("scored_probabilities"))
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)


def test_explicit_label_order_is_kept():
    frame = read_csv(os.path.join(DATA, "pima_like.csv"))
    model = TrainClassifier(model=NaiveBayes(), labelCol="diabetes",
                            labels=[1, 0]).fit(frame)
    assert model.levels == [1, 0]
    m = _metrics(model, frame)
    assert 0.5 < float(m["accuracy"]) <= 1.0


def test_train_classifier_takes_a_deep_learner():
    """TrainClassifier(model=DeepClassifier(...)): the deep learner's
    featurize hints apply, and it scores like the built-in learners."""
    frame = read_csv(os.path.join(DATA, "banknote_like.csv"))
    model = TrainClassifier(model=DeepClassifier(
        architecture="mlp_tabular", architectureArgs={"hidden": [16]},
        batchSize=64, epochs=8, learningRate=1e-2), labelCol="class").fit(
        frame)
    assert float(_metrics(model, frame)["accuracy"]) > 0.85


# -- TrainRegressor -----------------------------------------------------------
def _flights(n=1200, seed=1):
    return chip_smoke.flight_frame(n, np.random.default_rng(seed),
                                   num_partitions=2)


@pytest.mark.parametrize("make", [
    lambda: LinearRegression(regParam=0.1),
    lambda: MLPRegressor(layers=[32], maxIter=150),
    lambda: GBTRegressor(maxIter=30, maxDepth=4)])
def test_train_regressor_fits_the_flight_frame(make):
    """Example 102's flow: TrainRegressor, ComputeModelStatistics and
    ComputePerInstanceStatistics; ArrDelay's noise is 1.5, so a fit that
    learned the signal has R^2 above 0.9."""
    train, test = _flights(), _flights(400, seed=2)
    model = TrainRegressor(model=make(), labelCol="ArrDelay").fit(train)
    scored = model.transform(test)
    m = ComputeModelStatistics().transform(scored).head(1)[0]
    assert float(m["r2"]) > 0.9
    per_row = ComputePerInstanceStatistics().transform(scored)
    resid = np.asarray(scored.column("scores")) \
        - np.asarray(scored.column("ArrDelay"))
    np.testing.assert_allclose(per_row.column("L1_loss"), np.abs(resid),
                               rtol=1e-12)
    np.testing.assert_allclose(float(m["rmse"]),
                               np.sqrt(np.mean(resid ** 2)), rtol=1e-6)


def test_train_regressor_rejects_string_labels():
    frame = Frame.from_dict({"x": [1.0, 2.0], "y": ["a", "b"]})
    with pytest.raises(ValueError, match="string"):
        TrainRegressor(model=LinearRegression(), labelCol="y").fit(frame)


def test_learners_require_a_model():
    frame = Frame.from_dict({"x": [1.0, 2.0], "y": [0, 1]})
    with pytest.raises(ValueError, match="model"):
        TrainClassifier(labelCol="y").fit(frame)


# -- FindBestModel -------------------------------------------------------------
def test_find_best_model_picks_the_highest_auc():
    frame = read_csv(os.path.join(DATA, "pima_like.csv"))
    candidates = [TrainClassifier(model=make(), labelCol="diabetes").fit(
        frame) for make in (lambda: DecisionTreeClassifier(maxDepth=1),
                            lambda: LogisticRegression(maxIter=60),
                            lambda: NaiveBayes())]
    aucs = [float(_metrics(m, frame)["AUC"]) for m in candidates]
    best = FindBestModel(models=candidates,
                         evaluationMetric="AUC").fit(frame)
    assert best.get("bestModel") is candidates[int(np.argmax(aucs))]
    assert best._state["best_metric"] == pytest.approx(max(aucs))
    table = best.all_model_metrics.collect()
    assert table["model_uid"].tolist() == [m.uid for m in candidates]
    np.testing.assert_allclose(table["AUC"], aucs)
    assert best.roc_curve is not None and best.scored_dataset is not None
    np.testing.assert_array_equal(
        best.transform(frame).column("scored_labels"),
        best.get("bestModel").transform(frame).column("scored_labels"))


def test_find_best_model_ranks_rmse_lowest_first():
    train = _flights(800)
    candidates = [TrainRegressor(model=make(), labelCol="ArrDelay").fit(train)
                  for make in (lambda: GBTRegressor(maxIter=2, maxDepth=1),
                               lambda: LinearRegression(regParam=0.1))]
    best = FindBestModel(models=candidates, evaluationMetric="rmse").fit(
        train)
    assert best.get("bestModel") is candidates[1]
    with pytest.raises(ValueError, match="unknown metric"):
        FindBestModel(models=candidates, evaluationMetric="nope").fit(train)


def test_best_model_round_trips(tmp_path):
    frame = read_csv(os.path.join(DATA, "banknote_like.csv"))
    model = TrainClassifier(model=NaiveBayes(), labelCol="class").fit(frame)
    best = FindBestModel(models=[model], evaluationMetric="accuracy").fit(
        frame)
    save_stage(best, str(tmp_path / "best"))
    again = load_stage(str(tmp_path / "best"))
    assert isinstance(again, BestModel)
    np.testing.assert_array_equal(
        again.transform(frame).column("scored_probabilities"),
        best.transform(frame).column("scored_probabilities"))


# -- save / load ----------------------------------------------------------------
@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_trained_classifier_model_round_trips(tmp_path, learner):
    """save_stage / load_stage of a fitted TrainedClassifierModel scores
    bit for bit as the model it was saved from."""
    model, frame = _fit("pima_like.csv", learner)
    path = str(tmp_path / "m")
    save_stage(model, path)
    again = load_stage(path)
    assert isinstance(again, TrainedClassifierModel)
    assert again.levels == model.levels
    for col in ("scored_labels", "scored_probabilities", "scores"):
        np.testing.assert_array_equal(
            np.asarray(again.transform(frame).column(col)),
            np.asarray(model.transform(frame).column(col)))


# -- the torch twin of examples/101 ---------------------------------------------
def test_adult_census_flow_of_example_101(tmp_path):
    """Example 101's flow on the port: select columns, TrainClassifier
    with LogisticRegression(regParam=0.01), save / load, score, evaluate;
    then the DeepClassifier variant with a cosine schedule, warmup and a
    held-out split. The frame is chip_smoke.py's Adult-shaped one, small."""
    data = chip_smoke.adult_frame(2000, np.random.default_rng(0),
                                  num_partitions=2)
    data = SelectColumns(cols=["education", "marital-status",
                               "hours-per-week", "income"]).transform(data)
    parts = data.repartition(4).partitions
    train = Frame(data.schema, parts[:3])
    test = Frame(data.schema, parts[3:])
    model = TrainClassifier(model=LogisticRegression(regParam=0.01),
                            labelCol="income").fit(train)
    save_stage(model, str(tmp_path / "AdultCensus.mml"))
    model = load_stage(str(tmp_path / "AdultCensus.mml"))
    row = ComputeModelStatistics().transform(model.transform(test)).head(1)[0]
    assert float(row["AUC"]) > 0.75 and float(row["accuracy"]) > 0.76
    deep = DeepClassifier(architecture="mlp_tabular",
                          architectureArgs={"hidden": [64]}, batchSize=128,
                          epochs=6, learningRate=3e-3, lrSchedule="cosine",
                          warmupSteps=10, validationSplit=0.1, logEvery=50)
    deep_model = TrainClassifier(model=deep, labelCol="income").fit(train)
    row_deep = ComputeModelStatistics().transform(
        deep_model.transform(test)).head(1)[0]
    assert float(row_deep["AUC"]) > 0.75
    history = deep_model.get("learnerModel").validation_history
    assert [h["epoch"] for h in history] == list(range(1, 7))


def test_adult_frame_has_uci_adults_shape():
    frame = chip_smoke.adult_frame(4000, np.random.default_rng(0))
    assert frame.columns == [
        "age", "workclass", "fnlwgt", "education", "education-num",
        "marital-status", "occupation", "relationship", "race", "sex",
        "capital-gain", "capital-loss", "hours-per-week", "native-country",
        "income"]
    for name, levels in chip_smoke.ADULT_LEVELS.items():
        assert set(frame.column(name).tolist()) <= set(levels)
    assert [len(v) for v in chip_smoke.ADULT_LEVELS.values()] == \
        [9, 16, 7, 15, 6, 5, 2, 42]
    income = frame.column("income")
    assert set(income.tolist()) == {" <=50K", " >50K"}
    assert abs(np.mean(income == " >50K") - 0.24) < 0.01


def test_a_fit_counts_one_sync():
    """Every learner family fetches its fitted parameters in one counted
    sync (the trees' boosting rounds included)."""
    frame = read_csv(os.path.join(DATA, "banknote_like.csv"))
    for make in LEARNERS.values():
        before = syncs.total()
        TrainClassifier(model=make(), labelCol="class").fit(frame)
        assert syncs.total() - before == 1


# -- on the card ----------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tconfig.set("runtime.device", "cuda")
    yield torch.device("cuda", 0)
    tconfig.set("runtime.device", "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("make", [
    lambda: RandomForestClassifier(numTrees=16, maxDepth=5, seed=7),
    lambda: GBTClassifier(maxIter=20, maxDepth=3)])
def test_tree_fits_on_the_card_are_deterministic(card, make):
    """Two card fits of the same frame choose the same splits: the
    histograms accumulate in a fixed order."""
    frame = chip_smoke.adult_frame(6000, np.random.default_rng(3))
    fits = [TrainClassifier(model=make(), labelCol="income").fit(frame)
            for _ in range(2)]
    states = [f.get("learnerModel")._state for f in fits]
    assert torch.device(fits[0].get("learnerModel").fit_device).type \
        == "cuda"
    for key in ("feats", "thrs", "values", "leaf_probs"):
        if key in states[0]:
            np.testing.assert_array_equal(states[0][key], states[1][key])


@pytest.mark.cuda
def test_logistic_regression_on_the_card_matches_the_cpu(card):
    """The README's learner fit on the card and on the CPU, TF32 off:
    w and b within 1e-4 of the largest |parameter|."""
    frame = chip_smoke.adult_frame(6000, np.random.default_rng(4))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card = TrainClassifier(model=LogisticRegression(regParam=0.01),
                                  labelCol="income").fit(frame)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    tconfig.set("runtime.device", "cpu")
    on_cpu = TrainClassifier(model=LogisticRegression(regParam=0.01),
                             labelCol="income").fit(frame)
    for k in ("w", "b"):
        got = on_card.get("learnerModel")._state[k]
        want = on_cpu.get("learnerModel")._state[k]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k


# -- the reference's pinned benchmark cells ----------------------------------------
# tests/test_reference_parity.py's cells (the reference harness's learners
# and hyperparameters, VerifyTrainClassifier.scala:467-544, on the
# reconstructed UCI datasets of tests/data/reference) with its tolerances
REFERENCE_LEARNERS = {
    "LogisticRegression": lambda: LogisticRegression(
        regParam=0.3, elasticNetParam=0.8, maxIter=1500, learningRate=0.5),
    "DecisionTreeClassification": lambda: DecisionTreeClassifier(
        maxDepth=5, maxBins=32),
    "GradientBoostedTreesClassification": lambda: GBTClassifier(
        maxIter=20, maxDepth=5, maxBins=32, stepSize=0.1),
    "RandomForestClassification": lambda: RandomForestClassifier(
        numTrees=20, maxDepth=5, maxBins=32, subsamplingRate=1.0, seed=0),
    "NaiveBayesClassifier": lambda: NaiveBayes(),
}
#   (dataset, label, binary, learner, hard_labels, ref_m1, tol1, ref_m2, tol2)
REFERENCE_CELLS = [
    ("data_banknote_authentication.csv", "class", True,
     "LogisticRegression", False, 0.92, 0.03, 0.89, 0.03),
    ("data_banknote_authentication.csv", "class", True,
     "DecisionTreeClassification", False, 0.98, 0.03, 0.97, 0.03),
    ("data_banknote_authentication.csv", "class", True,
     "GradientBoostedTreesClassification", True, 0.98, 0.03, 0.98, 0.03),
    ("data_banknote_authentication.csv", "class", True,
     "RandomForestClassification", False, 1.00, 0.015, 1.00, 0.015),
    ("PimaIndian.csv", "Diabetes mellitus", True,
     "LogisticRegression", False, 0.50, 0.02, 0.68, 0.03),
    ("PimaIndian.csv", "Diabetes mellitus", True,
     "GradientBoostedTreesClassification", True, 0.68, 0.04, 0.68, 0.04),
    ("PimaIndian.csv", "Diabetes mellitus", True,
     "RandomForestClassification", False, 0.83, 0.05, 0.72, 0.05),
    ("PimaIndian.csv", "Diabetes mellitus", True,
     "NaiveBayesClassifier", True, 0.51, 0.06, 0.50, 0.09),
    ("abalone.csv", "Rings", False,
     "LogisticRegression", False, 0.15, 0.03, 0.04, 0.03),
    ("abalone.csv", "Rings", False,
     "DecisionTreeClassification", False, 0.25, 0.04, 0.22, 0.05),
    ("abalone.csv", "Rings", False,
     "RandomForestClassification", False, 0.26, 0.05, 0.22, 0.05),
    ("abalone.csv", "Rings", False,
     "NaiveBayesClassifier", False, 0.21, 0.05, 0.15, 0.05),
]


def _reference_metrics(fname, label, binary, learner, hard_labels):
    """The reference harness's metrics of one cell, as
    tests/test_reference_parity.py computes them (60/40 split with seed
    42; GBT and NB binary cells take AUC over hard labels)."""
    from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
        auc_from_pr, auc_from_roc, confusion_matrix, map_labels_to_indices,
        multiclass_metrics, pr_curve, roc_curve,
    )
    frame = read_csv(os.path.join(DATA, "reference", fname))
    train, test = frame.random_split([0.6, 0.4], seed=42)
    model = TrainClassifier(model=REFERENCE_LEARNERS[learner](),
                            labelCol=label).fit(train)
    scored = model.transform(test)
    cmap = scored.schema[label].categorical
    y = (map_labels_to_indices(scored.column(label), cmap) if cmap
         is not None else np.asarray(scored.column(label)).astype(np.int64))
    pred = np.asarray(scored.column("scored_labels"), np.float64)
    if binary:
        s = pred if hard_labels else np.asarray(scored.column("scores"))[:, 1]
        s = s.astype(np.float64)
        return (auc_from_roc(roc_curve(y, s)), auc_from_pr(pr_curve(y, s)))
    k = int(max(y.max(), pred.max())) + 1
    mm = multiclass_metrics(confusion_matrix(y, pred, k))
    return mm["accuracy"], mm["weighted_f1"]


@pytest.mark.parametrize(
    "fname,label,binary,learner,hard,m1,tol1,m2,tol2", REFERENCE_CELLS,
    ids=[f"{c[0].split('.')[0]}-{c[3]}" for c in REFERENCE_CELLS])
def test_reference_benchmark_cell_holds_on_the_port(
        fname, label, binary, learner, hard, m1, tol1, m2, tol2):
    got1, got2 = _reference_metrics(fname, label, binary, learner, hard)
    assert abs(got1 - m1) <= tol1, (fname, learner, got1, m1)
    assert abs(got2 - m2) <= tol2, (fname, learner, got2, m2)
