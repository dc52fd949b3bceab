"""Save/load + pipeline fuzzing over EVERY stage the port registers.

The reference's ``tests/test_fuzzing.py`` restated over
``mmlspark_tpu_torch``'s stages (on the CPU, ``runtime.device="cpu"``):
every stage round-trips save->load, runs on random data from the port's
``testing/datagen.py``, composes in a Pipeline, and keeps its param
declarations coherent; a stage added without a fuzz entry fails
``test_every_stage_is_covered``. ``generate_frame`` and ``random_column``
give the JAX package's columns for the same seed.
"""
import importlib
import pkgutil

import numpy as np
import pytest

import mmlspark_tpu_torch
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.pipeline import Pipeline
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Transformer
from mmlspark_tpu_torch.core.serialization import (
    load_stage, registered_stages, save_stage,
)
from mmlspark_tpu_torch.testing.datagen import generate_frame

# import every module so the registry is complete
for _m in pkgutil.walk_packages(mmlspark_tpu_torch.__path__,
                                  "mmlspark_tpu_torch."):
    importlib.import_module(_m.name)

# only stages shipped by the package: test modules may register their own
# throwaway stages (e.g. test_core's Doubler) in the shared process
ALL_STAGES = {q: c for q, c in registered_stages().items()
              if q.startswith("mmlspark_tpu_torch.")}


# ---------------------------------------------------------------------------
# fuzz configuration: stage -> (constructor, frame builder)
def _text_frame(seed=0):
    return generate_frame(24, 1, seed=seed, kinds=["string"],
                          missing_ratio=0.1)


def _tokens_frame(seed=0):
    return generate_frame(24, 1, seed=seed, kinds=["tokens"])


def _tf_frame(seed=0):
    from mmlspark_tpu_torch.feature.text import HashingTF
    f = _tokens_frame(seed)
    return HashingTF(inputCol="col0", outputCol="tf", numFeatures=64) \
        .fit(f).transform(f)


def _mixed_frame(seed=0):
    return generate_frame(32, 4, seed=seed,
                          kinds=["double", "string", "int", "vector"],
                          with_label="class")


def _numeric_frame(seed=0):
    return generate_frame(48, 3, seed=seed, kinds=["double", "float", "int"],
                          with_label="class")


def _features_frame(seed=0, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (60, 5)).astype(np.float32)
    y = rng.integers(0, classes, 60).astype(np.int32)
    return Frame.from_dict({"features": X, "label": y})


def _reg_features_frame(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (60, 5)).astype(np.float32)
    return Frame.from_dict({"features": X,
                            "label": X[:, 0].astype(np.float64)})


def _image_frame(seed=0, n=4, h=12, w=10):
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    rng = np.random.default_rng(seed)
    arr = np.empty(n, object)
    for i in range(n):
        arr[i] = ImageValue(path=f"mem://{i}",
                            data=rng.integers(0, 256, (h, w, 3), np.uint8))
    return Frame.from_dict({"image": arr},
                           schema=None)


def _scored_frame(seed=0):
    from mmlspark_tpu_torch.train.learners import LogisticRegression
    from mmlspark_tpu_torch.train.train_classifier import TrainClassifier
    f = _numeric_frame(seed)
    return TrainClassifier(model=LogisticRegression(maxIter=20),
                           labelCol="label").fit(f).transform(f)


def _lr():
    from mmlspark_tpu_torch.train.learners import LogisticRegression
    return LogisticRegression(maxIter=20)


# estimator/transformer fuzz table: name -> (stage factory, frame factory)
def _configs():
    from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
        ComputeModelStatistics)
    from mmlspark_tpu_torch.evaluate.compute_per_instance_statistics import (
        ComputePerInstanceStatistics)
    from mmlspark_tpu_torch.evaluate.find_best_model import FindBestModel
    from mmlspark_tpu_torch.train.deep import DeepClassifier, DeepRegressor
    from mmlspark_tpu_torch.feature.featurize import AssembleFeatures, Featurize
    from mmlspark_tpu_torch.feature.multi_column_adapter import MultiColumnAdapter
    from mmlspark_tpu_torch.feature.text import (
        HashingTF, IDF, NGram, RegexTokenizer, StopWordsRemover,
        TextFeaturizer)
    from mmlspark_tpu_torch.feature.value_indexer import (
        HashIndexer, IndexToValue, ValueIndexer)
    from mmlspark_tpu_torch.feature.word2vec import Word2Vec
    from mmlspark_tpu_torch.image.transformer import ImageTransformer, UnrollImage
    from mmlspark_tpu_torch.stages.stages import (
        CheckpointData, DataConversion, DropColumns, PartitionSample,
        RenameColumn, Repartition, SelectColumns, SummarizeData)
    from mmlspark_tpu_torch.train.learners import (
        LinearRegression, LogisticRegression, MLPClassifier, MLPRegressor,
        NaiveBayes)
    from mmlspark_tpu_torch.train.train_classifier import (
        TrainClassifier, TrainRegressor)
    from mmlspark_tpu_torch.train.trees import (
        DecisionTreeClassifier, DecisionTreeRegressor, GBTClassifier,
        GBTRegressor, RandomForestClassifier, RandomForestRegressor)

    def value_indexed(seed=0):
        f = _text_frame(seed)
        return ValueIndexer(inputCol="col0", outputCol="idx").fit(f).transform(f)

    return {
        "RegexTokenizer": (lambda: RegexTokenizer(inputCol="col0", outputCol="t"),
                           _text_frame),
        "StopWordsRemover": (lambda: StopWordsRemover(inputCol="col0", outputCol="s"),
                             _tokens_frame),
        "NGram": (lambda: NGram(inputCol="col0", outputCol="n"), _tokens_frame),
        "HashingTF": (lambda: HashingTF(inputCol="col0", outputCol="tf",
                                        numFeatures=64), _tokens_frame),
        "IDF": (lambda: IDF(inputCol="tf", outputCol="tfidf"), _tf_frame),
        "TextFeaturizer": (lambda: TextFeaturizer(inputCol="col0", outputCol="f",
                                                  numFeatures=64), _text_frame),
        "Word2Vec": (lambda: Word2Vec(inputCol="col0", outputCol="v",
                                      vectorSize=4, minCount=1, maxIter=1),
                     _tokens_frame),
        "ValueIndexer": (lambda: ValueIndexer(inputCol="col0", outputCol="i"),
                         _text_frame),
        "IndexToValue": (lambda: IndexToValue(inputCol="idx", outputCol="orig"),
                         value_indexed),
        "HashIndexer": (lambda: HashIndexer(inputCol="col0", outputCol="id",
                                            numBuckets=64), _text_frame),
        "Featurize": (lambda: Featurize(featureColumns={
            "features": ["col0", "col1", "col2", "col3"]}, numberOfFeatures=64),
            _mixed_frame),
        "AssembleFeatures": (lambda: AssembleFeatures(
            columnsToFeaturize=["col0", "col1", "col2", "col3"],
            numberOfFeatures=64), _mixed_frame),
        "MultiColumnAdapter": (lambda: MultiColumnAdapter(
            baseStage=RegexTokenizer(), inputCols=["col0"], outputCols=["o0"]),
            _text_frame),
        "TrainClassifier": (lambda: TrainClassifier(model=_lr(), labelCol="label"),
                            _numeric_frame),
        "TrainRegressor": (lambda: TrainRegressor(
            model=LinearRegression(), labelCol="label"),
            lambda seed=0: generate_frame(48, 3, seed=seed,
                                          kinds=["double", "float", "int"],
                                          with_label="real")),
        "LogisticRegression": (_lr, _features_frame),
        "DeepClassifier": (lambda: DeepClassifier(
            architectureArgs={"hidden": [8]}, batchSize=16, epochs=2),
            _features_frame),
        "MLPClassifier": (lambda: MLPClassifier(maxIter=10, layers=[8]),
                          _features_frame),
        "NaiveBayes": (lambda: NaiveBayes(), _features_frame),
        "LinearRegression": (lambda: LinearRegression(), _reg_features_frame),
        "MLPRegressor": (lambda: MLPRegressor(maxIter=10, layers=[8]),
                         _reg_features_frame),
        "DeepRegressor": (lambda: DeepRegressor(
            architectureArgs={"hidden": [8]}, batchSize=16, epochs=2),
            _reg_features_frame),
        "DecisionTreeClassifier": (lambda: DecisionTreeClassifier(maxDepth=3),
                                   _features_frame),
        "RandomForestClassifier": (lambda: RandomForestClassifier(
            numTrees=3, maxDepth=3), _features_frame),
        "GBTClassifier": (lambda: GBTClassifier(maxIter=3, maxDepth=2),
                          _features_frame),
        "DecisionTreeRegressor": (lambda: DecisionTreeRegressor(maxDepth=3),
                                  _reg_features_frame),
        "RandomForestRegressor": (lambda: RandomForestRegressor(
            numTrees=3, maxDepth=3), _reg_features_frame),
        "GBTRegressor": (lambda: GBTRegressor(maxIter=3, maxDepth=2),
                         _reg_features_frame),
        "ComputeModelStatistics": (lambda: ComputeModelStatistics(),
                                   _scored_frame),
        "ComputePerInstanceStatistics": (lambda: ComputePerInstanceStatistics(),
                                         _scored_frame),
        "FindBestModel": (lambda: FindBestModel(
            models=[TrainClassifier(model=_lr(), labelCol="label")
                    .fit(_numeric_frame()),
                    TrainClassifier(model=DecisionTreeClassifier(maxDepth=2),
                                    labelCol="label").fit(_numeric_frame())],
            evaluationMetric="accuracy"), _numeric_frame),
        "Repartition": (lambda: Repartition(n=3), _numeric_frame),
        "SelectColumns": (lambda: SelectColumns(cols=["col0"]), _numeric_frame),
        "DropColumns": (lambda: DropColumns(cols=["col0"]), _numeric_frame),
        "RenameColumn": (lambda: RenameColumn(inputCol="col0", outputCol="x"),
                         _numeric_frame),
        "DataConversion": (lambda: DataConversion(
            cols=["col0"], convertTo="string"), _numeric_frame),
        "SummarizeData": (lambda: SummarizeData(), _numeric_frame),
        "PartitionSample": (lambda: PartitionSample(
            mode="RandomSample", percent=0.5, seed=1), _numeric_frame),
        "CheckpointData": (lambda: CheckpointData(), _numeric_frame),
        "ImageTransformer": (lambda: ImageTransformer().resize(6, 6),
                             _image_frame),
        "UnrollImage": (lambda: UnrollImage(inputCol="image", outputCol="v"),
                        lambda seed=0: ImageTransformer().resize(6, 6)
                        .transform(_image_frame(seed))),
    }


# Stages with no standalone fuzz entry, each with the reason (the reference
# keeps the same kind of exclusion accounting in its Fuzzing suite).
EXCLUDED = {
    # model classes: produced and exercised via their estimator's fuzz entry
    "HashingTFModel": "model of HashingTF",
    "IDFModel": "model of IDF",
    "TextFeaturizerModel": "model of TextFeaturizer",
    "Word2VecModel": "model of Word2Vec",
    "ValueIndexerModel": "model of ValueIndexer",
    "AssembleFeaturesModel": "model of AssembleFeatures",
    "LinearClassifierModel": "model of LogisticRegression",
    "MLPClassifierModel": "model of MLPClassifier",
    "NaiveBayesModel": "model of NaiveBayes",
    "LinearRegressionModel": "model of LinearRegression",
    "MLPRegressorModel": "model of MLPRegressor",
    "TreeClassifierModel": "model of DecisionTree/RandomForestClassifier",
    "TreeRegressorModel": "model of tree regressors",
    "GBTClassifierModel": "model of GBTClassifier",
    "DeepClassifierModel": "model of DeepClassifier",
    "DeepRegressorModel": "model of DeepRegressor",
    "TrainedClassifierModel": "model of TrainClassifier",
    "TrainedRegressorModel": "model of TrainRegressor",
    "BestModel": "model of FindBestModel",
    # require external fixtures; covered by their own suites
    "TorchModel": "needs a zoo module + weights (test_torch_featurizer.py)",
    "ImageFeaturizer": "needs a zoo model (test_torch_featurizer.py)",
}


@pytest.fixture(autouse=True)
def _cpu_device():
    from mmlspark_tpu_torch.utils import config as tconfig
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _short(qualname: str) -> str:
    return qualname.rsplit(".", 1)[1]


# ---------------------------------------------------------------------------
def test_every_stage_is_covered():
    configs = _configs()
    missing = [q for q in ALL_STAGES
               if _short(q) not in configs and _short(q) not in EXCLUDED]
    assert not missing, (
        f"stages with neither a fuzz config nor an exclusion reason: {missing}")
    stale = [n for n in list(configs) + list(EXCLUDED)
             if not any(_short(q) == n for q in ALL_STAGES)]
    assert not stale, f"fuzz entries for unregistered stages: {stale}"


@pytest.mark.parametrize("qualname", sorted(ALL_STAGES))
def test_param_declarations_coherent(qualname):
    """Param attribute name == param.name; docs non-empty; defaults valid
    (reference Fuzzing.scala param-name assertions)."""
    cls = ALL_STAGES[qualname]
    for klass in cls.__mro__:
        for attr, v in vars(klass).items():
            if isinstance(v, Param):
                assert attr == v.name, (
                    f"{qualname}: attribute {attr!r} holds param {v.name!r}")
                assert v.doc and v.doc.strip(), f"{qualname}.{attr}: missing doc"
                if v.has_default and v.default is not None:
                    v.validate(v.default)


@pytest.mark.parametrize("name", sorted(_configs()))
def test_stage_roundtrip_and_random_data(name, tmp_path):
    """The core fuzz loop: construct -> save -> load -> run on random data ->
    (for estimators) save/load the model and check identical outputs."""
    factory, frame_fn = _configs()[name]
    stage = factory()
    frame = frame_fn()

    # unfitted round trip preserves class + explicit params
    stage.save(str(tmp_path / "stage"))
    loaded = load_stage(str(tmp_path / "stage"))
    assert type(loaded) is type(stage)
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    def _has_stage(v):
        if isinstance(v, PipelineStage):
            return True
        if isinstance(v, (list, tuple)):
            return any(_has_stage(x) for x in v)
        return False

    for pname, val in stage.explicit_param_values().items():
        lval = loaded.get(pname)
        if _has_stage(val):  # nested stages: identity differs, uid must match
            assert [s.uid for s in lval] == [s.uid for s in val] \
                if isinstance(val, list) else lval.uid == val.uid
        elif isinstance(val, (list, dict, str, int, float, bool, type(None))):
            assert lval == val, f"{name}.{pname}: {lval!r} != {val!r}"

    if isinstance(stage, Estimator):
        model = (factory() if name == "FindBestModel" else loaded).fit(frame)
        out1 = model.transform(frame)
        model.save(str(tmp_path / "model"))
        model2 = load_stage(str(tmp_path / "model"))
        out2 = model2.transform(frame)
    else:
        out1 = loaded.transform(frame)
        out2 = load_stage(str(tmp_path / "stage")).transform(frame)

    assert out1.schema.names == out2.schema.names
    for col in out1.schema.names:
        a, b = out1.column(col), out2.column(col)
        if a.dtype != np.object_ and np.issubdtype(a.dtype, np.number):
            assert np.allclose(a, b, equal_nan=True), f"{name}: column {col}"


@pytest.mark.parametrize("name", sorted(_configs()))
def test_stage_runs_inside_pipeline(name):
    """Every stage must compose in a Pipeline on generated data
    (Fuzzing.scala pipeline-fit assertion)."""
    factory, frame_fn = _configs()[name]
    pipe = Pipeline(stages=[factory()])
    model = pipe.fit(frame_fn(seed=1))
    assert model.transform(frame_fn(seed=1)) is not None


def test_datagen_determinism():
    f1 = generate_frame(16, 3, seed=9)
    f2 = generate_frame(16, 3, seed=9)
    assert f1.schema.names == f2.schema.names
    for c in f1.schema.names:
        a, b = f1.column(c), f2.column(c)
        if a.dtype != np.object_:
            assert np.array_equal(a, b, equal_nan=True)


def test_datagen_missing_values():
    f = generate_frame(200, 2, seed=3, kinds=["string", "double"],
                       missing_ratio=0.3)
    strings = f.column("col0")
    assert sum(v is None for v in strings) > 10
    assert np.isnan(f.column("col1")).sum() > 10


@pytest.mark.parametrize("seed", range(8))
def test_generate_frame_equals_the_jax_package_per_seed(seed):
    from mmlspark_tpu.testing.datagen import generate_frame as jgenerate
    kw = dict(n_rows=40, n_cols=6, seed=seed, missing_ratio=0.2,
              with_label=("class", "real", None)[seed % 3])
    got, want = generate_frame(**kw), jgenerate(**kw)
    assert got.schema.names == want.schema.names
    assert [c.dtype.value for c in got.schema.columns] == \
        [c.dtype.value for c in want.schema.columns]
    for col in got.schema.names:
        a, b = got.column(col), want.column(col)
        if a.dtype == np.object_:
            assert list(a) == list(b), col
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["int", "float", "double", "bool",
                                  "string", "tokens", "vector"])
def test_random_column_equals_the_jax_package(kind):
    from mmlspark_tpu.testing.datagen import random_column as jrandom
    from mmlspark_tpu_torch.testing.datagen import random_column
    got = random_column(kind, 50, np.random.default_rng(4), 0.3)
    want = jrandom(kind, 50, np.random.default_rng(4), 0.3)
    if isinstance(want, list):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)
