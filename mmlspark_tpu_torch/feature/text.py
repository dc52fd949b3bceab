"""Text featurization: tokenizer, stop words, n-grams, HashingTF, IDF,

The PyTorch port's own copy of ``mmlspark_tpu/feature/text.py``.
and the TextFeaturizer convenience estimator chaining them.

Re-expression of the reference's text pipeline
(``text-featurizer/src/main/scala/TextFeaturizer.scala``): each stage is
optional and auto-chained input->output exactly like the reference's
``fit`` (``TextFeaturizer.scala:230-290``); intermediate columns are dropped
from the output frame (``TextFeaturizerModel.transform``). Hashing is the
Spark-parity murmur3 of :mod:`mmlspark_tpu_torch.ops.hashing`.

Layout notes: HashingTF's 2^18 hash space is never materialized densely.
The fitted model records the ACTIVE slot set seen at fit time (the same
count-based compaction AssembleFeatures uses, mirroring the reference's
BitSet-OR + VectorSlicer at ``AssembleFeatures.scala:198-224``) and emits a
dense float32 matrix of width |active slots| — the layout that streams
straight into a device tensor. IDF weighting is a vectorized numpy
pass over that compact matrix.
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    BooleanParam, HasInputCol, HasOutputCol, IntParam, ListParam, Param,
    StringParam,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.ops.hashing import hash_token_rows, project_slots, tf_csr

# A standard English stop-word list (the classic Glasgow IR list that Spark's
# StopWordsRemover also ships). Public-domain word list.
ENGLISH_STOP_WORDS = (
    "a about above after again against all am an and any are aren't as at be "
    "because been before being below between both but by can't cannot could "
    "couldn't did didn't do does doesn't doing don't down during each few for "
    "from further had hadn't has hasn't have haven't having he he'd he'll "
    "he's her here here's hers herself him himself his how how's i i'd i'll "
    "i'm i've if in into is isn't it it's its itself let's me more most "
    "mustn't my myself no nor not of off on once only or other ought our ours "
    "ourselves out over own same shan't she she'd she'll she's should "
    "shouldn't so some such than that that's the their theirs them themselves "
    "then there there's these they they'd they'll they're they've this those "
    "through to too under until up very was wasn't we we'd we'll we're we've "
    "were weren't what what's when when's where where's which while who who's "
    "whom why why's with won't would wouldn't you you'd you'll you're you've "
    "your yours yourself yourselves"
).split()

STOP_WORD_LANGUAGES = {"english": ENGLISH_STOP_WORDS}


def _require_dtype(frame: Frame, col: str, expected: DType, stage: str) -> None:
    actual = frame.schema[col].dtype
    if actual != expected:
        raise SchemaError(
            f"{stage}: input column {col!r} must be {expected.value}, "
            f"got {actual.value}")


def _token_rows(frame: Frame, col: str) -> List[List[str]]:
    """Token column values with null rows normalized to [] (a TOKENS column
    may store None per the Frame storage rules)."""
    return [row if row is not None else [] for row in frame.column(col)]


@register_stage
class RegexTokenizer(HasInputCol, HasOutputCol, Transformer):
    """String -> tokens via regex gaps/matches.

    Parity with Spark's RegexTokenizer as configured by the reference
    (``TextFeaturizer.scala:240-245``): ``gaps`` decides whether ``pattern``
    matches delimiters (split) or tokens (findall); ``minTokenLength``
    filters; ``toLowercase`` applies before tokenizing.
    """

    gaps = BooleanParam("gaps", "pattern matches gaps (split) vs tokens", True)
    pattern = StringParam("pattern", "regex for delimiters or tokens", r"\s+")
    minTokenLength = IntParam("minTokenLength", "minimum token length", 0,
                              validator=lambda v: v >= 0)
    toLowercase = BooleanParam("toLowercase", "lowercase before tokenizing", True)

    def transform(self, frame: Frame) -> Frame:
        _require_dtype(frame, self.inputCol, DType.STRING, "RegexTokenizer")
        regex = re.compile(self.pattern)
        gaps, min_len, lower = self.gaps, self.minTokenLength, self.toLowercase

        def tok(text: Optional[str]) -> List[str]:
            if text is None:
                return []
            if lower:
                text = text.lower()
            toks = regex.split(text) if gaps else regex.findall(text)
            return [t for t in toks if len(t) >= min_len and t]

        values = [tok(v) for v in frame.column(self.inputCol)]
        return frame.with_column_values(
            ColumnSchema(self.outputCol, DType.TOKENS), values)

    def transform_schema(self, schema):
        return schema.add(ColumnSchema(self.outputCol, DType.TOKENS))


@register_stage
class StopWordsRemover(HasInputCol, HasOutputCol, Transformer):
    """Filters stop words out of a tokens column.

    Reference config surface: ``TextFeaturizer.scala:246-256`` (case
    sensitivity + language presets + custom list).
    """

    caseSensitive = BooleanParam("caseSensitive", "case sensitive comparison", False)
    stopWords = ListParam("stopWords", "words to filter out",
                          list(ENGLISH_STOP_WORDS))

    def transform(self, frame: Frame) -> Frame:
        _require_dtype(frame, self.inputCol, DType.TOKENS, "StopWordsRemover")
        words = self.stopWords
        if self.caseSensitive:
            stop = frozenset(words)
            values = [[t for t in row if t not in stop]
                      for row in _token_rows(frame, self.inputCol)]
        else:
            stop = frozenset(w.lower() for w in words)
            values = [[t for t in row if t.lower() not in stop]
                      for row in _token_rows(frame, self.inputCol)]
        return frame.with_column_values(
            ColumnSchema(self.outputCol, DType.TOKENS), values)

    def transform_schema(self, schema):
        return schema.add(ColumnSchema(self.outputCol, DType.TOKENS))


@register_stage
class NGram(HasInputCol, HasOutputCol, Transformer):
    """Tokens -> space-joined n-grams (Spark NGram semantics: rows shorter
    than n produce an empty array)."""

    n = IntParam("n", "number of tokens per n-gram", 2,
                 validator=lambda v: v >= 1)

    def transform(self, frame: Frame) -> Frame:
        _require_dtype(frame, self.inputCol, DType.TOKENS, "NGram")
        n = self.n
        values = [[" ".join(row[i:i + n]) for i in range(len(row) - n + 1)]
                  for row in _token_rows(frame, self.inputCol)]
        return frame.with_column_values(
            ColumnSchema(self.outputCol, DType.TOKENS), values)

    def transform_schema(self, schema):
        return schema.add(ColumnSchema(self.outputCol, DType.TOKENS))


@register_stage
class HashingTF(HasInputCol, HasOutputCol, Estimator):
    """Tokens -> term-frequency vectors in a murmur3 hash space.

    Estimator (unlike Spark's stateless transformer) because by default the
    fitted model compacts the 2^18 hash space to the active slots seen at fit
    — the dense device-ready layout. Slot indices are bit-identical to Spark's
    (``ops/hashing.py``), so a term's position within the active-slot ordering
    is auditable against the reference's pinned indices
    (``core/ml/src/test/scala/HashingTFSpec.scala:22-29``).

    ``compact=False`` restores Spark's stateless fixed-width contract: the
    output vector is always ``numFeatures`` wide and terms unseen at fit
    still land in their slot — use it when fitted models must stay
    column-compatible across datasets (e.g. serving with novel vocabulary).
    With the default ``compact=True``, unseen-at-fit terms are DROPPED at
    transform: width tracks the training corpus.

    NOTE: the output column is DENSE, so ``compact=False`` materializes
    n_rows x numFeatures float32 — pair it with a modest ``numFeatures``
    (e.g. 2^12), not the 2^18 default; transform raises rather than OOM.
    """

    numFeatures = IntParam("numFeatures", "hash space size", 1 << 18,
                           validator=lambda v: v > 0)
    binary = BooleanParam("binary", "clamp term counts to 1", False)
    compact = BooleanParam(
        "compact", "compact output to fit-time active slots (False = "
        "Spark-parity fixed numFeatures width)", True)

    def fit(self, frame: Frame) -> "HashingTFModel":
        _require_dtype(frame, self.inputCol, DType.TOKENS, "HashingTF")
        model = HashingTFModel(
            inputCol=self.inputCol, outputCol=self.outputCol,
            numFeatures=self.numFeatures, binary=self.binary,
            compact=self.compact)
        if self.compact:
            slots, _ = hash_token_rows(
                _token_rows(frame, self.inputCol), self.numFeatures)
            model._set_state({"slots": np.unique(slots)})
        else:  # stateless Spark behavior needs no fit-time scan
            model._set_state({"slots": np.zeros(0, np.int64)})
        return model


@register_stage
class HashingTFModel(HasInputCol, HasOutputCol, Model):
    numFeatures = IntParam("numFeatures", "hash space size", 1 << 18)
    binary = BooleanParam("binary", "clamp term counts to 1", False)
    compact = BooleanParam(
        "compact", "compact output to fit-time active slots (False = "
        "Spark-parity fixed numFeatures width)", True)

    @property
    def slots(self) -> np.ndarray:
        return self._get_state()["slots"]

    @property
    def width(self) -> int:
        return len(self.slots) if self.compact else self.numFeatures

    def transform(self, frame: Frame) -> Frame:
        _require_dtype(frame, self.inputCol, DType.TOKENS, "HashingTFModel")
        rows = _token_rows(frame, self.inputCol)
        width = self.width
        if len(rows) * width > (1 << 31):  # dense output: fail with guidance
            raise SchemaError(
                f"HashingTFModel: dense output {len(rows)}x{width} exceeds "
                "2^31 elements (~8 GB); lower numFeatures or use "
                "compact=True so width tracks the training corpus")
        out = np.zeros((len(rows), width), dtype=np.float32)
        if width:
            row_ptr, slots, counts = tf_csr(rows, self.numFeatures)
            rids = np.repeat(np.arange(len(rows), dtype=np.int64),
                             np.diff(row_ptr))
            vals = (np.ones_like(counts, np.float32) if self.binary
                    else counts.astype(np.float32))
            if self.compact:
                pos, ok = project_slots(self.slots, slots)
                out[rids[ok], pos[ok]] = vals[ok]  # unseen-at-fit slots dropped
            else:
                out[rids, slots] = vals
        return frame.with_column_values(
            ColumnSchema(self.outputCol, DType.VECTOR, dim=width), out)

    def transform_schema(self, schema):
        return schema.add(
            ColumnSchema(self.outputCol, DType.VECTOR, dim=self.width))


@register_stage
class IDF(HasInputCol, HasOutputCol, Estimator):
    """Inverse-document-frequency weighting over TF vectors.

    Spark formula: idf = log((numDocs + 1) / (docFreq + 1)); slots with
    docFreq < minDocFreq get weight 0 (``TextFeaturizer.scala:258-262``
    configures minDocFreq on Spark's IDF).
    """

    minDocFreq = IntParam("minDocFreq", "minimum docs a term must appear in", 1,
                          validator=lambda v: v >= 0)

    def fit(self, frame: Frame) -> "IDFModel":
        col = frame.schema[self.inputCol]
        if col.dtype != DType.VECTOR:
            raise SchemaError(f"IDF: input column {self.inputCol!r} must be "
                              f"vector, got {col.dtype.value}")
        mat = np.asarray(frame.column(self.inputCol), dtype=np.float32)
        n_docs = mat.shape[0]
        doc_freq = (mat != 0).sum(axis=0)
        idf = np.log((n_docs + 1.0) / (doc_freq + 1.0)).astype(np.float32)
        idf[doc_freq < self.minDocFreq] = 0.0
        model = IDFModel(inputCol=self.inputCol, outputCol=self.outputCol,
                         minDocFreq=self.minDocFreq)
        model._set_state({"idf": idf})
        return model


@register_stage
class IDFModel(HasInputCol, HasOutputCol, Model):
    minDocFreq = IntParam("minDocFreq", "minimum docs a term must appear in", 1)

    @property
    def idf(self) -> np.ndarray:
        return self._get_state()["idf"]

    def transform(self, frame: Frame) -> Frame:
        idf = self.idf
        mat = np.asarray(frame.column(self.inputCol), dtype=np.float32)
        if mat.shape[1] != idf.shape[0]:
            raise SchemaError(
                f"IDFModel: vector width {mat.shape[1]} != fitted {idf.shape[0]}")
        out = (mat * idf[None, :]).astype(np.float32)
        return frame.with_column_values(
            ColumnSchema(self.outputCol, DType.VECTOR, dim=out.shape[1]), out)

    def transform_schema(self, schema):
        return schema.add(
            ColumnSchema(self.outputCol, DType.VECTOR, dim=len(self.idf)))


@register_stage
class TextFeaturizer(HasInputCol, HasOutputCol, Estimator):
    """One-line text pipeline: tokenize -> stop words -> n-grams -> TF -> IDF,
    every stage optional, auto-chained.

    Parity with ``TextFeaturizer.scala:140-290``: the same param surface
    (tokenizer gaps/pattern/minTokenLength/toLowercase, stop-word case
    sensitivity/language/custom list, nGramLength, binary/numFeatures,
    useIDF/minDocFreq), the same auto-detection of ``useTokenizer`` from the
    input column type, and the same intermediate-column dropping.
    """

    useTokenizer = Param("useTokenizer", "whether to tokenize the input",
                         None, dtype=bool)
    tokenizerGaps = BooleanParam("tokenizerGaps", "regex splits on gaps", True)
    minTokenLength = IntParam("minTokenLength", "minimum token length", 0)
    tokenizerPattern = StringParam(
        "tokenizerPattern", "regex for delimiters or tokens", r"\s+")
    toLowercase = BooleanParam("toLowercase", "lowercase before tokenizing", True)
    useStopWordsRemover = BooleanParam(
        "useStopWordsRemover", "remove stop words from tokens", False)
    caseSensitiveStopWords = BooleanParam(
        "caseSensitiveStopWords", "case sensitive stop word match", False)
    defaultStopWordLanguage = StringParam(
        "defaultStopWordLanguage",
        "stop word language preset; 'custom' uses the stopWords param",
        "english", domain=list(STOP_WORD_LANGUAGES) + ["custom"])
    stopWords = ListParam("stopWords", "custom stop words", [])
    useNGram = BooleanParam("useNGram", "enumerate n-grams", False)
    nGramLength = IntParam("nGramLength", "n-gram size", 2)
    binary = BooleanParam("binary", "clamp term counts to 1", False)
    numFeatures = IntParam("numFeatures", "hash space size", 1 << 18)
    useIDF = BooleanParam("useIDF", "scale TF by IDF", True)
    minDocFreq = IntParam("minDocFreq", "IDF minimum document frequency", 1)

    def fit(self, frame: Frame) -> "TextFeaturizerModel":
        use_tok = self.get("useTokenizer")
        if use_tok is None:  # auto-detect from column type (fit():232-236)
            use_tok = frame.schema[self.inputCol].dtype == DType.STRING
        stages = []
        if use_tok:
            stages.append(RegexTokenizer(
                gaps=self.tokenizerGaps, pattern=self.tokenizerPattern,
                minTokenLength=self.minTokenLength, toLowercase=self.toLowercase))
        if self.useStopWordsRemover:
            lang = self.defaultStopWordLanguage
            words = (self.stopWords if lang == "custom"
                     else STOP_WORD_LANGUAGES[lang])
            stages.append(StopWordsRemover(
                caseSensitive=self.caseSensitiveStopWords,
                stopWords=list(words)))
        if self.useNGram:
            stages.append(NGram(n=self.nGramLength))
        stages.append(HashingTF(numFeatures=self.numFeatures, binary=self.binary))
        if self.useIDF:
            stages.append(IDF(minDocFreq=self.minDocFreq))

        if not use_tok and frame.schema[self.inputCol].dtype != DType.TOKENS:
            raise SchemaError(
                f"TextFeaturizer: input column {self.inputCol!r} is "
                f"{frame.schema[self.inputCol].dtype.value}; it looks like "
                "your data is not tokenized, try useTokenizer=True")

        # Auto-chain input/output columns (fit():267-285) through unused
        # temp names, last stage writes outputCol.
        in_col = self.inputCol
        tmp_cols: List[str] = []
        fitted = []
        cur = frame
        for i, stage in enumerate(stages):
            is_last = i == len(stages) - 1
            out_col = self.outputCol if is_last else f"{self.uid}__tmp{i}"
            if not is_last:
                tmp_cols.append(out_col)
            stage.set_params(inputCol=in_col, outputCol=out_col)
            model = stage.fit(cur) if isinstance(stage, Estimator) else stage
            if not is_last:  # no frame pass needed beyond the last stage
                cur = model.transform(cur)
            fitted.append(model)
            in_col = out_col
        model = TextFeaturizerModel(
            inputCol=self.inputCol, outputCol=self.outputCol)
        model.set_params(stages=fitted, colsToDrop=tmp_cols)
        return model


@register_stage
class TextFeaturizerModel(HasInputCol, HasOutputCol, Model):
    from mmlspark_tpu_torch.core.params import AnyParam as _AnyParam
    stages = _AnyParam("stages", "fitted chain of text stages", default=[])
    colsToDrop = ListParam("colsToDrop", "intermediate columns to drop", [])

    def transform(self, frame: Frame) -> Frame:
        for stage in self.get("stages"):
            frame = stage.transform(frame)
        drop = [c for c in self.get("colsToDrop") if c in frame.schema.names]
        return frame.drop(*drop) if drop else frame

    def transform_schema(self, schema):
        for stage in self.get("stages"):
            schema = stage.transform_schema(schema)
        drop = [c for c in self.get("colsToDrop") if c in schema.names]
        return schema.drop(drop) if drop else schema
