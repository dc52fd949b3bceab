"""Word2Vec: skip-gram word embeddings trained by a loop on the device.

The port of ``mmlspark_tpu/feature/word2vec.py`` (the reference's use of
Spark ML Word2Vec, notebook ``202 - Amazon Book Reviews - Word2Vec``): fit a
tokens column -> per-word vectors; transform averages word vectors per row;
``find_synonyms`` does cosine top-k. Training is skip-gram with negative
sampling on two embedding matrices, as the JAX package's.

- **Host draws, bit-equal to the JAX package's.** ``fit`` consumes
  ``np.random.default_rng(seed)`` in the reference's order: the dynamic
  window spans of :func:`_skipgram_pairs`, then the unigram^0.75 negative
  table, then the uniform init of ``w_in`` (or, on a corpus without
  pairs, the normal init that is returned untrained). Vocabulary, pairs,
  table and initial vectors therefore equal the JAX package's.
- **The epoch on the device.** The pair arrays, the table and ``w_in``
  cross to ``runtime.device`` once a fit. Each epoch permutes the pairs on
  the device and wrap-pads them to whole batches; each minibatch draws its
  negatives from the table, and takes one SGD step at ``stepSize`` on the
  loss SUMMED over the batch (classic per-pair SGD accumulated into one
  update), on both matrices. The shuffle and the negatives come from a
  ``torch.Generator`` on the device seeded with ``seed`` (the reference
  draws them from ``jax.random``, so the streams differ). The vectors are
  fetched once at the end: one counted sync a fit.
- **The step** (:func:`_sgd_step`) writes the gradient of that loss out by
  hand and scatter-adds it into the gathered rows (``index_add_``), so a
  step touches only the rows of its batch. On a card the scatter-add
  accumulates with atomics in no fixed order, so two card fits may differ
  in the last bits; on the CPU it is serial and a fit is reproducible.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.params import (
    FloatParam, HasInputCol, HasOutputCol, IntParam, ListParam,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, SchemaError
from mmlspark_tpu_torch.core.serialization import register_stage
from mmlspark_tpu_torch.observability import syncs as obssyncs
from mmlspark_tpu_torch.parallel.trainer import to_device
from mmlspark_tpu_torch.utils.config import resolve_device

_TABLE_SIZE = 1 << 16


def _build_vocab(rows, min_count: int) -> Tuple[List[str], np.ndarray]:
    counts: Counter = Counter()
    for row in rows:
        counts.update(row)
    vocab = sorted([w for w, c in counts.items() if c >= min_count],
                   key=lambda w: (-counts[w], w))
    freqs = np.asarray([counts[w] for w in vocab], dtype=np.float64)
    return vocab, freqs


def _flat_ids(rows, index: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, row_ids) over all in-vocab tokens, corpus-flattened."""
    ids: List[int] = []
    row_ids: List[int] = []
    for r, row in enumerate(rows):
        for t in row:
            i = index.get(t)
            if i is not None:
                ids.append(i)
                row_ids.append(r)
    return np.asarray(ids, np.int32), np.asarray(row_ids, np.int64)


def _skipgram_pairs(rows, index: Dict[str, int], window: int,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized skip-gram pair generation with word2vec's dynamic window.

    Each center draws an effective window b in [1, window]; context j pairs
    with center i iff |i-j| <= b_i within the same row. One masked shift of
    the corpus-flat id array per offset: O(window) numpy passes over the
    corpus."""
    ids, row_ids = _flat_ids(rows, index)
    if ids.size < 2:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    spans = rng.integers(1, window + 1, size=ids.size)
    centers, contexts = [], []
    for d in range(1, window + 1):
        if d >= ids.size:
            break
        same_row = row_ids[:-d] == row_ids[d:]
        # center on the left of the pair: include iff its span reaches d
        m = same_row & (spans[:-d] >= d)
        centers.append(ids[:-d][m])
        contexts.append(ids[d:][m])
        # center on the right of the pair
        m = same_row & (spans[d:] >= d)
        centers.append(ids[d:][m])
        contexts.append(ids[:-d][m])
    c = np.concatenate(centers) if centers else np.zeros(0, np.int32)
    x = np.concatenate(contexts) if contexts else np.zeros(0, np.int32)
    return c.astype(np.int32), x.astype(np.int32)


def _sgd_step(w_in: torch.Tensor, w_out: torch.Tensor, cb: torch.Tensor,
              xb: torch.Tensor, neg_idx: torch.Tensor, lr: float) -> None:
    """One SGD step, in place, on the skip-gram negative-sampling loss
    summed over the batch::

        -(sum_b log_sigmoid(w_in[cb] . w_out[xb])
          + sum_{b,k} log_sigmoid(-w_in[cb] . w_out[neg_idx]))

    Both matrices are read before either is written, as the reference's
    ``value_and_grad`` step reads them; ``cb``, ``xb`` (B,) and
    ``neg_idx`` (B, K) index rows."""
    b, k = neg_idx.shape
    flat_neg = neg_idx.reshape(-1)
    vc = w_in.index_select(0, cb)                                # (B, D)
    uo = w_out.index_select(0, xb)                               # (B, D)
    un = w_out.index_select(0, flat_neg).view(b, k, -1)          # (B, K, D)
    pos = (vc * uo).sum(dim=-1)                                  # (B,)
    negs = torch.bmm(un, vc.unsqueeze(-1)).squeeze(-1)           # (B, K)
    # d/dx -log_sigmoid(x) = -sigmoid(-x); d/dx -log_sigmoid(-x) = sigmoid(x)
    g_pos = -torch.sigmoid(-pos)
    g_neg = torch.sigmoid(negs)
    g_vc = g_pos.unsqueeze(-1) * uo \
        + torch.bmm(g_neg.unsqueeze(1), un).squeeze(1)
    g_uo = g_pos.unsqueeze(-1) * vc
    g_un = g_neg.unsqueeze(-1) * vc.unsqueeze(1)
    w_in.index_add_(0, cb, g_vc, alpha=-lr)  # lint: allow-embed (dense SGD)
    w_out.index_add_(0, xb, g_uo, alpha=-lr)  # lint: allow-embed (dense SGD)
    w_out.index_add_(0, flat_neg, g_un.reshape(b * k, -1), alpha=-lr)  # lint: allow-embed (dense SGD)


@register_stage
class Word2Vec(HasInputCol, HasOutputCol, Estimator):
    vectorSize = IntParam("vectorSize", "embedding dimension", 100,
                          validator=lambda v: v > 0)
    windowSize = IntParam("windowSize", "max skip-gram window", 5,
                          validator=lambda v: v >= 1)
    minCount = IntParam("minCount", "minimum token frequency", 5,
                        validator=lambda v: v >= 1)
    maxIter = IntParam("maxIter", "training epochs", 1,
                       validator=lambda v: v >= 1)
    stepSize = FloatParam("stepSize", "SGD learning rate", 0.025)
    numNegatives = IntParam("numNegatives", "negative samples per pair", 5,
                            validator=lambda v: v >= 1)
    batchSize = IntParam("batchSize", "pairs per step", 1024,
                         validator=lambda v: v > 0)
    seed = IntParam("seed", "random seed", 0)

    def fit(self, frame: Frame) -> "Word2VecModel":
        device = resolve_device()
        if frame.schema[self.inputCol].dtype != DType.TOKENS:
            raise SchemaError(
                f"Word2Vec: input column {self.inputCol!r} must be tokens")
        rows = frame.column(self.inputCol)
        vocab, freqs = _build_vocab(rows, self.minCount)
        if not vocab:
            raise SchemaError(
                f"Word2Vec: no token appears >= minCount={self.minCount} times")
        index = {w: i for i, w in enumerate(vocab)}
        host_rng = np.random.default_rng(self.seed)
        centers, contexts = _skipgram_pairs(rows, index, self.windowSize,
                                            host_rng)

        dim, v = self.vectorSize, len(vocab)
        if centers.size == 0:  # degenerate corpus: random init, no training
            w_in = host_rng.normal(0, 1.0 / dim, (v, dim)).astype(np.float32)
            return self._make_model(vocab, w_in)

        # unigram^0.75 negative-sampling table
        p = freqs ** 0.75
        p /= p.sum()
        table = host_rng.choice(v, size=_TABLE_SIZE, p=p).astype(np.int32)
        w_in_host = host_rng.uniform(-0.5 / dim, 0.5 / dim,
                                     (v, dim)).astype(np.float32)

        # ONE transfer each for the pairs, the table and w_in; epochs
        # re-permute on the device
        w_in = to_device(w_in_host, device)
        w_out = torch.zeros((v, dim), dtype=torch.float32, device=device)
        c_dev = to_device(centers, device)
        x_dev = to_device(contexts, device)
        table_dev = to_device(table, device)
        gen = torch.Generator(device=device).manual_seed(int(self.seed))
        for _ in range(self.maxIter):
            self._epoch(w_in, w_out, c_dev, x_dev, table_dev, gen)
        return self._make_model(vocab, obssyncs.device_get(w_in,
                                                           "word2vec.fit"))

    def _epoch(self, w_in, w_out, c_all, x_all, table, gen) -> None:
        """One pass over the pairs: a device permutation, wrap-padded to
        whole batches (ceil, so the remainder trains too; duplicates are
        harmless for SGD and the shuffle differs per epoch), then one
        :func:`_sgd_step` per batch with its own negatives."""
        n_pairs = c_all.shape[0]
        batch = min(self.batchSize, n_pairs)
        n_batches = -(-n_pairs // batch)
        device = c_all.device
        perm = torch.randperm(n_pairs, generator=gen, device=device)
        idx = perm.index_select(
            0, torch.arange(n_batches * batch, device=device) % n_pairs)
        cb = c_all.index_select(0, idx).view(n_batches, batch)
        xb = x_all.index_select(0, idx).view(n_batches, batch)
        neg, lr = self.numNegatives, float(self.stepSize)
        for i in range(n_batches):
            draw = torch.randint(0, _TABLE_SIZE, (batch * neg,),
                                 generator=gen, device=device)
            neg_idx = table.index_select(0, draw).view(batch, neg)
            _sgd_step(w_in, w_out, cb[i], xb[i], neg_idx, lr)

    def _make_model(self, vocab: List[str], vectors: np.ndarray) -> "Word2VecModel":
        model = Word2VecModel(inputCol=self.inputCol, outputCol=self.outputCol,
                              vectorSize=self.vectorSize)
        model.set_params(vocabulary=list(vocab))
        model._set_state({"vectors": np.asarray(vectors, np.float32)})
        return model


@register_stage
class Word2VecModel(HasInputCol, HasOutputCol, Model):
    vectorSize = IntParam("vectorSize", "embedding dimension", 100)
    vocabulary = ListParam("vocabulary", "ordered vocabulary", [])

    @property
    def vectors(self) -> np.ndarray:
        return self._get_state()["vectors"]

    def get_vectors(self) -> Dict[str, np.ndarray]:
        return {w: self.vectors[i] for i, w in enumerate(self.get("vocabulary"))}

    def transform(self, frame: Frame) -> Frame:
        """Average the vectors of in-vocab tokens per row (Spark semantics);
        rows with no known token map to the zero vector."""
        if frame.schema[self.inputCol].dtype != DType.TOKENS:
            raise SchemaError(
                f"Word2VecModel: input column {self.inputCol!r} must be tokens")
        index = {w: i for i, w in enumerate(self.get("vocabulary"))}
        vecs = self.vectors
        dim = vecs.shape[1]
        rows = frame.column(self.inputCol)
        out = np.zeros((len(rows), dim), dtype=np.float32)
        ids, row_ids = _flat_ids(rows, index)
        if ids.size:
            np.add.at(out, row_ids, vecs[ids])
            counts = np.bincount(row_ids, minlength=len(rows)).astype(np.float32)
            out /= np.maximum(counts, 1.0)[:, None]
        return frame.with_column_values(
            ColumnSchema(self.outputCol, DType.VECTOR, dim=dim), out)

    def transform_schema(self, schema):
        return schema.add(ColumnSchema(self.outputCol, DType.VECTOR,
                                       dim=self.vectorSize))

    def find_synonyms(self, word: str, num: int) -> List[Tuple[str, float]]:
        vocab = self.get("vocabulary")
        index = {w: i for i, w in enumerate(vocab)}
        if word not in index:
            raise KeyError(f"{word!r} not in vocabulary")
        vecs = self.vectors
        q = vecs[index[word]]
        norms = np.linalg.norm(vecs, axis=1) * (np.linalg.norm(q) + 1e-12) + 1e-12
        sims = vecs @ q / norms
        order = np.argsort(-sims)
        out = []
        for i in order:
            if vocab[i] != word:
                out.append((vocab[i], float(sims[i])))
            if len(out) >= num:
                break
        return out
