"""The port's text models against the JAX package's, on the CPU: TextCNN
(``models/zoo/cnn1d.py``), its scoring through ``TorchModel``, and
Word2Vec (``feature/word2vec.py``).

TextCNN's flax parameters go through ``from_jax_params`` into the port's
module. Word2Vec's host draws (vocabulary, skip-gram pairs, negative
table, initial vectors) come from one ``np.random.default_rng(seed)`` in
both packages and are held bit-equal; its in-epoch shuffle and negatives
are ``jax.random`` in the reference and a ``torch.Generator`` here, so
whole fits are held to the reference's own assertions
(``tests/test_text.py``), and one SGD step to the JAX step's math on the
same batch. Tolerances are stated at each test.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.feature import word2vec as jw2v
from mmlspark_tpu.models.zoo.cnn1d import TextCNN as JaxTextCNN
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.feature import word2vec as tw2v
from mmlspark_tpu_torch.feature.word2vec import Word2Vec, Word2VecModel
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.zoo.cnn1d import Conv1d, TextCNN
from mmlspark_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


# -- TextCNN -----------------------------------------------------------------

def _textcnn_pair(kernel_sizes, vocab=64, seq_len=20, num_classes=3,
                  embed_dim=16, filters=8):
    """One fp32 TextCNN in each package from the flax init of seed 0."""
    jm = JaxTextCNN(vocab_size=vocab, embed_dim=embed_dim,
                    kernel_sizes=kernel_sizes, filters=filters,
                    num_classes=num_classes, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, seq_len), jnp.int32))
    tm = TextCNN(vocab, embed_dim, kernel_sizes, filters, num_classes,
                 dtype="float32")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_jax_params(params).items()}, strict=True)
    return jm, params, tm


@pytest.mark.parametrize("kernel_sizes,seq_len", [
    ((3, 4, 5), 20), ((3, 4, 5), 7), ((4,), 9)])
def test_textcnn_logits_and_pool_match_flax_in_fp32(kernel_sizes, seq_len):
    """Logits and the ``pool`` layer from one converted init, fp32: the
    same sums in another order, atol 1e-5 (logits of magnitude ~0.3)."""
    jm, params, tm = _textcnn_pair(kernel_sizes, seq_len=seq_len)
    ids = np.random.default_rng(1).integers(0, 64, (4, seq_len)).astype(
        np.int32)
    want, inters = jm.apply(params, jnp.asarray(ids),
                            mutable=["intermediates"])
    with torch.no_grad():
        got, t_inters = tm.forward_with_intermediates(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(
        t_inters["pool"].numpy(),
        np.asarray(inters["intermediates"]["pool"][0]), atol=1e-5, rtol=0)
    assert got.dtype == t_inters["pool"].dtype == torch.float32


@pytest.mark.parametrize("k,length", [(4, 9), (4, 8), (3, 5), (5, 6)])
def test_conv1d_same_padding_matches_flax_at_every_position(k, length):
    """flax SAME pads (k - 1) // 2 on the left and the rest on the right
    (1 and 2 at k = 4); every output position, the edges included, equals
    flax's ``nn.Conv`` on the same input (fp32, atol 1e-6)."""
    x = np.random.default_rng(2).normal(size=(2, length, 3)).astype(
        np.float32)
    conv = fnn.Conv(5, (k,), padding="SAME", dtype=jnp.float32)
    params = conv.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    mod = Conv1d(3, 5, k, dtype="float32")
    sd = from_jax_params({"params": {"conv": params["params"]}})
    mod.load_state_dict({n.split(".", 1)[1]: torch.from_numpy(v)
                         for n, v in sd.items()})
    with torch.no_grad():
        got = mod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_textcnn_bf16_logits_track_flax():
    """The zoo's default dtype: bf16 embedding rows, bf16 convs with the
    bias added after, pools cast to fp32 after the concat. Both round the
    same values to bf16; the convs sum in another order before rounding,
    so the logits are held at 2% of their scale (measured 1.8e-7)."""
    jm = JaxTextCNN(vocab_size=64, embed_dim=16, filters=8, num_classes=3)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 20), jnp.int32))
    tm = TextCNN(64, 16, (3, 4, 5), 8, 3)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_jax_params(params).items()}, strict=True)
    ids = np.random.default_rng(4).integers(0, 64, (4, 20)).astype(np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=0.02 * np.abs(want).max(),
                               rtol=0)


def test_torch_model_compute_dtype_keeps_token_models_integer():
    """The twin of ``tests/test_models.py::test_jax_model_compute_dtype_
    keeps_token_models_integer``: bf16 scoring must not cast int32 token
    inputs."""
    ids = np.arange(24, dtype=np.int32).reshape(2, 12) % 7
    f = Frame.from_dict({"ids": ids})
    m = TorchModel(inputCol="ids", outputCol="o", miniBatchSize=2,
                   computeDtype="bfloat16")
    m.set_model("textcnn", num_classes=3, vocab_size=8, seq_len=12, seed=0)
    out = m.transform(f)
    assert out.count() == 2 and out.schema["o"].dim == 3
    assert np.isfinite(np.asarray(out.column("o"))).all()


# -- Word2Vec: the host draws ------------------------------------------------

def _toy_docs():
    # 'apple' and 'orange' share contexts; 'motor' lives elsewhere
    # (tests/test_text.py::_toy_corpus)
    docs = []
    for fruit in ("apple", "orange"):
        docs += [["i", "eat", fruit, "every", "day"],
                 ["fresh", fruit, "juice", "tastes", "sweet"],
                 ["the", fruit, "tree", "grows", "fast"]] * 6
    docs += [["the", "motor", "engine", "runs", "fast"],
             ["repair", "the", "motor", "with", "tools"]] * 6
    return docs


def _toy_corpus():
    return Frame.from_dict({"tok": _toy_docs()})


def _reviews(n=60, seed=5):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(40)])
    return [list(rng.choice(words, rng.integers(3, 12))) for _ in range(n)]


@pytest.mark.parametrize("docs", [_toy_docs(), _reviews()],
                         ids=["toy", "reviews"])
def test_word2vec_vocab_and_pairs_are_bit_equal(docs):
    """Vocabulary (order and counts), flat ids and the skip-gram pairs of
    one ``default_rng`` stream: bit-equal."""
    jv, jf = jw2v._build_vocab(docs, 2)
    tv, tf = tw2v._build_vocab(docs, 2)
    assert jv == tv
    np.testing.assert_array_equal(jf, tf)
    index = {w: i for i, w in enumerate(tv)}
    for a, b in zip(jw2v._flat_ids(docs, index), tw2v._flat_ids(docs, index)):
        np.testing.assert_array_equal(a, b)
    for window in (1, 5):
        want = jw2v._skipgram_pairs(docs, index, window,
                                    np.random.default_rng(9))
        got = tw2v._skipgram_pairs(docs, index, window,
                                   np.random.default_rng(9))
        for a, b in zip(want, got):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def _jax_fit_uploads(monkeypatch, frame, **kw):
    """The numpy arrays the JAX fit hands to ``jnp.asarray``, in order."""
    seen = []
    real = jnp.asarray

    def spy(x, *a, **k):
        if isinstance(x, np.ndarray):
            seen.append(np.array(x))
        return real(x, *a, **k)
    with monkeypatch.context() as m:
        m.setattr(jnp, "asarray", spy)
        jw2v.Word2Vec(inputCol="tok", outputCol="v", **kw).fit(frame)
    return seen


def _port_fit_uploads(monkeypatch, frame, **kw):
    """The host arrays the port's fit sends to the device, in order."""
    seen = []
    real = tw2v.to_device

    def spy(x, device):
        seen.append(np.array(x))
        return real(x, device)
    with monkeypatch.context() as m:
        m.setattr(tw2v, "to_device", spy)
        model = Word2Vec(inputCol="tok", outputCol="v", **kw).fit(frame)
    return seen, model


def test_word2vec_table_and_initial_vectors_are_bit_equal(monkeypatch):
    """What each fit uploads: the JAX fit ``w_in, centers, contexts,
    table``, the port ``w_in, centers, contexts, table``: the same four
    arrays bit for bit, so both fits start from the same state."""
    kw = dict(vectorSize=8, minCount=2, maxIter=1, seed=7)
    want = _jax_fit_uploads(monkeypatch, JFrame.from_dict({"tok": _toy_docs()}),
                            **kw)
    got, _ = _port_fit_uploads(monkeypatch, _toy_corpus(), **kw)
    assert len(want) == len(got) == 4
    assert want[0].shape == (20, 8) and want[3].shape == (tw2v._TABLE_SIZE,)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_word2vec_degenerate_corpus_init_is_bit_equal():
    """No pair (every row one token): both fits return the normal init of
    the same stream, untrained, bit-equal."""
    docs = [["a"], ["b"], ["a"], ["c"]]
    want = jw2v.Word2Vec(inputCol="tok", outputCol="v", vectorSize=6,
                         minCount=1, seed=4).fit(JFrame.from_dict(
                             {"tok": docs}))
    got = Word2Vec(inputCol="tok", outputCol="v", vectorSize=6, minCount=1,
                   seed=4).fit(Frame.from_dict({"tok": docs}))
    assert got.get("vocabulary") == want.get("vocabulary")
    np.testing.assert_array_equal(got.vectors, want.vectors)


# -- Word2Vec: the step ------------------------------------------------------

def test_word2vec_sgd_step_matches_the_jax_step_math():
    """One step of ``_sgd_step`` against ``jax.value_and_grad`` of the JAX
    fit's summed loss, on identical ``cb``/``xb``/``neg_idx`` with
    repeated rows (so the scatter-adds collide), then ``w - lr * grad``:
    fp32, rtol 1e-5 (atol 1e-7 for elements that cancel to ~0; measured
    at most 1.2e-7 absolute on values up to 1)."""
    rng = np.random.default_rng(6)
    v, d, b, k, lr = 30, 12, 64, 5, 0.05
    w_in = rng.uniform(-0.5, 0.5, (v, d)).astype(np.float32)
    w_out = rng.normal(0, 0.3, (v, d)).astype(np.float32)
    cb = rng.integers(0, v, b).astype(np.int32)
    xb = rng.integers(0, v, b).astype(np.int32)
    neg_idx = rng.integers(0, v, (b, k)).astype(np.int32)

    def loss_fn(w_in, w_out):
        vc, uo, un = w_in[cb], w_out[xb], w_out[neg_idx]
        pos = jnp.sum(vc * uo, axis=-1)
        negs = jnp.einsum("bd,bkd->bk", vc, un)
        return -(jax.nn.log_sigmoid(pos).sum()
                 + jax.nn.log_sigmoid(-negs).sum())
    _, (g_in, g_out) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        jnp.asarray(w_in), jnp.asarray(w_out))
    want_in = np.asarray(w_in - lr * g_in)
    want_out = np.asarray(w_out - lr * g_out)

    t_in, t_out = torch.from_numpy(w_in.copy()), torch.from_numpy(w_out.copy())
    tw2v._sgd_step(t_in, t_out, torch.from_numpy(cb), torch.from_numpy(xb),
                   torch.from_numpy(neg_idx), lr)
    np.testing.assert_allclose(t_in.numpy(), want_in, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_out.numpy(), want_out, rtol=1e-5, atol=1e-7)
    assert not np.array_equal(t_out.numpy(), w_out)


# -- Word2Vec: tests/test_text.py's assertions on the port --------------------

def test_word2vec_fit_and_shapes():
    f = _toy_corpus()
    model = Word2Vec(inputCol="tok", outputCol="vec", vectorSize=16,
                     minCount=2, maxIter=3, seed=7).fit(f)
    vecs = model.get_vectors()
    assert "apple" in vecs and vecs["apple"].shape == (16,)
    out = model.transform(f)
    assert out.schema["vec"].dim == 16
    assert np.isfinite(np.asarray(out.column("vec"))).all()


def test_word2vec_synonyms_cluster():
    model = Word2Vec(inputCol="tok", outputCol="vec", vectorSize=24,
                     minCount=2, maxIter=10, stepSize=0.05, seed=3,
                     batchSize=256).fit(_toy_corpus())
    vecs = model.get_vectors()

    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    assert cos(vecs["apple"], vecs["orange"]) > cos(vecs["apple"],
                                                    vecs["motor"])
    syns = model.find_synonyms("apple", 3)
    assert len(syns) == 3 and all(w != "apple" for w, _ in syns)


def test_word2vec_transform_averages():
    model = Word2VecModel(inputCol="tok", outputCol="vec", vectorSize=2)
    model.set_params(vocabulary=["a", "b"])
    model._set_state({"vectors": np.array([[1, 0], [0, 1]], np.float32)})
    f = Frame.from_dict({"tok": [["a", "b"], ["a"], ["zzz"], []]})
    out = np.asarray(model.transform(f).column("vec"))
    assert np.allclose(out[0], [0.5, 0.5])
    assert np.allclose(out[1], [1, 0])
    assert np.allclose(out[2], [0, 0])  # OOV-only -> zero vector
    assert np.allclose(out[3], [0, 0])


def test_word2vec_save_load(tmp_path):
    f = _toy_corpus()
    model = Word2Vec(inputCol="tok", outputCol="vec", vectorSize=8,
                     minCount=2, maxIter=1, seed=0).fit(f)
    expected = np.asarray(model.transform(f).column("vec"))
    model.save(str(tmp_path / "w2v"))
    loaded = Word2VecModel.load(str(tmp_path / "w2v"))
    assert np.allclose(expected, np.asarray(loaded.transform(f).column("vec")))


def test_word2vec_epochs_transfer_pairs_once(monkeypatch):
    """The pair arrays, the table and w_in cross to the device once a fit:
    the number of host->device transfers does not grow with maxIter, and
    the fitted vectors come back in one counted fetch."""
    from mmlspark_tpu_torch.observability import syncs

    def count(max_iter):
        before = syncs.total()
        seen, _ = _port_fit_uploads(monkeypatch, _toy_corpus(), vectorSize=8,
                                    minCount=2, maxIter=max_iter, seed=0)
        return len(seen), syncs.total() - before

    assert count(1) == count(6) == (4, 1)


def test_word2vec_small_pair_count_uses_all_pairs():
    # fewer pairs than batchSize: remainder must still train (vectors move)
    docs = [["red", "blue"], ["blue", "red"]] * 3
    model = Word2Vec(inputCol="tok", outputCol="v", vectorSize=4, minCount=1,
                     maxIter=5, batchSize=1024, seed=0).fit(
        Frame.from_dict({"tok": docs}))
    vecs = model.get_vectors()
    assert np.abs(vecs["red"]).max() > 0.05  # moved well beyond init scale


def test_word2vec_fit_raises_without_a_card_unless_asked_for_the_cpu(
        monkeypatch):
    """At ``runtime.device``'s default ("cuda") on a machine without CUDA,
    the fit raises before any work; with "cpu" it runs (the fixture)."""
    monkeypatch.delenv("MMLSPARK_TPU_TORCH_RUNTIME_DEVICE", raising=False)
    tconfig.unset("runtime.device")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check is for a machine without it")
    with pytest.raises(RuntimeError, match="is_available"):
        Word2Vec(inputCol="tok", outputCol="v", minCount=1).fit(_toy_corpus())
