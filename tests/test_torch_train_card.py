"""The text and token training slice on a card against the CPU: the
``lamb`` and ``adafactor`` optimizers, TextCNN and Word2Vec.

This file imports no JAX, so the tests marked ``cuda`` can run on a card's
machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_card.py

Here, without a card, they skip; the unmarked tests run on the CPU.
Tolerances are stated at each test.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.feature import word2vec as tw2v
from mmlspark_tpu_torch.feature.word2vec import Word2Vec
from mmlspark_tpu_torch.models.zoo import build_model, init_state
from mmlspark_tpu_torch.observability import syncs
from mmlspark_tpu_torch.parallel import optim
from mmlspark_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tconfig.set("runtime.device", "cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    tconfig.set("runtime.device", "cpu")


def _tree(seed=0):
    """A factored (128 x 256), an unfactored (3 x 200) and a vector leaf,
    with one gradient each."""
    rng = np.random.default_rng(seed)
    shapes = [(128, 256), (3, 200), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return params, grads


def _updated(recipe, params, grads, device, steps=1):
    ws = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(device))
          for p in params]
    state = recipe.init(ws)
    for _ in range(steps):
        for w, g in zip(ws, grads):
            w.grad = torch.from_numpy(g).to(device)
        state.step()
        state.zero_grad()
    return [w.detach().cpu().numpy() for w in ws]


# -- on the CPU ---------------------------------------------------------------

def test_lamb_trust_ratio_is_one_at_a_zero_parameter():
    """optax's ``scale_by_trust_ratio``: a parameter of norm 0 takes the
    bare Adam step (ratio 1), ``-lr * sign(g)`` on the first update up to
    eps; a nonzero one is scaled to ``lr * ||p||`` in norm."""
    g = np.asarray([0.5, -2.0, 1.0], np.float32)
    zero = _updated(optim.lamb(0.1), [np.zeros(3, np.float32)], [g],
                    torch.device("cpu"))[0]
    np.testing.assert_allclose(zero, -0.1 * np.sign(g), rtol=1e-5)
    p = np.asarray([3.0, 4.0, 0.0], np.float32)
    moved = _updated(optim.lamb(0.1), [p], [g], torch.device("cpu"))[0]
    np.testing.assert_allclose(np.linalg.norm(moved - p),
                               0.1 * np.linalg.norm(p), rtol=1e-5)


def test_adafactor_keeps_factored_float32_state():
    """The 128 x 256 leaf keeps a row and a column second moment, the
    others whole ones; all float32, and a step reads nothing back."""
    params, grads = _tree()
    ws = [torch.nn.Parameter(torch.from_numpy(p)) for p in params]
    state = optim.adafactor(1e-2).init(ws)
    for w, g in zip(ws, grads):
        w.grad = torch.from_numpy(g)
    before = syncs.total()
    state.step()
    assert syncs.total() == before
    st = [state.torch.state[w] for w in ws]
    assert st[0]["v_row"].shape == (128,) and st[0]["v_col"].shape == (256,)
    assert st[1]["v"].shape == (3, 200) and st[2]["v"].shape == (7,)
    assert all(t.dtype == torch.float32 for s in st for t in s.values())


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["lamb", "adafactor"])
def test_optimizer_update_on_the_card_matches_the_cpu(card, opt):
    """Three updates of the same tree from the same gradients on the card
    and on the CPU: the same float32 operations, reductions in another
    order; rtol 1e-5, atol 1e-6 (parameters up to ~4)."""
    recipe = {"lamb": lambda: optim.lamb(1e-2, weight_decay=0.1),
              "adafactor": lambda: optim.adafactor(1e-2)}[opt]
    params, grads = _tree(1)
    got = _updated(recipe(), params, grads, card, steps=3)
    want = _updated(recipe(), params, grads, torch.device("cpu"), steps=3)
    for g, w, p in zip(got, want, params):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        assert np.abs(g - p).max() > 1e-3


@pytest.mark.cuda
def test_textcnn_fp32_logits_on_the_card_match_the_cpu(card):
    """TextCNN at its zoo width (embed 128, widths 3/4/5, 128 filters) in
    fp32 with TF32 off: card logits and pool within 1e-5 of the CPU's
    (cuDNN and the CPU sum the convs in other orders)."""
    module = build_model("textcnn", seq_len=128, dtype="float32")["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            init_state(module, seed=0).items()})
    ids = np.random.default_rng(2).integers(1, 1 << 15, (16, 128))
    x = torch.from_numpy(ids.astype(np.int32))
    with torch.no_grad():
        want, w_inters = module.eval().forward_with_intermediates(x)
        got, g_inters = module.to(card).forward_with_intermediates(
            x.to(card))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(g_inters["pool"].cpu().numpy(),
                               w_inters["pool"].numpy(), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_word2vec_fits_on_the_card(card):
    """The synonym corpus of ``tests/test_text.py`` on the card: the pairs,
    the table and w_in cross once (4 uploads over 10 epochs), one counted
    sync a fit, finite vectors, and the synonym cluster holds."""
    docs = []
    for fruit in ("apple", "orange"):
        docs += [["i", "eat", fruit, "every", "day"],
                 ["fresh", fruit, "juice", "tastes", "sweet"],
                 ["the", fruit, "tree", "grows", "fast"]] * 6
    docs += [["the", "motor", "engine", "runs", "fast"],
             ["repair", "the", "motor", "with", "tools"]] * 6
    uploads = []
    real = tw2v.to_device

    def spy(x, device):
        uploads.append(device)
        return real(x, device)
    tw2v.to_device = spy
    try:
        before = syncs.total()
        model = Word2Vec(inputCol="tok", outputCol="vec", vectorSize=24,
                         minCount=2, maxIter=10, stepSize=0.05, seed=3,
                         batchSize=256).fit(Frame.from_dict({"tok": docs}))
        fit_syncs = syncs.total() - before
    finally:
        tw2v.to_device = real
    assert len(uploads) == 4 and all(d.type == "cuda" for d in uploads)
    assert fit_syncs == 1
    vecs = model.get_vectors()
    assert np.isfinite(model.vectors).all()

    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    assert cos(vecs["apple"], vecs["orange"]) > cos(vecs["apple"],
                                                    vecs["motor"])
    syns = model.find_synonyms("apple", 3)
    assert len(syns) == 3 and all(w != "apple" for w, _ in syns)
