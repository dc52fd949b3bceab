"""Training the port's token and attention models against the JAX
package's trainer, on the CPU.

Each test trains one model in both packages: the flax init converted by
``from_jax_params`` into the port's module, the JAX ``DistributedTrainer``
on a one-device mesh (its sums in one order) and the port's, each fed the
same batches in the same order by its unshuffled ``DeviceEpochCache``,
with optax's optimizer on one side and its twin in ``parallel/optim.py``
on the other. fp32 throughout. The per-step losses are held at rtol 1e-4:
both frameworks run the same fp32 operations in other summation orders,
and Adam carries the last-bit differences of small gradients into its
steps (measured at most 1.3e-6 relative over these runs; the MoE LM's
``moe_aux`` 1.1e-7).

The losses are the JAX package's: next-token cross-entropy (``logits[:,
:-1]`` against ``ids[:, 1:]``, mean) for the LMs, plus ``0.01 *
moe_aux_loss`` for the MoE LM (``tests/test_moe.py``); softmax
cross-entropy for ViT (with K1 in the loss, its plain version on the CPU
in the port and the Pallas kernel in interpret mode in the JAX package)
and TextCNN, as the JAX bench's ``train_large`` and ``text`` lanes train
them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu.models.zoo.moe import moe_aux_loss as jax_moe_aux_loss
from mmlspark_tpu.ops.pallas_preprocess import (
    make_preprocess_fn as jax_make_preprocess_fn,
)
from mmlspark_tpu.parallel.mesh import data_parallel_mesh
from mmlspark_tpu.parallel.trainer import (
    DeviceEpochCache as JaxDeviceEpochCache,
    DistributedTrainer as JaxDistributedTrainer,
)
from mmlspark_tpu_torch.models.convert import from_jax_params
from mmlspark_tpu_torch.models.zoo import build_model
from mmlspark_tpu_torch.models.zoo.moe import moe_aux_loss
from mmlspark_tpu_torch.ops.preprocess import make_preprocess_fn
from mmlspark_tpu_torch.parallel import optim
from mmlspark_tpu_torch.parallel.trainer import (
    DeviceEpochCache, DistributedTrainer,
)
from mmlspark_tpu_torch.utils import config as tconfig

RTOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _pair(name, example, **arch):
    """(flax module, its init of seed 0 as numpy, the port's module with
    those parameters) for zoo entry ``name``."""
    jmod = jbuild(name, **arch)["module"]
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(example))
    params = jax.tree_util.tree_map(np.array, params)
    tmod = build_model(name, **arch)["module"]
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in
                          from_jax_params(params).items()}, strict=True)
    return jmod, params, tmod


def _train_both(jloss, jopt, params, tloss, topt, tmod, data, batch,
                epochs=1):
    """Loss histories of the two trainers over ``epochs`` unshuffled epochs
    of ``data`` at ``batch``, and their final states."""
    mesh = data_parallel_mesh(jax.devices()[:1])
    jtr = JaxDistributedTrainer(jloss, jopt, mesh=mesh)
    jstate = jtr.init(lambda: jax.tree_util.tree_map(jnp.asarray, params))
    jcache = JaxDeviceEpochCache(data, batch, mesh=mesh)
    want = []
    for epoch in range(epochs):
        for b in jcache.batches(epoch):
            jstate, m = jtr.train_step(jstate, b, jax.random.PRNGKey(1))
            want.append(float(m["loss"]))
    ttr = DistributedTrainer(tloss, topt)
    tstate = ttr.init(lambda: tmod)
    tcache = DeviceEpochCache(data, batch)
    got = []
    for epoch in range(epochs):
        for b in tcache.batches(epoch):
            tstate, m = ttr.train_step(tstate, b, 1)
            got.append(float(m["loss"]))
    return np.asarray(got), np.asarray(want), tstate, jstate


def _next_token_ce_jax(logits, ids):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1], ids[:, 1:]).mean()


def _next_token_ce(logits, ids):
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                           ids[:, 1:].reshape(-1).long())


def test_tiny_lm_next_token_training_tracks_the_jax_trainer():
    """transformer_lm_tiny (vocab 256, dim 64, depth 2, 4 heads), 32 rows
    of 32 ids, batch 4, adamw(1e-3), two epochs: 16 steps."""
    ids = np.random.default_rng(0).integers(0, 256, (32, 32)).astype(np.int32)
    jmod, params, tmod = _pair("transformer_lm_tiny", ids[:1])

    def jloss(p, batch, rng):
        return _next_token_ce_jax(jmod.apply(p, batch["ids"]), batch["ids"])

    def tloss(module, batch, gen):
        return _next_token_ce(module(batch["ids"]), batch["ids"])

    got, want, tstate, _ = _train_both(
        jloss, optax.adamw(1e-3), params, tloss, optim.adamw(1e-3), tmod,
        {"ids": ids}, 4, epochs=2)
    assert len(got) == 16 and want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert int(tstate["step"]) == 16


def test_tiny_moe_lm_training_with_aux_loss_tracks_the_jax_trainer():
    """transformer_lm_moe_tiny (4 experts, top-2, capacity 2.0) with the
    loss of ``tests/test_moe.py``: CE + 0.01 * moe_aux_loss, adamw(1e-3),
    16 rows of 16 ids, batch 4, two epochs (8 steps). ``moe_aux`` itself
    is held to JAX's at the init and after the last step."""
    ids = np.random.default_rng(0).integers(0, 256, (16, 16)).astype(np.int32)
    jmod, params, tmod = _pair("transformer_lm_moe_tiny", ids[:2],
                               num_experts=4, max_len=16)

    def jloss(p, batch, rng):
        logits, state = jmod.apply(p, batch["ids"], mutable=["losses"])
        return _next_token_ce_jax(logits, batch["ids"]) \
            + 0.01 * jax_moe_aux_loss(state)

    def tloss(module, batch, gen):
        logits, inters = module.forward_with_intermediates(batch["ids"])
        return _next_token_ce(logits, batch["ids"]) \
            + 0.01 * moe_aux_loss(inters)

    def aux_pair(jparams, module):
        _, state = jmod.apply(jparams, jnp.asarray(ids[:4]),
                              mutable=["losses"])
        with torch.no_grad():
            _, inters = module.forward_with_intermediates(
                torch.from_numpy(ids[:4]))
        blocks = sum(float(m.aux_loss) for m in module.modules()
                     if getattr(m, "aux_loss", None) is not None)
        return float(moe_aux_loss(inters)), float(jax_moe_aux_loss(state)), \
            blocks

    got_aux0, want_aux0, blocks_aux0 = aux_pair(params, tmod)
    got, want, tstate, jstate = _train_both(
        jloss, optax.adamw(1e-3), params, tloss, optim.adamw(1e-3), tmod,
        {"ids": ids}, 4, epochs=2)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    got_aux, want_aux, _ = aux_pair(jstate["params"], tstate["module"])
    assert want_aux0 > 0 and want_aux > 0
    np.testing.assert_allclose([got_aux0, got_aux], [want_aux0, want_aux],
                               rtol=RTOL)
    # the intermediates carry the sum of the routed blocks' own terms
    np.testing.assert_allclose(got_aux0, blocks_aux0, rtol=1e-6)


def test_moe_aux_loss_is_zero_without_routed_layers():
    """Like the JAX sum over an empty ``losses`` collection: a dense LM's
    intermediates have no term."""
    module = build_model("transformer_lm_tiny", max_len=16)["module"]
    with torch.no_grad():
        _, inters = module.forward_with_intermediates(
            torch.zeros((1, 16), dtype=torch.int32))
    aux = moe_aux_loss(inters)
    assert float(aux) == 0.0 and aux.dtype == torch.float32


def test_vit_tiny_training_with_k1_in_the_loss_tracks_the_jax_trainer():
    """vit_tiny (fp32, 32x32 uint8 images, patch 4) with K1 inside the
    loss (mean = std = 127.5, as the ``train_large`` lane normalizes),
    sgd(0.05, momentum 0.9), 48 images, batch 8: 6 steps."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (48, 32 * 32 * 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 48).astype(np.int32)
    jmod, params, tmod = _pair("vit_tiny", np.zeros((1, 32, 32, 3),
                                                    np.float32),
                               dtype="float32")
    jpre = jax_make_preprocess_fn((32, 32, 3), mean=(127.5,) * 3,
                                  std=(127.5,) * 3, out_dtype=jnp.float32)
    tpre = make_preprocess_fn((32, 32, 3), mean=(127.5,) * 3,
                              std=(127.5,) * 3, out_dtype=torch.float32)

    def jloss(p, batch, rng):
        logits = jmod.apply(p, jpre(batch["image"])).astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["label"]).mean()

    def tloss(module, batch, gen):
        return F.cross_entropy(module(tpre(batch["image"])).float(),
                               batch["label"].long())

    got, want, _, _ = _train_both(
        jloss, optax.sgd(0.05, momentum=0.9), params, tloss,
        optim.sgd(0.05, momentum=0.9), tmod,
        {"image": images, "label": labels}, 8)
    assert len(got) == 6
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_textcnn_training_tracks_the_jax_trainer():
    """TextCNN (vocab 512, embed 32, widths 3/4/5, 16 filters, fp32) on 64
    rows of 24 hashed-id-like ids with binary labels, adam(1e-3), batch 16,
    two epochs: 8 steps."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 512, (64, 24)).astype(np.int32)
    labels = rng.integers(0, 2, 64).astype(np.int32)
    from mmlspark_tpu.models.zoo.cnn1d import TextCNN as JaxTextCNN
    from mmlspark_tpu_torch.models.zoo.cnn1d import TextCNN
    jmod = JaxTextCNN(vocab_size=512, embed_dim=32, filters=16,
                      dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.array, jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 24), jnp.int32)))
    tmod = TextCNN(512, 32, filters=16, dtype="float32")
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in
                          from_jax_params(params).items()}, strict=True)

    def jloss(p, batch, rng):
        logits = jmod.apply(p, batch["ids"]).astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["label"]).mean()

    def tloss(module, batch, gen):
        return F.cross_entropy(module(batch["ids"]).float(),
                               batch["label"].long())

    got, want, _, _ = _train_both(
        jloss, optax.adam(1e-3), params, tloss, optim.adam(1e-3), tmod,
        {"ids": ids, "label": labels}, 16, epochs=2)
    assert len(got) == 8
    np.testing.assert_allclose(got, want, rtol=RTOL)
