"""A new architecture family enters the benchmark through files of its own:
``reference/<family>.py`` and ``counts/<family>.py``, found by the
configuration's ``family``; a banked weight states its fan-in in its
spec; the train lane weighs the model's auxiliary loss by the
configuration's ``aux_loss_weight``, on both sides. A toy family with one
of the port's ``MoeMlp`` layers runs through ``run_cell`` on the CPU with
no file under ``cardbench/`` written for it. The two families already in
the benchmark draw and count as they did."""
import json
import math
import sys
import time
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from cardbench import weights
from cardbench.counts import flops
from cardbench.harness import HERE, Cell, CellError, benchmark, run_cell
from cardbench.reference import module_for
from cardbench.reference.drive import train_steps
from cardbench.weights import sub_seed

CPU = torch.device("cpu")
TOY = {"name": "toy_moe", "architecture": "cardbench_toy_moe",
       "family": "toy", "source": "cardbench/tests/test_cardbench_families.py",
       "image_size": 16, "patch_size": 4, "in_channels": 3,
       "hidden_size": 32, "num_attention_heads": 2, "intermediate_size": 128,
       "num_experts": 4, "top_k": 2, "expert_hidden": 64,
       "capacity_factor": 2.0, "num_classes": 10,
       "compute_dtype": "float32", "param_dtype": "float32",
       "arch_args": {"num_classes": 10}, "aux_loss_weight": 0.01,
       "reduced": []}


# -- the toy family: the port's model, its plain reference, its count ------

def _toy_model(num_classes=10):
    from mmlspark_tpu_torch.models.zoo import PooledHead
    from mmlspark_tpu_torch.models.zoo.moe import MoeMlp
    from mmlspark_tpu_torch.models.zoo.resnet import Dense
    from mmlspark_tpu_torch.models.zoo.transformer import LayerNorm
    from mmlspark_tpu_torch.models.zoo.vit import EncoderBlock, PatchEmbedding
    c = TOY
    d, p = c["hidden_size"], c["patch_size"]

    class ToyMoe(PooledHead):
        """Patches, a dense encoder block, an encoder block whose MLP is
        routed over experts, a final norm, the mean token, a head."""

        def __init__(self):
            super().__init__()
            f32 = torch.float32
            self.patch_embedding = PatchEmbedding(3, d, p, f32)
            self.pos_embedding = nn.Parameter(
                torch.empty(1, (c["image_size"] // p) ** 2, d))
            self.block0 = EncoderBlock(d, c["num_attention_heads"], dtype=f32)
            self.block1 = EncoderBlock(d, c["num_attention_heads"], dtype=f32)
            self.block1.mlp = MoeMlp(
                d, c["num_experts"], c["expert_hidden"], c["top_k"],
                c["capacity_factor"], dtype=f32)
            self.final_norm = LayerNorm(d)
            self.head = Dense(d, num_classes)

        def forward_features(self, x):
            x = self.patch_embedding(x) + self.pos_embedding
            x = self.block1(self.block0(x))
            return self.final_norm(x).mean(dim=1)

    s = c["image_size"]
    return dict(module=ToyMoe(), input_shape=(s, s, 3), feature_layer="pool",
                feature_dim=d, layer_names=["pool", "head"])


def _toy_specs(cfg):
    d, p, m = cfg["hidden_size"], cfg["patch_size"], cfg["intermediate_size"]
    e, h = cfg["num_experts"], cfg["expert_hidden"]
    specs = [("patch_embedding.weight", (d, cfg["in_channels"], p, p), "fan_in"),
             ("patch_embedding.bias", (d,), "bias"),
             ("pos_embedding", (1, (cfg["image_size"] // p) ** 2, d), "embed")]
    for b in ("block0", "block1"):
        specs += [(f"{b}.norm1.weight", (d,), "scale"),
                  (f"{b}.norm1.bias", (d,), "bias")]
        for proj in ("query", "key", "value", "out"):
            specs += [(f"{b}.attn.{proj}.weight", (d, d), "fan_in"),
                      (f"{b}.attn.{proj}.bias", (d,), "bias")]
        specs += [(f"{b}.norm2.weight", (d,), "scale"),
                  (f"{b}.norm2.bias", (d,), "bias")]
    specs += [("block0.mlp.mlp_up.weight", (m, d), "fan_in"),
              ("block0.mlp.mlp_up.bias", (m,), "bias"),
              ("block0.mlp.mlp_down.weight", (d, m), "fan_in"),
              ("block0.mlp.mlp_down.bias", (d,), "bias"),
              ("block1.mlp.router.weight", (e, d), "fan_in"),
              ("block1.mlp.router.bias", (e,), "bias"),
              ("block1.mlp.experts_up", (e, d, h), "fan_in", d),
              ("block1.mlp.experts_down", (e, h, d), "fan_in", h),
              ("final_norm.weight", (d,), "scale"),
              ("final_norm.bias", (d,), "bias"),
              ("head.weight", (cfg["num_classes"], d), "fan_in"),
              ("head.bias", (cfg["num_classes"],), "bias")]
    return specs


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], 1e-6)


def _linear(x, p, name):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _experts(p, name, x, cfg):
    """The routed MLP, expert by expert: top-k of the router's softmax,
    gates renormalised, each expert's slots taken in (choice, token)
    order up to the capacity; and the load-balancing term."""
    e_count, k_top = cfg["num_experts"], cfg["top_k"]
    xf = x.reshape(-1, x.shape[-1])
    cap = math.ceil(cfg["capacity_factor"] * xf.shape[0] * k_top / e_count)
    probs = torch.softmax(_linear(xf, p, f"{name}.router"), dim=-1)
    gate, idx = torch.topk(probs, k_top, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(xf)
    for e in range(e_count):
        taken = 0
        for k in range(k_top):
            rows = (idx[:, k] == e).nonzero().flatten()
            kept = rows[:max(0, cap - taken)]
            taken += len(rows)
            h = F.gelu(xf[kept] @ p[f"{name}.experts_up"][e], approximate="tanh")
            y = y.index_add(0, kept, gate[kept, k, None]
                            * (h @ p[f"{name}.experts_down"][e]))
    first = F.one_hot(idx[:, 0], e_count).float().mean(dim=0)
    aux = e_count * torch.sum(first * probs.mean(dim=0))
    return y.reshape(x.shape), aux


def _toy_forward(p, images, cfg, mode="fp32"):
    """NHWC float images -> (logits, pool, aux)."""
    x = F.conv2d(images.permute(0, 3, 1, 2), p["patch_embedding.weight"],
                 p["patch_embedding.bias"], stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2) + p["pos_embedding"]
    b, n, d = x.shape
    heads = cfg["num_attention_heads"]
    aux = None
    for blk in ("block0", "block1"):
        h = _ln(x, p, f"{blk}.norm1")
        q, k, v = (_linear(h, p, f"{blk}.attn.{t}").reshape(b, n, heads, -1)
                   for t in ("query", "key", "value"))
        s = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(d // heads), k)
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + _linear(a.reshape(b, n, d), p, f"{blk}.attn.out")
        h = _ln(x, p, f"{blk}.norm2")
        if blk == "block0":
            h = F.gelu(_linear(h, p, f"{blk}.mlp.mlp_up"), approximate="tanh")
            x = x + _linear(h, p, f"{blk}.mlp.mlp_down")
        else:
            y, aux = _experts(p, f"{blk}.mlp", h, cfg)
            x = x + y
    pool = _ln(x, p, "final_norm").mean(dim=1)
    return _linear(pool, p, "head"), pool, aux


def _toy_count(cfg, image_size):
    d, m, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    n = (image_size // p) ** 2
    routed = 2 * 2 * n * d * cfg["expert_hidden"] * cfg["top_k"]
    return (2 * p * p * cfg["in_channels"] * d * n
            + 2 * (4 * 2 * n * d * d + 2 * 2 * n * n * d)
            + 2 * 2 * n * d * m + 2 * n * d * cfg["num_experts"] + routed
            + 2 * d * cfg["num_classes"])


@pytest.fixture
def toy(monkeypatch):
    """The toy family's modules under the names the harness looks up, and
    its model in the port's zoo, all undone after the test."""
    from mmlspark_tpu_torch.models import zoo
    from mmlspark_tpu_torch.utils import config
    ref = types.ModuleType("cardbench.reference.toy")
    ref.param_specs, ref.forward = _toy_specs, _toy_forward
    count = types.ModuleType("cardbench.counts.toy")
    count.forward = _toy_count
    monkeypatch.setitem(sys.modules, "cardbench.reference.toy", ref)
    monkeypatch.setitem(sys.modules, "cardbench.counts.toy", count)
    monkeypatch.setattr(zoo, "_ZOO", dict(zoo._ZOO))
    zoo.register_model(TOY["architecture"])(_toy_model)
    yield dict(TOY)
    config.set("runtime.device", "cuda")


def _cell(base, cfg, traffic, limits):
    cell = Cell(base)
    cell.cfg, cell.limits = cfg, limits
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


TRAIN = dict(epoch_images=64, batch=8, warm_steps=1)
TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_norm_gap": 0.02, "change_norm_gap": 0.02}
FEATURIZE = dict(image=[24, 24, 3], pool_images=16, frame_images=8,
                 mini_batch=4, warm_frames=1)


def _run(cell, seconds=1.0):
    return run_cell(cell.name, 2**31 + 29, seconds, False, time.perf_counter(),
                    device="cpu", cell=cell)


def test_a_new_family_trains_through_run_cell_with_its_auxiliary_loss(toy):
    with_aux = _run(_cell("vit_b16.train", toy, TRAIN, TRAIN_LIMITS))
    assert with_aux["correct"], with_aux["compared"]
    plain = dict(toy)
    del plain["aux_loss_weight"]
    without = _run(_cell("vit_b16.train", plain, TRAIN, TRAIN_LIMITS))
    assert without["correct"], without["compared"]
    got, want = with_aux["info"], without["info"]
    # the same weights and batches: the first loss differs by the weighted
    # load-balancing term (near 1 for a router that spreads its tokens),
    # on the program's side and the reference's alike
    added = got["losses"][0] - want["losses"][0]
    assert 0.005 < added < 0.05, added
    assert got["ref_losses"][0] - want["ref_losses"][0] == pytest.approx(
        added, rel=0.02)
    # a gap as large as the term would fail the cell's loss limit
    assert added / want["ref_losses"][0] > 3 * TRAIN_LIMITS["loss_gap"]


def test_a_new_family_featurizes_through_run_cell(toy):
    r = _run(_cell("resnet50.featurize", toy, FEATURIZE, {"row_rel_err": 1e-4}))
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_a_banked_weight_is_drawn_by_the_fan_in_its_spec_states(toy):
    params = weights.make(toy, 7, CPU)
    for name, fan in (("block1.mlp.experts_up", toy["hidden_size"]),
                      ("block1.mlp.experts_down", toy["expert_hidden"])):
        assert params[name].std() == pytest.approx(math.sqrt(1 / fan), rel=0.05)
    assert set(params) == {s[0] for s in _toy_specs(toy)}


def test_the_reference_takes_a_batch_whole_when_the_aux_loss_is_weighed(toy):
    params = weights.make(toy, 5, CPU)
    u8 = torch.randint(0, 256, (8, 16, 16, 3), dtype=torch.uint8).numpy()
    batches = [(u8, list(range(8)))]
    args = (0.01, 0.9, (127.5,) * 3, (127.5,) * 3, CPU)
    whole = train_steps(toy, params, batches, *args)
    assert train_steps(toy, params, batches, *args, chunk=8) == whole
    with pytest.raises(CellError, match="whole batch"):
        train_steps(toy, params, batches, *args, chunk=4)


def test_the_family_count_is_found_by_name(toy):
    from torch.utils.flop_counter import FlopCounterMode
    assert flops.forward(toy) == _toy_count(toy, toy["image_size"])
    assert flops.train_step(toy, 8) == 3 * 8 * flops.forward(toy)
    # no token is dropped at this capacity: the counter over the reference
    # sees every routed matmul the count holds
    params = {k: torch.from_numpy(v) for k, v in weights.make(toy, 1, CPU).items()}
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        _toy_forward(params, torch.rand(2, 16, 16, 3), toy)
    assert counter.get_total_flops() == 2 * flops.forward(toy)


def test_an_unknown_family_names_the_missing_file(toy):
    cfg = dict(toy, family="nonesuch")
    with pytest.raises(CellError, match="cardbench/reference/nonesuch.py"):
        module_for(cfg)
    with pytest.raises(CellError, match="cardbench/counts/nonesuch.py"):
        flops.forward(cfg)
    with pytest.raises(CellError, match="cardbench/reference/nonesuch.py"):
        _run(_cell("vit_b16.train", cfg, TRAIN, TRAIN_LIMITS))


# -- the families already in the benchmark ---------------------------------

@pytest.mark.parametrize("config", [c["name"] for c in benchmark()["configs"]])
def test_every_configuration_names_a_family_with_both_files(config):
    entry = [c for c in benchmark()["configs"] if c["name"] == config][0]
    with open(HERE.parent / entry["file"]) as f:
        cfg = json.load(f)
    family = cfg["family"]
    assert (HERE / "reference" / f"{family}.py").exists()
    assert (HERE / "counts" / f"{family}.py").exists()
    assert module_for(cfg).__name__ == f"cardbench.reference.{family}"


def _make_three_element(cfg, seed, device):
    """``weights.make`` as it drew before specs could state a fan-in."""
    import numpy as np
    specs = module_for(cfg).param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    offset = 0
    for _, shape, kind in specs:
        n = math.prod(shape)
        leaf = flat[offset:offset + n]
        if kind == "fan_in":
            leaf.mul_(math.sqrt(1.0 / math.prod(shape[1:])))
        elif kind == "scale":
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(0.02)
        offset += n
    host = flat.cpu().numpy()
    out, offset = {}, 0
    for name, shape, _ in specs:
        n = math.prod(shape)
        out[name] = np.array(host[offset:offset + n].reshape(shape))
        offset += n
    return out


@pytest.mark.parametrize("cell,flop", [("resnet50.featurize", 8_178_368_512),
                                       ("vit_b16.train", 35_127_656_448)])
def test_the_existing_families_draw_and_count_as_before(cell, flop):
    cfg = Cell(cell).cfg
    assert flops.forward(cfg) == flop
    assert flops.train_step(cfg, 128) == 3 * 128 * flop
    before = _make_three_element(cfg, 7, CPU)
    now = weights.make(cfg, 7, CPU)
    assert list(now) == list(before)
    for name, leaf in before.items():
        assert now[name].tobytes() == leaf.tobytes(), name
