"""V-MoE (``models/zoo/vit.py::vmoe_*``, ``models/zoo/moe.py`` under
``router="vmoe"``) and the index dispatch (``ops/moe.py``).

On the CPU, at a small size (hidden 64, 4 blocks, 8 experts, top 2, 32²
images, patch 8), with seeded random weights from ``cardbench/weights.py``:
the port's model against the benchmark's plain reference
(``cardbench/reference/vmoe.py``); the index dispatch against the one-hot
einsum route on the LM's settings; the seeded router noise; a planted
fault the comparison must reject; the V-MoE bank's initial draw; the
trainer's device counters and the hot spans.

This file imports no JAX, so the tests marked ``cuda`` run on a card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_vmoe.py

and skip without one (the CUDA kernels have no CPU mode): one ``vmoe_b16``
training step under ``torch.cuda.set_sync_debug_mode("error")``, and each
kernel against its plain-torch version at vmoe_b16.train's shapes.
"""
import math

import pytest
import torch
import torch.nn.functional as F

from cardbench import weights
from cardbench.counts import vmoe as vmoe_counts
from cardbench.reference import vmoe as ref
from mmlspark_tpu_torch import kernels
from mmlspark_tpu_torch.models.zoo import build_model, init_state
from mmlspark_tpu_torch.models.zoo.moe import MoeMlp, moe_aux_loss
from mmlspark_tpu_torch.ops import moe as moe_ops

CPU = torch.device("cpu")
TINY = dict(name="vmoe_tiny", family="vmoe", architecture="vmoe_tiny",
            patch_size=8, hidden_size=64, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=256, image_size=32,
            in_channels=3, num_classes=10, layer_norm_eps=1e-6,
            num_experts=8, experts_per_token=2, moe_layers=[1, 3],
            capacity_factor=1.05, router_noise_std=1.0,
            router_noise_seed=11, aux_loss_weight=0.01)
ARGS = dict(num_classes=10, image_size=32, patch=8, dim=64, depth=4, heads=4,
            num_experts=8, top_k=2, moe_layers=(1, 3), capacity_factor=1.05,
            noise_std=1.0, noise_seed=11)

# fp32 on both sides, the same routing, sums in another order (the index
# route's gather and batched matmuls against the reference's per-expert
# loop and index_add): a few fp32 ulps of the largest value of each leaf,
# grown through 4 blocks and the backward
RTOL = 2e-5


def _model(cfg=TINY, seed=3, **overrides):
    params = weights.make(cfg, seed, CPU)
    module = build_model("vmoe_tiny", **dict(ARGS, **overrides))["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                           strict=True)
    return module.train(), {k: torch.from_numpy(v).requires_grad_(True)
                            for k, v in params.items()}


def _images(n=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 32, 32, 3, generator=g) * 2 - 1


def _loss(logits, aux, labels):
    return F.cross_entropy(logits.float(), labels) \
        + TINY["aux_loss_weight"] * aux


def _close(got, want, rtol=RTOL):
    """Max |got - want| within ``rtol`` of max |want| (a leaf's scale)."""
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) <= rtol * scale


def _both(module, params, x, labels):
    record = {}
    for m in module.modules():
        if isinstance(m, MoeMlp):
            m.record_routing = True
    logits = module(x)
    aux = moe_aux_loss(module)
    r_logits, r_pool, r_aux = ref.forward(params, x, TINY, record=record)
    _loss(logits, aux, labels).backward()
    _loss(r_logits, r_aux, labels).backward()
    return logits, aux, r_logits, r_aux, record


def test_the_model_matches_the_reference_forward_and_gradients():
    module, params = _model()
    x, labels = _images(), torch.arange(8) % 10
    logits, aux, r_logits, r_aux, record = _both(module, params, x, labels)
    # the routing is the reference's, and the capacity drops pairs here
    for block in TINY["moe_layers"]:
        mine = getattr(module, f"block{block}").mlp.routing
        assert torch.equal(mine["gate_idx"].long(), record[block]["gate_idx"])
        assert mine["capacity"] == record[block]["capacity"]
    assert record[1]["dropped"] > 0
    assert _close(logits, r_logits)
    pool = module.forward_with_intermediates(x)[1]["pool"]
    assert _close(pool, ref.forward(params, x, TINY)[1])
    assert abs(float(aux) - float(r_aux)) <= RTOL * float(r_aux)
    named = dict(module.named_parameters())
    assert set(named) == set(params)
    # a leaf whose reference gradient is under a thousandth of the median
    # leaf's is round-off alone (the key biases under the softmax, ~1e-9,
    # zero in exact arithmetic): both sides' must stay under that floor,
    # as the benchmark's train lane leaves them out
    scales = [float(p.grad.abs().max()) for p in params.values()]
    floor = 1e-3 * sorted(scales)[len(scales) // 2]
    for (name, p), scale in zip(params.items(), scales):
        got = named[name].grad
        if scale < floor:
            assert float(got.abs().max()) < floor, name
        else:
            assert _close(got, p.grad), name


def test_one_sgd_step_matches_the_reference():
    module, params = _model(seed=5)
    x, labels = _images(seed=1), (torch.arange(8) * 3) % 10
    _both(module, params, x, labels)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.sub_(0.01 * p.grad)
            params[name].sub_(0.01 * params[name].grad)
    got = _loss(module(x), moe_aux_loss(module), labels)
    want = _loss(*ref.forward(params, x, TINY)[::2], labels)
    assert abs(float(got) - float(want)) <= RTOL * float(want)


def test_second_choices_left_out_are_rejected(monkeypatch):
    """A planted fault: every second choice dropped before the experts."""
    plan = moe_ops.index_plan

    def first_choices_only(gate_idx, num_experts, capacity):
        p = plan(gate_idx, num_experts, capacity)
        slots = p.pair_slot.clone()
        slots[gate_idx.shape[0]:] = -1
        return p._replace(pair_slot=slots)
    monkeypatch.setattr(moe_ops, "index_plan", first_choices_only)
    module, params = _model()
    x = _images()
    with torch.no_grad():
        assert not _close(module(x), ref.forward(params, x, TINY)[0])


def test_the_seeded_noise_is_the_references_bit_for_bit():
    m = MoeMlp(16, num_experts=8, router="vmoe", noise_std=1.0,
               noise_seed=11, layer=3, dtype=torch.float32)
    logits = torch.zeros(40, 8)
    mine = (m.noise_std / m.num_experts) * m._noise(logits)
    assert torch.equal(mine, ref.noise((40, 8), TINY, 3, CPU))
    # the same draw again, and another block draws another
    assert torch.equal(mine, (m.noise_std / m.num_experts) * m._noise(logits))
    assert not torch.equal(mine, ref.noise((40, 8), TINY, 1, CPU))


def test_an_eval_forward_adds_no_noise():
    module, params = _model()
    x = _images()
    with torch.no_grad():
        got = module.eval()(x)
        want = ref.forward(params, x, TINY, train=False)[0]
    assert _close(got, want)


def _lm_moe(capacity_factor, seed=0):
    """The LM's MoeMlp (GShard rules, fp32), which routes by one-hot
    einsums, with seeded weights."""
    m = MoeMlp(16, num_experts=4, expert_hidden=32, top_k=2,
               capacity_factor=capacity_factor, dtype=torch.float32)
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in init_state(m, seed).items()})
    return m


def _index_route(m, x):
    """``m``'s function on the LM's settings (renormalised gates, the
    ceil capacity, no expert bias, fp32) through ``index_plan`` and the
    plain row moves and experts of ``ops/moe.py``."""
    B, L, D = x.shape
    S, E, K = B * L, m.num_experts, m.top_k
    xf = x.reshape(S, D)
    probs = torch.softmax(m.router(xf.float()), dim=-1)
    gates, gate_idx = torch.topk(probs, K, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    C = max(1, math.ceil(m.capacity_factor * S * K / E))
    plan = moe_ops.index_plan(gate_idx, E, C)
    xe = moe_ops.permute_plain(xf, plan.pair_slot, E * C, torch.float32)
    ye = moe_ops.experts_plain(xe.view(E, C, D), m.experts_up, None,
                               m.experts_down, None, torch.float32,
                               torch.float32)
    y = moe_ops.unpermute_plain(ye.view(E * C, D), gates, plan.pair_slot,
                                torch.float32)
    return y.view(B, L, D), plan


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_the_index_dispatch_is_the_onehot_route(capacity_factor):
    m = _lm_moe(capacity_factor)
    x = torch.randn(4, 12, 16, generator=torch.Generator().manual_seed(1))
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    onehot = m(xs[0])
    index, plan = _index_route(m, xs[1])
    assert _close(index, onehot, 1e-6)
    w = torch.randn(onehot.shape, generator=torch.Generator().manual_seed(2))
    grads = []
    for out, xi in zip((onehot, index), xs):
        m.zero_grad()
        (out * w).sum().backward()
        grads.append([xi.grad] + [p.grad.clone() for p in m.parameters()])
    names = ["x"] + [n for n, _ in m.named_parameters()]
    for name, a, b in zip(names, *grads):
        assert _close(b, a, 1e-6), name
    kept = int(plan.kept.sum())
    assert (kept < 2 * 48) == (capacity_factor < 1)
    assert kept == int((plan.pair_slot >= 0).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_index_plan_takes_the_onehot_slots(seed):
    g = torch.Generator().manual_seed(seed)
    gate_idx = torch.stack([torch.randperm(6, generator=g)[:2]
                            for _ in range(50)]).to(torch.int32)
    position, _ = MoeMlp(8, num_experts=6)._positions(gate_idx, 6)
    plan = moe_ops.index_plan(gate_idx, 6, 15)
    assert torch.equal(plan.position, position)
    slots = plan.pair_slot.view(2, 50).t()
    want = torch.where(position < 15, gate_idx * 15 + position, -1)
    assert torch.equal(slots, want)
    counts = torch.bincount(gate_idx.flatten(), minlength=6)
    assert torch.equal(plan.kept, counts.clamp(max=15).to(torch.int32))


def test_a_vmoe_bank_draws_by_each_experts_fan_in():
    module = build_model("vmoe_tiny")["module"]
    state = init_state(module, 0)
    assert float(state["block1.mlp.experts_up"].std()) == pytest.approx(
        math.sqrt(1 / 64), rel=0.05)
    assert float(state["block1.mlp.experts_down"].std()) == pytest.approx(
        math.sqrt(1 / 256), rel=0.05)
    assert "block1.mlp.router.bias" not in state
    assert not state["block1.mlp.experts_up_bias"].any()
    # the LM's bank keeps flax's fan-in of the whole array
    lm = MoeMlp(16, num_experts=4, expert_hidden=32)
    lm_state = init_state(lm, 0)
    assert float(lm_state["experts_up"].std()) == pytest.approx(
        math.sqrt(1 / (4 * 16)), rel=0.05)


def test_the_trainer_reads_the_routing_counters_in_its_flush():
    from mmlspark_tpu_torch.observability import metrics as obsmetrics
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    from mmlspark_tpu_torch.utils import config
    config.set("runtime.device", "cpu")
    try:
        module, _ = _model()

        def loss_fn(m, b, g):
            return _loss(m(b["image"]), moe_aux_loss(m), b["label"])
        trainer = DistributedTrainer(loss_fn, sgd(0.01, momentum=0.9))
        state = trainer.init(lambda: module)
        before = {n: obsmetrics.counter(n).value
                  for n in ("moe.routed", "moe.dropped",
                            "moe.routed.block1.mlp")}
        batch = {"image": _images(), "label": torch.arange(8) % 10}
        for _ in range(2):
            state, _ = trainer.train_step(state, batch)
        syncs_before = syncs.total()
        flushed = trainer.flush_metrics()
        assert syncs.total() - syncs_before == 1
        assert set(flushed) == {"loss", "step"}
        pairs = 2 * 2 * 8 * 17 * 2    # 2 steps, 2 blocks, 8 x 17 tokens, K 2
        routed = obsmetrics.counter("moe.routed").value - before["moe.routed"]
        dropped = obsmetrics.counter("moe.dropped").value \
            - before["moe.dropped"]
        assert routed + dropped == pairs and dropped > 0
        assert obsmetrics.counter("moe.routed.block1.mlp").value \
            - before["moe.routed.block1.mlp"] > 0
        assert not module.block1.mlp.routed_pairs.any()
    finally:
        config.set("runtime.device", "cuda")


def test_a_routed_forward_opens_the_moe_spans():
    from mmlspark_tpu_torch.observability import spans
    module, _ = _model()
    spans.collect_start()
    try:
        with torch.no_grad():
            module(_images(2))
    finally:
        got, _ = spans.collect_stop()
    names = [s["name"] for s in got]
    for stage in ("route", "permute", "experts", "unpermute"):
        assert names.count(f"moe:{stage}") == 2, stage


def test_the_count_is_the_references_flops_and_the_b16_numbers():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dict(TINY, capacity_factor=4.0)   # nothing dropped
    params = {k: torch.from_numpy(v) for k, v in weights.make(cfg, 1, CPU).items()}
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(params, _images(2), cfg)
    assert counter.get_total_flops() == 2 * vmoe_counts.forward(cfg, 32)
    b16 = dict(TINY, patch_size=16, hidden_size=768, num_hidden_layers=12,
               intermediate_size=3072, image_size=224, num_classes=1000,
               num_experts=32, moe_layers=[1, 3, 5, 7, 9, 11])
    assert vmoe_counts.forward(b16, 224) == 46_340_505_600
    assert vmoe_counts.expert_gemm_flops(b16, 128) == 8_566_849_142_784
    spec = build_model("vmoe_b16")["module"]
    assert sum(p.numel() for p in spec.parameters()) == 965_087_464
    assert {s[0]: s[1] for s in ref.param_specs(b16)} == {
        k: tuple(v.shape) for k, v in spec.state_dict().items()}


def test_the_benchmark_cell_runs_a_small_vmoe_through_the_train_lane():
    """``vmoe_b16.train``'s lane, files and limits on the CPU at the small
    size: the program's three steps against the reference's."""
    import time

    from cardbench.harness import Cell, Context, lane_module
    from mmlspark_tpu_torch.utils import config
    cell = Cell("vmoe_b16.train")
    cell.cfg = dict(TINY, arch_args=ARGS)
    cell.traffic = dict(cell.traffic, epoch_images=64, batch=8, warm_steps=1)
    config.set("runtime.device", "cpu")
    try:
        # the lane itself: run_cell refuses a process that loaded JAX, as
        # this suite's conftest does
        ctx = Context(cell, 2**31 + 7, 0.5, False, CPU, time.perf_counter())
        r = lane_module(cell.traffic).run(ctx)
    finally:
        config.set("runtime.device", "cuda")
    # K1 hands the program bf16 inputs and the reference fp32 ones: at 136
    # tokens a layer one flipped top-2 choice moves the loss by ~1e-3, so
    # the small model is held to the readings' scale, not the cell's limits
    assert all(0 <= v < 0.01 for v, _ in r["compared"].values()), \
        r["compared"]
    assert r["attempted"] > 0 and r["info"]["losses"][0] > 0


def test_the_cuda_route_refuses_what_its_kernels_do_not_take():
    plan = moe_ops.index_plan(torch.zeros(4, 2, dtype=torch.int32), 2, 4)
    # on the CPU every dtype takes the plain version
    assert moe_ops.permute(torch.zeros(4, 8), plan, 2,
                           torch.float32).shape == (8, 8)

    class OnCard:
        device = torch.device("cuda", 0)
    assert moe_ops._kernel_route(OnCard(), torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        moe_ops._kernel_route(OnCard(), torch.float32)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _moe_launches():
    return {k.name: k.launches for k in kernels.KERNELS
            if k.name.startswith("moe_")}


@pytest.mark.cuda
def test_each_kernel_matches_its_plain_version_on_the_card(card):
    # vmoe_b16.train's shapes: 128 images of 197 tokens
    g = torch.Generator(device=card).manual_seed(0)
    E, K, S, D, H = 32, 2, 128 * 197, 768, 3072
    C = round(K * S * 1.05 / E)
    x = torch.randn(S, D, generator=g, device=card, requires_grad=True)
    logits = torch.randn(S, E, generator=g, device=card)
    gates, gate_idx = torch.topk(torch.softmax(logits, -1), K, dim=-1)
    gates.requires_grad_(True)
    plan = moe_ops.index_plan(gate_idx, E, C)
    w_up = (torch.randn(E, D, H, generator=g, device=card) / D ** 0.5)
    w_down = (torch.randn(E, H, D, generator=g, device=card) / H ** 0.5)
    b_up = 0.02 * torch.randn(E, H, generator=g, device=card)
    b_down = 0.02 * torch.randn(E, D, generator=g, device=card)
    leaves = [w_up, b_up, w_down, b_down]
    for t in leaves:
        t.requires_grad_(True)
    bf16 = torch.bfloat16
    dy = torch.randn(S, D, generator=g, device=card).to(bf16)
    grads = []
    before = _moe_launches()
    for route in ("kernel", "plain"):
        if route == "kernel":
            xe = moe_ops.permute(x, plan, E, bf16)
            ye = moe_ops.experts(xe.view(E, C, D), *leaves, bf16, bf16)
            y = moe_ops.unpermute(ye.view(E * C, D), gates, plan, bf16)
        else:
            xe = moe_ops.permute_plain(x, plan.pair_slot, E * C, bf16)
            ye = moe_ops.experts_plain(xe.view(E, C, D), *leaves, bf16, bf16)
            y = moe_ops.unpermute_plain(ye.view(E * C, D), gates,
                                        plan.pair_slot, bf16)
        y.backward(dy)
        grads.append([y.detach()] + [t.grad.clone() for t in [x, gates]
                                     + leaves])
        for t in [x, gates] + leaves:
            t.grad = None
    torch.cuda.synchronize()
    # bf16 storage of the pre-activation, activation and output on both
    # routes, fp32 sums in another order: an output or gradient may round
    # to the neighbouring bf16 value (2^-8 relative); the gradients also
    # round d_h to bf16 on the plain route alone. A wrong tile, slot or
    # operand layout reads O(1).
    names = ["y", "x", "gates", "w_up", "b_up", "w_down", "b_down"]
    for name, got, want in zip(names, *grads):
        assert _rel(got, want) < 2e-2, (name, _rel(got, want))
    made = {n: c - before[n] for n, c in _moe_launches().items()}
    # a gather, an expert pass and a combine, and their backward: up, down,
    # d_pre, d_x and two weight gradients; two bias gradients
    assert made == {"moe_grouped_gemm": 6, "moe_permute": 1,
                    "moe_unpermute": 2, "moe_unpermute_bwd": 1,
                    "moe_bias_grad": 2}


@pytest.mark.cuda
def test_a_vmoe_b16_train_step_makes_no_host_read(card):
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    from mmlspark_tpu_torch.utils import config
    config.set("runtime.device", "cuda")
    module = build_model("vmoe_b16", noise_seed=1)["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            init_state(module, 0).items()})

    def loss_fn(m, b, gen):
        return F.cross_entropy(m(b["image"]).float(), b["label"]) \
            + 0.01 * moe_aux_loss(m)
    trainer = DistributedTrainer(loss_fn, sgd(0.01, momentum=0.9))
    state = trainer.init(lambda: module)
    batch = {"image": torch.randn(32, 224, 224, 3, device=card),
             "label": torch.arange(32, device=card) % 1000}
    state, _ = trainer.train_step(state, batch)     # builds the kernels
    torch.cuda.synchronize()
    before = _moe_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = trainer.train_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]).item()
    made = {n: c - before[n] for n, c in _moe_launches().items()}
    # 6 routed blocks, each as in the test above
    assert made == {"moe_grouped_gemm": 36, "moe_permute": 6,
                    "moe_unpermute": 12, "moe_unpermute_bwd": 6,
                    "moe_bias_grad": 12}
