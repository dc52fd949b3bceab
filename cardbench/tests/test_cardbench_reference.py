"""The plain reference against the port's CPU path on the same weights, at
small image sizes, in float32."""
import pytest
import torch

from cardbench import weights
from cardbench.harness import Cell
from cardbench.reference import module_for
from cardbench.reference.preprocess import crop_resize_normalize, normalize

CPU = torch.device("cpu")


def _port_module(cfg, size):
    from mmlspark_tpu_torch.models.zoo import build_model
    args = dict(cfg["arch_args"], dtype=torch.float32)
    if "image_size" in args:
        args["image_size"] = size
    return build_model(cfg["architecture"], **args)["module"].eval()


@pytest.mark.parametrize("cell,size", [("resnet50.featurize", 64),
                                       ("vit_b16.train", 32)])
def test_reference_matches_the_port_on_the_same_weights(cell, size):
    cfg = dict(Cell(cell).cfg, image_size=size)
    params = weights.make(cfg, 3, CPU)
    module = _port_module(cfg, size)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                           strict=True)
    x = torch.rand(3, size, size, 3) * 4 - 2
    with torch.no_grad():
        logits, inter = module.forward_with_intermediates(x)
        want_logits, want_pool = module_for(cfg).forward(
            {k: torch.from_numpy(v) for k, v in params.items()}, x, cfg)
    assert torch.allclose(inter["pool"].float(), want_pool, rtol=1e-4, atol=1e-4)
    assert torch.allclose(logits.float(), want_logits, rtol=1e-4, atol=1e-4)


def test_reference_shapes_are_the_port_state_dict():
    for cell in ("resnet50.featurize", "vit_b16.train"):
        cfg = Cell(cell).cfg
        port = _port_module(cfg, cfg["image_size"]).state_dict()
        ref = {n: tuple(s) for n, s, *_ in module_for(cfg).param_specs(cfg)}
        assert ref == {k: tuple(v.shape) for k, v in port.items()}


def test_preprocess_matches_the_port_plain_versions():
    from mmlspark_tpu_torch.ops.preprocess import (
        CropResizePlan, _crop_resize_normalize_plain, _fused_normalize_plain,
        _inv_std,
    )
    u8 = torch.randint(0, 256, (2, 256, 256, 3), dtype=torch.uint8)
    plan = CropResizePlan((256, 256, 3), resize=(224, 224))
    assert torch.equal(crop_resize_normalize(u8, (224, 224)),
                       _crop_resize_normalize_plain(u8, plan))
    crop = CropResizePlan((256, 256, 3), resize=(224, 224), crop=(240, 200),
                          mean=(1.0, 2.0, 3.0), std=(2.0, 4.0, 8.0))
    assert torch.allclose(
        crop_resize_normalize(u8, (224, 224), (240, 200), (1.0, 2.0, 3.0),
                              (2.0, 4.0, 8.0)),
        _crop_resize_normalize_plain(u8, crop), rtol=0, atol=1e-5)
    mean = (127.5, 127.5, 127.5)
    m = torch.tensor(mean)
    istd = torch.from_numpy(_inv_std(mean))
    assert torch.equal(normalize(u8, mean, mean),
                       _fused_normalize_plain(u8, m, istd, torch.float32))


def test_fp8_operands_round_to_e4m3_under_one_scale():
    from cardbench.reference.precision import operand
    t = torch.linspace(-3, 3, 1001, requires_grad=True)
    q = operand(t, "fp8")
    assert torch.equal(operand(t, "fp32"), t)
    assert 0 < (q - t).abs().max() < 0.1 * 3
    assert len(torch.unique(q.detach())) < 256
    q.sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))
