"""The benchmark's FLOP and byte counts against ``FlopCounterMode`` on the
plain reference, the published sizes, and the readers over a record."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cardbench import weights
from cardbench.counts import flops, kernel_bytes, peaks
from cardbench.harness import Cell, reader
from cardbench.reference import module_for


@pytest.mark.parametrize("cell,size", [("resnet50.featurize", 64),
                                       ("vit_b16.train", 32)])
def test_forward_flops_match_the_flop_counter(cell, size):
    cfg = dict(Cell(cell).cfg, image_size=size)
    params = {k: torch.from_numpy(v) for k, v in
              weights.make(cfg, 1, torch.device("cpu")).items()}
    x = torch.rand(2, size, size, 3)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        module_for(cfg).forward(params, x, cfg)
    assert counter.get_total_flops() == 2 * flops.forward(cfg, size)


def test_published_sizes():
    vit = Cell("vit_b16.train").cfg
    assert abs(flops.forward(vit) / 1e9 - 35.1) <= 0.2
    assert flops.train_step(vit, 128) == 3 * 128 * flops.forward(vit)
    assert abs(flops.forward(Cell("resnet50.featurize").cfg) / 1e9 - 8.18) < 0.01
    assert abs(kernel_bytes.k2(128, (256, 256, 3), (224, 224)) / 1e6 - 63.7) < 0.05
    assert abs(kernel_bytes.k1(128, (224, 224, 3)) / 1e6 - 57.8) < 0.05


def _record(ops, lane, window=1.0, busy=0.5):
    return {"window_s": window, "busy_s": [busy], "ops": ops, "spans": [],
            "lane": lane, "cfg": Cell("resnet50.featurize").cfg,
            "traffic": {}, "chips": 1}


def test_k2_roofline_reads_bytes_at_the_hbm_peak_over_kernel_time():
    nbytes = kernel_bytes.k2(128, (256, 256, 3), (224, 224))
    secs = 2 * nbytes / peaks.HBM_BYTES_PER_S / 0.5  # two launches at 50%
    ops = [("void crop_resize_normalize_kernel<1>", 0, 0.0, secs / 2)] * 2 + \
          [("crop_resize_normalize_empty_kernel", 0, 0.0, 1.0)]
    lane = {"batch": 128, "src": [256, 256, 3], "out_bytes": 2}
    assert np.isclose(reader("k2_roofline.featurize")(_record(ops, lane)), 50.0)
    served = dict(lane, replays={128: 2})
    assert np.isclose(reader("k2_roofline.serve")(_record(ops, served)), 50.0)


def test_readers_return_nothing_when_nothing_was_traced():
    lane = {"batch": 128, "src": [256, 256, 3], "out_bytes": 2,
            "image": [224, 224, 3], "images": 0, "train": False}
    rec = _record([], lane, busy=0.0)
    for name in ("k2_roofline.featurize", "k1_roofline.train", "mfu.train",
                 "copy_ms.featurize", "idle_share.train",
                 "queue_ms_mean.serve", "occupancy.serve"):
        assert reader(name)(rec) is None, name


def test_mfu_and_idle_share():
    cfg = Cell("resnet50.featurize").cfg
    lane = {"images": 1000, "train": False}
    rec = _record([], lane, window=2.0, busy=1.5)
    want = 100 * flops.forward(cfg) * 1000 / (2.0 * peaks.BF16_FLOPS)
    assert np.isclose(reader("mfu.featurize")(rec), want)
    assert np.isclose(reader("mfu.serve")(dict(rec, lane=dict(lane, over_busy=True))),
                      want * 2.0 / 1.5)
    assert np.isclose(reader("idle_share.featurize")(rec), 25.0)
