"""The streamed, checkpointed ResNet-20 run survives a SIGKILL on a card.

This file imports no JAX, so its test, marked ``cuda``, runs on a card's
machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stream_resume_card.py

Here, without a card, it skips. ``chip_smoke.py``'s three children at 12
steps: A trains ResNet-20 (bf16, sgd with momentum, K1 in the loss) over
512 PNG files streamed through ``FileSource -> shuffle -> decode -> map ->
batch -> repeat`` with a checkpoint every 5 steps; B is SIGKILLed once it
reports step 7; C restores B's directory and finishes. C's final module,
optimizer state, count and step must EQUAL A's (deterministic mode), C
must resume from B's newest committed step and its mid-epoch snapshot,
and K1 must launch once a step in each child.
"""
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda", 0)


def test_sigkilled_streamed_run_resumes_bit_equal(card, tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke
    from mmlspark_tpu_torch import kernels
    kernels.build_all([kernels.FUSED_NORMALIZE])
    spec = chip_smoke._stream_spec(str(tmp_path), deep=False, files=512,
                                   steps=12, save_every=5, kill_at=7)
    chip_smoke._write_corpus(spec)
    out = chip_smoke._stream_children(torch, kernels, spec, str(tmp_path))
    assert out["state_bit_equal"]
    assert out["A"]["launches"]["fused_normalize"] == 12
    assert out["C"]["start"] >= 5
    assert out["C"]["launches"]["fused_normalize"] == 12 - out["C"]["start"]
    assert out["B"]["k1"] == out["B"]["killed_at"] >= 7
