"""One worker process of the port's process fleet on a card.

This file imports no JAX, so its test, marked ``cuda``, runs on a card's
machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_process_fleet_card.py

Here, without a card, it skips. A ``python -m mmlspark_tpu_torch.cli
serve`` worker, spawned by ``ProcessSpawner`` and supervised by
``Supervisor``, serves ``transformer_lm`` at the zoo's width cut to depth 2
in fp32; its greedy tokens for prompts of 520-900 ids (K3's CUDA-core
route in the prefill) must EQUAL an in-process ``Server``'s with TF32 off,
and the K3 launches its drain reports must equal what its own programs'
replays and captures imply.
"""
import json
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.serve import ProcessSpawner, Server, Supervisor
from mmlspark_tpu_torch.utils import config as tconfig

pytestmark = pytest.mark.cuda

_GEN = {"generate.max_seq_len": 1024, "generate.max_sequences": 4,
        "generate.kv_block_tokens": 16}
_LM32 = {"seed": 0, "dtype": "float32", "depth": 2}


class _RecordingSpawner(ProcessSpawner):
    """Keeps every worker it spawns, so the test can reap them all."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.workers = []

    def spawn(self, name):
        self.workers.append(super().spawn(name))
        return self.workers[-1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tconfig.set("runtime.device", "cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k, v in _GEN.items():
        tconfig.set(k, v)
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    for k in list(_GEN) + ["runtime.device"]:
        tconfig.unset(k)


def test_worker_tokens_equal_one_server_and_its_launches_add_up(card,
                                                                 tmp_path):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 32000, n).tolist() for n in (520, 700, 900)]
    srv = Server({"lm32": TorchModel().set_model("transformer_lm",
                                                 **_LM32)})
    try:
        want = [srv.generate("lm32", p, max_new_tokens=16,
                             timeout=300)["tokens"] for p in prompts]
    finally:
        srv.close()
    env = {"MMLSPARK_TPU_TORCH_" + k.replace(".", "_").upper(): str(v)
           for k, v in _GEN.items()}
    spawner = _RecordingSpawner(
        ["lm32=transformer_lm:" + json.dumps(_LM32)],
        events_dir=str(tmp_path), env=env)
    workers = spawner.workers
    sup = Supervisor(spawner, ["w0"], ready_timeout_s=180.0)
    try:
        sup.start()
        assert sup.stats()["live_replicas"] == 1
        rep = sup.replica("w0")
        got = [rep.submit_generate("lm32", p, 16)["tokens"]
               for p in prompts]
        pid = sup.pid("w0")
        sup.shutdown(drain_timeout_s=60.0)
    finally:
        sup.shutdown()
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait(10.0)
    assert got == want
    assert workers and all(w.poll() == 0 for w in workers)
    events = [json.loads(line) for line in
              open(os.path.join(str(tmp_path), f"events-{pid}.jsonl"))]
    (summary,) = [e for e in events
                  if e["type"] == "serving" and e["name"] == "summary"]
    report = summary["device"]
    assert report["tf32_matmul"] is False
    assert report["memory_bytes"]["reserved"] > 0
    implied = sum(p["launches"].get("flash_attention", 0)
                  * (p["replays"] + (1 if p["graph"] else 0))
                  for p in report["programs"])
    assert implied > 0
    assert report["launches"]["flash_attention"] == implied
    assert report["launches"]["flash_attention_tc"] == 0
