"""The port's TrainCheckpointer and ResilientTrainLoop, on the CPU.

Checkpoint round trips, the async save against the in-place step, resume
equal to an uninterrupted run bit for bit, the reference's crash
scenarios (``tests/test_data.py`` and ``tests/test_reliability.py``) on
the port, and the port's final parameters after ``run_dataset`` against
the JAX package's ``ResilientTrainLoop`` on a one-device mesh, from the
same init (rtol 1e-5, norm-wise: optax's adam bias correction is fp32,
ROADMAP §C).
"""
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.data import FileSource as JFileSource
from mmlspark_tpu.parallel.checkpoint import (
    TrainCheckpointer as JTrainCheckpointer,
)
from mmlspark_tpu.parallel.mesh import data_parallel_mesh
from mmlspark_tpu.parallel.trainer import (
    DistributedTrainer as JDistributedTrainer,
)
from mmlspark_tpu.reliability.resilient import (
    ResilientTrainLoop as JResilientTrainLoop,
)
from mmlspark_tpu_torch.data import FileSource
from mmlspark_tpu_torch.observability import events as tevents
from mmlspark_tpu_torch.parallel import checkpoint as tcheckpoint
from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
from mmlspark_tpu_torch.parallel.optim import adam, lamb
from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
from mmlspark_tpu_torch.reliability.faults import (
    FaultPlan, FaultSpec, InjectedFault,
)
from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop
from mmlspark_tpu_torch.utils import config as tconfig

DIM = 8
TIME_LIMIT_S = 120


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test of this file fails after TIME_LIMIT_S seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TIME_LIMIT_S} s limit")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


class Linear(torch.nn.Module):
    """``x @ w + b``, the reference tests' model, with their init."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((DIM, DIM), 0.1))
        self.b = torch.nn.Parameter(torch.zeros(DIM))

    def forward(self, x):
        return x @ self.w + self.b


def _loss(module, batch, gen):
    pred = module(batch["x"])
    return ((pred - batch["y"]) ** 2).mean()


def _noisy_loss(module, batch, gen):
    """A loss that draws from the step's generator (dropout-like)."""
    keep = (torch.rand(batch["x"].shape, generator=gen) > 0.25).float()
    pred = module(batch["x"] * keep)
    return ((pred - batch["y"]) ** 2).mean()


def _trainer(loss=_loss, opt=None):
    return DistributedTrainer(loss, opt or adam(1e-2))


def _batch(i):
    rng = np.random.default_rng(i)
    x = rng.normal(0, 1, (16, DIM)).astype(np.float32)
    return {"x": x, "y": (x * 0.5).astype(np.float32)}


def _run_steps(trainer, state, start, n, rng=0):
    for i in range(start, start + n):
        state, _ = trainer.train_step(state, trainer.put_batch(_batch(i)),
                                      rng)
    return state


def _state_of(state):
    """Everything a checkpoint must carry, copied to the host."""
    opt = state["optimizer"]
    return {"module": {k: v.clone() for k, v in
                       state["module"].state_dict().items()},
            "optimizer": json.dumps(_plain(opt.torch.state_dict()),
                                    sort_keys=True),
            "count": opt.count, "step": int(state["step"]),
            "gens": {k: g.get_state().clone()
                     for k, g in state["generators"].items()}}


def _plain(obj):
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _assert_same(a, b):
    a, b = _state_of(a), _state_of(b)
    assert a["module"].keys() == b["module"].keys()
    for k in a["module"]:
        assert torch.equal(a["module"][k], b["module"][k]), k
    assert a["optimizer"] == b["optimizer"]
    assert (a["count"], a["step"]) == (b["count"], b["step"])
    assert a["gens"].keys() == b["gens"].keys()
    for k in a["gens"]:
        assert torch.equal(a["gens"][k], b["gens"][k])


# -- the checkpointer ---------------------------------------------------------

def test_save_restore_round_trip(tmp_path):
    trainer = _trainer(_noisy_loss)
    state = _run_steps(trainer, trainer.init(Linear), 0, 3)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    assert ckpt.save(state, wait=True) == 3
    assert ckpt.latest_step() == 3 and ckpt.all_steps() == [3]
    assert os.listdir(os.path.join(ckpt.directory, "3")) == ["state.pt"]
    restored = ckpt.restore(_trainer(_noisy_loss), Linear)
    _assert_same(state, restored)
    ckpt.close()


def test_async_save_survives_the_next_in_place_step(tmp_path, monkeypatch):
    """The write is held back until a step has updated the module, the
    optimizer and the step counter in place: the checkpoint still holds
    the state from before that step (``save`` copied it to the host before
    returning)."""
    release = threading.Event()
    real_save = tcheckpoint.torch.save

    def held_save(obj, f):
        assert release.wait(30)
        real_save(obj, f)
    monkeypatch.setattr(tcheckpoint.torch, "save", held_save)
    trainer = _trainer()
    state = _run_steps(trainer, trainer.init(Linear), 0, 2)
    before = _state_of(state)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    ckpt.save(state)                      # async: the write waits
    state = _run_steps(trainer, state, 2, 1)
    assert int(state["step"]) == 3
    assert ckpt.all_steps() == []         # not committed, not listed
    release.set()
    ckpt.wait()
    restored = _state_of(ckpt.restore(_trainer(), Linear))
    for k in before["module"]:
        assert torch.equal(restored["module"][k], before["module"][k])
    assert restored["optimizer"] == before["optimizer"]
    assert (restored["count"], restored["step"]) == (2, 2)
    ckpt.close()


@pytest.mark.parametrize("loss", [_loss, _noisy_loss],
                         ids=["plain", "generator_drawing"])
def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path, loss):
    """5 steps, against 3 + save + a fresh trainer restoring + 2: equal bit
    for bit, a generator-drawing loss too (its generator state rides the
    checkpoint)."""
    t_full = _trainer(loss)
    full = _run_steps(t_full, t_full.init(Linear), 0, 5)
    t_a = _trainer(loss)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    ckpt.save(_run_steps(t_a, t_a.init(Linear), 0, 3), wait=True)
    t_b = _trainer(loss)
    state, resumed = TrainCheckpointer(str(tmp_path / "ck")).restore_or_init(
        t_b, Linear)
    assert resumed and int(state["step"]) == 3
    _assert_same(full, _run_steps(t_b, state, 3, 2))
    ckpt.close()


def test_lamb_keeps_its_own_count_across_a_restore(tmp_path):
    trainer = _trainer(opt=lamb(1e-2))
    state = _run_steps(trainer, trainer.init(Linear), 0, 3)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    ckpt.save(state, wait=True)
    t2 = _trainer(opt=lamb(1e-2))
    restored = ckpt.restore(t2, Linear)
    assert restored["optimizer"].torch.count == 3
    _assert_same(_run_steps(trainer, state, 3, 2),
                 _run_steps(t2, restored, 3, 2))
    ckpt.close()


def test_restore_or_init_fresh_and_missing_checkpoint(tmp_path):
    trainer = _trainer()
    state, resumed = TrainCheckpointer(str(tmp_path / "ck")).restore_or_init(
        trainer, Linear)
    assert not resumed and int(state["step"]) == 0
    _run_steps(trainer, state, 0, 1)
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(str(tmp_path / "empty")).restore(trainer, Linear)


def test_maybe_save_interval_and_retention(tmp_path):
    trainer = _trainer()
    state = trainer.init(Linear)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    for i in range(6):
        state, _ = trainer.train_step(state, trainer.put_batch(_batch(i)))
        ckpt.maybe_save(state, every=2, step=i + 1, wait=True)
    assert ckpt.latest_step() == 6
    assert ckpt.all_steps() == [4, 6]     # max_to_keep=2 pruned step 2
    ckpt.close()


def test_stale_step_and_torn_write_are_cleared(tmp_path):
    """A ``<step>.tmp-<pid>`` of a dead process is swept at start and never
    listed; a stale ``<step>/`` is replaced by the new save of that step."""
    d = tmp_path / "ck"
    (d / "7.tmp-999999999").mkdir(parents=True)
    (d / "5").mkdir()
    (d / "5" / "state.pt").write_bytes(b"left by a dead run")
    ckpt = TrainCheckpointer(str(d))
    assert not (d / "7.tmp-999999999").exists()
    assert ckpt.all_steps() == [5]
    trainer = _trainer()
    state = _run_steps(trainer, trainer.init(Linear), 0, 5)
    ckpt.save(state, step=5, wait=True)
    _assert_same(state, ckpt.restore(_trainer(), Linear))
    ckpt.close()


def test_meta_sidecar_round_trip(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    assert ckpt.get_meta() == {}
    ckpt.put_meta(batch_order="cached")
    ckpt.put_meta(extra=1)
    assert TrainCheckpointer(str(tmp_path / "ck")).get_meta() == {
        "batch_order": "cached", "extra": 1}


def test_data_state_sidecar_sha256_tamper_legacy_and_gc(tmp_path):
    """The reference's sidecar: a sha256 wrapper that round-trips; a
    tampered or torn sidecar is quarantined; a bare legacy dict loads; the
    file a JAX checkpointer writes reads in the port, and the reverse."""
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    state = {"epoch": 2, "cursor": 17, "block": [3, 1, 2]}
    path = ck.put_data_state(4, state)
    payload = json.loads(open(path).read())
    assert set(payload) == {"sha256", "state"}
    assert ck.get_data_state(4) == state
    payload["state"]["cursor"] = 99
    with open(path, "w") as f:
        json.dump(payload, f)
    assert ck.get_data_state(4) is None
    assert [n for n in os.listdir(ck.directory)
            if n.startswith("corrupt-data_state-")] == \
        ["corrupt-data_state-4.p0.json"]
    with open(ck._data_state_path(7), "w") as f:
        f.write("{torn write")
    assert ck.get_data_state(7) is None
    legacy = {"epoch": 0, "cursor": 3}
    with open(ck._data_state_path(6), "w") as f:
        json.dump(legacy, f)
    assert ck.get_data_state(6) == legacy
    # the two packages' sidecars are one format
    jck = JTrainCheckpointer(str(tmp_path / "jck"))
    jck.put_data_state(3, state)
    assert TrainCheckpointer(jck.directory).get_data_state(3) == state
    ck.put_data_state(9, state)
    assert JTrainCheckpointer(ck.directory).get_data_state(9) == state
    jck.close()
    ck.close()


def test_close_is_idempotent_and_raises_a_failed_background_save(
        tmp_path, monkeypatch):
    ckpt = TrainCheckpointer(str(tmp_path / "a"))
    ckpt.close()
    ckpt.close()
    trainer = _trainer()
    state = trainer.init(Linear)
    ckpt = TrainCheckpointer(str(tmp_path / "b"))
    with FaultPlan(FaultSpec("checkpoint.save")):
        with pytest.raises(InjectedFault):
            ckpt.save(state, step=1, wait=True)
    ckpt.close()
    ckpt.close()

    def broken(obj, f):
        raise OSError("disk full")
    monkeypatch.setattr(tcheckpoint.torch, "save", broken)
    ckpt = TrainCheckpointer(str(tmp_path / "c"))
    ckpt.save(state, step=1)              # async: returns, the write fails
    with pytest.raises(OSError, match="disk full"):
        ckpt.close()                      # the first close surfaces it
    ckpt.close()
    assert ckpt.all_steps() == [] and os.listdir(ckpt.directory) == []


def test_quarantine_step_hides_it(tmp_path):
    trainer = _trainer()
    state = trainer.init(Linear)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    ckpt.save(state, step=1, wait=True)
    ckpt.save(state, step=2, wait=True)
    quarantined = ckpt.quarantine_step(2)
    assert os.path.isdir(quarantined)
    assert ckpt.all_steps() == [1] and ckpt.latest_step() == 1
    ckpt.close()


# -- ResilientTrainLoop: the reference's scenarios ---------------------------

def _loop(ckdir, save_every=2, loss=_noisy_loss):
    return ResilientTrainLoop(_trainer(loss), TrainCheckpointer(ckdir),
                              Linear, save_every=save_every)


def _crash(loop, total):
    with pytest.raises(InjectedFault):
        loop.run(_batch, total)
    loop.ckpt.close()


def test_crash_mid_checkpoint_write_then_resume_is_bit_identical(tmp_path):
    ref = _loop(str(tmp_path / "ref")).run(_batch, 6)
    ckdir = str(tmp_path / "faulty")
    with FaultPlan(FaultSpec("checkpoint.save", on_hit=2)):
        _crash(_loop(ckdir), 6)
    assert TrainCheckpointer(ckdir).latest_step() == 2
    resumed = _loop(ckdir).run(_batch, 6)
    assert TrainCheckpointer(ckdir).latest_step() == 6
    _assert_same(ref, resumed)


def test_crash_mid_train_step_then_resume_is_bit_identical(tmp_path):
    ref = _loop(str(tmp_path / "ref")).run(_batch, 6)
    ckdir = str(tmp_path / "faulty")
    with FaultPlan(FaultSpec("trainer.train_step", on_hit=5)):
        _crash(_loop(ckdir), 6)
    assert TrainCheckpointer(ckdir).latest_step() == 4
    _assert_same(ref, _loop(ckdir).run(_batch, 6))


def test_corrupt_latest_checkpoint_falls_back_to_the_previous_step(
        tmp_path):
    ref = _loop(str(tmp_path / "ref")).run(_batch, 4)
    ckdir = str(tmp_path / "victim")
    loop = _loop(ckdir)
    loop.run(_batch, 4)
    loop.ckpt.close()
    for root, _dirs, files in os.walk(os.path.join(ckdir, "4")):
        for fn in files:
            with open(os.path.join(root, fn), "wb") as f:
                f.write(b"corrupt garbage")
    events_path = tmp_path / "events.jsonl"
    tconfig.set("observability.events_path", str(events_path))
    try:
        fresh = _loop(ckdir)
        state, start = fresh.restore_or_init()
    finally:
        tevents.close()
        tconfig.unset("observability.events_path")
    assert start == 2 and fresh.ckpt.all_steps() == [2]
    assert "corrupt-4" in os.listdir(ckdir)
    events = [json.loads(ln) for ln in events_path.read_text().splitlines()]
    assert [(e["step"], e["fallback"]) for e in events
            if e["name"] == "restore.fallback"] == [(4, 2)]
    _assert_same(ref, fresh.run(_batch, 4))


def test_resilient_loop_noop_when_already_complete(tmp_path):
    final = _loop(str(tmp_path / "ck")).run(_batch, 4)
    _assert_same(final, _loop(str(tmp_path / "ck")).run(_batch, 4))


def test_reshard_to_is_refused_until_slice_6(tmp_path):
    """Without a ``trainer_factory`` a reshard can never be honoured, so it
    is refused at the call (the reference's rule); a bad shape is refused
    before it is queued. The reshard itself runs on gloo ranks in
    tests/test_torch_trainer_mesh.py."""
    loop = _loop(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="trainer_factory"):
        loop.reshard_to("4x2")
    loop.trainer_factory = lambda mesh: loop.trainer
    with pytest.raises(ValueError, match="mesh shape"):
        loop.reshard_to("4x2x2x2")
    loop.ckpt.close()


def _vec_files(root, n=32):
    root.mkdir()
    for i in range(n):
        rng = np.random.default_rng(i)
        (root / f"r_{i:03d}.bin").write_bytes(
            rng.normal(0, 1, (DIM,)).astype(np.float32).tobytes())


def _parse(rec):
    x = np.frombuffer(rec["bytes"], np.float32)
    return {"x": x, "y": (x * 0.5).astype(np.float32)}


def _pipeline(source_cls, root):
    return (source_cls(str(root)).map(_parse).shuffle(window=16, seed=9)
            .batch(8, remainder="drop").repeat())


def test_run_dataset_crash_resume_bit_identical(tmp_path):
    """The reference's scenario: 32 records, batch 8 (4 steps an epoch),
    10 steps, ``save_every=3``; a crash at the 8th step leaves step 6 and
    its epoch-1 snapshot, and the resume is bit-identical. A finite stream
    that runs dry raises."""
    root = tmp_path / "vecs"
    _vec_files(root)
    ck_full = TrainCheckpointer(str(tmp_path / "ck_full"))
    full = ResilientTrainLoop(_trainer(_noisy_loss), ck_full, Linear,
                              save_every=3).run_dataset(
        _pipeline(FileSource, root), 10)
    ck_full.close()
    ck_a = TrainCheckpointer(str(tmp_path / "ck_crash"))
    loop_a = ResilientTrainLoop(_trainer(_noisy_loss), ck_a, Linear,
                                save_every=3)
    with FaultPlan(FaultSpec("trainer.train_step", on_hit=8)):
        with pytest.raises(InjectedFault):
            loop_a.run_dataset(_pipeline(FileSource, root), 10)
    ck_a.wait()
    assert ck_a.latest_step() == 6
    snap = ck_a.get_data_state(6)
    assert snap is not None and snap["epoch"] == 1
    ck_a.close()
    ck_b = TrainCheckpointer(str(tmp_path / "ck_crash"))
    resumed = ResilientTrainLoop(_trainer(_noisy_loss), ck_b, Linear,
                                 save_every=3).run_dataset(
        _pipeline(FileSource, root), 10)
    _assert_same(full, resumed)
    ck_c = TrainCheckpointer(str(tmp_path / "ck_short"))
    short = FileSource(str(root)).map(_parse).batch(8, remainder="drop")
    with pytest.raises(ValueError, match="exhausted"):
        ResilientTrainLoop(_trainer(), ck_c, Linear,
                           save_every=0).run_dataset(short, 6)
    ck_c.close()
    ck_b.close()


def test_run_dataset_matches_the_jax_resilient_loop(tmp_path):
    """The same files, pipeline, init and adam(1e-2): the port's
    ``run_dataset`` (crashed at step 8, resumed) ends within rtol 1e-5 of
    the JAX package's uninterrupted ``ResilientTrainLoop`` on a one-device
    mesh, and both checkpointers hold the same committed steps."""
    root = tmp_path / "vecs"
    _vec_files(root)
    mesh = data_parallel_mesh(jax.devices()[:1])

    def jloss(params, batch, rng):
        pred = batch["x"] @ params["w"] + params["b"]
        return ((pred - batch["y"]) ** 2).mean()

    def jinit():
        return {"w": jnp.ones((DIM, DIM), jnp.float32) * 0.1,
                "b": jnp.zeros((DIM,), jnp.float32)}
    jck = JTrainCheckpointer(str(tmp_path / "jck"))
    jstate = JResilientTrainLoop(
        JDistributedTrainer(jloss, optax.adam(1e-2), mesh=mesh), jck, jinit,
        save_every=3).run_dataset(_pipeline(JFileSource, root), 10)
    jck.wait()
    jsteps = jck.all_steps()
    jck.close()
    tdir = str(tmp_path / "tck")
    loop = ResilientTrainLoop(_trainer(), TrainCheckpointer(tdir), Linear,
                              save_every=3)
    with FaultPlan(FaultSpec("trainer.train_step", on_hit=8)):
        with pytest.raises(InjectedFault):
            loop.run_dataset(_pipeline(FileSource, root), 10)
    loop.ckpt.close()
    ck = TrainCheckpointer(tdir)
    state = ResilientTrainLoop(_trainer(), ck, Linear,
                               save_every=3).run_dataset(
        _pipeline(FileSource, root), 10)
    assert ck.all_steps() == jsteps == [6, 9, 10]
    ck.close()
    # norm-wise per array: torch computes adam's bias correction in
    # float64, optax in float32 (up to ~7e-6 of each update), so elements
    # near zero move by more than 1e-5 of themselves (6.6e-7 here)
    for name in ("w", "b"):
        got = getattr(state["module"], name).detach().numpy()
        want = np.asarray(jstate["params"][name])
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
