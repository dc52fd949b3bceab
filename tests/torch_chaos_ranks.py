"""Rank-side functions of the port's mesh-bound chaos tests.

``mmlspark_tpu_torch.testing.ranks.RankPool`` runs these in gloo rank
processes on the CPU, as ``fn(rank, world, *args)``: rank 0 runs the
scenario as the leader (``parallel/leader.py``) and returns its verdict,
ranks 1..W-1 follow until it stops them and return the number of commands
they ran. Like ``torch_serve_ranks.py`` this module imports torch, numpy
and the port only (never JAX).
"""
from __future__ import annotations

import json

from mmlspark_tpu_torch.parallel import leader

IDLE_S = 300.0


def scenario(rank, world, name, seed, outdir, kw):
    """``chaos.run_named(name, seed, outdir, **kw)`` led on rank 0: the
    verdict as the file holds it, and the placements every rank holds
    once the leader is done."""
    if rank:
        return {"follower_commands": leader.follow(idle_s=IDLE_S)}
    from mmlspark_tpu_torch.reliability import chaos
    with leader.lead() as ch:
        verdict = chaos.run_named(name, seed, outdir, **kw)
        left = ch.call("mmlspark_tpu_torch.reliability.chaos:_placements",
                       results=True)
    out = json.loads(json.dumps(verdict))
    out["left_after"] = left
    return out


def kill_mid_call(rank, world, seed):
    """Two replicas of a meshed ``mlp_tabular`` share one placement; the
    leader's part of replica r0's next meshed call is held 0.5 s inside
    ``Channel.call`` and r0 is killed then (``Fleet.kill``, no drain).
    Returns how the in-flight request ended, the survivor's answers, the
    holds on the placement after the kill, and the placements every rank
    holds before and after the fleet closes."""
    import threading
    import time

    import numpy as np
    if rank:
        return {"follower_commands": leader.follow(idle_s=IDLE_S)}
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.reliability import chaos
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.testing import loadgen
    out = {}
    with leader.lead() as ch:
        model = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8,
                           meshSpec=chaos.SHARDED_MESH)
        model.set_model("mlp_tabular", input_dim=8, hidden=[16],
                        num_classes=3, seed=seed)
        x = loadgen.feature_rows(1, 2, 8, seed)[0]
        with Fleet({"m": model}, replicas=2,
                   server_kwargs={"max_batch": 4}) as fleet:
            victim, survivor = fleet.replicas
            want = np.asarray(survivor.submit("m", x))
            victim.submit("m", x)
            inside = threading.Event()
            run = ch._run

            def held(op, header, tensors, local):
                if op.endswith(":_mesh_score") and not inside.is_set():
                    inside.set()
                    time.sleep(0.5)
                return run(op, header, tensors, local)
            ch._run = held
            box = {}

            def client():
                try:
                    box["got"] = np.asarray(victim.submit("m", x))
                except Exception as e:            # noqa: BLE001
                    box["err"] = e
            t = threading.Thread(target=client, daemon=True)
            t.start()
            if not inside.wait(30):
                raise RuntimeError("the victim's call never started")
            fleet.kill(0)
            t.join(30)
            ch._run = run
            if "got" in box:
                out["victim"] = ("equal" if np.array_equal(box["got"], want)
                                 else "unequal")
            else:
                # (error, retryable): a failed call must fail retryably
                err = box.get("err")
                out["victim"] = (type(err).__name__,
                                 bool(getattr(err, "retryable", False)))
            out["client_done"] = not t.is_alive()
            out["broken"] = ch.broken
            out["refs"] = dict(ch.refs)
            out["placed"] = ch.call(
                "mmlspark_tpu_torch.reliability.chaos:_placements",
                results=True)
            out["survivor"] = [bool(np.array_equal(
                np.asarray(survivor.submit("m", x)), want))
                for _ in range(3)]
            out["fleet"] = bool(np.array_equal(
                np.asarray(fleet.submit("m", x)), want))
        out["left"] = ch.call(
            "mmlspark_tpu_torch.reliability.chaos:_placements",
            results=True)
    return out
