"""Rank-side functions of the port's serving-on-a-mesh tests.

``mmlspark_tpu_torch.testing.ranks.RankPool`` runs these in gloo rank
processes on the CPU, as ``fn(rank, world, *args)``. Each is led: rank 0
runs the body as the leader (``parallel/leader.py``) and returns its
result, ranks 1..W-1 follow until it stops them and return the number of
commands they ran. Like ``torch_mesh_ranks.py`` this module imports
torch, numpy and the port only (never JAX); inputs and results are numpy
arrays and plain values.
"""
from __future__ import annotations

import functools
import os
import threading
import time

import numpy as np

from mmlspark_tpu_torch.parallel import leader

IDLE_S = 120.0


def led(body):
    """``body(*args)`` on rank 0 inside ``leader.lead()``; the other
    ranks follow."""
    @functools.wraps(body)
    def run(rank, world, *args):
        if rank:
            return {"follower_commands": leader.follow(idle_s=IDLE_S)}
        with leader.lead():
            return body(*args)
    return run


def _tm(arch, params, kw, spec=None, **stage):
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    tm = TorchModel(**({"meshSpec": spec} if spec is not None else {}),
                    **stage)
    return tm.set_model(arch, params=params, **kw)


def _placements(ch, header, tensors, local):
    return sorted(ch.placements)


def _placed_everywhere():
    """Every rank's placement keys (one command over the world)."""
    return leader.channel().call("torch_serve_ranks:_placements",
                                 results=True)


# -- TorchModel scoring -------------------------------------------------------

@led
def score(arch, params, kw, x, spec, stage, col="x"):
    """The column ``o`` of a meshed ``TorchModel`` over ``x`` (partitioned
    in 3), its output shape, and the placements left on every rank once
    the stage released its own."""
    from mmlspark_tpu_torch.core.frame import Frame
    tm = _tm(arch, params, kw, spec, inputCol=col, outputCol="o", **stage)
    frame = Frame.from_dict({col: x}, num_partitions=3 if len(x) >= 3
                            else 1)
    out = tm.transform(frame)
    got = np.asarray(out.column("o"))
    tm.release_placement()
    return {"o": got, "count": out.count(), "vector": str(
        out.schema["o"].dtype), "left": _placed_everywhere()}


@led
def mesh_spec_round_trip(arch, params, kw, x, directory):
    """meshSpec given as a MeshSpec and as a live DeviceMesh: scored,
    saved, loaded (as an axis-size dict) and scored again."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.serialization import load_stage, save_stage
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    frame = Frame.from_dict({"x": x})
    out = []
    for i, spec in enumerate((MeshSpec(data=1, tensor=2),
                              make_mesh(MeshSpec(data=1, tensor=2)))):
        tm = _tm(arch, params, kw, spec, inputCol="x", outputCol="o",
                 miniBatchSize=8)
        want = np.asarray(tm.transform(frame).column("o"))
        path = os.path.join(directory, f"m{i}")
        save_stage(tm, path)
        loaded = load_stage(path)
        got = np.asarray(loaded.transform(frame).column("o"))
        out.append({"want": want, "got": got,
                    "saved": loaded.get("meshSpec")})
        tm.release_placement()
        loaded.release_placement()
    return out


@led
def featurize(params, kw, images, spec):
    """A vit_tiny ``ImageFeaturizer`` on ``spec`` over uint8 images: the
    features and the inner model's devicePreprocess (the fused uint8
    route)."""
    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    f = ImageFeaturizer(cutOutputLayers=1, miniBatchSize=4, meshSpec=spec)
    f.set_model("vit_tiny", params=params, **kw)
    got = np.asarray(f.transform(_image_frame(images)).column("features"))
    tm = f._tm_cache
    out = {"features": got, "dp": tm.get("devicePreprocess")}
    tm.release_placement()
    return out


def _image_frame(images):
    """uint8 images as an ImageValue column in two partitions."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.schema import (ColumnSchema, DType,
                                                ImageValue)
    vals = np.empty(len(images), dtype=object)
    for i, im in enumerate(images):
        vals[i] = ImageValue(path=f"mem://{i}", data=im)
    frame = Frame.from_dict({"row": np.arange(len(images))},
                            num_partitions=2)
    return frame.with_column_values(ColumnSchema("image", DType.IMAGE),
                                    vals)


# -- serving: registry, ledger, generate --------------------------------------

@led
def serve_rows(arch, params, kw, x, spec, max_batch):
    """``Server.submit_many`` of a (meshed) model: the answers, the
    ledger's rows, the entry's resident bytes, the placed tables'
    local and whole bytes, and the placements left after close."""
    from mmlspark_tpu_torch.observability import memory as devmem
    from mmlspark_tpu_torch.serve import Server
    led_ = devmem.get_ledger()
    led_.reset()
    tm = _tm(arch, params, kw, spec)
    t0 = time.perf_counter()
    with Server({"rec": tm}, max_batch=max_batch, max_wait_ms=1.0) as srv:
        entry = srv.registry.get("rec")
        entry.ensure_apply()
        ready_s = time.perf_counter() - t0
        out = srv.submit_many("rec", x, timeout=60)
        tables = {n: (devmem.shard_bytes_of(p), devmem.param_bytes({n: p}),
                      getattr(p, "_mesh_sharding", None) and
                      p._mesh_sharding.spec)
                  for n, p in entry.module.named_parameters()
                  if n.endswith("_embedding")}
        res = {"out": out, "tables": tables,
               "table": led_.total(model="rec", kind="table"),
               "params": led_.total(model="rec", kind="params"),
               "resident": entry.resident_bytes(),
               "captures": entry.compile_count,
               "ready_s": ready_s,
               "projected": srv.registry.projected_bytes(tm)}
    res["after_close"] = led_.total(model="rec")
    res["left"] = _placed_everywhere()
    led_.reset()
    return res


@led
def audit_tables(rows, dim):
    """The reference's sharded-table audit on the port: a table
    row-sharded over ``tensor`` and charged at its per-shard bytes."""
    ch = leader.channel()
    mesh = ch.mesh({"data": ch.world // 2, "tensor": 2})
    return ch.call("torch_serve_ranks:_audit", {"rows": rows, "dim": dim},
                   results=True, n=mesh.size())


def _audit(ch, header, tensors, local):
    from mmlspark_tpu_torch.embed.tables import (EmbeddingCollection,
                                                 EmbeddingTable)
    from mmlspark_tpu_torch.observability import memory as devmem
    mesh = ch.meshes[tuple(sorted({"data": ch.world // 2,
                                   "tensor": 2}.items()))]
    coll = EmbeddingCollection(
        [EmbeddingTable("big", header["rows"], header["dim"])], mesh=mesh)
    placed = coll.place(coll.init(seed=0))
    led_ = devmem.MemoryLedger()
    led_.set_bytes("big", "table",
                   sum(devmem.shard_bytes_of(a) for a in placed.values()))
    out = devmem.audit_device_bytes(led_)
    return {"accounted": out["accounted_bytes"],
            "logical": int(coll.logical_bytes()),
            "supported": out["supported"]}


def _lane_run(lane, futs, max_steps=96):
    for _ in range(max_steps):
        if all(f.done() for f in futs):
            break
        lane.step()
    return [f.result(1) for f in futs]


@led
def decode(params, kw, prompt, new_tokens, spec, gen_cfg):
    """Greedy decode of a (meshed) ``transformer_lm_tiny`` through a
    manually stepped lane: the tokens, the arena's spec and bytes, the
    entry's resident bytes and the model's whole parameter bytes, each
    rank's launches under the prefill program, the lane reset and
    rebuilt once, and the placements left after close."""
    from mmlspark_tpu_torch.observability import memory as devmem
    from mmlspark_tpu_torch.serve import Server
    from mmlspark_tpu_torch.utils import config
    for k, v in gen_cfg.items():
        config.set(k, v)
    tm = _tm("transformer_lm_tiny", params, kw, spec)
    srv = Server({"lm": tm}, start=False)
    try:
        lane = srv.enable_generate("lm", start=False)
        gen = lane.gen
        f = srv.submit_generate("lm", prompt, max_new_tokens=new_tokens)
        out, = _lane_run(lane, [f])
        entry = srv.registry.get("lm")
        res = {"tokens": out["tokens"],
               "arena_spec": gen.kv.arena_sharding,
               "arena_bytes": gen.kv.arena_bytes(),
               "arena_shard_bytes": gen.kv.arena_shard_bytes(),
               "local_heads": gen.kv.local_heads,
               "resident": entry.resident_bytes(),
               "whole_params": devmem.param_bytes(tm._state["params"]),
               "mesh": None if gen.mesh is None else
               {a: int(n) for a, n in zip(gen.mesh.mesh_dim_names,
                                          gen.mesh.mesh.shape)}}
        progs = gen.built_programs()
        res["programs"] = sorted(progs)
        res["kinds"] = sorted({type(p).__name__ for p in progs.values()})
        if gen.mesh is not None:
            prefill = next(p for k, p in progs.items() if k[0] == "prefill")
            res["prefill_rank_launches"] = prefill.rank_launches()
        # the lane closes and is rebuilt on the same placement
        srv.reset_lane("lm", timeout_s=5.0)
        lane = srv.enable_generate("lm", start=False)
        f = srv.submit_generate("lm", prompt, max_new_tokens=new_tokens)
        res["tokens_again"] = _lane_run(lane, [f])[0]["tokens"]
    finally:
        srv.close()
        for k in gen_cfg:
            config.unset(k)
    res["left"] = _placed_everywhere()
    return res


# -- the fleet ----------------------------------------------------------------

def _mlp(params, kw):
    return _tm("mlp_tabular", params, kw, None, inputCol="x", outputCol="y",
               miniBatchSize=8)


@led
def fleet_reshard(params, kw, x, shape, replicas, kill=None):
    """``Fleet.reshard(shape)`` under closed-loop fire (``kill``: that
    replica killed first): the answers before, during and after, the
    report, the fleet's and an entry's mesh, a scale_up's meshSpec, then
    ``reshard(None)`` and the answers back on one device."""
    from mmlspark_tpu_torch.serve.fleet import Fleet
    m = _mlp(params, kw)
    res = {"fired": [], "errors": []}
    with Fleet({"mlp": m}, replicas=replicas,
               server_kwargs={"max_batch": 4}) as fleet:
        res["before"] = fleet.submit("mlp", x)
        if kill is not None:
            fleet.kill(kill)
        stop = threading.Event()

        def fire():
            while not stop.is_set():
                try:
                    res["fired"].append(fleet.submit("mlp", x))
                except Exception as e:          # noqa: BLE001
                    res["errors"].append(f"{type(e).__name__}: {e}")
                    return
        t = threading.Thread(target=fire, daemon=True)
        t.start()
        try:
            res["report"] = fleet.reshard(shape, warm_x=x)
        finally:
            stop.set()
            t.join(timeout=30)
        res["mesh_shape"] = fleet.mesh_shape
        live = [r for r in fleet.replicas if not r._dead]
        entry = live[0].server.registry.get("mlp")
        spec = entry.model.get("meshSpec")
        res["spec"] = (spec.data, spec.tensor)
        mesh = entry.model._resolve_score_mesh()
        res["tensor"] = dict(zip(mesh.mesh_dim_names,
                                 mesh.mesh.shape))["tensor"]
        res["after"] = [fleet.submit("mlp", x) for _ in range(3)]
        res["placements_in_use"] = len(leader.channel().refs)
        name = fleet.scale_up()
        new = fleet.replicas[-1].server.registry.get("mlp").model
        res["scaled"] = (name, new.get("meshSpec").data,
                         new.get("meshSpec").tensor)
        res["scaled_answer"] = fleet.replicas[-1].submit("mlp", x)
        res["placements_after_scale"] = len(leader.channel().refs)
        back = fleet.reshard(None, warm_x=x)
        res["back"] = {"mesh_shape": back["mesh_shape"],
                       "fleet": fleet.mesh_shape,
                       "spec": fleet.servers[0].registry.get("mlp")
                       .model.get("meshSpec"),
                       "answer": fleet.submit("mlp", x)}
    res["left"] = _placed_everywhere()
    return res


@led
def fleet_over_budget(params, kw, x, shape):
    """A placement over the registry budget: reshard raises
    ``PlacementOverBudget`` before any entry is dropped."""
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.serve.registry import PlacementOverBudget
    from mmlspark_tpu_torch.utils import config
    m = _mlp(params, kw)
    with Fleet({"mlp": m}, replicas=2,
               server_kwargs={"max_batch": 4}) as fleet:
        want = fleet.submit("mlp", x)
        config.set("runtime.device_cache_mb", 1e-6)
        try:
            fleet.reshard(shape, warm_x=x)
            raised = None
        except PlacementOverBudget as e:
            raised = str(e)
        finally:
            config.unset("runtime.device_cache_mb")
        return {"raised": raised, "mesh_shape": fleet.mesh_shape,
                "weight": fleet.router._handles["r0"].weight,
                "spec": fleet.servers[0].registry.get("mlp").model.get(
                    "meshSpec"),
                "want": want, "got": fleet.submit("mlp", x),
                "left": _placed_everywhere()}


@led
def autopilot_reshard(params, kw, x, target):
    """The autopilot's fifth lever on a live fleet: HBM pressure and a
    ``reshard_wide`` policy actuate ``Fleet.reshard``; the next tick
    vetoes at the target."""
    from mmlspark_tpu_torch.control.autopilot import (Autopilot,
                                                      AutopilotPolicy)
    from mmlspark_tpu_torch.serve.fleet import Fleet
    m = _mlp(params, kw)
    with Fleet({"mlp": m}, replicas=1,
               server_kwargs={"max_batch": 4}) as fleet:
        want = fleet.submit("mlp", x)
        policy = AutopilotPolicy(
            min_replicas=1, max_replicas=1, hbm_limit_bytes=1,
            reshard_wide=target, reshard_hbm_frac=0.5,
            reshard_cooldown_s=0.0, scale_down_queue=-1.0)
        ap = Autopilot(fleet, policy=policy, clock=lambda: 1000.0)
        acted = [d for d in ap.tick()
                 if d["lever"] == "reshard" and not d["suppressed"]]
        spec = fleet.servers[0].registry.get("mlp").model.get("meshSpec")
        again = [d for d in ap.tick() if d["lever"] == "reshard"]
        return {"actions": [d["action"] for d in acted],
                "errors": [d.get("error") for d in acted],
                "resharded": [d["report"]["resharded"] for d in acted
                              if "report" in d],
                "mesh_shape": fleet.mesh_shape,
                "spec": (spec.data, spec.tensor),
                "again": [(d["suppressed"], d["reason"]) for d in again],
                "want": want, "got": fleet.submit("mlp", x)}


# -- refusals and failures ----------------------------------------------------

def elsewhere(rank, world, arch, params, kw, x):
    """Rank 1 states another host when it joins: rank 0's meshed scoring
    over both is refused; over rank 0 alone it is one device."""
    if rank:
        leader._hostname = lambda: "another-host"
        return leader.follow(idle_s=IDLE_S)
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.schema import SchemaError
    with leader.lead() as ch:
        tm = _tm(arch, params, kw, {"data": 2}, inputCol="x",
                 outputCol="o")
        try:
            tm.transform(Frame.from_dict({"x": x}))
            refused = None
        except SchemaError as e:
            refused = str(e)
        big = _tm(arch, params, kw, {"data": 4}, inputCol="x",
                  outputCol="o")
        try:
            big.transform(Frame.from_dict({"x": x}))
            too_big = None
        except ValueError as e:
            too_big = str(e)
        return {"hosts": ch.hosts, "refused": refused, "too_big": too_big}


def _exit(ch, header, tensors, local):
    if ch.rank == header["rank"]:
        os._exit(3)


def follower_dies(rank, world, arch, params, kw, x, path):
    """Rank 0 scores once on the mesh, then rank 1 exits inside a
    command: the call fails with a retryable error within the channel's
    timeout, and the next call fails at once. Rank 0 writes what it saw
    to ``path`` (the pool loses rank 1 and is replaced)."""
    import json
    if rank:
        return leader.follow(idle_s=IDLE_S)
    from mmlspark_tpu_torch.core.frame import Frame
    ch = leader.channel()
    tm = _tm(arch, params, kw, {"data": 2}, inputCol="x", outputCol="o")
    frame = Frame.from_dict({"x": x})
    seen = {"first": np.asarray(tm.transform(frame).column("o")).tolist()}
    t0 = time.perf_counter()
    try:
        ch.call("torch_serve_ranks:_exit", {"rank": 1})
    except Exception as e:                       # noqa: BLE001
        seen["died"] = {"type": type(e).__name__,
                        "connection": isinstance(e, ConnectionError),
                        "retryable": bool(getattr(e, "retryable", False)),
                        "seconds": time.perf_counter() - t0}
    try:
        tm.transform(frame)
    except Exception as e:                       # noqa: BLE001
        seen["next"] = {"type": type(e).__name__,
                        "connection": isinstance(e, ConnectionError)}
    with open(path, "w") as f:
        json.dump(seen, f)
    return seen


@led
def nothing():
    """A led call that does nothing (the pool's ranks answer)."""
    return {"world": leader.channel().world}


def card_lm_score(rank, world, ids, depth):
    """On the card, TF32 off on every rank: the fp32 ``transformer_lm``
    (zoo width, ``depth`` blocks) scored at tensor 2 over the ranks and
    on rank 0 alone, and each rank's kernel launches in the meshed
    pass."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank:
        return leader.follow(idle_s=IDLE_S)
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    frame = Frame.from_dict({"ids": ids})

    def scorer(spec):
        tm = TorchModel(inputCol="ids", outputCol="o", miniBatchSize=len(ids),
                        outputNodeName="logits", meshSpec=spec)
        return tm.set_model("transformer_lm", seed=0, dtype="float32",
                            depth=depth)
    with leader.lead() as ch:
        one = np.asarray(scorer(None).transform(frame).column("o"))
        tm = scorer({"data": 1, "tensor": 2})
        ch.rank_stats(reset=True)
        got = np.asarray(tm.transform(frame).column("o"))
        stats = ch.rank_stats()
        tm.release_placement()
    return {"one": one, "mesh": got,
            "launches": [{k: v[0] for k, v in s["launches"].items()}
                         for s in stats]}
