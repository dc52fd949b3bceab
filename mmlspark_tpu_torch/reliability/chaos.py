"""Seeded chaos harness: deterministic fault schedules + a verdict.

The port's copy of ``mmlspark_tpu/reliability/chaos.py``: all eleven
scenarios, with the reference's plans, schedules and invariant names. An
invariant the port cannot keep as it is worded is restated, never dropped,
and the verdict names it under ``restated``:

- a CUDA graph does not serialize, so a fresh worker process cannot load
  its programs from a cache (``host``'s ``warm_restart``, ``elastic``'s
  ``warm_scale_up`` and ``steady_compiles_zero``). Those become three
  conditions: the fresh worker captures exactly its bucket count, the
  kernel build directory (``kernels/_build/``) is unchanged across the
  run, and the worker ran no ``nvcc``. In-process fleets keep
  ``steady_compiles_zero`` literally: the registry's ``compiles`` count
  CUDA-graph captures, and survivors must capture nothing new;
- the four mesh-bound scenarios (``fleet_sharded``, ``decode_sharded``,
  ``recommender``, ``reshard``) run where the port's mesh lives: one rank a
  device over ``torch.distributed``, rank 0 leading inside
  ``parallel.leader.lead()`` and the other ranks in ``leader.follow()``
  (``cli chaos --scenario NAME --nprocs N`` starts them). The fleet, its
  router, registries and ledger are the leader's; the shards of a
  placement live in the followers' processes, which the leader's ledger
  cannot see, so ``ledger_reconciles_on_close`` also requires that no
  placement is left on any rank, read through one channel command. Called
  outside a joined channel they raise rather than run on one device. A
  kill is the reference's: an in-process replica closed without drain
  (``Fleet.kill``), never a rank's process.

The tentpole scenario (``mmlspark-tpu-torch chaos --seed N``):

1. **reference** — an uninterrupted :class:`ResilientTrainLoop` run on a
   tiny deterministic problem (params are a pure function of the seed);
2. **chaos** — the same run under a :class:`FaultPlan` *generated from the
   seed*: at least one mid-run kill (``trainer.train_step`` or
   ``checkpoint.save``), maybe a poisoned restore (exercising the
   quarantine-and-fall-back path), maybe tiny injected delays. Every
   ``InjectedFault`` that escapes the loop is "the process died"; the
   harness restarts the loop the way an operator (or a supervisor) would
   rerun the program, until the run completes;
3. **serve** — an HTTP server over a registry model takes traffic while
   seeded ``serve.*`` faults fire; ``/healthz`` is polled throughout and
   must answer every time, then the server drains and a second ``close()``
   proves idempotence.

Invariants asserted (the verdict JSON records each one):

- ``params_bit_identical``   — chaos-run final params == reference params,
  with the trainer's device-resident metrics ring active and its flush
  interval deliberately misaligned with the checkpoint interval (a flush
  boundary that changed the stream would break this bit-for-bit check);
- ``final_checkpoint_loads`` — a FRESH checkpointer restores the last step
  and it matches the in-memory state (no corrupt checkpoint survived);
- ``server_stays_live``      — every ``/healthz`` poll answered 200;
- ``no_unhandled_exceptions``— nothing escaped outside the injected
  fault channel.

Everything derives from ``seed`` — two runs with the same seed produce the
same fault schedule, the same kill points, and the same verdict, which is
what makes a red chaos run *debuggable* instead of an anecdote.
"""
from __future__ import annotations

import itertools
import json
import os
import random
from typing import Any, Callable, Dict, List, Optional

from mmlspark_tpu_torch.reliability.faults import (
    FaultPlan, FaultSpec, InjectedFault)
from mmlspark_tpu_torch.testing import loadgen
from mmlspark_tpu_torch.utils.logging import get_logger

_LOG = get_logger("reliability.chaos")

VERDICT_FILE = "chaos_verdict.json"

# Registered scenarios (name -> one-line description). The CLI dispatches
# through this registry; an unknown --scenario prints it and exits 2
# instead of tracebacking.
SCENARIOS: Dict[str, str] = {
    "train": "kill+resume training to bit-identical params, then serve "
             "under injected faults",
    "fleet": "kill one in-process replica of an N-wide fleet under fire; "
             "zero dropped requests, scores bit-identical",
    "decode": "kill a replica mid-generation; every sequence completes "
              "via failover-restart with bit-identical tokens",
    "host": "SIGKILL a real worker PROCESS under fire; the supervisor "
            "restarts it, which captures exactly its buckets with no "
            "kernel build, and a crash-looper ends breaker-open, not "
            "flapping",
    "autopilot": "seeded load spike + replica kill, twice: a static fleet "
                 "vs the same fleet under the autopilot; the autopilot "
                 "must shed strictly less, recover weights/replicas, and "
                 "never flap (asserted from autopilot.* events alone)",
    "elastic": "SIGKILL a worker mid autopilot-driven PROCESS scale-up; "
               "zero failed requests, the half-spawned slot completes or "
               "is reaped (never a zombie), the new worker captures "
               "exactly its buckets with no kernel build, and both "
               "pilots' event logs replay byte-identical",
    "fleetprefix": "kill the replica holding the hottest advertised "
                   "prefix chains mid-stream; zero failed requests, "
                   "survivors absorb the sessions, tokens bit-identical "
                   "to a single server, and the prefix hit rate recovers "
                   "with zero new captures",
    "fleet_sharded": "the fleet scenario with every replica's model "
                     "2-D mesh-sharded (data x tensor); same zero-drop "
                     "+ bit-identical invariants through the kill",
    "decode_sharded": "the decode scenario with a mesh-sharded model + "
                      "head-sharded KV arena; failover token-identical "
                      "and the HBM ledger reconciles PER SHARD",
    "recommender": "kill a replica mid-scoring with row-sharded embedding "
                   "tables resident; zero failed requests, scores "
                   "bit-identical to an unsharded single server, and the "
                   "HBM ledger's kind=\"table\" lines reconcile to zero "
                   "on close, with no placement left on any rank",
    "reshard": "kill a replica MID-RESHARD while the fleet moves to a "
               "new mesh placement under fire; zero failed requests, "
               "scores bit-identical to an untouched reference on both "
               "placements, the survivors finish the reshard, and the "
               "HBM ledger reconciles to zero on close (no orphan "
               "params/kv bytes from the dead replica or the old "
               "placement, no placement left on any rank)",
}

# the 2-D topology the mesh-bound scenarios run on: tensor=2 model axis,
# data absorbs the rest of the world's ranks (1x2 on 2 ranks, 2x2 on 4)
SHARDED_MESH = "data=-1,tensor=2"
# the scenarios that run on a mesh of ranks (rank 0 leading)
MESH_SCENARIOS = ("fleet_sharded", "decode_sharded", "recommender",
                  "reshard")
# reshard's default target: tensor 2 on ranks 0-1, a sub-mesh of any
# world. The reference moves onto its whole world (4x2), and XLA's
# per-row sums do not depend on a device's row count; MKL's and cuBLAS's
# do (a 2-row request split over data 2 is a 1-row GEMM a rank, which
# rounds otherwise than the one-device 2-row GEMM), so a data split
# cannot keep scores_bit_identical_post_reshard
RESHARD_MESH = "1x2"

# Sites the TRAIN phase draws its schedule from. `trainer.train_step` /
# `checkpoint.save` raises are kills (the loop restarts); a
# `checkpoint.restore` raise poisons the newest checkpoint ONCE, forcing
# the quarantine-and-fall-back path on resume; delays exercise timeout
# plumbing without changing any numerics.
TRAIN_KILL_SITES = ("trainer.train_step", "checkpoint.save")
TRAIN_DELAY_SITES = ("checkpoint.save.commit", "checkpoint.restore")
# SERVE-phase fault sites (see faults.py's site inventory).
SERVE_FAULT_SITES = ("serve.enqueue", "serve.batch", "serve.score")

_DIM = 8


class ChaosError(RuntimeError):
    """The scenario itself failed to make progress (distinct from an
    injected fault, which is the scenario working as designed)."""


# -- plan generation ---------------------------------------------------------

def generate_train_plan(seed: int, total_steps: int,
                        sleep: Optional[Callable[[float], None]] = None
                        ) -> FaultPlan:
    """A randomized-but-deterministic fault schedule for the train phase.

    Always contains at least one kill so the resume path is exercised;
    hit counts accumulate across restarts (the plan stays installed), so
    later kills land in the *resumed* run.
    """
    rng = random.Random(seed)
    specs: List[FaultSpec] = []
    # guaranteed kill, mid-run: never on hit 1 (a run that dies before any
    # checkpoint proves nothing about resume)
    site = rng.choice(TRAIN_KILL_SITES)
    if site == "trainer.train_step":
        specs.append(FaultSpec(site, on_hit=rng.randint(2, total_steps)))
    else:
        specs.append(FaultSpec(site, on_hit=rng.randint(1, 2)))
    # optional second kill, landing during the resumed run's replay
    if rng.random() < 0.5:
        specs.append(FaultSpec(
            "trainer.train_step",
            on_hit=total_steps + rng.randint(1, total_steps)))
    # optional poisoned restore: the FIRST restore after the kill fails,
    # forcing quarantine of the newest step and fall-back to the previous
    if rng.random() < 0.5:
        specs.append(FaultSpec("checkpoint.restore", on_hit=1))
    # optional tiny delays (timeout plumbing, not numerics)
    for delay_site in TRAIN_DELAY_SITES:
        if rng.random() < 0.5:
            specs.append(FaultSpec(delay_site, on_hit=rng.randint(1, 3),
                                   action="delay", delay=0.001))
    kwargs = {"sleep": sleep} if sleep is not None else {}
    return FaultPlan(*specs, **kwargs)


def generate_serve_plan(seed: int, requests: int) -> FaultPlan:
    """Seeded faults for the serve phase: a couple of scoring/admission
    failures, few enough that the per-model circuit breaker (default
    threshold 5 consecutive) never opens — the invariant under test is
    *liveness*, not breaker behavior."""
    rng = random.Random(seed ^ 0x5EEDED)
    specs = [FaultSpec("serve.score", on_hit=rng.randint(2, max(2, requests // 2)))]
    if rng.random() < 0.5:
        specs.append(FaultSpec("serve.enqueue",
                               on_hit=rng.randint(2, max(2, requests - 1))))
    return FaultPlan(*specs)


# -- deterministic tiny workload --------------------------------------------

def _make_trainer():
    from mmlspark_tpu_torch.parallel.optim import adam
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer

    def loss_fn(module, batch, gen):
        pred = module(batch["x"])
        return ((pred - batch["y"]) ** 2).mean()

    return DistributedTrainer(loss_fn, adam(1e-2))


def _init_params():
    """The reference's ``{"w": 0.1 * ones, "b": zeros}`` linear model."""
    import torch

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.full((_DIM, _DIM), 0.1))
            self.b = torch.nn.Parameter(torch.zeros(_DIM))

        def forward(self, x):
            return x @ self.w + self.b

    return Linear()


def _batch_fn(seed: int) -> Callable[[int], Dict[str, Any]]:
    import numpy as np

    def batch(step: int) -> Dict[str, Any]:
        x = loadgen.feature_rows(1, 16, _DIM, (seed << 20) + step)[0]
        return {"x": x, "y": (x * 0.5).astype(np.float32)}

    return batch


def _bit_identical(a: Any, b: Any) -> bool:
    """Two trainer states hold the same parameters, bit for bit."""
    import numpy as np

    from mmlspark_tpu_torch.observability import syncs
    fa = syncs.device_get(dict(a["module"].state_dict()), "chaos.compare")
    fb = syncs.device_get(dict(b["module"].state_dict()), "chaos.compare")
    return fa.keys() == fb.keys() and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


# -- scenario phases ---------------------------------------------------------

def _run_loop_to_completion(ckdir: str, batch_fn, total_steps: int,
                            save_every: int, max_restarts: int) -> Any:
    """Run a ResilientTrainLoop to completion, restarting on every escaped
    InjectedFault exactly the way a supervisor reruns a killed program.
    The active FaultPlan's hit counters persist across restarts, so the
    schedule is deterministic end-to-end."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop
    restarts = 0
    while True:
        loop = ResilientTrainLoop(_make_trainer(), TrainCheckpointer(ckdir),
                                  _init_params, save_every=save_every)
        try:
            state = loop.run(batch_fn, total_steps)
            loop.ckpt.close()
            return state, restarts
        except InjectedFault as e:
            restarts += 1
            _LOG.info("chaos kill #%d (%s); restarting the loop", restarts, e)
            try:
                loop.ckpt.close()
            except Exception as close_err:
                # a kill mid-save can leave the manager wedged; a fresh
                # checkpointer supersedes it on the next restart
                _LOG.debug("post-kill checkpointer close failed: %s",
                           close_err)
            if restarts > max_restarts:
                raise ChaosError(
                    f"loop did not complete within {max_restarts} restarts "
                    "(fault schedule never drains?)") from e


def _final_checkpoint_loads(ckdir: str, expect_state: Any,
                            total_steps: int) -> bool:
    """A FRESH checkpointer must list the final step and restore it to
    exactly the in-memory final state — proving no corrupt checkpoint
    survived the chaos run as the newest step."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    ckpt = TrainCheckpointer(ckdir)
    try:
        if ckpt.latest_step() != total_steps:
            _LOG.warning("final checkpoint check: latest_step=%s != %d",
                         ckpt.latest_step(), total_steps)
            return False
        restored = ckpt.restore(_make_trainer(), _init_params)
        return _bit_identical(restored, expect_state)
    finally:
        ckpt.close()


def _quarantined(ckdir: str) -> List[str]:
    try:
        return sorted(n for n in os.listdir(ckdir)
                      if n.startswith("corrupt-"))
    except OSError:
        return []


def _serve_phase(seed: int, requests: int,
                 errors: List[str]) -> Dict[str, Any]:
    """Serve traffic under seeded faults; returns phase facts including
    whether every /healthz poll answered."""
    import threading
    import urllib.request

    import numpy as np

    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve.http import serve_http
    from mmlspark_tpu_torch.serve.server import ServeError, Server

    model = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    model.set_model("mlp_tabular", input_dim=_DIM, hidden=[16],
                    num_classes=3, seed=seed & 0xFFFF)
    server = Server({"chaos": model}, max_batch=4, queue_depth=32)
    httpd, addr = serve_http(server, port=0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                                   name="mmlspark-tpu-chaos-http")
    http_thread.start()

    polls_ok = 0
    polls_bad = 0

    def poll(allow=("ok", "draining")) -> None:
        nonlocal polls_ok, polls_bad
        try:
            with urllib.request.urlopen(
                    f"http://{addr}/healthz", timeout=5) as resp:
                body = json.loads(resp.read().decode())
                if resp.status == 200 and body.get("status") in allow:
                    polls_ok += 1
                else:
                    polls_bad += 1
        except Exception as e:
            polls_bad += 1
            errors.append(f"healthz poll failed: {type(e).__name__}: {e}")

    stream = loadgen.feature_rows(requests, 3, _DIM, seed)
    served = 0
    injected = 0
    plan = generate_serve_plan(seed, requests)
    with plan:
        for i in range(requests):
            x = stream[i]
            try:
                y = server.submit("chaos", x, timeout=30)
                if np.asarray(y).shape[0] == 3:
                    served += 1
                else:
                    errors.append(f"request {i}: wrong result shape")
            except (InjectedFault, ServeError):
                injected += 1  # seeded fault surfacing is the design
            except Exception as e:
                errors.append(
                    f"request {i}: unexpected {type(e).__name__}: {e}")
            if i % 3 == 0:
                poll()
    poll()
    server.drain(reason="chaos scenario complete")
    # the endpoint must still ANSWER after the drain; with the
    # liveness/readiness split it now truthfully reports "closed"
    poll(allow=("ok", "draining", "closed"))
    server.close()  # idempotence: second close is a no-op
    httpd.shutdown()
    httpd.server_close()
    if served == 0:
        errors.append("serve phase completed zero requests")
    return {"requests": requests, "served": served,
            "injected_failures": injected, "faults": plan.triggered,
            "healthz_ok": polls_ok, "healthz_bad": polls_bad}


# -- the mesh-bound scenarios' ranks -----------------------------------------

_PLACEMENTS = "mmlspark_tpu_torch.reliability.chaos:_placements"


def _mesh_leader(scenario: str):
    """The channel a mesh-bound scenario leads: this process must be rank
    0 of a joined channel (inside ``parallel.leader.lead()``, the other
    ranks in ``leader.follow()``) over an even number of ranks, since
    :data:`SHARDED_MESH` has a tensor axis of 2. Raises otherwise: the
    scenario never falls back to one device."""
    from mmlspark_tpu_torch.parallel import leader
    how = (f"start it as `python -m mmlspark_tpu_torch.cli chaos "
           f"--scenario {scenario} --nprocs 2` (rank 0 leads inside "
           "parallel.leader.lead(), ranks 1..N-1 run "
           "parallel.leader.follow())")
    ch = leader.joined()
    if ch is None:
        raise ChaosError(f"chaos {scenario} runs on a mesh of ranks, and "
                         f"this process joined none; {how}")
    if ch.rank != 0:
        raise ChaosError(f"chaos {scenario} runs on rank 0, the leader; "
                         f"this is rank {ch.rank}; {how}")
    if ch.world < 2 or ch.world % 2:
        raise ChaosError(f"chaos {scenario} needs an even world of at "
                         f"least 2 ranks (tensor 2), not {ch.world}; {how}")
    return ch


def _placements(ch, header, tensors, local) -> List[str]:
    """A rank's placement keys (a channel command)."""
    return sorted(ch.placements)


def _rank_facts(ch, errors: List[str]) -> Dict[str, Any]:
    """Every rank's kernel launches since the scenario zeroed them, and
    the placements left on each rank (one channel command each)."""
    facts: Dict[str, Any] = {"world": ch.world, "launches": None,
                             "placements_left": None}
    try:
        facts["launches"] = [
            {name: int(n) for name, (n, _) in s["launches"].items()}
            for s in ch.rank_stats()]
        facts["placements_left"] = ch.call(_PLACEMENTS, results=True)
    except Exception as e:
        errors.append(f"mesh ranks: {type(e).__name__}: {e}")
    return facts


# what ``ledger_reconciles_on_close`` holds on a mesh of ranks, in place
# of the reference's one process-wide ledger
_RECONCILED = ("leader_ledger_zero_after_close", "no_placement_on_any_rank")


def _no_placement_left(facts: Dict[str, Any]) -> bool:
    left = facts.get("placements_left")
    return left is not None and not any(left)


def _conclude(verdict: Dict[str, Any], outdir: str, label: str,
              seed: int) -> Dict[str, Any]:
    """Write ``verdict`` to ``outdir/chaos_verdict.json`` (atomically) and,
    when it is red, dump the flight recorder beside it: a red verdict
    ships its own forensics, the last-N telemetry events, even with
    events_path unset."""
    path = os.path.join(outdir, VERDICT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(verdict, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    _LOG.info("chaos %sverdict (%s): %s", f"{label} " if label else "",
              path, "PASS" if verdict["passed"] else "FAIL")
    if not verdict["passed"]:
        from mmlspark_tpu_torch.observability import flightrec
        dumped = flightrec.dump(
            reason=f"chaos.{label + '.' if label else ''}red.seed{seed}",
            path=os.path.join(outdir, "chaos_flightrec.jsonl"))
        if dumped:
            _LOG.error("chaos: flight recorder dumped to %s", dumped)
    return verdict


# -- fleet scenario ----------------------------------------------------------

def run_fleet_scenario(seed: int, outdir: str, replicas: int = 3,
                       requests: int = 24,
                       mesh: str = "") -> Dict[str, Any]:
    """Kill a replica under fire; the fleet must not drop a request.

    1. **reference** — the full request stream scored on a single
       :class:`~mmlspark_tpu_torch.serve.server.Server` over the same model:
       the numerics ground truth.
    2. **fleet** — the same stream through a ``replicas``-wide
       :class:`~mmlspark_tpu_torch.serve.fleet.Fleet`; at a seeded point
       mid-stream one seeded replica is killed without drain (in-flight
       work fails retryably, health goes dead). The client wraps
       ``router.submit`` in a :class:`RetryPolicy`, exactly as a real
       client rides out a consolidated shed.

    Invariants (verdict JSON, ``outdir/chaos_verdict.json``):

    - ``zero_failed_requests``  — every request eventually scored; the
      only acceptable non-successes are sheds the retry layer absorbed;
    - ``scores_bit_identical`` — fleet results == single-server results,
      row for row, through the kill and the failover;
    - ``failover_observed``    — the kill actually forced at least one
      failover (otherwise the scenario proved nothing);
    - ``replicas_stay_probed`` — every health probe round answered for
      every replica (dead replicas ANSWER dead; probing never wedges).

    The scenario also runs the observability stack against itself: a
    :class:`~mmlspark_tpu_torch.observability.aggregate.FleetScraper` +
    :class:`~mmlspark_tpu_torch.observability.slo.SloEngine` pair on a virtual
    clock (30 s per request round, so burn windows slide inside a
    seconds-long run) watches the whole incident, and a **recovery
    phase** keeps healthy traffic flowing until the incident leaves both
    windows. Four more invariants come from that aggregated view alone:

    - ``readiness_flip_observed`` — the kill shows up as a ready-count
      drop in the scraped fleet view (and never before the kill);
    - ``slo_burn_on_kill``        — availability burn crosses the fast
      threshold after the kill (failovers count as budget burn even
      though the retry layer hid them from the client);
    - ``slo_clears_after_recovery`` — burn decays back below threshold
      once healthy traffic has aged the incident out of the windows;
    - ``no_false_breach``         — ``slo.breach`` never fires before
      the kill and is clear again at the end.

    The verdict's ``schedule`` (kill point, killed replica, per-request
    serving replica, failover count) is a pure function of ``seed`` —
    two same-seed runs must produce byte-identical schedules, which is
    what the tier-1 smoke test asserts.

    With ``mesh`` (``fleet_sharded``, :data:`SHARDED_MESH`) every
    replica's copy of the model scores over that mesh of ranks, this
    process leading them (:func:`_mesh_leader`); the verdict's ``ranks``
    holds every rank's kernel launches and the placements left on each.
    """
    import numpy as np

    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability.aggregate import FleetScraper
    from mmlspark_tpu_torch.observability.slo import SloEngine
    from mmlspark_tpu_torch.reliability.retry import RetryPolicy
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.serve.server import Server

    os.makedirs(outdir, exist_ok=True)
    errors: List[str] = []
    verdict: Dict[str, Any] = {
        "seed": seed, "scenario": "fleet_sharded" if mesh else "fleet",
        "replicas": replicas, "requests": requests, "mesh": mesh}
    ch = _mesh_leader("fleet_sharded") if mesh else None
    if ch is not None:
        ch.rank_stats(reset=True)

    rng = random.Random(seed ^ 0xF1EE7)
    # the kill lands right after a probe round: the next probe is then a
    # full probe-interval of submits away, and a WRR walk that long over
    # `replicas` candidates is GUARANTEED to route onto the dead replica
    # first — failover discovers every kill, for every seed
    probe_every = max(4, replicas + 1)
    kill_at = -(-rng.randint(requests // 3, (2 * requests) // 3)
                // probe_every) * probe_every
    kill_at = min(kill_at, max(requests - probe_every, 0))
    kill_idx = rng.randrange(replicas)

    # sharded variant: the SAME scenario, but every replica's copy of the
    # model scores over a 2-D (data x tensor) mesh — the kill and the
    # failover must not care that each rank holds only a param shard
    model = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8,
                       **({"meshSpec": mesh} if mesh else {}))
    model.set_model("mlp_tabular", input_dim=_DIM, hidden=[16],
                    num_classes=3, seed=seed & 0xFFFF)
    stream = loadgen.feature_rows(requests, 2, _DIM, seed)

    # phase 1: single-server reference (same model object -> same programs)
    ref_server = Server({"chaos": model}, max_batch=4, queue_depth=32)
    try:
        reference = [np.asarray(ref_server.submit("chaos", x, timeout=30))
                     for x in stream]
    finally:
        ref_server.close()

    # phase 2: the same stream through the fleet, with a seeded mid-stream
    # kill. Sequential blocking submits keep the router's WRR walk (and so
    # the whole schedule) deterministic.
    fleet = Fleet({"chaos": model}, replicas=replicas,
                  server_kwargs={"max_batch": 4, "queue_depth": 32})
    route_log: List[str] = []
    fleet.router.route_log = route_log
    client_retry = RetryPolicy(max_attempts=4, base_delay=0.0, jitter=0.0,
                               name="chaos.fleet.client", seed=seed)
    results: List[Optional[Any]] = []
    failed = 0
    probe_rounds: List[Dict[str, str]] = []

    # the SLO watcher: one virtual-clock scrape per request round (30 s of
    # virtual time each), so the 5-minute fast window is 10 rounds wide and
    # the whole burn/recover cycle fits inside a seconds-long scenario
    vclock = {"t": 1000.0}
    scraper = FleetScraper(fleet, clock=lambda: vclock["t"])
    engine = SloEngine(clock=lambda: vclock["t"],
                       fast_window_s=300.0, slow_window_s=900.0)
    slo_trace: List[Dict[str, Any]] = []

    def observe_fleet() -> None:
        snap = scraper.scrape()
        status = engine.observe(scraper.slo_sample(snap))
        slo_trace.append({
            "t": vclock["t"],
            "ready": sum(1 for r in snap["replicas"].values()
                         if r.get("ready")),
            "burning": any(s["burning"] for s in status),
            "breaching": any(s["breaching"] for s in status),
        })
        vclock["t"] += 30.0

    try:
        for i, x in enumerate(stream):
            # probe BEFORE this round's kill: the kill must be discovered
            # by failover (a live request landing on the dead replica),
            # not pre-empted by a health probe in the same iteration —
            # with the probe leading, the dead replica stays in rotation
            # for the next few submits and the WRR walk is guaranteed to
            # reach it before the next probe round.
            if i % probe_every == 0:
                probe_rounds.append(fleet.router.probe())
            if i == kill_at:
                fleet.kill(kill_idx)  # lint: allow-actuate
            try:
                results.append(np.asarray(
                    client_retry.call(fleet.submit, "chaos", x)))
            except Exception as e:
                failed += 1
                results.append(None)
                errors.append(
                    f"request {i}: {type(e).__name__}: {e}")
            observe_fleet()
        probe_rounds.append(fleet.router.probe())
        # phase 3: recovery — healthy traffic while the virtual clock ages
        # the incident out of both burn windows (10 rounds x 120 s > the
        # 900 s slow window); the engine must come back clean
        for x in itertools.islice(itertools.cycle(stream), 10):
            fleet.router.probe()
            client_retry.call(fleet.submit, "chaos", x)
            vclock["t"] += 90.0  # on top of observe_fleet's own 30 s
            observe_fleet()
        stats = fleet.stats()
    finally:
        fleet.close()
    if ch is not None:
        verdict["ranks"] = _rank_facts(ch, errors)

    identical = all(
        r is not None and np.array_equal(r, ref)
        for r, ref in zip(results, reference))
    probed_ok = bool(probe_rounds) and all(
        len(round_) == replicas for round_ in probe_rounds)
    failovers = int(stats["failovers"])
    shed = sum(int(s.get("shed", 0))
               for s in stats["servers"].values())

    verdict["schedule"] = {
        "kill_at": kill_at, "kill_replica": f"r{kill_idx}",
        "route_log": route_log, "failovers": failovers,
    }
    verdict["fleet"] = {
        "served": sum(1 for r in results if r is not None),
        "failed": failed, "shed": shed,
        "probe_rounds": len(probe_rounds),
        "final_states": probe_rounds[-1] if probe_rounds else {},
    }

    # the incident as the aggregated view saw it: trace index == request
    # index through the stream (one scrape per round), then 10 recovery
    # rounds. The kill lands at trace index ``kill_at`` (kill precedes
    # that round's submit, so its scrape already sees the dead replica).
    pre_kill = slo_trace[:kill_at]
    post_kill = slo_trace[kill_at:]
    tail = slo_trace[-3:]
    burn_observed = any(e["burning"] for e in post_kill)
    breach_observed = any(e["breaching"] for e in post_kill)
    slo_clean_after = all(not e["burning"] and not e["breaching"]
                          for e in tail)
    no_false_breach = (all(not e["breaching"] for e in pre_kill)
                       and slo_clean_after)
    ready_flip = (all(e["ready"] == replicas for e in pre_kill)
                  and any(e["ready"] < replicas for e in post_kill))
    verdict["slo"] = {
        "kill_trace_index": kill_at,
        "burn_observed": burn_observed,
        "breach_observed": breach_observed,
        "clean_at_end": slo_clean_after,
        "trace": slo_trace,
    }
    invariants = {
        "zero_failed_requests": failed == 0,
        "scores_bit_identical": identical,
        "failover_observed": failovers >= 1,
        "replicas_stay_probed": probed_ok,
        "no_unhandled_exceptions": not errors,
        "readiness_flip_observed": ready_flip,
        "slo_burn_on_kill": burn_observed,
        "slo_clears_after_recovery": slo_clean_after,
        "no_false_breach": no_false_breach,
    }
    verdict["invariants"] = invariants
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())

    return _conclude(verdict, outdir, "fleet", seed)


def run_recommender_scenario(seed: int, outdir: str, replicas: int = 3,
                             requests: int = 24) -> Dict[str, Any]:
    """Kill a replica mid-scoring with SHARDED EMBEDDING TABLES resident.

    The fleet scenario's zero-drop + bit-identity contract, on the
    recommender subsystem: every replica serves a DLRM whose embedding
    tables are row-sharded over the 2-D ``data x tensor`` mesh of ranks
    (:data:`SHARDED_MESH`, this process leading them: :func:`_mesh_leader`),
    scoring a seeded Zipf-id stream drawn from
    :func:`loadgen.recommender_rows`. At a seeded point mid-stream one
    seeded replica dies without drain.

    Invariants (verdict JSON, ``outdir/chaos_verdict.json``):

    - ``zero_failed_requests``   — every request eventually scored
      through the client :class:`RetryPolicy`;
    - ``scores_bit_identical``   — fleet results == an UNSHARDED
      single-device single-server reference, row for row, through the
      kill (the sharded-lookup numerics contract, under failover);
    - ``failover_observed``      — the kill forced >= 1 failover;
    - ``tables_charged_per_shard`` — while the fleet serves, the leader's
      HBM ledger carries the model's ``kind="table"`` bytes at PER-SHARD
      size (tensor axis = 2 -> half the logical table bytes);
    - ``ledger_reconciles_on_close`` — after the fleet (and the
      reference server before it) closes, NO ``{model, kind}`` line
      survives in the leader's ledger and no placement is left on any
      rank (restated: the followers' shards are outside that ledger);
    - ``replicas_stay_probed``   — every probe round answers for every
      replica;
    - ``no_unhandled_exceptions``.

    The schedule (kill point, victim, failover count) is a pure function
    of ``seed`` — the tier-1 smoke test asserts byte-identical replay.
    """
    import numpy as np

    from mmlspark_tpu_torch.embed.model import padded_rows
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability import memory as devmem
    from mmlspark_tpu_torch.reliability.retry import RetryPolicy
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.serve.server import Server

    os.makedirs(outdir, exist_ok=True)
    errors: List[str] = []
    dense_dim, slots, embed_dim = 8, 4, 8
    tables = (("user", 64), ("item", 128))
    verdict: Dict[str, Any] = {
        "seed": seed, "scenario": "recommender", "replicas": replicas,
        "requests": requests, "mesh": SHARDED_MESH,
        "tables": [list(t) for t in tables]}
    ch = _mesh_leader("recommender")
    ch.rank_stats(reset=True)

    rng = random.Random(seed ^ 0x7AB1E5)
    # kill right after a probe round (see run_fleet_scenario: the WRR
    # walk then discovers the death by failover, for every seed)
    probe_every = max(4, replicas + 1)
    kill_at = -(-rng.randint(requests // 3, (2 * requests) // 3)
                // probe_every) * probe_every
    kill_at = min(kill_at, max(requests - probe_every, 0))
    kill_idx = rng.randrange(replicas)

    model_kw = dict(seed=seed & 0xFFFF, dense_dim=dense_dim,
                    tables=[list(t) for t in tables],
                    embed_dim=embed_dim, slots=slots,
                    bottom=[16], top=[16])
    stream = loadgen.recommender_rows(
        requests, dense=dense_dim,
        tables=tuple((rows, slots) for _, rows in tables), seed=seed)

    ledger = devmem.get_ledger()
    ledger.reset()
    # per-rank table residency the ledger must carry while serving:
    # padded rows x dim x 4 B, halved by the tensor=2 row-sharding
    expected_shard = sum(padded_rows(rows) * embed_dim * 4
                         for _, rows in tables) // 2

    # phase 1: UNSHARDED single-server reference — the numerics ground
    # truth the sharded fleet must match bit-for-bit
    ref_model = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    ref_model.set_model("recommender_dlrm", **model_kw)
    ref_server = Server({"rec": ref_model}, max_batch=4, queue_depth=32)
    try:
        reference = [np.asarray(ref_server.submit("rec", x, timeout=30))
                     for x in stream]
    finally:
        ref_server.close()
    ledger_after_ref = int(ledger.total())

    # phase 2: the same stream through the sharded fleet with a seeded
    # mid-stream kill; sequential submits keep the WRR walk deterministic
    model = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8,
                       meshSpec=SHARDED_MESH)
    model.set_model("recommender_dlrm", **model_kw)
    fleet = Fleet({"rec": model}, replicas=replicas,
                  server_kwargs={"max_batch": 4, "queue_depth": 32})
    route_log: List[str] = []
    fleet.router.route_log = route_log
    client_retry = RetryPolicy(max_attempts=4, base_delay=0.0, jitter=0.0,
                               name="chaos.recommender.client", seed=seed)
    results: List[Optional[Any]] = []
    failed = 0
    probe_rounds: List[Dict[str, str]] = []
    table_line_mid = 0
    try:
        for i, x in enumerate(stream):
            if i % probe_every == 0:
                probe_rounds.append(fleet.router.probe())
            if i == kill_at:
                fleet.kill(kill_idx)  # lint: allow-actuate
            try:
                results.append(np.asarray(
                    client_retry.call(fleet.submit, "rec", x)))
            except Exception as e:
                failed += 1
                results.append(None)
                errors.append(f"request {i}: {type(e).__name__}: {e}")
        probe_rounds.append(fleet.router.probe())
        # survivors have re-mirrored their residency since the kill:
        # the model's table line sits at per-shard bytes, not logical
        table_line_mid = int(ledger.total(model="rec", kind="table"))
        stats = fleet.stats()
    finally:
        fleet.close()
    ledger_after_close = int(ledger.total())
    table_after_close = int(ledger.total(kind="table"))
    verdict["ranks"] = _rank_facts(ch, errors)

    identical = all(
        r is not None and np.array_equal(r, ref)
        for r, ref in zip(results, reference))
    probed_ok = bool(probe_rounds) and all(
        len(round_) == replicas for round_ in probe_rounds)
    failovers = int(stats["failovers"])

    verdict["schedule"] = {
        "kill_at": kill_at, "kill_replica": f"r{kill_idx}",
        "route_log": route_log, "failovers": failovers,
    }
    verdict["fleet"] = {
        "served": sum(1 for r in results if r is not None),
        "failed": failed, "probe_rounds": len(probe_rounds),
    }
    verdict["ledger"] = {
        "table_bytes_serving": table_line_mid,
        "expected_shard_bytes": expected_shard,
        "after_reference_close": ledger_after_ref,
        "table_bytes_after_close": table_after_close,
        "total_bytes_after_close": ledger_after_close,
    }
    invariants = {
        "zero_failed_requests": failed == 0,
        "scores_bit_identical": identical,
        "failover_observed": failovers >= 1,
        "tables_charged_per_shard": table_line_mid == expected_shard,
        "ledger_reconciles_on_close": (ledger_after_ref == 0
                                       and ledger_after_close == 0
                                       and table_after_close == 0
                                       and _no_placement_left(
                                           verdict["ranks"])),
        "replicas_stay_probed": probed_ok,
        "no_unhandled_exceptions": not errors,
    }
    verdict["invariants"] = invariants
    verdict["restated"] = {"ledger_reconciles_on_close": list(_RECONCILED)}
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())
    return _conclude(verdict, outdir, "recommender", seed)


def run_reshard_scenario(seed: int, outdir: str, replicas: int = 3,
                         requests: int = 24,
                         mesh_to: str = "") -> Dict[str, Any]:
    """Kill a replica MID-RESHARD; the elastic mesh loses nothing.

    The robustness half of ``Fleet.reshard``: while the fleet moves every
    replica from the single-device placement onto ``mesh_to`` (default
    :data:`RESHARD_MESH`, tensor 2 on ranks 0-1, named under the
    verdict's ``restated``; this process leads the ranks,
    :func:`_mesh_leader`) under fire, one
    seeded replica is killed without drain — timed to land INSIDE the
    reshard, after the first replica starts draining and before the
    victim's own turn in the swap order.

    1. **reference** — the full request stream scored on an untouched
       single :class:`~mmlspark_tpu_torch.serve.server.Server`: the
       numerics ground truth for BOTH placements (the reshard contract is
       that placement never moves a bit).
    2. **fleet under fire** — the same stream through a
       ``replicas``-wide fleet; at a seeded request the reshard starts
       in a background thread, a watcher kills the victim the instant
       the first replica's router weight drops to zero (the reshard's
       first observable action), and the client keeps submitting through
       the whole reshard window behind a :class:`RetryPolicy`. The three
       threads share the leader's command channel, ordered by its lock.
    3. **post-reshard** — the stream once more, wholly on the new
       placement.

    Invariants (verdict JSON, ``outdir/chaos_verdict.json``):

    - ``zero_failed_requests``   — no request failed in any phase: not
      during the swaps, not from the kill, not on the new placement;
    - ``scores_bit_identical``   — under-fire results == reference, row
      for row, through drain/swap/kill/failover;
    - ``scores_bit_identical_post_reshard`` — the resharded fleet still
      matches the reference bit-for-bit;
    - ``reshard_survived_kill``  — the survivors all finished
      (``status="resharded"``), the victim was recorded dead (``died`` /
      ``skipped_dead``), and the fleet landed on ``mesh_to``;
    - ``kill_landed_mid_reshard`` — the watcher really fired inside the
      reshard window;
    - ``fired_through_reshard``  — requests were served WHILE the
      reshard was in flight (zero-downtime is a claim about the whole
      window, not its endpoints);
    - ``params_charged_while_serving`` / ``ledger_reconciles_on_close``
      — the leader's HBM ledger carried ``kind="params"`` bytes while
      serving and holds ZERO bytes of any kind after close, and no
      placement is left on any rank (restated: the followers' shards are
      outside that ledger): neither the dead replica nor the replaced
      old-placement entries leak;
    - ``victim_probed_dead``     — the router's probe answers ``dead``
      for the victim (dead replicas answer, never wedge);
    - ``no_unhandled_exceptions``.

    The schedule (reshard point, victim, per-replica statuses) is a pure
    function of ``seed`` — the tier-1 smoke test asserts byte-identical
    replay. The kill triggers off the FIRST replica's drain and the
    victim is never that replica, so the victim is already dead when the
    swap order reaches it: ``skipped_dead``, deterministically.
    """
    import threading
    import time as _time

    import numpy as np

    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability import memory as devmem
    from mmlspark_tpu_torch.reliability.retry import RetryPolicy
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.serve.server import Server

    os.makedirs(outdir, exist_ok=True)
    errors: List[str] = []
    ch = _mesh_leader("reshard")
    mesh_to = mesh_to or RESHARD_MESH
    verdict: Dict[str, Any] = {
        "seed": seed, "scenario": "reshard", "replicas": replicas,
        "requests": requests, "mesh_to": mesh_to}
    ch.rank_stats(reset=True)

    rng = random.Random(seed ^ 0x4E5A4D)
    probe_every = max(4, replicas + 1)
    reshard_at = rng.randint(requests // 3, (2 * requests) // 3)
    victim = rng.randrange(1, replicas)

    model = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    model.set_model("mlp_tabular", input_dim=_DIM, hidden=[16],
                    num_classes=3, seed=seed & 0xFFFF)
    stream = loadgen.feature_rows(requests, 2, _DIM, seed)

    ledger = devmem.get_ledger()
    ledger.reset()

    # phase 1: untouched single-server reference
    ref_server = Server({"chaos": model}, max_batch=4, queue_depth=32)
    try:
        reference = [np.asarray(ref_server.submit("chaos", x, timeout=30))
                     for x in stream]
    finally:
        ref_server.close()
    ledger_after_ref = int(ledger.total())

    # phase 2: fire through the fleet with a background reshard and a
    # mid-reshard kill; sequential blocking submits keep the request
    # order (and so the bit-identity comparison) deterministic
    fleet = Fleet({"chaos": model}, replicas=replicas,
                  server_kwargs={"max_batch": 4, "queue_depth": 32})
    client_retry = RetryPolicy(max_attempts=4, base_delay=0.0, jitter=0.0,
                               name="chaos.reshard.client", seed=seed)
    results: List[Optional[Any]] = []
    post: List[Optional[Any]] = []
    failed = 0
    probe_rounds: List[Dict[str, str]] = []
    reshard_box: Dict[str, Any] = {}
    kill_box: Dict[str, Any] = {}
    fired_during = 0
    params_serving = 0

    def _do_reshard() -> None:
        try:
            reshard_box["report"] = fleet.reshard(  # lint: allow-actuate
                mesh_to, warm_x=stream[0])
        except Exception as e:
            reshard_box["err"] = e

    def _watch_and_kill() -> None:
        # the reshard's first observable action is draining replica 0
        # (router weight -> 0); the kill fires right then, while the
        # whole swap sequence is still ahead of the victim
        handle = fleet.router._handles[fleet.replicas[0].name]
        deadline = _time.monotonic() + 60
        while _time.monotonic() < deadline:
            if handle.weight == 0.0:
                fleet.kill(victim)  # lint: allow-actuate
                kill_box["killed"] = fleet.replicas[victim].name
                return
            _time.sleep(0.0005)

    reshard_t = threading.Thread(
        target=_do_reshard, daemon=True, name="mmlspark-tpu-chaos-reshard")
    watcher_t = threading.Thread(
        target=_watch_and_kill, daemon=True,
        name="mmlspark-tpu-chaos-reshard-kill")
    try:
        for i, x in enumerate(stream):
            if i % probe_every == 0:
                probe_rounds.append(fleet.router.probe())
            if i == reshard_at:
                watcher_t.start()
                reshard_t.start()
            try:
                results.append(np.asarray(
                    client_retry.call(fleet.submit, "chaos", x)))
            except Exception as e:
                failed += 1
                results.append(None)
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            if reshard_t.is_alive():
                fired_during += 1
        # the reshard (fresh placement and captures per survivor) usually
        # outlives a short stream: keep healthy traffic flowing until it
        # lands — zero-downtime is a claim about the WHOLE window
        spin = itertools.cycle(stream)
        spin_deadline = _time.monotonic() + 120
        while reshard_t.is_alive() and _time.monotonic() < spin_deadline:
            try:
                client_retry.call(fleet.submit, "chaos", next(spin))
                fired_during += 1
            except Exception as e:
                failed += 1
                errors.append(f"recovery: {type(e).__name__}: {e}")
        reshard_t.join(10)
        watcher_t.join(10)
        if reshard_t.is_alive():
            errors.append("reshard wedged: thread still alive")
        if "err" in reshard_box:
            e = reshard_box["err"]
            errors.append(f"reshard raised: {type(e).__name__}: {e}")
        probe_rounds.append(fleet.router.probe())
        params_serving = int(ledger.total(kind="params"))
        # phase 3: the stream once more, wholly on the new placement
        for i, x in enumerate(stream):
            try:
                post.append(np.asarray(
                    client_retry.call(fleet.submit, "chaos", x)))
            except Exception as e:
                failed += 1
                post.append(None)
                errors.append(f"post {i}: {type(e).__name__}: {e}")
    finally:
        fleet.close()
    ledger_after_close = int(ledger.total())
    params_after = int(ledger.total(kind="params"))
    kv_after = int(ledger.total(kind="kv"))
    verdict["ranks"] = _rank_facts(ch, errors)

    identical = all(r is not None and np.array_equal(r, ref)
                    for r, ref in zip(results, reference))
    identical_post = all(r is not None and np.array_equal(r, ref)
                         for r, ref in zip(post, reference))
    report = reshard_box.get("report", {})
    statuses = [{"replica": r.get("replica"), "status": r.get("status")}
                for r in report.get("replicas", [])]
    victim_name = f"r{victim}"
    survivors_ok = (
        bool(statuses)
        and all(s["status"] == "resharded" for s in statuses
                if s["replica"] != victim_name)
        and all(s["status"] in ("died", "skipped_dead") for s in statuses
                if s["replica"] == victim_name)
        and report.get("mesh_shape") == mesh_to
        and getattr(fleet, "mesh_shape", "") == mesh_to)
    victim_dead = (probe_rounds
                   and probe_rounds[-1].get(victim_name) == "dead")

    verdict["schedule"] = {
        "reshard_at": reshard_at, "victim": victim_name,
        "statuses": statuses, "mesh_to": mesh_to,
        "resharded": report.get("resharded"),
    }
    verdict["fleet"] = {
        "served": sum(1 for r in results if r is not None),
        "failed": failed, "probe_rounds": len(probe_rounds),
    }
    verdict["ledger"] = {
        "after_reference_close": ledger_after_ref,
        "params_bytes_serving": params_serving,
        "params_bytes_after_close": params_after,
        "kv_bytes_after_close": kv_after,
        "total_bytes_after_close": ledger_after_close,
    }
    invariants = {
        "zero_failed_requests": failed == 0,
        "scores_bit_identical": identical,
        "scores_bit_identical_post_reshard": identical_post,
        "reshard_survived_kill": survivors_ok,
        "kill_landed_mid_reshard": "killed" in kill_box,
        "fired_through_reshard": fired_during > 0,
        "params_charged_while_serving": params_serving > 0,
        "ledger_reconciles_on_close": (ledger_after_ref == 0
                                       and ledger_after_close == 0
                                       and params_after == 0
                                       and kv_after == 0
                                       and _no_placement_left(
                                           verdict["ranks"])),
        "victim_probed_dead": bool(victim_dead),
        "no_unhandled_exceptions": not errors,
    }
    verdict["invariants"] = invariants
    verdict["restated"] = {
        "ledger_reconciles_on_close": list(_RECONCILED),
        "mesh_to": ["tensor_2_sub_mesh_keeps_gemm_row_counts"]}
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())
    return _conclude(verdict, outdir, "reshard", seed)


def run_decode_scenario(seed: int, outdir: str, replicas: int = 2,
                        requests: int = 5,
                        mesh: str = "") -> Dict[str, Any]:
    """Kill a replica mid-GENERATION; every sequence still completes.

    Generation raises the stakes over the scoring-fleet scenario: a
    sequence killed mid-decode loses its KV pages and its sampled prefix
    — there is nothing to resume, only a RESTART from the prompt on a
    survivor. The invariant that makes that restart correct is seeded
    sampling: tokens are a pure function of (seed, position), so the
    survivor replays the exact stream the dead replica was producing.

    1. **reference** — every request generated on a single
       :class:`~mmlspark_tpu_torch.serve.server.Server`: the token ground truth.
    2. **fleet** — the same requests through a ``replicas``-wide
       :class:`~mmlspark_tpu_torch.serve.fleet.Fleet`. One seeded request is
       the victim: while it decodes (a seeded delay on the
       ``generate.step`` fault site keeps it in flight long enough to be
       observable), the harness watches per-replica decode-step counters
       and kills the replica that is actually stepping it. The router
       maps the death to a failover and restarts the sequence from its
       prompt on a survivor.

    Invariants (verdict JSON, ``outdir/chaos_verdict.json``):

    - ``all_sequences_complete`` — every request returned a finished
      token stream (``finish_reason`` length/stop), including the victim;
    - ``tokens_bit_identical``   — fleet tokens == single-server tokens
      for every request, THROUGH the kill and restart;
    - ``failover_observed``      — the kill really forced >= 1 failover;
    - ``no_unhandled_exceptions``— nothing escaped the router/retry
      channel.

    3. **shared-prefix kill** (phase 3) — two sequences ride the SAME
       cached system-prompt blocks (refcount > 1) and one is killed
       mid-stream while holding them. Invariants:

    - ``prefix_sharing_observed``   — the sharers really held common
      blocks with refcount > 1 when the kill landed;
    - ``prefix_refcounts_reconcile``— after the survivor finishes, the
      block ledger is empty (``used_blocks == 0``) and conservation
      holds (every block in exactly one of free/cached/refcounted);
    - ``no_leaked_kv_bytes``        — the HBM ledger's ``kind="kv"``
      charge still equals the arena's real byte footprint (the fixed
      arena neither grew nor lost accounting through the kill);
    - ``prefix_restart_bit_identical`` — resubmitting the killed request
      (the restart) and the surviving sharer both emit token streams
      bit-identical to a prefix-cache-OFF reference server.

    With ``mesh`` (``decode_sharded``, :data:`SHARDED_MESH`) the model
    decodes over that mesh of ranks, this process leading them, its KV
    arena head-sharded over ``tensor``: the ledger's ``kind="kv"`` line
    and ``no_leaked_kv_bytes`` hold the leader's shard of it. The
    verdict's ``ranks`` holds every rank's kernel launches and the
    placements left on each.
    """
    import threading

    import numpy as np

    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.serve.server import Server
    from mmlspark_tpu_torch.utils import config as mmlconfig

    os.makedirs(outdir, exist_ok=True)
    errors: List[str] = []
    verdict: Dict[str, Any] = {
        "seed": seed, "scenario": "decode_sharded" if mesh else "decode",
        "replicas": replicas, "requests": requests, "mesh": mesh}
    ch = _mesh_leader("decode_sharded") if mesh else None
    if ch is not None:
        ch.rank_stats(reset=True)

    rng = random.Random(seed ^ 0xDEC0DE)
    kill_req = rng.randint(requests // 3, max(requests // 3,
                                              (2 * requests) // 3))
    prompts = loadgen.token_prompts(requests, rng, vocab=200,
                                    min_len=3, max_len=8)
    # the victim generates long enough that the kill lands mid-decode;
    # decode lengths are scenario parameters, not a payload stream
    max_new = [24 if i == kill_req else rng.randint(4, 8)  # lint: allow-handload
               for i in range(requests)]

    # a tiny arena keeps compile cost down; restore the config afterwards
    prior = {k: mmlconfig.get(k) for k in
             ("generate.max_seq_len", "generate.max_sequences",
              "generate.kv_block_tokens")}
    mmlconfig.set("generate.max_seq_len", 64)
    mmlconfig.set("generate.max_sequences", 4)
    mmlconfig.set("generate.kv_block_tokens", 8)
    # sharded variant: a 2-D (data x tensor) mesh-bound model whose KV
    # arena is head-sharded over the tensor axis — the kill, failover
    # restart, and shared-prefix ledger invariants must all hold with
    # every rank holding only its param + KV shard
    model = TorchModel(**({"meshSpec": mesh} if mesh else {})).set_model(
        "transformer_lm_tiny", seed=seed & 0xFFFF)

    reference: List[List[int]] = []
    results: List[Optional[Dict[str, Any]]] = []
    killed_replica = ""
    failovers = 0
    route_log: List[str] = []
    try:
        # phase 1: single-server token ground truth
        ref_server = Server({"lm": model})
        try:
            for i in range(requests):
                reference.append(ref_server.generate(
                    "lm", prompts[i], max_new_tokens=max_new[i],
                    seed=seed + i, timeout=60)["tokens"])
        finally:
            ref_server.close()

        # phase 2: the same requests through the fleet; the victim is
        # killed mid-decode and must complete via failover-restart
        fleet = Fleet({"lm": model}, replicas=replicas)
        fleet.router.route_log = route_log
        try:
            for i in range(requests):
                if i != kill_req:
                    try:
                        results.append(fleet.submit_generate(
                            "lm", prompts[i], max_new_tokens=max_new[i],
                            seed=seed + i))
                    except Exception as e:
                        results.append(None)
                        errors.append(
                            f"request {i}: {type(e).__name__}: {e}")
                    continue
                # victim request: client in a thread, kill from here the
                # moment a replica's decode-step counter moves for it
                base = {r.name: (r.server._lanes["lm"].steps
                                 if "lm" in r.server._lanes else 0)
                        for r in fleet.replicas}
                box: Dict[str, Any] = {}

                def _client(idx=i):
                    try:
                        box["out"] = fleet.submit_generate(
                            "lm", prompts[idx],
                            max_new_tokens=max_new[idx], seed=seed + idx)
                    except Exception as e:   # recorded, not swallowed
                        box["err"] = e

                plan = FaultPlan(FaultSpec(
                    "generate.step", on_hit=1, times=10_000,
                    action="delay", delay=0.002))
                with plan:
                    t = threading.Thread(
                        target=_client, daemon=True,
                        name="mmlspark-tpu-chaos-decode-client")
                    t.start()
                    import time as _time
                    deadline = _time.monotonic() + 30
                    while (not killed_replica
                           and _time.monotonic() < deadline):
                        for j, rep in enumerate(fleet.replicas):
                            lane = rep.server._lanes.get("lm")
                            if (lane is not None
                                    and lane.steps > base[rep.name]):
                                fleet.kill(j)  # lint: allow-actuate
                                killed_replica = rep.name
                                break
                        _time.sleep(0.0005)
                    t.join(60)
                if not killed_replica:
                    errors.append("kill never landed: no replica was "
                                  "observed decoding the victim")
                if t.is_alive():
                    errors.append(f"request {i}: victim client wedged")
                    results.append(None)
                elif "err" in box:
                    results.append(None)
                    errors.append(f"request {i} (victim): "
                                  f"{type(box['err']).__name__}: "
                                  f"{box['err']}")
                else:
                    results.append(box.get("out"))
            failovers = int(fleet.router.stats()["failovers"])
        finally:
            fleet.close()

        # phase 3: kill a sequence HOLDING SHARED PREFIX BLOCKS.
        # Deterministic single server, manually stepped (no threads): two
        # sharers ride one system prompt's cached KV; one dies mid-decode
        # with refcount > 1 on the shared blocks; the survivor and the
        # restarted victim must both stay bit-identical, and the block +
        # HBM ledgers must reconcile to the token.
        verdict["prefix"] = _run_shared_prefix_kill(
            model, rng, seed, errors)
    except Exception as e:
        errors.append(f"decode scenario: {type(e).__name__}: {e}")
    finally:
        for k, v in prior.items():
            mmlconfig.set(k, v)
    if ch is not None:
        verdict["ranks"] = _rank_facts(ch, errors)

    finished = [r is not None and r.get("finish_reason")
                in ("length", "stop") for r in results]
    identical = (len(results) == len(reference)
                 and all(r is not None and r["tokens"] == ref
                         for r, ref in zip(results, reference)))
    verdict["schedule"] = {
        "kill_request": kill_req, "killed_replica": killed_replica,
        "max_new": max_new, "route_log": route_log,
        "failovers": failovers,
    }
    verdict["decode"] = {
        "completed": sum(finished),
        "finish_reasons": [r.get("finish_reason") if r else None
                           for r in results],
        "ttft_ms": [round(r["ttft_ms"], 3) if r else None
                    for r in results],
    }
    invariants = {
        "all_sequences_complete": bool(results) and all(finished),
        "tokens_bit_identical": identical,
        "failover_observed": failovers >= 1,
        "no_unhandled_exceptions": not errors,
    }
    invariants.update(verdict.get("prefix", {}).get("invariants", {}))
    verdict["invariants"] = invariants
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())

    return _conclude(verdict, outdir, "decode", seed)


def _run_shared_prefix_kill(model, rng, seed: int,
                            errors: List[str]) -> Dict[str, Any]:
    """Phase 3 of the decode scenario: kill a sequence that is HOLDING
    shared prefix blocks (refcount > 1) mid-stream.

    Deterministic by construction — one :class:`Server` stepped by hand,
    no threads, the kill landed at an exact step boundary — so a red
    verdict here is a real ledger bug, never scheduling noise. See
    :func:`run_decode_scenario` for the invariants.
    """
    from mmlspark_tpu_torch.observability import memory as devmem
    from mmlspark_tpu_torch.serve.server import Server
    from mmlspark_tpu_torch.utils import config as mmlconfig

    bt = int(mmlconfig.get("generate.kv_block_tokens"))
    # one shared system prompt of 3 full KV blocks, from the shared-prefix
    # population vocabulary (rank-0 prefix of a 1-prefix population)
    sysp = loadgen.PromptPopulation(
        rng, prefixes=1, prefix_tokens=3 * bt, vocab=200).prefix(0)
    pa, pb = sysp + [11, 12], sysp + [21, 22]
    max_new = 10

    def _stepped(srv, lane, prompt, sd):
        fut = srv.submit_generate("lm", prompt, max_new_tokens=max_new,
                                  seed=sd)
        for _ in range(96):
            if fut.done():
                break
            lane.step()
        return fut.result(1)["tokens"]

    # independent token ground truth: a reference server with the
    # prefix cache OFF (no sharing anywhere in its decode path)
    prior = mmlconfig.get("generate.prefix_cache")
    mmlconfig.set("generate.prefix_cache", False)
    try:
        ref_srv = Server({"lm": model}, start=False)
        try:
            ref_lane = ref_srv.enable_generate("lm", start=False)
            ref_a = _stepped(ref_srv, ref_lane, pa, seed + 101)
            ref_b = _stepped(ref_srv, ref_lane, pb, seed + 102)
        finally:
            ref_srv.close()
    finally:
        mmlconfig.set("generate.prefix_cache", prior)

    sharing = reconciled = identical = leak_ok = False
    victim_surfaced = False
    shared_blocks = 0
    stats: Dict[str, Any] = {}
    srv = Server({"lm": model}, start=False)
    try:
        lane = srv.enable_generate("lm", start=False)
        kv = lane.gen.kv
        ledger = devmem.get_ledger()
        charged0 = ledger.total(model="lm", kind="kv")
        # warm the prefix index, then run both sharers together
        _stepped(srv, lane, sysp + [1], seed + 100)
        fa = srv.submit_generate("lm", pa, max_new_tokens=max_new,
                                 seed=seed + 101)
        fb = srv.submit_generate("lm", pb, max_new_tokens=max_new,
                                 seed=seed + 102)
        lane.step()          # both admitted, riding the cached prefix
        lane.step()          # ... and decoding: the kill lands MID-stream
        victim = next((s for s in lane.batcher.active if s.future is fa),
                      None)
        if victim is None:
            errors.append("prefix kill: victim never reached the batch")
        else:
            shared = [b for b in kv.blocks_for(victim.seq_id)
                      if kv.block_refcount(b) > 1]
            shared_blocks = len(shared)
            sharing = bool(shared)
            lane._fail_seq(victim, RuntimeError("chaos: killed mid-stream"))
            lane.batcher.leave(victim)
        for _ in range(96):  # the survivor decodes on, unperturbed
            if fb.done():
                break
            lane.step()
        toks_b = fb.result(1)["tokens"]
        try:
            fa.result(0)
        except RuntimeError:
            victim_surfaced = True   # the kill reported, not swallowed
        # the restart: resubmit the killed request from its prompt
        toks_a = _stepped(srv, lane, pa, seed + 101)
        identical = (toks_a == ref_a) and (toks_b == ref_b)
        reconciled = kv.used_blocks == 0 and kv.check_conservation()
        charged1 = ledger.total(model="lm", kind="kv")
        # per-SHARD footprint: for a head-sharded arena (decode_sharded)
        # the ledger charges what one chip actually holds, not the
        # logical total; equal to arena_bytes() when unsharded
        leak_ok = (charged1 == kv.arena_shard_bytes()
                   and charged1 == charged0)
        stats = {k: v for k, v in lane.stats().items()
                 if k.startswith(("prefix", "cow", "kv."))}
    except Exception as e:
        errors.append(f"prefix kill: {type(e).__name__}: {e}")
    finally:
        srv.close()
    return {
        "shared_blocks_at_kill": shared_blocks,
        "stats": stats,
        "invariants": {
            "prefix_sharing_observed": sharing,
            "prefix_refcounts_reconcile": reconciled,
            "no_leaked_kv_bytes": leak_ok,
            "prefix_restart_bit_identical": identical,
            "victim_error_surfaced": victim_surfaced,
        },
    }


# -- fleetprefix scenario ----------------------------------------------------

def run_fleetprefix_scenario(seed: int, outdir: str, replicas: int = 3,
                             requests: int = 12) -> Dict[str, Any]:
    """Kill the replica holding the HOTTEST advertised prefix chains.

    The affinity subsystem's chaos counterpart: prefix-digest routing
    deliberately concentrates a Zipf-hot system prompt's KV blocks on
    one replica — which makes that replica's death the worst case the
    "N replicas, one cache" story has to survive. The scenario builds
    exactly that concentration, then kills it mid-stream.

    1. **reference** — every request generated on a single
       :class:`~mmlspark_tpu_torch.serve.server.Server`: the token ground
       truth (and the shared compile cache every fleet replica loads
       from — what makes ``steady_compiles_zero`` assertable).
    2. **warm** — a seeded Zipf :class:`~mmlspark_tpu_torch.testing.loadgen.
       PromptPopulation` round through the fleet under plain WRR (no
       digests exist yet), then one :class:`FleetScraper` scrape pulls
       every replica's advertised chains into the router's
       :class:`~mmlspark_tpu_torch.serve.affinity.AffinityState`.
    3. **kill** — a rank-0 (hottest prefix) victim request is submitted;
       affinity steers it to a deepest-chain leader, and the harness
       kills the replica actually decoding it mid-stream. Failover
       restarts the sequence from its prompt, re-scored against the
       SURVIVORS' digests.
    4. **recover** — a session-keyed round: every session lands on a
       survivor, re-uses cached prefixes, and compiles nothing.

    Invariants (verdict JSON, ``outdir/chaos_verdict.json``):

    - ``all_sequences_complete``  — every request (victim included)
      returned a finished stream: zero failed requests through the kill;
    - ``tokens_bit_identical``    — fleet tokens == single-server tokens
      for every request, through kill, failover, and session rounds;
    - ``victim_routed_to_leader`` — the kill landed on a replica the
      digest scoring named a deepest-chain leader for the victim prompt
      (the router concentrated the hot prefix where it claimed);
    - ``failover_observed``       — the kill really forced >= 1 failover;
    - ``sessions_absorbed``       — no post-kill request routed to the
      dead replica (session ring + candidate filter exclude it);
    - ``hit_rate_recovers``       — the recovery round re-used cached
      prefix blocks on survivors (summed per-request ``prefix_hits`` >
      0);
    - ``steady_compiles_zero``    — survivors absorbed the victim's
      sessions with ZERO new program captures;
    - ``no_unhandled_exceptions`` — nothing escaped the router/retry
      channel.

    Everything — prompts, routing order, the victim, the verdict — is a
    pure function of ``seed``.
    """
    import threading
    import time as _time

    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability.aggregate import FleetScraper
    from mmlspark_tpu_torch.serve import affinity as aff_mod
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.serve.kvcache import prefix_block_hashes
    from mmlspark_tpu_torch.serve.server import Server
    from mmlspark_tpu_torch.utils import config as mmlconfig

    os.makedirs(outdir, exist_ok=True)
    errors: List[str] = []
    verdict: Dict[str, Any] = {"seed": seed, "scenario": "fleetprefix",
                               "replicas": replicas, "requests": requests}

    rng = random.Random(seed ^ 0xAFF1)
    prior = {k: mmlconfig.get(k) for k in
             ("generate.max_seq_len", "generate.max_sequences",
              "generate.kv_block_tokens", "generate.advertise_top_k",
              "fleet.affinity_enabled", "fleet.affinity_min_depth",
              "runtime.compile_cache_dir")}
    mmlconfig.set("generate.max_seq_len", 64)
    mmlconfig.set("generate.max_sequences", 4)
    mmlconfig.set("generate.kv_block_tokens", 8)
    mmlconfig.set("generate.advertise_top_k", 8)
    mmlconfig.set("fleet.affinity_enabled", True)
    mmlconfig.set("fleet.affinity_min_depth", 1)
    mmlconfig.set("runtime.compile_cache_dir",
                  os.path.join(outdir, "compile_cache"))

    bt = 8
    pop = loadgen.PromptPopulation(rng, prefixes=3, prefix_tokens=2 * bt,
                                   vocab=200, zipf_s=1.2)
    warm_prompts = [pop.sample(tail_tokens=2) for _ in range(requests)]
    # the victim rides the HOTTEST prefix; a fixed tail keeps the prompt
    # a pure function of the population (itself a pure function of seed)
    victim_prompt = pop.prefix(0) + [5, 7]
    sess_prompts = [pop.sample(tail_tokens=2)
                    for _ in range(max(2, requests // 2))]

    def _rank(prompt: List[int]) -> int:
        return next(r for r in range(3)
                    if prompt[:2 * bt] == pop.prefix(r))

    # per-request decode lengths: scenario parameters, not a payload
    # stream; the victim decodes long enough for the kill to land
    warm_new = [rng.randint(4, 8) for _ in warm_prompts]  # lint: allow-handload
    sess_new = [rng.randint(4, 8) for _ in sess_prompts]  # lint: allow-handload
    victim_new = 24

    model = TorchModel().set_model("transformer_lm_tiny", seed=seed & 0xFFFF)

    reference: List[List[int]] = []
    results: List[Optional[Dict[str, Any]]] = []
    killed_replica = ""
    leaders: List[str] = []
    failovers = 0
    kill_at = -1
    compile_delta = -1
    recover_hits = -1
    route_log: List[str] = []
    all_prompts = warm_prompts + [victim_prompt] + sess_prompts
    all_new = warm_new + [victim_new] + sess_new
    try:
        # phase 1: single-server token ground truth (+ compile cache)
        ref_server = Server({"lm": model})
        try:
            for i, p in enumerate(all_prompts):
                reference.append(ref_server.generate(
                    "lm", p, max_new_tokens=all_new[i],
                    seed=seed + i, timeout=60)["tokens"])
        finally:
            ref_server.close()

        fleet = Fleet({"lm": model}, replicas=replicas)
        fleet.router.route_log = route_log
        scraper = FleetScraper(fleet)
        try:
            # phase 2: warm round (WRR — nothing advertised yet), then
            # one scrape publishes every replica's digest
            for i, p in enumerate(warm_prompts):
                try:
                    results.append(fleet.submit_generate(
                        "lm", p, max_new_tokens=warm_new[i],
                        seed=seed + i))
                except Exception as e:
                    results.append(None)
                    errors.append(f"warm {i}: {type(e).__name__}: {e}")
            scraper.scrape()
            aff = fleet.router.affinity
            kv_dtype = fleet.replicas[0].server.stats().get(
                "generate.lm.kv.kv_dtype", "float32")
            vh = prefix_block_hashes("lm", str(kv_dtype),
                                     victim_prompt, bt)
            scores = {r.name: aff_mod.score_digest(
                aff.digest_for(r.name, "lm"), vh)
                for r in fleet.replicas}
            best = max(scores.values())
            leaders = sorted(n for n, s in scores.items() if s == best)

            # phase 3: the victim decodes on a deepest-chain leader; the
            # harness kills whichever replica is actually stepping it
            vidx = len(warm_prompts)
            base = {r.name: (r.server._lanes["lm"].steps
                             if "lm" in r.server._lanes else 0)
                    for r in fleet.replicas}
            box: Dict[str, Any] = {}

            def _client():
                try:
                    box["out"] = fleet.submit_generate(
                        "lm", victim_prompt, max_new_tokens=victim_new,
                        seed=seed + vidx)
                except Exception as e:
                    box["err"] = e

            plan = FaultPlan(FaultSpec(
                "generate.step", on_hit=1, times=10_000,
                action="delay", delay=0.002))
            with plan:
                t = threading.Thread(
                    target=_client, daemon=True,
                    name="mmlspark-tpu-chaos-fleetprefix-client")
                t.start()
                deadline = _time.monotonic() + 30
                while (not killed_replica
                       and _time.monotonic() < deadline):
                    for j, rep in enumerate(fleet.replicas):
                        lane = rep.server._lanes.get("lm")
                        if (lane is not None
                                and lane.steps > base[rep.name]):
                            fleet.kill(j)  # lint: allow-actuate
                            killed_replica = rep.name
                            kill_at = len(route_log)
                            break
                    _time.sleep(0.0005)
                t.join(60)
            if not killed_replica:
                errors.append("kill never landed: no replica was "
                              "observed decoding the victim")
            if t.is_alive():
                errors.append("victim client wedged")
                results.append(None)
            elif "err" in box:
                results.append(None)
                errors.append(f"victim: {type(box['err']).__name__}: "
                              f"{box['err']}")
            else:
                results.append(box.get("out"))

            # phase 4: session-keyed recovery round on the survivors —
            # fresh digests first, then zero new compiles allowed
            scraper.scrape()
            survivors = [r for r in fleet.replicas if not r._dead]
            pre = {r.name: int(r.server.stats().get(
                "registry.compiles", 0)) for r in survivors}
            hits = 0
            for i, p in enumerate(sess_prompts):
                gi = vidx + 1 + i
                try:
                    out = fleet.submit_generate(
                        "lm", p, max_new_tokens=sess_new[i],
                        seed=seed + gi, session=f"sess{_rank(p)}")
                    results.append(out)
                    hits += int(out.get("prefix_hits", 0))
                except Exception as e:
                    results.append(None)
                    errors.append(f"session {i}: {type(e).__name__}: {e}")
            recover_hits = hits
            compile_delta = sum(
                int(r.server.stats().get("registry.compiles", 0))
                - pre[r.name] for r in survivors)
            failovers = int(fleet.router.stats()["failovers"])
            verdict["affinity"] = fleet.router.affinity.snapshot()
        finally:
            fleet.close()
    except Exception as e:
        errors.append(f"fleetprefix scenario: {type(e).__name__}: {e}")
    finally:
        for k, v in prior.items():
            mmlconfig.set(k, v)

    finished = [r is not None and r.get("finish_reason")
                in ("length", "stop") for r in results]
    identical = (len(results) == len(reference)
                 and all(r is not None and r["tokens"] == ref
                         for r, ref in zip(results, reference)))
    post_kill = route_log[kill_at:] if kill_at >= 0 else []
    verdict["schedule"] = {
        "killed_replica": killed_replica, "leaders": leaders,
        "victim_rank": 0, "kill_at": kill_at, "route_log": route_log,
        "warm_new": warm_new, "sess_new": sess_new,
        "failovers": failovers,
    }
    verdict["recover"] = {"prefix_hits": recover_hits,
                          "compile_delta": compile_delta}
    invariants = {
        "all_sequences_complete": bool(results) and all(finished),
        "tokens_bit_identical": identical,
        "victim_routed_to_leader": bool(killed_replica)
        and killed_replica in leaders,
        "failover_observed": failovers >= 1,
        "sessions_absorbed": bool(post_kill)
        and killed_replica not in post_kill,
        "hit_rate_recovers": recover_hits > 0,
        "steady_compiles_zero": compile_delta == 0,
        "no_unhandled_exceptions": not errors,
    }
    verdict["invariants"] = invariants
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())

    return _conclude(verdict, outdir, "fleetprefix", seed)


# -- host scenario -----------------------------------------------------------

# the worker's bucket ladder in the process scenarios: a fresh worker must
# capture one program per bucket and nothing more
_WORKER_BUCKETS = (1, 2, 4)


def _build_dir_listing() -> List[Any]:
    """Every file under ``kernels/_build/``: name, size, mtime (ns)."""
    from mmlspark_tpu_torch.kernels.build import BUILD_DIR
    if not BUILD_DIR.is_dir():
        return []
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in BUILD_DIR.iterdir())


def _fresh_worker_facts(rep, row, errors: List[str]) -> Dict[str, float]:
    """Score one batch of every bucket size on the worker behind ``rep``
    (each builds that bucket's program once; a bucket built already is
    not built again), then read its own ``/metrics``: the programs it
    captured (``compile_cache.bypasses``, one a build) and the ``nvcc``
    processes it started (``kernels.nvcc_runs``)."""
    import urllib.request

    import numpy as np

    from mmlspark_tpu_torch.observability.aggregate import (
        parse_prometheus_text)
    for b in _WORKER_BUCKETS:
        x = np.resize(np.asarray(row), (b,) + np.asarray(row).shape[1:])
        y = np.asarray(rep.submit("chaos", x))
        if y.shape[0] != b:
            errors.append(f"fresh worker: bucket {b}: wrong shape "
                          f"{y.shape}")
    with urllib.request.urlopen(f"{rep.addr}/metrics", timeout=10) as resp:
        parsed = parse_prometheus_text(resp.read().decode())
    return {key: float(parsed.get(name, {}).get("value", 0.0))
            for key, name in (("captures", "compile_cache_bypasses"),
                              ("nvcc_runs", "kernels_nvcc_runs"))}


def _restated_fresh_worker(facts: Dict[str, float], build_before,
                           build_after) -> Dict[str, bool]:
    """The three conditions a fresh worker is held to in place of the
    reference's warm cache load."""
    return {
        "fresh_worker_captures_exactly_buckets":
            facts.get("captures") == float(len(_WORKER_BUCKETS)),
        "kernel_build_dir_unchanged": build_before == build_after,
        "no_nvcc_runs": facts.get("nvcc_runs") == 0.0,
    }


def _worker_env() -> Dict[str, str]:
    """The worker processes run on this process's ``runtime.device``."""
    from mmlspark_tpu_torch.utils import config
    return {"MMLSPARK_TPU_TORCH_RUNTIME_DEVICE":
            str(config.get("runtime.device"))}


class _DeadHandle:
    """Fake worker handle that is already dead at birth: the crash-loop
    stimulus for the supervisor's breaker hysteresis (phase B of the host
    scenario). Satisfies the duck-typed handle protocol."""

    def __init__(self, pid: int):
        self.pid = pid
        self.addr = ""

    def poll(self) -> int:
        return 1

    def wait(self, timeout: Optional[float] = None) -> int:
        return 1

    def terminate(self) -> None:
        pass

    def kill(self) -> None:
        pass

    def close(self) -> None:
        pass


class _CrashSpawner:
    """Spawner whose every child dies instantly; counts spawns so the
    no-flapping invariant is a plain integer comparison."""

    def __init__(self) -> None:
        self.spawns = 0

    def spawn(self, name: str) -> _DeadHandle:
        self.spawns += 1
        return _DeadHandle(40_000 + self.spawns)


def run_host_scenario(seed: int, outdir: str, replicas: int = 2,
                      requests: int = 12) -> Dict[str, Any]:
    """SIGKILL a worker PROCESS under fire; the fleet rides it out warm.

    Unlike the ``fleet`` scenario (in-process replicas, simulated kill),
    every replica here is a real ``mmlspark-tpu-torch serve`` OS process behind
    the :class:`~mmlspark_tpu_torch.serve.supervisor.Supervisor` — the kill is
    a real ``SIGKILL`` (no drain, no goodbye, a torn final event-log
    line), and the restart is a real process cold-start that must come
    back WARM from the shared compile cache.

    **Phase A (real processes):** spawn ``replicas`` workers over a
    shared ``runtime.compile_cache_dir`` and a shared per-pid-sidecar
    events dir; drive a seeded request stream through the Router (client
    retries ride out the failover window); at the seeded ``kill_at`` the
    seeded victim is SIGKILLed; the supervisor backs off, respawns it,
    and re-registers it into rotation; the harness then scores directly
    on the restarted replica and scrapes its ``/metrics`` for
    ``compile_cache_hits``.

    **Phase B (crash-loop hysteresis, virtual clock):** a fake spawner
    whose children die at birth drives the SAME supervisor state machine
    under an injected clock: enough consecutive crashes trip the breaker
    OPEN, the cooldown admits exactly ONE half-open probe respawn, and
    the probe's crash re-opens — restart *flapping* is structurally
    impossible, and the whole phase is deterministic.

    Invariants (verdict JSON, ``outdir/chaos_verdict.json``):

    - ``zero_failed_requests``     — every streamed request scored
      despite the kill (failover + client retry absorbed the window);
    - ``warm_restart`` is restated (a CUDA graph does not serialize, so
      a restarted process cannot load its programs): the restarted
      process captures exactly one program per bucket
      (``fresh_worker_captures_exactly_buckets``), ``kernels/_build/`` is
      unchanged (``kernel_build_dir_unchanged``) and it ran no ``nvcc``
      (``no_nvcc_runs``);
    - ``restart_observed``         — the victim really respawned (new
      pid, same replica name, back in rotation);
    - ``supervisor_events``        — the merged per-pid sidecars carry
      the supervisor's ``spawn``/``exit``/``backoff``/``restart``
      decisions;
    - ``merged_report_coherent``   — one ``build_report`` over all
      sidecars yields a supervisor section whose distinct worker pids
      cover the initial fleet AND the restart;
    - ``crash_loop_breaker_open``  — phase B ends breaker-open, the
      crash-looper held OUT of rotation;
    - ``no_restart_flapping``      — total phase-B spawns ==
      ``breaker_failures + 1`` (the closed-state attempts plus exactly
      one half-open probe) and the cooldown window spawned nothing.

    The ``schedule`` (kill point, victim) is a pure function of ``seed``.
    """
    import time as _time

    import numpy as np

    from mmlspark_tpu_torch.observability.aggregate import (
        expand_event_paths, merge_event_logs)
    from mmlspark_tpu_torch.observability.report import build_report
    from mmlspark_tpu_torch.reliability.retry import RetryPolicy
    from mmlspark_tpu_torch.serve.router import Router
    from mmlspark_tpu_torch.serve.supervisor import ProcessSpawner, Supervisor
    from mmlspark_tpu_torch.utils import config as mmlconfig

    os.makedirs(outdir, exist_ok=True)
    events_dir = os.path.join(outdir, "events")
    cache_dir = os.path.join(outdir, "compile-cache")
    os.makedirs(events_dir, exist_ok=True)
    os.makedirs(cache_dir, exist_ok=True)
    errors: List[str] = []
    verdict: Dict[str, Any] = {"seed": seed, "scenario": "host",
                               "replicas": replicas, "requests": requests}

    rng = random.Random(seed ^ 0x4057)
    kill_at = rng.randint(max(1, requests // 3), max(1, (2 * requests) // 3))
    kill_idx = rng.randrange(replicas)
    kill_name = f"w{kill_idx}"
    verdict["schedule"] = {"kill_at": kill_at, "kill_replica": kill_name}

    model_spec = json.dumps({"input_dim": _DIM, "hidden": [16],
                             "num_classes": 3, "seed": seed & 0xFFFF})
    model_flag = f"chaos=mlp_tabular:{model_spec}"

    # the chaos/supervisor process writes its OWN per-pid sidecar next to
    # the workers' so supervisor.* decisions land in the merged view
    prior_events = mmlconfig.get("observability.events_path")
    mmlconfig.set("observability.events_path",
                  os.path.join(events_dir, f"events-{os.getpid()}.jsonl"))

    names = [f"w{i}" for i in range(replicas)]
    spawner = ProcessSpawner([model_flag], events_dir=events_dir,
                             compile_cache_dir=cache_dir,
                             extra_args=["--max-batch", "4",
                                         "--queue-depth", "32",
                                         "--buckets", ",".join(
                                             map(str, _WORKER_BUCKETS))],
                             env=_worker_env())
    # tight supervision: a SIGKILLed worker respawns within ~50 ms of the
    # reap, and half a second of uptime confirms the incarnation healthy
    sup = Supervisor(spawner, names, min_uptime_s=0.5, base_delay_s=0.05,
                     max_delay_s=0.5, breaker_failures=3,
                     breaker_reset_s=30.0)
    client = RetryPolicy(max_attempts=6, base_delay=0.2, max_delay=2.0,
                         jitter=0.0, name="chaos.host.client", seed=seed)
    stream = loadgen.feature_rows(requests, 2, _DIM, seed)

    served = 0
    failed = 0
    killed_pid: Optional[int] = None
    fresh: Dict[str, float] = {}
    restart_stats: Dict[str, Any] = {}
    build_before = _build_dir_listing()
    router = None
    try:
        sup.start()
        down = [n for n, s in sup.stats()["replicas"].items()
                if not s["running"]]
        if down:
            raise ChaosError(f"workers failed to start: {down} "
                             f"(see {events_dir}/worker-*.log)")
        router = Router(sup.replicas, failover_attempts=replicas + 1)
        sup.attach_router(router)
        router.probe()
        sup.start_monitor(0.05)
        for i, x in enumerate(stream):
            if i == kill_at:
                killed_pid = sup.kill_replica(  # lint: allow-actuate
                    kill_name)
                if killed_pid is None:
                    errors.append("kill landed on a slot with no live "
                                  "process")
            try:
                y = np.asarray(client.call(router.submit, "chaos", x))
                if y.shape[0] == 2:
                    served += 1
                else:
                    failed += 1
                    errors.append(f"request {i}: wrong shape {y.shape}")
            except Exception as e:
                failed += 1
                errors.append(f"request {i}: {type(e).__name__}: {e}")
        # wait for the warm restart (respawn is ~50 ms after the reap; the
        # child's cold-start — imports + cache loads — dominates)
        deadline = _time.monotonic() + 120
        while _time.monotonic() < deadline:
            st = sup.stats()["replicas"][kill_name]
            # ready_spawns (not spawns) is the gate: the respawned pid is
            # alive long before it binds, and only _on_ready guarantees
            # the replica's addr points at the NEW incarnation
            if st["running"] and st["ready_spawns"] >= 2:
                restart_stats = dict(st)
                break
            _time.sleep(0.1)
        if not restart_stats:
            errors.append("killed replica never came back ready")
        else:
            # score every bucket directly on the RESTARTED process, then
            # read its own /metrics: one capture a bucket, no nvcc
            fresh = _fresh_worker_facts(sup.replica(kill_name),
                                        stream[kill_at], errors)
    except Exception as e:
        errors.append(f"host scenario: {type(e).__name__}: {e}")
    finally:
        if router is not None:
            try:
                router.close()
            except Exception as e:
                _LOG.debug("router close failed: %s", e)
        sup.shutdown(reason="chaos host scenario complete")

    verdict["schedule"]["killed_pid"] = killed_pid
    verdict["host"] = {"served": served, "failed": failed,
                       "restart": restart_stats,
                       "restarted_worker": fresh,
                       "buckets": list(_WORKER_BUCKETS),
                       "events_dir": events_dir}

    # merge every per-pid sidecar (workers + supervisor) into ONE view;
    # the SIGKILLed worker's torn final line must be skipped, not fatal
    paths = expand_event_paths(
        [], os.path.join(events_dir, "events-*.jsonl"))
    merged = merge_event_logs(paths)
    sup_event_names = {e.get("name") for e in merged
                       if e.get("type") == "supervisor"}
    report = build_report(paths) if paths else {}
    rep_sup = report.get("supervisor", {}) if isinstance(report, dict) \
        else {}
    worker_pids = rep_sup.get("worker_pids", [])
    coherent = (bool(rep_sup)
                and len(set(worker_pids)) >= replicas + 1
                and rep_sup.get("restarts", 0) >= 1)
    verdict["host"]["sidecars"] = len(paths)
    verdict["host"]["supervisor_event_names"] = sorted(
        n for n in sup_event_names if n)

    # phase B: crash-loop hysteresis on a virtual clock (deterministic)
    vt = {"t": 0.0}
    crash = _CrashSpawner()
    sup2 = Supervisor(crash, ["cl0"], min_uptime_s=5.0, base_delay_s=1.0,
                      max_delay_s=8.0, ready_timeout_s=1.0,
                      breaker_failures=3, breaker_reset_s=60.0,
                      clock=lambda: vt["t"],
                      sleep=lambda s: vt.__setitem__("t", vt["t"] + s))
    sup2.start()
    opened_at: Optional[float] = None
    spawns_at_open = 0
    spawn_trace: List[Any] = []
    for _ in range(200):
        sup2.poll_once()
        state = sup2.breaker_state("cl0")
        spawn_trace.append((vt["t"], crash.spawns, state))
        if opened_at is None and state == "open":
            opened_at = vt["t"]
            spawns_at_open = crash.spawns
        vt["t"] += 1.0
        if opened_at is not None and vt["t"] > opened_at + 75.0:
            break
    sup2.shutdown(reason="chaos host phase B complete")
    final_state = sup2.breaker_state("cl0")
    cooldown_spawns = [s for t, s, _ in spawn_trace
                       if opened_at is not None
                       and opened_at <= t < opened_at + 59.0]
    no_spawn_in_cooldown = bool(cooldown_spawns) \
        and max(cooldown_spawns) == spawns_at_open
    verdict["crash_loop"] = {
        "spawns": crash.spawns, "opened_at": opened_at,
        "spawns_at_open": spawns_at_open, "final_breaker": final_state,
    }

    invariants = {
        "zero_failed_requests": failed == 0 and served == requests,
        **_restated_fresh_worker(fresh, build_before, _build_dir_listing()),
        "restart_observed": bool(restart_stats),
        "supervisor_events": {"spawn", "exit", "backoff",
                              "restart"} <= sup_event_names,
        "merged_report_coherent": coherent,
        "crash_loop_breaker_open": final_state == "open",
        "no_restart_flapping": (crash.spawns == 3 + 1
                                and no_spawn_in_cooldown),
        "no_unhandled_exceptions": not errors,
    }
    verdict["invariants"] = invariants
    verdict["restated"] = {"warm_restart": sorted(_restated_fresh_worker(
        {}, None, None))}
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())

    # restore the prior event sink AFTER the verdict facts are gathered
    mmlconfig.set("observability.events_path", prior_events)

    return _conclude(verdict, outdir, "host", seed)


# -- autopilot scenario ------------------------------------------------------

def _autopilot_drive(model, stream, arrivals, *, kill_round: int,
                     kill_idx: int, replicas: int, policy,
                     events_path: str = "",
                     deadline_s: float = 90.0) -> Dict[str, Any]:
    """One fleet pass through the seeded open-loop schedule — the shared
    driver behind both halves of the autopilot scenario (and the
    ``serving_autopilot`` bench lane). ``policy=None`` is the static
    fleet: same arrivals, same kill, no controller.

    OPEN loop: ``arrivals`` (per-round offered counts, normally
    ``loadgen.bucket_counts`` of a seeded trace) keeps offering no
    matter how wedged the fleet is, and every request's latency is
    measured from its ARRIVAL round — a retry after a kill does not
    restart its clock (the re-enqueue-time accounting this replaces was
    coordinated omission: both halves of the r08 spike read exactly
    90000.0 ms because the deadline clipped what the retries hid). The
    returned ``workload`` dict is the
    :class:`~mmlspark_tpu_torch.observability.goodput.GoodputMeter` verdict:
    goodput under ``deadline_s``, offered/delivered QPS, and the
    un-clipped arrival-time percentiles.

    No executor threads: every replica is a ``start=False``
    :class:`~mmlspark_tpu_torch.serve.server.Server` stepped with
    :meth:`~mmlspark_tpu_torch.serve.server.Server.pump` (one coalesce+flush
    per replica per round), and the autopilot/SLO stack runs on a
    virtual clock advancing 30 s per round — the whole pass is a pure
    function of the schedule, which is what lets the verdict compare
    the two halves shed-for-shed."""
    import numpy as np

    from mmlspark_tpu_torch.control.autopilot import Autopilot
    from mmlspark_tpu_torch.observability.aggregate import FleetScraper
    from mmlspark_tpu_torch.observability.goodput import GoodputMeter
    from mmlspark_tpu_torch.observability.slo import SloEngine
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.serve.server import ServerClosed, ServerOverloaded

    fleet = Fleet({"chaos": model}, replicas=replicas, start=False,
                  server_kwargs={"max_batch": 4, "queue_depth": 8})
    # every founding replica captures its buckets BEFORE the first round
    # (a scaled-up one is warmed like a live one inside scale_up); the
    # captures each replica has when it starts serving are its warm-up,
    # and steady_compiles_zero counts only captures made after it
    row = np.asarray(stream[0])[:1]
    for rep in fleet.replicas:
        entry = rep.server.registry.get("chaos")
        for b in rep.server.buckets:
            entry.program_for(b, np.resize(row, (b,) + row.shape[1:]))
    warm_captures: Dict[str, int] = {}

    def _captures(rep) -> int:
        return int(rep.server.registry.stats()["compiles"])

    def _note_warm() -> None:
        for rep in fleet.replicas:
            warm_captures.setdefault(rep.name, _captures(rep))

    _note_warm()
    vclock = {"t": 1000.0}
    scraper = FleetScraper(fleet, clock=lambda: vclock["t"])
    engine = SloEngine(clock=lambda: vclock["t"],
                       fast_window_s=300.0, slow_window_s=900.0)
    pilot = None
    if policy is not None:
        pilot = Autopilot(fleet, scraper=scraper, engine=engine,
                          policy=policy, clock=lambda: vclock["t"])

    prior_events = None
    if events_path:
        from mmlspark_tpu_torch.utils import config as mmlconfig
        prior_events = mmlconfig.get("observability.events_path")
        mmlconfig.set("observability.events_path", events_path)

    scores: Dict[int, Any] = {}
    lat_rounds: Dict[int, int] = {}
    arrival_round: Dict[int, int] = {}   # intended arrival, NOT re-enqueue
    meter = GoodputMeter(deadline_s=deadline_s, bucket_s=30.0)
    shed = 0
    hard_failed = 0
    pending: List[tuple] = []   # (idx, replica, future, enqueue_round)
    retries: List[int] = []
    decisions: List[Dict[str, Any]] = []
    trace: List[Dict[str, Any]] = []
    next_req = 0

    def _tid(idx: int) -> str:
        return f"q{idx:06d}"

    def enqueue(idx: int, rnd: int) -> None:
        nonlocal shed
        weights = {name: h.get("weight", 0.0) for name, h in
                   fleet.router.stats()["replicas"].items()}
        cands = [r for r in fleet.replicas
                 if not r._dead and weights.get(r.name, 0.0) > 0.0]
        if not cands:
            shed += 1
            meter.shed(_tid(idx))
            return
        # deterministic spread: shortest queue wins, name breaks ties
        rep = min(cands, key=lambda r: (
            r.server.stats().get("queue_depth", 0), r.name))
        try:
            fut = rep.server.submit_async("chaos", stream[idx],
                                          trace_id=_tid(idx))
            pending.append((idx, rep, fut, rnd))
        except (ServerOverloaded, ServerClosed):
            shed += 1
            meter.shed(_tid(idx))

    def step_round(rnd: int, new_arrivals: int) -> None:
        nonlocal pending, hard_failed, retries
        if rnd == kill_round:
            fleet.kill(kill_idx)  # lint: allow-actuate
        this_round, retries = retries, []
        nonlocal next_req
        for idx in range(next_req, next_req + new_arrivals):
            arrival_round[idx] = rnd
            meter.offer(_tid(idx), vclock["t"])
            this_round.append(idx)
        next_req += new_arrivals
        for idx in this_round:
            enqueue(idx, rnd)
        for rep in list(fleet.replicas):
            if not rep._dead:
                try:
                    rep.server.pump(max_batches=1)
                except ServerClosed:  # pragma: no cover - kill race
                    pass
        still: List[tuple] = []
        for idx, rep, fut, enq in pending:
            if fut.done():
                exc = fut.exception()
                if exc is None:
                    scores[idx] = np.asarray(fut.result())
                    # arrival-time truth: the clock started when the
                    # request was OFFERED, not when a retry re-entered
                    lat_rounds[idx] = rnd - arrival_round[idx]
                    meter.complete(_tid(idx), vclock["t"])
                elif isinstance(exc, (ServerOverloaded, ServerClosed)):
                    retries.append(idx)   # the kill shed it; try again
                else:
                    hard_failed += 1
                    meter.expire(_tid(idx))
            elif rep._dead:
                retries.append(idx)       # future died with the replica
            else:
                still.append((idx, rep, fut, enq))
        pending = still
        if pilot is not None:
            decisions.extend(pilot.tick())
            _note_warm()
        else:
            engine.observe(scraper.slo_sample(scraper.scrape()))
        status = engine.status()
        trace.append({
            "round": rnd, "t": vclock["t"],
            "live": sum(1 for r in fleet.replicas
                        if not r._dead and r.health().get("ready")),
            "replicas": len(fleet.replicas),
            "burning": any(s["burning"] for s in status),
            "shed": shed})
        vclock["t"] += 30.0

    try:
        for rnd, n in enumerate(arrivals):
            step_round(rnd, n)
        # drain rounds: no new arrivals, same tick cadence, until every
        # admitted/retried request has resolved (bounded — base load is
        # far below capacity, so a handful of rounds always suffices)
        rnd = len(arrivals)
        while (pending or retries) and rnd < len(arrivals) + 12:
            step_round(rnd, 0)
            rnd += 1

        rstats = fleet.router.stats()["replicas"]
        final = {
            "live_ready": sum(1 for r in fleet.replicas
                              if not r._dead and r.health().get("ready")),
            "replicas": len(fleet.replicas),
            "ready_weights": {r.name: rstats[r.name]["weight"]
                              for r in fleet.replicas
                              if not r._dead and r.name in rstats},
            "dead_weights": {r.name: rstats[r.name]["weight"]
                             for r in fleet.replicas
                             if r._dead and r.name in rstats},
            "capacity_rows": int(fleet.router.fairness.capacity_rows),
            "baseline_rows": int(fleet.router.fairness.baseline_rows),
            # captures made while serving, past each replica's warm-up
            "compiles": sum(_captures(r) - warm_captures[r.name]
                            for r in fleet.replicas),
        }
        # workload verdict (goodput, offered/delivered QPS, un-clipped
        # arrival percentiles) — exported while the event log is still
        # ours so `report` can render the workload section for this run
        workload = meter.export(
            lane="autopilot" if policy is not None else "static")
    finally:
        if events_path:
            from mmlspark_tpu_torch.utils import config as mmlconfig
            mmlconfig.set("observability.events_path", prior_events)
            from mmlspark_tpu_torch.observability import events as _events
            _events.close()
        fleet.close()

    return {"scores": scores, "latency_rounds": lat_rounds,
            "arrival_rounds": arrival_round, "workload": workload,
            "shed": shed, "hard_failed": hard_failed,
            "unresolved": len(pending) + len(retries),
            "decisions": decisions, "trace": trace, "final": final}


def _no_flap(events_path: str, policy) -> Dict[str, Any]:
    """The no-flap check, from the ``autopilot.*`` event stream ALONE
    (not the in-memory decision list): no cooldown key may actuate two
    DIFFERENT actions within one cooldown window — A -> B -> A inside a
    window is the textbook control-loop flap the shared up/down cooldown
    key exists to prevent."""
    from mmlspark_tpu_torch.control.autopilot import cooldown_key
    cooldowns = {"shift": policy.shift_cooldown_s,
                 "scale": policy.scale_cooldown_s,
                 "admission": policy.admission_cooldown_s}
    acted: List[Dict[str, Any]] = []
    suppressed = 0
    with open(events_path) as f:
        for line in f:
            e = json.loads(line)
            if e.get("type") != "autopilot":
                continue
            if e.get("suppressed"):
                suppressed += 1
            else:
                acted.append(e)
    flaps: List[Dict[str, Any]] = []
    last: Dict[str, tuple] = {}   # key -> (action, decision time)
    for e in acted:
        key = cooldown_key(e["lever"], e.get("target", ""))
        cd = cooldowns.get(e["lever"], 0.0)
        prev = last.get(key)
        if prev and prev[0] != e["name"] and e["t"] - prev[1] < cd:
            flaps.append({"key": key, "from": prev[0], "to": e["name"],
                          "dt": e["t"] - prev[1], "cooldown_s": cd})
        last[key] = (e["name"], e["t"])
    return {"actuated_events": len(acted), "suppressed_events": suppressed,
            "flaps": flaps}


def run_autopilot_scenario(seed: int, outdir: str, replicas: int = 3,
                           rounds: int = 40) -> Dict[str, Any]:
    """Close the loop under fire: the same seeded open-loop load spike +
    mid-spike replica kill hits a STATIC fleet and an AUTOPILOTED fleet,
    and the verdict compares them.

    The schedule (pure function of ``seed``): ~2 requests per 30 s
    virtual round of base load, a spike of 18/round for a seeded span,
    and one seeded replica killed without drain inside the spike.
    Capacity is 2 requests per replica per round (``max_batch=4`` rows,
    one pump each), so the spike overruns the static fleet by design.

    Invariants (verdict JSON, ``outdir/chaos_verdict.json``):

    - ``autopilot_sheds_fewer``  — the autopiloted half sheds STRICTLY
      fewer requests than the identically-seeded static half (the
      scale-up lever must actually buy capacity);
    - ``scaled_up_under_spike``  — at least one ``scale_up`` actuated;
    - ``replicas_recovered``     — after the spike the fleet is back to
      exactly ``min_replicas`` ready replicas (scale-down unwound the
      surge, the dead replica stayed dead);
    - ``weights_recovered``      — every ready replica ends at weight
      1.0 and the killed one at 0.0 (the shift lever ramped it out);
    - ``admission_restored``     — the fairness quota is back at its
      baseline (tighten was matched by relax);
    - ``no_flap``                — from the ``autopilot.*`` EVENT STREAM
      alone: no cooldown key actuates two different actions inside one
      cooldown window;
    - ``suppressed_decisions_visible`` — the event stream contains
      considered-but-held decisions (cooldown/window/bounds), proving
      suppression is observable, not silent;
    - ``scores_bit_identical``   — every served score equals the
      single-server reference, through the kill, the scale events and
      the weight shifts;
    - ``steady_compiles_zero``   — the autopiloted half (scale-ups
      included) captured no program while serving: every replica's
      captures happen in its warm-up (founding replicas before the first
      round, scaled-up ones inside ``scale_up``);
    - ``zero_hard_failures`` / ``all_requests_resolved`` — every request
      either served or shed; nothing lost, nothing wedged.
    """
    import numpy as np

    from mmlspark_tpu_torch.control.autopilot import AutopilotPolicy
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve.server import Server

    os.makedirs(outdir, exist_ok=True)
    errors: List[str] = []
    verdict: Dict[str, Any] = {"seed": seed, "scenario": "autopilot",
                               "replicas": replicas, "rounds": rounds}

    rng = random.Random(seed ^ 0xA1707)
    spike_start = rng.randint(6, 9)
    spike_len = rng.randint(6, 9)
    kill_round = spike_start + rng.randint(1, 3)
    kill_idx = rng.randrange(replicas)
    base_rate, spike_rate = 2, 18
    # the open-loop schedule: a seeded Poisson flash-crowd trace from the
    # shared load vocabulary (testing/loadgen), bucketed into 30 s rounds
    # — same (seed, trace) replays the identical schedule, which the
    # fingerprint records
    trace_spec = loadgen.Trace(
        duration_s=rounds * 30.0, rate=base_rate / 30.0, shape="spike",
        spike_start_s=spike_start * 30.0, spike_len_s=spike_len * 30.0,
        spike_factor=spike_rate / base_rate)
    schedule = loadgen.generate(trace_spec, seed)
    arrivals = loadgen.bucket_counts(schedule, 30.0, rounds)
    total_requests = len(schedule)
    verdict["schedule"] = {
        "spike_start": spike_start, "spike_len": spike_len,
        "spike_rate": spike_rate, "base_rate": base_rate,
        "kill_round": kill_round, "kill_replica": f"r{kill_idx}",
        "trace": trace_spec.describe(),
        "fingerprint": loadgen.schedule_fingerprint(schedule),
        "total_requests": total_requests}

    model = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    model.set_model("mlp_tabular", input_dim=_DIM, hidden=[16],
                    num_classes=3, seed=seed & 0xFFFF)
    stream = loadgen.feature_rows(total_requests, 2, _DIM, seed)

    # every fleet server (founding AND autopilot-scaled) must load its
    # bucket programs from the shared on-disk cache the reference server
    # populates — that is what makes steady_compiles_zero assertable
    # through scale_up events
    from mmlspark_tpu_torch.utils import config as mmlconfig
    prior_cache = mmlconfig.get("runtime.compile_cache_dir")
    mmlconfig.set("runtime.compile_cache_dir",
                  os.path.join(outdir, "compile_cache"))
    try:
        # ground truth: the full stream on one server, same model object
        ref_server = Server({"chaos": model}, max_batch=4, queue_depth=32)
        try:
            reference = [np.asarray(
                ref_server.submit("chaos", x, timeout=30))
                for x in stream]
        finally:
            ref_server.close()

        policy = AutopilotPolicy(
            tick_s=30.0, min_replicas=replicas,
            max_replicas=replicas + 3, scale_up_queue=3.0,
            scale_down_queue=0.0, scale_cooldown_s=45.0,
            shift_error_rate=0.5, shift_recover_rate=0.05,
            shift_step=0.5, shift_cooldown_s=30.0, admission_factor=0.5,
            admission_floor_frac=0.25, admission_relax_burn=1.0,
            admission_cooldown_s=45.0, window_s=300.0,
            max_actions_per_window=4)

        static = _autopilot_drive(model, stream, arrivals,
                                  kill_round=kill_round,
                                  kill_idx=kill_idx,
                                  replicas=replicas, policy=None)
        events_path = os.path.join(outdir, "autopilot_events.jsonl")
        if os.path.exists(events_path):
            os.remove(events_path)
        auto = _autopilot_drive(model, stream, arrivals,
                                kill_round=kill_round, kill_idx=kill_idx,
                                replicas=replicas, policy=policy,
                                events_path=events_path)
    finally:
        mmlconfig.set("runtime.compile_cache_dir", prior_cache)

    identical = all(
        np.array_equal(auto["scores"][i], reference[i])
        for i in auto["scores"])
    flap = _no_flap(events_path, policy)
    acted = [d for d in auto["decisions"] if not d.get("suppressed")]
    by_action: Dict[str, int] = {}
    for d in acted:
        by_action[d["action"]] = by_action.get(d["action"], 0) + 1
    fin = auto["final"]

    # time-to-recover: first post-spike round with the surge unwound
    spike_end = spike_start + spike_len
    recover_round = next(
        (e["round"] for e in auto["trace"]
         if e["round"] >= spike_end and e["live"] == replicas),
        rounds)
    verdict["static"] = {"shed": static["shed"],
                         "served": len(static["scores"]),
                         "hard_failed": static["hard_failed"],
                         "workload": static["workload"]}
    verdict["autopilot"] = {
        "shed": auto["shed"], "served": len(auto["scores"]),
        "hard_failed": auto["hard_failed"],
        "workload": auto["workload"],
        "decisions": len(auto["decisions"]),
        "actuated": len(acted), "by_action": by_action,
        "suppressed": flap["suppressed_events"],
        "events_path": events_path,
        "time_to_recover_s": (recover_round - spike_end) * 30.0,
        "final": fin}
    verdict["flaps"] = flap["flaps"]

    invariants = {
        "autopilot_sheds_fewer": auto["shed"] < static["shed"],
        "scaled_up_under_spike": by_action.get("scale_up", 0) >= 1,
        "replicas_recovered": fin["live_ready"] == replicas,
        "weights_recovered": (
            fin["ready_weights"]
            and all(w == 1.0 for w in fin["ready_weights"].values())
            and all(w == 0.0 for w in fin["dead_weights"].values())),
        "admission_restored":
            fin["capacity_rows"] == fin["baseline_rows"],
        "no_flap": not flap["flaps"],
        "suppressed_decisions_visible": flap["suppressed_events"] >= 1,
        "scores_bit_identical":
            identical and len(auto["scores"]) > 0,
        "steady_compiles_zero": fin["compiles"] == 0,
        "zero_hard_failures": (auto["hard_failed"] == 0
                               and static["hard_failed"] == 0),
        "all_requests_resolved": (
            auto["unresolved"] == 0 and static["unresolved"] == 0
            and len(auto["scores"]) + auto["shed"] == total_requests),
    }
    verdict["invariants"] = invariants
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())

    return _conclude(verdict, outdir, "autopilot", seed)


# -- elastic scenario --------------------------------------------------------

def run_elastic_scenario(seed: int, outdir: str, replicas: int = 2,
                         requests: int = 12) -> Dict[str, Any]:
    """SIGKILL a worker mid autopilot-driven scale-up; elasticity holds.

    The supervised-elasticity rung above ``host`` (real-process restart)
    and ``autopilot`` (in-process scale decisions): here the autopilot's
    ``scale_up`` actuates :meth:`~mmlspark_tpu_torch.serve.supervisor.
    Supervisor.add_slot` — a REAL new ``mmlspark-tpu-torch serve`` process —
    and the seeded kill lands while that spawn is still in flight.

    **Phase 1 (warm):** ``replicas`` supervised workers over a shared
    ``runtime.compile_cache_dir`` take a seeded stream through the
    Router, populating the disk cache every later incarnation loads
    from.

    **Phase 2 (elastic scale-up under fire):** an autopilot tick over
    :class:`~mmlspark_tpu_torch.serve.fleet.ProcessFleet` decides ``scale_up``
    (``live < min_replicas``) and spawns ``w<replicas>``; the moment the
    new child has a pid, the seeded victim — the half-spawned slot
    itself, or an existing worker, a coin-flip of the seed — is
    SIGKILLed, with concurrent retrying traffic in flight the whole
    time. The ordinary supervision loop must reconcile desired == live
    with every slot ready (the half-spawned slot either completes
    registration or is reaped and respawned — never a zombie), and the
    scaled-up worker must come up WARM: ``compile_cache_hits > 0`` and
    ``compile_cache_misses == 0`` on its own ``/metrics``.

    **Phase 3 (elastic scale-down):** a second autopilot (its own event
    sidecar) decides ``scale_down`` on the idle fleet; the highest slot
    drains through :meth:`~mmlspark_tpu_torch.serve.supervisor.Supervisor.
    retire_slot` and leaves the router rotation.

    **Phase 4 (replay fidelity):** both pilots' event sidecars are fed
    back through :mod:`mmlspark_tpu_torch.control.replay` — replaying the
    recorded signals under the recorded policy must reproduce each
    recorded decision list byte for byte.

    Invariants (verdict JSON, ``outdir/chaos_verdict.json``):

    - ``zero_failed_requests``  — every streamed request scored despite
      the kill landing mid-scale-up;
    - ``scale_up_actuated``     — exactly one actuated ``scale_up``,
      no actuation error, new slot named ``w<replicas>``;
    - ``kill_landed``           — the seeded SIGKILL hit a live pid;
    - ``desired_equals_live``   — the fleet reconciled to
      ``replicas + 1`` workers, all ready, none mid-spawn;
    - ``killed_slot_respawned`` — the victim slot really respawned;
    - ``no_zombie_in_rotation`` — router rotation == supervised slots,
      every weight restored to 1.0;
    - ``warm_scale_up``         — the new worker loaded programs from
      the shared cache (``compile_cache_hits > 0``);
    - ``steady_compiles_zero``  — and compiled NOTHING
      (``compile_cache_misses == 0``);
    - ``scale_down_retired``    — one actuated ``scale_down`` retired
      the new slot; desired == live == ``replicas``; slot gone from
      rotation;
    - ``replay_fidelity``       — both recorded decision sequences
      replay byte-identical under their recorded policies;
    - ``no_unhandled_exceptions``.

    The ``schedule`` (kill mode + victim) is a pure function of ``seed``.
    """
    import threading
    import time as _time

    import numpy as np

    from mmlspark_tpu_torch.control import replay as _replay
    from mmlspark_tpu_torch.control.autopilot import Autopilot, AutopilotPolicy
    from mmlspark_tpu_torch.reliability.retry import RetryPolicy
    from mmlspark_tpu_torch.serve.fleet import ProcessFleet
    from mmlspark_tpu_torch.serve.router import Router
    from mmlspark_tpu_torch.serve.supervisor import ProcessSpawner, Supervisor
    from mmlspark_tpu_torch.utils import config as mmlconfig

    os.makedirs(outdir, exist_ok=True)
    events_dir = os.path.join(outdir, "events")
    cache_dir = os.path.join(outdir, "compile-cache")
    os.makedirs(events_dir, exist_ok=True)
    os.makedirs(cache_dir, exist_ok=True)
    errors: List[str] = []
    verdict: Dict[str, Any] = {"seed": seed, "scenario": "elastic",
                               "replicas": replicas, "requests": requests}

    new_name = f"w{replicas}"
    rng = random.Random(seed ^ 0xE1A5)
    kill_new = rng.random() < 0.5
    kill_name = new_name if kill_new else f"w{rng.randrange(replicas)}"
    verdict["schedule"] = {
        "kill_replica": kill_name,
        "kill_mode": "half_spawned_slot" if kill_new
        else "existing_worker"}

    model_spec = json.dumps({"input_dim": _DIM, "hidden": [16],
                             "num_classes": 3, "seed": seed & 0xFFFF})
    model_flag = f"chaos=mlp_tabular:{model_spec}"

    # each autopilot phase records to its OWN sidecar so phase 4 can
    # fidelity-check one (policy, ticks, decisions) triple per log
    prior_events = mmlconfig.get("observability.events_path")
    up_log = os.path.join(events_dir, f"pilot-up-{os.getpid()}.jsonl")
    down_log = os.path.join(events_dir, f"pilot-down-{os.getpid()}.jsonl")
    mmlconfig.set("observability.events_path", up_log)

    names = [f"w{i}" for i in range(replicas)]
    spawner = ProcessSpawner([model_flag], events_dir=events_dir,
                             compile_cache_dir=cache_dir,
                             extra_args=["--max-batch", "4",
                                         "--queue-depth", "32",
                                         "--buckets", ",".join(
                                             map(str, _WORKER_BUCKETS))],
                             env=_worker_env())
    sup = Supervisor(spawner, names, min_uptime_s=0.5, base_delay_s=0.05,
                     max_delay_s=0.5, breaker_failures=3,
                     breaker_reset_s=30.0)
    client = RetryPolicy(max_attempts=8, base_delay=0.2, max_delay=2.0,
                         jitter=0.0, name="chaos.elastic.client",
                         seed=seed)
    stream = loadgen.feature_rows(requests, 2, _DIM, seed)
    warm_n = max(2, requests // 3)

    served = 0
    failed = 0
    killed_pid: Optional[int] = None
    fresh: Dict[str, float] = {}
    build_before = _build_dir_listing()
    up_decisions: List[Dict[str, Any]] = []
    down_decisions: List[Dict[str, Any]] = []
    stats_up: Dict[str, Any] = {}
    stats_down: Dict[str, Any] = {}
    rotation_up: Dict[str, Any] = {}
    rotation_down: Dict[str, Any] = {}
    reconciled = False
    router = None
    try:
        sup.start()
        down = [n for n, s in sup.stats()["replicas"].items()
                if not s["running"]]
        if down:
            raise ChaosError(f"workers failed to start: {down} "
                             f"(see {events_dir}/worker-*.log)")
        router = Router(sup.replicas, failover_attempts=replicas + 2)
        sup.attach_router(router)
        router.probe()
        sup.start_monitor(0.05)

        # phase 1: warm the shared compile cache through the original
        # workers so the scaled-up incarnation can come up warm
        for i, x in enumerate(stream[:warm_n]):
            try:
                y = np.asarray(client.call(router.submit, "chaos", x))
                if y.shape[0] == 2:
                    served += 1
                else:
                    failed += 1
                    errors.append(f"request {i}: wrong shape {y.shape}")
            except Exception as e:
                failed += 1
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        # phase 2: one autopilot tick decides scale_up (live < min) and
        # actuates add_slot; the seeded victim is SIGKILLed the moment
        # the new child has a pid, under concurrent retrying traffic
        policy_up = AutopilotPolicy(
            tick_s=1.0, min_replicas=replicas + 1,
            max_replicas=replicas + 2, scale_up_queue=1e6,
            scale_down_queue=0.0, scale_cooldown_s=0.0)
        pilot_up = Autopilot(ProcessFleet(sup, router), policy=policy_up)

        kill_box: Dict[str, Any] = {"pid": None}

        def _killer() -> None:
            deadline = _time.monotonic() + 60.0
            while _time.monotonic() < deadline:
                st = sup.stats()["replicas"].get(new_name)
                if st is not None and st["pid"] is not None:
                    pid = sup.kill_replica(  # lint: allow-actuate
                        kill_name)
                    if pid is not None:
                        kill_box["pid"] = pid
                        return
                _time.sleep(0.005)

        traffic_results: List[Optional[str]] = []

        def _traffic() -> None:
            for i, x in enumerate(stream[warm_n:], warm_n):
                try:
                    y = np.asarray(client.call(router.submit,
                                               "chaos", x))
                    traffic_results.append(
                        None if y.shape[0] == 2
                        else f"request {i}: wrong shape {y.shape}")
                except Exception as e:
                    traffic_results.append(
                        f"request {i}: {type(e).__name__}: {e}")

        killer = threading.Thread(target=_killer, daemon=True)
        traffic = threading.Thread(target=_traffic, daemon=True)
        killer.start()
        traffic.start()
        up_decisions = pilot_up.tick()   # blocks through add_slot
        killer.join(60.0)
        traffic.join(120.0)
        killed_pid = kill_box["pid"]
        if killed_pid is None:
            errors.append("seeded kill never landed on a live pid")
        if traffic.is_alive():
            errors.append("traffic thread wedged")
        for r in traffic_results:
            if r is None:
                served += 1
            else:
                failed += 1
                errors.append(r)

        # reconcile: the supervision loop must close the desired/live
        # gap — every slot ready, nothing mid-spawn, no zombie
        deadline = _time.monotonic() + 120.0
        while _time.monotonic() < deadline:
            st = sup.stats()
            if (st["desired_replicas"] == replicas + 1
                    and st["live_replicas"] == replicas + 1
                    and st["spawns_in_flight"] == 0
                    and all(r["ready_spawns"] == r["spawns"]
                            and r["ready_spawns"] >= 1
                            for r in st["replicas"].values())):
                reconciled = True
                stats_up = st
                break
            _time.sleep(0.05)
        if not reconciled:
            stats_up = sup.stats()
            errors.append(f"fleet never reconciled to {replicas + 1} "
                          f"ready workers: {stats_up['replicas']}")
        rotation_up = {n: dict(r) for n, r in
                       router.stats()["replicas"].items()}

        # fresh-worker check: score every bucket directly on the
        # scaled-up worker, then read its own /metrics — one capture a
        # bucket, no nvcc
        if reconciled:
            fresh = _fresh_worker_facts(sup.replica(new_name), stream[0],
                                        errors)

            # phase 3: a second autopilot (fresh cooldowns, its own
            # sidecar) sees the idle fleet and retires the extra slot
            mmlconfig.set("observability.events_path", down_log)
            policy_down = AutopilotPolicy(
                tick_s=1.0, min_replicas=replicas,
                max_replicas=replicas + 2, scale_up_queue=1e6,
                scale_down_queue=0.0, scale_cooldown_s=0.0)
            pilot_down = Autopilot(ProcessFleet(sup, router),
                                   policy=policy_down)
            down_decisions = pilot_down.tick()  # blocks through retire
            stats_down = sup.stats()
            rotation_down = {n: dict(r) for n, r in
                             router.stats()["replicas"].items()}
    except Exception as e:
        errors.append(f"elastic scenario: {type(e).__name__}: {e}")
    finally:
        if router is not None:
            try:
                router.close()
            except Exception as e:
                _LOG.debug("router close failed: %s", e)
        sup.shutdown(reason="chaos elastic scenario complete")

    # phase 4: each pilot's sidecar must replay byte-identical under
    # its recorded policy — the counterfactual-replay contract, checked
    # against a REAL process-elasticity run rather than a synthetic log
    replay_fidelity: Dict[str, Any] = {}
    replay_ok = True
    for label, p in (("scale_up", up_log), ("scale_down", down_log)):
        try:
            log = _replay.load_log([p]) if os.path.exists(p) else \
                {"policy": None, "ticks": [], "decisions": []}
            if not log["ticks"] or log["policy"] is None:
                replay_fidelity[label] = {"identical": False,
                                          "error": "no recorded ticks"}
                replay_ok = False
                continue
            pol = _replay.policy_from_fields(log["policy"])
            fid = _replay.fidelity_check(
                log["decisions"],
                _replay.replay_decisions(log["ticks"], pol))
            replay_fidelity[label] = {"identical": fid["identical"],
                                      "decisions": fid["recorded"]}
            if not fid["identical"]:
                replay_ok = False
                replay_fidelity[label]["first_diff"] = fid["first_diff"]
        except Exception as e:
            replay_fidelity[label] = {
                "identical": False,
                "error": f"{type(e).__name__}: {e}"}
            replay_ok = False

    actuated_up = [d for d in up_decisions
                   if d["action"] == "scale_up" and not d["suppressed"]]
    actuated_down = [d for d in down_decisions
                     if d["action"] == "scale_down"
                     and not d["suppressed"]]
    verdict["schedule"]["killed_pid"] = killed_pid
    verdict["elastic"] = {
        "served": served, "failed": failed,
        "spawn_to_ready_ms": stats_up.get("spawn_to_ready_ms", {}),
        "new_worker": fresh, "buckets": list(_WORKER_BUCKETS),
        "supervisor_after_scale_up": stats_up.get("replicas", {}),
        "rotation_after_scale_up": sorted(rotation_up),
        "rotation_after_scale_down": sorted(rotation_down),
        "events_dir": events_dir}
    verdict["replay"] = replay_fidelity

    invariants = {
        "zero_failed_requests": failed == 0 and served == requests,
        "scale_up_actuated": (
            len(actuated_up) == 1
            and actuated_up[0].get("replica") == new_name
            and "error" not in actuated_up[0]),
        "kill_landed": killed_pid is not None,
        "desired_equals_live": reconciled,
        "killed_slot_respawned": (
            stats_up.get("replicas", {}).get(kill_name, {})
            .get("spawns", 0) >= 2),
        "no_zombie_in_rotation": (
            sorted(rotation_up) == sorted(stats_up.get("replicas", {}))
            and bool(rotation_up)
            and all(r.get("weight") == 1.0
                    for r in rotation_up.values())),
        **_restated_fresh_worker(fresh, build_before, _build_dir_listing()),
        "scale_down_retired": (
            len(actuated_down) == 1
            and actuated_down[0].get("target") == new_name
            and "error" not in actuated_down[0]
            and stats_down.get("desired_replicas") == replicas
            and stats_down.get("live_replicas") == replicas
            and new_name not in rotation_down),
        "replay_fidelity": replay_ok,
        "no_unhandled_exceptions": not errors,
    }
    verdict["invariants"] = invariants
    restated = sorted(_restated_fresh_worker({}, None, None))
    verdict["restated"] = {"warm_scale_up": restated,
                           "steady_compiles_zero": restated}
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())

    # restore the prior event sink AFTER the verdict facts are gathered
    mmlconfig.set("observability.events_path", prior_events)

    return _conclude(verdict, outdir, "elastic", seed)


# -- the scenario ------------------------------------------------------------

def run_scenario(seed: int, outdir: str, total_steps: int = 8,
                 save_every: int = 2, requests: int = 12) -> Dict[str, Any]:
    """Train-kill-resume-then-serve under a seeded fault schedule; returns
    (and writes to ``outdir/chaos_verdict.json``) the verdict dict."""
    from mmlspark_tpu_torch.utils import config as mmlconfig

    os.makedirs(outdir, exist_ok=True)
    errors: List[str] = []
    # flush interval deliberately COPRIME with save_every: the device
    # metrics ring's flush boundary lands mid-checkpoint-interval, so the
    # bit-identical-resume invariant proves the ring is pure telemetry —
    # where the kill falls relative to a flush must not change the stream
    flush_steps = max(3, save_every * 2 + 1)
    verdict: Dict[str, Any] = {"seed": seed, "total_steps": total_steps,
                               "save_every": save_every,
                               "metrics_flush_steps": flush_steps}

    batch_fn = _batch_fn(seed)
    prior_flush = mmlconfig.get("train.metrics_flush_steps")
    mmlconfig.set("train.metrics_flush_steps", flush_steps)
    chaos_dir = os.path.join(outdir, "chaos")
    plan = generate_train_plan(seed, total_steps)
    bit_identical = False
    final_loads = False
    restarts = 0
    try:
        ref_state, _ = _run_loop_to_completion(
            os.path.join(outdir, "ref"), batch_fn, total_steps, save_every,
            max_restarts=0)
        with plan:
            state, restarts = _run_loop_to_completion(
                chaos_dir, batch_fn, total_steps, save_every,
                max_restarts=len(plan.specs) + 2)
        bit_identical = _bit_identical(state, ref_state)
        final_loads = _final_checkpoint_loads(chaos_dir, state, total_steps)
    except Exception as e:
        errors.append(f"train phase: {type(e).__name__}: {e}")
    finally:
        mmlconfig.set("train.metrics_flush_steps", prior_flush)
    verdict["train"] = {"restarts": restarts, "faults": plan.triggered,
                        "quarantined": _quarantined(chaos_dir)}

    serve_facts: Dict[str, Any] = {}
    try:
        serve_facts = _serve_phase(seed, requests, errors)
    except Exception as e:
        errors.append(f"serve phase: {type(e).__name__}: {e}")
    verdict["serve"] = serve_facts

    invariants = {
        "params_bit_identical": bit_identical,
        "final_checkpoint_loads": final_loads,
        "server_stays_live": bool(serve_facts)
        and serve_facts.get("healthz_bad", 1) == 0
        and serve_facts.get("healthz_ok", 0) > 0,
        "no_unhandled_exceptions": not errors,
    }
    verdict["invariants"] = invariants
    verdict["errors"] = errors
    verdict["passed"] = all(invariants.values())

    return _conclude(verdict, outdir, "", seed)


def run_named(scenario: str, seed: int, outdir: str, *, replicas: int = 3,
              requests: int = 12, total_steps: int = 8,
              save_every: int = 2) -> Dict[str, Any]:
    """Run the registered ``scenario`` (``cli chaos`` dispatches here).
    The :data:`MESH_SCENARIOS` run on rank 0 of a joined channel, inside
    ``parallel.leader.lead()``, and raise anywhere else."""
    if scenario not in SCENARIOS:
        raise KeyError(f"unknown chaos scenario {scenario!r}; have "
                       f"{sorted(SCENARIOS)}")
    if scenario == "train":
        return run_scenario(seed, outdir, total_steps=total_steps,
                            save_every=save_every, requests=requests)
    if scenario == "autopilot":
        return run_autopilot_scenario(seed, outdir, replicas=replicas)
    run = {"fleet": run_fleet_scenario, "decode": run_decode_scenario,
           "fleet_sharded": run_fleet_scenario,
           "decode_sharded": run_decode_scenario,
           "fleetprefix": run_fleetprefix_scenario,
           "host": run_host_scenario,
           "elastic": run_elastic_scenario,
           "recommender": run_recommender_scenario,
           "reshard": run_reshard_scenario}[scenario]
    mesh = {"mesh": SHARDED_MESH} if scenario.endswith("_sharded") else {}
    return run(seed, outdir, replicas=replicas, requests=requests, **mesh)
