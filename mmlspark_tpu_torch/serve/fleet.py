"""Fleet: N serving replicas behind one router, rolled out without downtime.

The port of ``mmlspark_tpu/serve/fleet.py``'s in-process half: the
deployment-unit layer above :class:`~mmlspark_tpu_torch.serve.server.Server`
(one executor, one bounded queue) and
:class:`~mmlspark_tpu_torch.serve.router.Router` (spread + failover +
fairness):

- :class:`InProcessReplica` — a live :class:`Server` behind the Replica
  protocol, plus ``kill()``: the chaos lever that makes a replica die the
  way a preempted pod does (in-flight work fails retryably, subsequent
  calls are transport-dead), so failover is exercised for real.
- :class:`Fleet` — builds N in-process replicas over the SAME model
  objects and fronts them with a :class:`Router`. The replicas share one
  placed module per model (the ``TorchModel`` memo), but each replica's
  ``Server`` has its own registry and captures its OWN CUDA graphs: a
  graph's static buffers cannot be replayed by two servers at once. Every
  replica's captures and replays take the process-wide
  ``serve/programs.py::DEVICE_LOCK``, so the replicas share the card one
  program at a time.
- :meth:`Fleet.rollout` — the zero-downtime model-version rollout, one
  replica at a time: **deploy** (router weight 0 — no new traffic,
  in-flight finishes) -> **drain** (wait for in-flight 0, generate lanes
  included) -> **swap** (:meth:`ModelRegistry.replace`; a generate lane
  bound to the old entry is closed) -> **warm** (capture the new
  version's programs — the buckets the old entry and lane had built —
  BEFORE the replica takes traffic) -> **shift** (restore weight).

The reference's "N replicas cost one compile" and "no compile through
``scale_up``" hold here as: each replica's captures are counted once, at
its warm-up (:meth:`Fleet.scale_up` warms the new replica with the
programs a live replica has built before it enters the router), and no
replica captures after warm-up. A CUDA graph does not serialize, so the
capture time is paid by every replica and reported, not skipped.
- :meth:`Fleet.reshard` — the same sequence moving every replica onto
  another mesh placement (``parallel/leader.py``): one resharded copy
  per model, shared by the replicas, its lanes rebuilt on the new
  placement; over budget or without the ranks it is a no-op.

- :class:`ProcessFleet` — the same scale surface over a
  :class:`~mmlspark_tpu_torch.serve.supervisor.Supervisor`: each replica is
  a ``python -m mmlspark_tpu_torch.cli serve`` worker process, spawned by
  ``scale_up`` and drained by ``scale_down``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.observability import events
from mmlspark_tpu_torch.serve.router import ReplicaUnavailable, Router
from mmlspark_tpu_torch.serve.server import (
    Server, ServerClosed, ServerOverloaded,
)
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.fleet")

# (kind, bucket) keys of a lane's target programs and of its draft's
_LaneKeys = Tuple[List[Tuple[str, int]], List[Tuple[str, int]]]


class RolloutAborted(RuntimeError):
    """A rollout guard stopped the rollout after the canary took traffic
    on the new version. The canary KEEPS the new version (it is already
    warmed and back in rotation); every replica after it still serves the
    old one. The operator decides between re-running the rollout and
    rolling the canary back."""


class InProcessReplica:
    """One in-process :class:`Server` behind the Replica protocol.

    ``submit`` blocks on the server's future so the router sees a plain
    call with plain exceptions; a replica that has been :meth:`kill`-ed
    (or whose server closed under the request) surfaces as
    :class:`ReplicaUnavailable` — the transport-dead signal the router's
    failover path keys on, distinct from a shed (the server answering
    "full")."""

    def __init__(self, name: str, server: Server):
        self.name = name
        self.server = server
        self._dead = False

    @property
    def capacity_rows(self) -> int:
        return self.server.capacity_rows

    def submit(self, model: str, x, deadline_ms: Optional[float] = None,
               trace_id: str = "") -> np.ndarray:
        if self._dead:
            raise ReplicaUnavailable(f"replica {self.name} is dead")
        try:
            fut = self.server.submit_async(model, x, deadline_ms,
                                           trace_id=trace_id or None)
            return fut.result()
        except ServerClosed as e:
            raise ReplicaUnavailable(
                f"replica {self.name} closed") from e
        except ServerOverloaded as e:
            if self._dead or not self.server.health()["live"]:
                # the kill landed while this request was in flight: its
                # ticket failed retryably, but for the ROUTER this is a
                # dying replica, not a full one — failover, don't shed
                raise ReplicaUnavailable(
                    f"replica {self.name} died mid-request") from e
            raise

    def submit_generate(self, model: str, prompt,
                        max_new_tokens: Optional[int] = None,
                        **kw) -> Dict:
        """Generative counterpart of :meth:`submit`: blocks on the lane's
        future and maps a dead/closed replica to
        :class:`ReplicaUnavailable`. Generation state (KV blocks, sampled
        tokens) dies with the replica, so the router RESTARTS the sequence
        from its prompt on a survivor — seeded sampling makes the replay
        token-identical."""
        if self._dead:
            raise ReplicaUnavailable(f"replica {self.name} is dead")
        try:
            fut = self.server.submit_generate(
                model, prompt, max_new_tokens, **kw)
            return fut.result()
        except ServerClosed as e:
            raise ReplicaUnavailable(
                f"replica {self.name} closed") from e
        except ServerOverloaded as e:
            if self._dead or not self.server.health()["live"]:
                raise ReplicaUnavailable(
                    f"replica {self.name} died mid-generation") from e
            raise

    def health(self) -> Dict[str, object]:
        if self._dead:
            return {"live": False, "ready": False, "state": "dead"}
        return self.server.health()

    def models(self) -> List[str]:
        return self.server.registry.names()

    def kill(self) -> None:
        """Die like a preempted pod: no drain, in-flight tickets fail
        retryably ("retry elsewhere"), health goes dead. Idempotent: a
        second kill is a silent no-op."""
        if self._dead:
            return
        self._dead = True
        logger.warning("replica %s killed", self.name)
        if events.recording_enabled():
            events.emit("fleet", "kill", replica=self.name)
        self.server.close(drain=False, timeout_s=0.5)


class Fleet:
    """N in-process replicas + router + rolling rollout, one object.

    ``models`` maps serving names to fitted models, exactly as
    :class:`Server` takes them; every replica registers the SAME model
    objects. Server knobs (``queue_depth``, ``max_batch``, ...) pass
    through to every replica; router knobs (``failover_attempts``,
    ``tenant_weights``, ...) to the router. ``clock``/``sleep`` are
    injectable for deterministic tests and reach both layers. Replicas
    run on ``runtime.device`` and raise without CUDA as :class:`Server`
    does.
    """

    def __init__(self, models: Dict[str, object], *,
                 replicas: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 start: bool = True,
                 server_kwargs: Optional[Dict] = None,
                 **router_kwargs):
        n = int(replicas if replicas is not None
                else mmlconfig.get("fleet.replicas"))
        if n < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {n}")
        self._sleep = sleep if sleep is not None else time.sleep
        skw = dict(server_kwargs or {})
        skw.setdefault("clock", clock)
        # kept so scale_up() builds replicas identical to the founding set
        self._models = models
        self._server_kwargs = skw
        self._start = start
        self._next_idx = n
        self.servers = [Server(models, start=start, **skw)
                        for _ in range(n)]
        self.replicas = [InProcessReplica(f"r{i}", srv)
                         for i, srv in enumerate(self.servers)]
        self.router = Router(self.replicas, clock=clock, sleep=sleep,
                             **router_kwargs)
        self.mesh_shape: str = ""        # 'DxT[xP]' after a reshard
        self._closed = False

    # -- serving surface (delegates; the HTTP front-end binds the router) --
    def submit(self, model: str, x, deadline_ms: Optional[float] = None,
               **kw) -> np.ndarray:
        return self.router.submit(model, x, deadline_ms, **kw)

    def submit_generate(self, model: str, prompt,
                        max_new_tokens: Optional[int] = None,
                        **kw) -> Dict:
        return self.router.submit_generate(model, prompt,
                                           max_new_tokens, **kw)

    def health(self) -> Dict[str, object]:
        return self.router.health()

    def stats(self) -> Dict[str, object]:
        s = self.router.stats()
        s["servers"] = {r.name: r.server.stats() for r in self.replicas}
        return s

    def kill(self, index: int) -> None:
        """Chaos lever: kill replica ``index`` without telling the router
        — failover and health probing must DISCOVER the death.
        Idempotent like the replica-level kill."""
        self.replicas[index].kill()

    # -- scale actuators ----------------------------------------------------
    def scale_up(self) -> str:
        """Add one replica over the SAME model objects as the founding
        set. Before it enters the router (ready, weight 1.0) it is warmed
        with every program a live replica has built — scoring buckets,
        generate lanes and their programs — so its captures happen here
        and none after. Returns the new replica's name."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        srv = Server(self._models, start=self._start,
                     **self._server_kwargs)
        name = f"r{self._next_idx}"
        self._next_idx += 1
        rep = InProcessReplica(name, srv)
        donor = next((r for r in self.replicas if not r._dead), None)
        if donor is not None:
            self._warm_like(rep, donor)
        self.servers.append(srv)
        self.replicas.append(rep)
        self.router.add_replica(rep)
        if events.recording_enabled():
            events.emit("fleet", "scale_up", replica=name,
                        replicas=len(self.replicas),
                        captures=srv.registry.stats()["compiles"])
        return name

    def scale_down(self, name: str,
                   drain_timeout_s: Optional[float] = None) -> None:
        """Retire one replica gracefully: out of the router rotation
        first (no new traffic), then drain in-flight work, then close its
        server. The inverse of :meth:`scale_up`; killing is what
        :meth:`kill` is for. A no-op (and an event) on an unknown or
        already-retired name."""
        timeout = float(drain_timeout_s if drain_timeout_s is not None
                        else mmlconfig.get("serving.drain_timeout_s"))
        rep = next((r for r in self.replicas if r.name == name), None)
        if rep is None:
            logger.info("scale_down(%r): no such replica (already "
                        "retired?) — no-op", name)
            if events.recording_enabled():
                events.emit("fleet", "scale_down_noop", replica=name,
                            replicas=len(self.replicas))
            return
        self.router.remove_replica(name)
        if not rep._dead:
            try:
                self._wait_idle(rep.server, timeout)
            finally:
                rep.server.close(drain=True)
        self.replicas.remove(rep)
        if rep.server in self.servers:
            self.servers.remove(rep.server)
        if events.recording_enabled():
            events.emit("fleet", "scale_down", replica=name,
                        replicas=len(self.replicas))

    # -- rolling rollout ----------------------------------------------------
    def rollout(self, name: str, model, version: str,
                warm_x=None,
                drain_timeout_s: Optional[float] = None,
                guard: Optional[Callable[[str], Optional[str]]] = None,
                ) -> Dict:
        """Roll ``name`` to ``model``@``version`` across the fleet with
        zero downtime: one replica at a time leaves rotation, drains,
        swaps, warms, and returns — the rest keep serving throughout.

        The warm step captures, before the replica takes traffic, every
        scoring bucket the old entry had built (``warm_x``, a sample row
        or batch, also scores once end to end) and, when the replica ran
        a generate lane for ``name``, a fresh lane over the new entry with
        the programs the old lane had built; then the affinity pre-warm
        replays the fleet's hottest prompt prefixes. The first replica is
        the canary: its warm failure aborts the rollout with every other
        replica still on the old version.

        ``guard`` is called with the replica name AFTER each replica is
        back in rotation on the new version; a non-empty return value
        (the reason) raises :class:`RolloutAborted` before the next
        replica is touched. The report lists each replica's status and
        its captures at warm-up."""
        timeout = float(drain_timeout_s if drain_timeout_s is not None
                        else mmlconfig.get("serving.drain_timeout_s"))
        report: Dict = {"model": name, "version": version, "replicas": []}
        if events.recording_enabled():
            events.emit("rollout", "deploy", model=name, version=version,
                        replicas=len(self.replicas))
        for rep in list(self.replicas):  # scale events must not shift it
            if rep._dead:
                report["replicas"].append(
                    {"replica": rep.name, "status": "skipped_dead"})
                continue
            step = {"replica": rep.name, "status": "updated"}
            weight = self.router._handles[rep.name].weight
            # deploy: out of rotation — no NEW traffic; in-flight finishes
            self.router.set_weight(rep.name, 0.0)
            try:
                self._wait_idle(rep.server, timeout)
                entry = self._swap(rep, name, model, version, warm_x,
                                   timeout)
                step["captures"] = entry.compile_count
            except Exception:
                # canary semantics: put the replica back in rotation on
                # whatever version its registry now holds, then abort —
                # replicas not yet touched still serve the old version
                self.router.set_weight(rep.name, weight)
                if events.recording_enabled():
                    events.emit("rollout", "abort", model=name,
                                version=version, replica=rep.name)
                raise
            # shift: warmed replica takes traffic again
            self.router.set_weight(rep.name, weight)
            if events.recording_enabled():
                events.emit("rollout", "shift", model=name,
                            version=version, replica=rep.name,
                            weight=weight)
            report["replicas"].append(step)
            if guard is not None:
                reason = guard(rep.name)
                if reason:
                    step["status"] = "aborted_after"
                    if events.recording_enabled():
                        events.emit("rollout", "abort", model=name,
                                    version=version, replica=rep.name,
                                    reason=str(reason))
                    raise RolloutAborted(
                        f"rollout of {name}@{version} aborted at "
                        f"{rep.name}: {reason}")
        # replicas added later serve the new version
        self._models = dict(self._models)
        self._models[name] = model
        if events.recording_enabled():
            events.emit("rollout", "done", model=name, version=version,
                        updated=sum(1 for r in report["replicas"]
                                    if r["status"] == "updated"))
        report["versions"] = {r.name: r.server.registry.versions()
                              for r in self.replicas if not r._dead}
        return report

    # -- elastic mesh (the autopilot's fifth lever) -------------------------
    def reshard(self, mesh_shape, *, models: Optional[Sequence[str]] = None,
                warm_x=None,
                drain_timeout_s: Optional[float] = None) -> Dict:
        """Move the SERVING fleet onto another mesh placement with zero
        downtime: each served model's SAME state is placed on the new
        mesh (``meshSpec``), one replica at a time, through
        :meth:`rollout`'s drain -> swap -> warm -> shift.

        ``mesh_shape`` is the ``parallel.mesh_shape`` shorthand (``'2x2'``
        = data 2 x tensor 2, ``'DxTxP'`` with pipe), a
        :class:`~mmlspark_tpu_torch.parallel.mesh.MeshSpec`, or None to
        return to one device. One resharded copy per model is shared by
        every replica: their entries share its placement
        (``parallel/leader.py``: counted on the leader, freed on every
        rank with its last entry). Scores stay bit-identical when the
        split does not reorder a sum (the data axis; a tensor split of a
        layer the module gathers).

        A generate lane drains on the old placement, closes, and is
        rebuilt on the new one (its arena head-sharded there) before the
        replica takes traffic again. The target placement is resolved
        before any replica is touched (a mesh needs the leader's ranks),
        and a copy whose per-device bytes exceed the registry budget
        raises :class:`~mmlspark_tpu_torch.serve.registry.PlacementOverBudget`
        from the first swap, before any entry is dropped: either way the
        reshard is a no-op with every replica serving. A replica killed
        mid-reshard is recorded (``status="died"``) and skipped; one dead
        before is ``skipped_dead``. ``warm_x`` (a sample, or ``{name:
        sample}``) scores once on each swapped replica before it
        re-enters rotation."""
        from mmlspark_tpu_torch.parallel.mesh import (MeshSpec,
                                                      parse_mesh_shape)
        if isinstance(mesh_shape, str) and mesh_shape:
            spec = parse_mesh_shape(mesh_shape)
        elif isinstance(mesh_shape, MeshSpec) or mesh_shape is None \
                or mesh_shape == "":
            spec = mesh_shape or None
        else:
            raise TypeError(
                f"mesh_shape must be a 'DxT[xP]' string, MeshSpec, or "
                f"None; got {type(mesh_shape).__name__}")
        shape_text = self._shape_text(spec)
        timeout = float(drain_timeout_s if drain_timeout_s is not None
                        else mmlconfig.get("serving.drain_timeout_s"))
        names = list(models) if models is not None else sorted(self._models)
        for n in names:
            if n not in self._models:
                raise KeyError(f"unknown model {n!r}; fleet serves "
                               f"{sorted(self._models)}")
        copies = {}
        for n in names:
            m = self._models[n].copy()
            if not hasattr(m, "_resolve_score_mesh"):
                raise TypeError(
                    f"model {n!r} ({type(m).__name__}) does not carry a "
                    "meshSpec param; reshard needs TorchModel-style models")
            m.set_params(meshSpec=spec)
            m._resolve_score_mesh()          # the target exists, or raise
            copies[n] = m
        warm = dict(warm_x) if isinstance(warm_x, dict) else \
            {n: warm_x for n in names}
        report: Dict = {"mesh_shape": shape_text, "models": names,
                        "replicas": []}
        if events.recording_enabled():
            events.emit("reshard", "start", mesh_shape=shape_text,
                        models=names, replicas=len(self.replicas))
        t0 = time.perf_counter()
        for rep in list(self.replicas):  # scale events must not shift it
            if rep._dead:
                report["replicas"].append(
                    {"replica": rep.name, "status": "skipped_dead"})
                continue
            step = {"replica": rep.name, "status": "resharded"}
            weight = self.router._handles[rep.name].weight
            self.router.set_weight(rep.name, 0.0)
            try:
                self._wait_idle(rep.server, timeout)
                for n in names:
                    version = rep.server.registry.versions().get(n, "v1")
                    entry = self._swap(rep, n, copies[n], version,
                                       warm.get(n), timeout)
                    step[f"captures:{n}"] = entry.compile_count
            except Exception as e:
                if rep._dead or not rep.health()["live"]:
                    step["status"] = "died"
                    step["error"] = f"{type(e).__name__}: {e}"
                    report["replicas"].append(step)
                    if events.recording_enabled():
                        events.emit("reshard", "replica_died",
                                    replica=rep.name, mesh_shape=shape_text)
                    continue
                # no-op semantics: back in rotation on its current
                # placement, then surface the failure
                self.router.set_weight(rep.name, weight)
                if events.recording_enabled():
                    events.emit("reshard", "abort", replica=rep.name,
                                mesh_shape=shape_text,
                                reason=f"{type(e).__name__}: {e}")
                raise
            self.router.set_weight(rep.name, weight)
            report["replicas"].append(step)
            if events.recording_enabled():
                events.emit("reshard", "shift", replica=rep.name,
                            mesh_shape=shape_text, weight=weight)
        # scale_up() builds on the new placement, and a repeat reshard
        # copies from the resharded models
        self._models = dict(self._models)
        self._models.update(copies)
        self.mesh_shape = shape_text
        report["resharded"] = sum(1 for r in report["replicas"]
                                  if r["status"] == "resharded")
        report["seconds"] = time.perf_counter() - t0
        if events.recording_enabled():
            events.emit("reshard", "done", mesh_shape=shape_text,
                        resharded=report["resharded"],
                        replicas=len(self.replicas))
        return report

    @staticmethod
    def _shape_text(spec) -> str:
        """Canonical 'DxT[xP]' text of a MeshSpec ('' for None): the
        comparison key of the autopilot's reshard lever."""
        if spec is None:
            return ""
        parts = [spec.data, spec.tensor]
        if spec.pipe != 1:
            parts.append(spec.pipe)
        return "x".join(str(p) for p in parts)

    # -- warm-up ------------------------------------------------------------
    def _swap(self, rep: InProcessReplica, name: str, model, version: str,
              warm_x, timeout_s: float):
        """Swap ``rep``'s entry for ``name`` (drained) to ``model`` and
        warm it: its lane drains and closes (its arena and programs are
        bound to the old entry), the new entry builds the buckets and
        the lane programs the old ones had built. Returns the new entry."""
        lane = rep.server._lanes.get(name)
        keys = None
        if lane is not None:
            self._wait_lane_idle(lane, timeout_s)
            keys = _lane_keys(lane)
        shapes = self._scoring_shapes(rep, name)
        entry = rep.server.registry.replace(name, model, version)
        if lane is not None:
            rep.server.reset_lane(name, timeout_s=timeout_s)
        self._warm(rep, entry, name, warm_x, shapes, keys)
        return entry

    def _wait_lane_idle(self, lane, timeout_s: float) -> None:
        """Bounded wait for a generate lane's in-flight sequences to
        finish. Best-effort: on timeout the lane's close fails the
        stragglers retryably and the router restarts them token-
        identically elsewhere — either way no tokens are lost."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while time.monotonic() < deadline:
            s = lane.stats()
            if s.get("waiting", 0) + s.get("active", 0) \
                    + s.get("prefilling", 0) <= 0:
                return
            self._sleep(0.005)

    def _wait_idle(self, server: Server, timeout_s: float) -> None:
        """Drain: wait for the replica's in-flight scoring count to hit
        zero (admission continues — only the ROUTER stopped sending)."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while server.inflight > 0:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"replica did not drain within {timeout_s:.1f}s "
                    f"({server.inflight} in flight)")
            self._sleep(0.005)

    @staticmethod
    def _scoring_shapes(rep: InProcessReplica, name: str
                        ) -> List[Tuple[Tuple[int, ...], str]]:
        """The padded batch shapes (and dtypes) of the scoring programs
        ``rep``'s entry for ``name`` has built."""
        try:
            entry = rep.server.registry.get(name)
        except KeyError:
            return []
        return list(entry.built_programs())

    def _warm_like(self, rep: InProcessReplica,
                   donor: InProcessReplica) -> None:
        """Build on ``rep`` every program ``donor`` has built: each
        model's scoring buckets, and each generate lane with its target
        and draft programs."""
        for name in donor.server.registry.names():
            shapes = self._scoring_shapes(donor, name)
            lane = donor.server._lanes.get(name)
            keys = _lane_keys(lane) if lane is not None else None
            if not shapes and keys is None:
                continue
            self._build_programs(rep, rep.server.registry.get(name), name,
                                 shapes, keys)

    @staticmethod
    def _build_programs(rep: InProcessReplica, entry, name: str,
                        shapes, keys: Optional[_LaneKeys]) -> None:
        entry.ensure_apply()
        for shape, dtype in shapes:
            entry.program_for(shape[0], np.zeros(shape, dtype))
        if keys is not None:
            lane = rep.server.enable_generate(name)
            for kind, bucket in keys[0]:
                lane.gen.program_for(kind, bucket)
            if lane.draft is not None:
                for kind, bucket in keys[1]:
                    lane.draft.program_for(kind, bucket)

    def _warm(self, rep: InProcessReplica, entry, name: str, warm_x,
              shapes, keys: Optional[_LaneKeys]) -> None:
        """Warm the swapped entry before it takes traffic: the device
        module, the scoring buckets the old entry had built (and one
        end-to-end score of ``warm_x`` when given), a fresh generate lane
        with the programs the old lane had built, then the affinity
        pre-warm. Every capture lands here, counted on the entry
        (``compile_count``) and carried by the warm event."""
        self._build_programs(rep, entry, name, shapes, keys)
        if warm_x is not None:
            rep.submit(name, warm_x)
        self._prewarm_prefixes(rep, name)
        if events.recording_enabled():
            events.emit("rollout", "warm", model=name,
                        version=entry.version, replica=rep.name,
                        warmed=warm_x is not None,
                        compile_cache_hits=entry.cache_hits,
                        compiles=entry.compile_count)

    def _prewarm_prefixes(self, rep: InProcessReplica, name: str) -> None:
        """Affinity pre-warm: before a swapped replica takes weight,
        replay the fleet's hottest advertised prefix chains through its
        prefill so the canary re-enters rotation already holding the KV
        blocks the router will score it on. Best-effort on every axis: no
        affinity state, no hot prompts, or a model without a generate lane
        all mean "skip", never "abort the rollout"."""
        aff = getattr(self.router, "affinity", None)
        if aff is None:
            return
        limit = int(mmlconfig.get("fleet.affinity_prewarm"))
        prompts = aff.hot_prompts(name, limit) if limit > 0 else []
        if not prompts:
            return
        warmed = 0
        for prompt in prompts:
            try:
                rep.server.submit_generate(
                    name, prompt, max_new_tokens=1).result()
                warmed += 1
            except Exception:
                continue    # one cold prompt is not a rollout failure
        if events.recording_enabled():
            events.emit("rollout", "prewarm", model=name,
                        replica=rep.name, prompts=len(prompts),
                        warmed=warmed)

    # -- lifecycle ----------------------------------------------------------
    def drain(self, reason: str = "drain") -> None:
        """Fleet-wide graceful drain (preemption): every live replica
        stops admission, finishes in-flight work, and closes."""
        for rep in self.replicas:
            if not rep._dead:
                rep.server.drain(reason=reason)

    def close(self, drain: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self.router.close()
        for rep in self.replicas:
            if not rep._dead:
                rep.server.close(drain=drain)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ProcessFleet:
    """A supervised process-backed fleet behind the Fleet scale surface.

    The adapter that gives the autopilot real hands: same
    ``scale_up()/scale_down(name)`` actuator signature as :class:`Fleet`,
    but routed through :meth:`~mmlspark_tpu_torch.serve.supervisor.Supervisor.
    add_slot` / :meth:`~mmlspark_tpu_torch.serve.supervisor.Supervisor.
    retire_slot` — each replica is a real OS worker process (which
    captures its own CUDA graphs) drained through SIGTERM. Serving calls
    delegate to the router (the same
    :class:`~mmlspark_tpu_torch.serve.router.HttpReplica` objects the
    supervisor re-registers across restarts), so
    :class:`~mmlspark_tpu_torch.observability.aggregate.FleetScraper` and
    :class:`~mmlspark_tpu_torch.control.autopilot.Autopilot` accept either
    fleet flavor unchanged. Selected by ``autopilot.scale_backend``.
    """

    def __init__(self, supervisor, router: Router):
        self.supervisor = supervisor
        self.router = router
        if getattr(supervisor, "router", None) is None:
            supervisor.attach_router(router)

    @property
    def replicas(self):
        return self.supervisor.replicas

    # -- serving surface ----------------------------------------------------
    def submit(self, model: str, x, deadline_ms: Optional[float] = None,
               **kw) -> np.ndarray:
        return self.router.submit(model, x, deadline_ms, **kw)

    def submit_generate(self, model: str, prompt,
                        max_new_tokens: Optional[int] = None,
                        **kw) -> Dict:
        return self.router.submit_generate(model, prompt,
                                           max_new_tokens, **kw)

    def health(self) -> Dict[str, object]:
        return self.router.health()

    def stats(self) -> Dict[str, object]:
        s = self.router.stats()
        s["supervisor"] = self.supervisor.stats()
        return s

    # -- scale actuators (the autopilot's lever) ----------------------------
    def scale_up(self) -> str:
        """One new supervised worker process: announce handshake,
        ``/readyz``, router registration at full weight, pinned to its own
        card slot when ``fleet.devices_per_worker`` > 0. Returns the new
        slot's name."""
        return self.supervisor.add_slot()

    def scale_down(self, name: str,
                   drain_timeout_s: Optional[float] = None) -> None:
        """Gracefully retire one supervised worker (weight→0, SIGTERM
        drain, SIGKILL stragglers). Idempotent on unknown names, like
        :meth:`Fleet.scale_down`."""
        self.supervisor.retire_slot(name, drain_timeout_s=drain_timeout_s)

    def reshard(self, mesh_shape, **kw):
        """Not yet supported for process-backed fleets: each worker
        process owns its model placement, so an elastic reshard means a
        rolling worker restart under a new ``parallel.mesh_shape`` —
        future work. Raising (instead of silently no-oping) keeps the
        autopilot honest: its actuation is recorded as failed and the
        lever cools down."""
        raise NotImplementedError(
            "ProcessFleet.reshard: restart workers with a new "
            "parallel.mesh_shape instead (rolling, via scale_up/"
            "scale_down); an in-process Fleet reshards its placements")

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        self.supervisor.shutdown(reason="fleet_close")

    def __enter__(self) -> "ProcessFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _lane_keys(lane) -> _LaneKeys:
    """The (kind, bucket) keys of the programs a lane has built, target
    first, then its draft's."""
    draft = lane.draft
    return (sorted(lane.gen.built_programs()),
            sorted(draft.built_programs()) if draft is not None else [])
