"""Replica supervisor: real OS processes, warm restart-on-crash.

The port's copy of ``mmlspark_tpu/serve/supervisor.py``: workers are
``python -m mmlspark_tpu_torch.cli serve`` processes. A restarted worker
cannot load its programs from the compile cache (a CUDA graph holds one
process's device addresses, see :mod:`mmlspark_tpu_torch.compile_cache`),
so it captures them again; the kernels' libraries under ``kernels/_build``
are shared on disk and never rebuilt by a worker. Several workers may
share one card (``devices_per_worker=0``): each has its own CUDA context.

Everything below the :class:`~mmlspark_tpu_torch.serve.router.Router` so far
lived in ONE interpreter — ``InProcessReplica.kill()`` simulates a death
without a process ever dying. This module crosses the real boundary: each
replica is a ``mmlspark-tpu-torch serve`` *process* (its own port, its own
per-pid event-log sidecar, the shared compile-cache setting), and the
:class:`Supervisor` owns its lifecycle:

- **spawn**: :class:`ProcessSpawner` launches ``python -m mmlspark_tpu_torch.cli
  serve --port 0`` and reads the one-line JSON announce from the child's
  stdout to learn the ephemeral port. The child inherits
  ``runtime.compile_cache_dir`` through its environment
  (:func:`mmlspark_tpu_torch.compile_cache.worker_env`); with CUDA
  graphs there is nothing to load, so every incarnation captures its own
  programs and its spawn-to-ready time is reported.
- **supervise**: one :meth:`Supervisor.poll_once` step reaps exits,
  schedules restarts through the existing :class:`RetryPolicy`
  exponential backoff (deterministic, non-blocking — a crash-looping
  replica never stalls supervision of the others), and feeds a
  per-replica :class:`CircuitBreaker`: a child that dies before
  ``fleet.supervisor_min_uptime_s`` counts a failure, enough consecutive
  failures trip the breaker OPEN and the replica leaves the Router
  rotation (weight 0) instead of flapping. After the cooldown the
  breaker's single half-open slot admits exactly ONE probe respawn;
  a probe crash re-opens with a fresh cooldown (the hysteresis).
- **re-register**: a restarted child gets a fresh port; the supervisor
  mutates the replica's :class:`~mmlspark_tpu_torch.serve.router.HttpReplica`
  ``addr`` in place — object identity, router handle, and breaker history
  survive the restart, so failover, fairness, SLO burn, and the
  aggregated dashboard keep working across it.
- **drain**: SIGTERM to the supervisor (via the preemption layer) calls
  :meth:`Supervisor.shutdown`, which SIGTERMs every child (each drains
  through its own preemption handler) and only SIGKILLs stragglers.

- **elasticity**: :meth:`Supervisor.add_slot` grows the fleet by one
  supervised worker (router registration at weight 0 first, then the
  normal announce → ``/readyz`` handshake lifts it to full weight,
  pinned to its own disjoint card slot when ``devices_per_worker`` > 0)
  and :meth:`Supervisor.retire_slot` shrinks it gracefully
  (weight→0, SIGTERM drain, SIGKILL stragglers past
  ``serving.drain_timeout_s``, state + breaker cleaned up). These are
  the process-level actuators the autopilot's scale lever drives
  through :class:`~mmlspark_tpu_torch.serve.fleet.ProcessFleet`.

Decisions are observable: ``supervisor.spawn|ready|exit|backoff|restart|
giveup|add_slot|retire|retire_noop|shutdown`` events flow into the event
log. Clock and
sleep are injectable so the whole restart state machine runs under a
virtual clock in tests.

This module is the one home of process management (``subprocess.Popen``,
``os.kill``) in the serving package.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.reliability.breaker import CircuitBreaker
from mmlspark_tpu_torch.reliability.retry import RetryPolicy
from mmlspark_tpu_torch.serve.router import HttpReplica, ReplicaUnavailable
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.supervisor")


class ProcessWorker:
    """One spawned ``mmlspark-tpu-torch serve`` child process.

    Satisfies the duck-typed worker-handle protocol the
    :class:`Supervisor` supervises (``pid``, ``addr``, ``poll``,
    ``terminate``, ``kill``, ``wait``). A daemon reader thread captures
    the child's one-line JSON announce (``{"serving": "host:port", ...}``)
    and then keeps draining stdout so the pipe never blocks the child.
    """

    def __init__(self, name: str, argv: Sequence[str],
                 env: Optional[Dict[str, str]] = None,
                 log_path: Optional[str] = None,
                 popen: Optional[Callable] = None):
        self.name = name
        self.addr = ""
        self.announce: Dict[str, object] = {}
        self._announced = threading.Event()
        self._log_fh = open(log_path, "ab") if log_path else None
        stderr = self._log_fh if self._log_fh is not None \
            else subprocess.DEVNULL
        # ``popen`` is the transport seam: the multi-host launcher wraps
        # the argv in an ssh invocation while reusing this class's
        # announce-handshake and drain machinery unchanged
        launch = popen if popen is not None else subprocess.Popen
        self.proc = launch(
            list(argv), env=env, stdout=subprocess.PIPE, stderr=stderr,
            text=True)
        self.pid = self.proc.pid
        self._reader = threading.Thread(
            target=self._drain_stdout,
            name=f"mmlspark-tpu-torch-worker-{name}-stdout", daemon=True)
        self._reader.start()

    def _drain_stdout(self) -> None:
        try:
            first = self.proc.stdout.readline()
            try:
                info = json.loads(first)
                if isinstance(info, dict):
                    self.announce = info
                    self.addr = str(info.get("serving", ""))
            except (json.JSONDecodeError, TypeError):
                logger.warning("worker %s: unparseable announce %r",
                               self.name, first[:200])
            self._announced.set()
            for _ in self.proc.stdout:
                pass  # keep the pipe drained; content is the child's log
        except (OSError, ValueError):
            pass  # pipe torn down under us: the child died, poll() reaps
        finally:
            self._announced.set()

    def await_announce(self, timeout: float) -> bool:
        """Wait for the child's announce line; True iff an addr arrived."""
        self._announced.wait(timeout)
        return bool(self.addr)

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self) -> None:
        """SIGTERM: the child's preemption handler drains gracefully."""
        try:
            self.proc.terminate()
        except OSError:
            pass  # already reaped

    def kill(self) -> None:
        """SIGKILL — the host-failure simulation: no drain, no goodbye."""
        try:
            os.kill(self.pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            pass  # already dead; chaos double-kills under race

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None
        self.close()
        return rc

    def close(self) -> None:
        if self._log_fh is not None:
            try:
                self._log_fh.close()
            except OSError:
                pass
            self._log_fh = None


class ProcessSpawner:
    """Factory for :class:`ProcessWorker` children.

    Builds the ``python -m mmlspark_tpu_torch.cli serve`` command line: port 0
    (the child announces its real ephemeral port), ``--events-dir`` so
    every child writes its own ``events-<pid>.jsonl`` sidecar, and the
    shared compile-cache directory exported through the environment so
    restarts load programs instead of compiling them. The package root is
    prepended to ``PYTHONPATH`` so children import the same tree the
    supervisor runs from, and ``PYTHONUNBUFFERED`` guarantees the
    announce line crosses the pipe immediately.
    """

    def __init__(self, model_flags: Sequence[str], *,
                 host: str = "127.0.0.1",
                 events_dir: str = "",
                 compile_cache_dir: Optional[str] = None,
                 extra_args: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None,
                 devices_per_worker: int = 0):
        if not model_flags:
            raise ValueError("spawner needs at least one --model flag")
        self.model_flags = list(model_flags)
        self.host = host
        self.events_dir = events_dir
        self.compile_cache_dir = compile_cache_dir
        self.extra_args = list(extra_args)
        self.env = dict(env or {})
        self.devices_per_worker = int(devices_per_worker)
        # stable name -> slot assignment: a restarted replica keeps ITS
        # chips (first spawn claims the next slot, every respawn reuses
        # it), so two workers never share a chip across restarts
        self._slots: Dict[str, int] = {}

    def build_argv(self, name: str) -> List[str]:
        argv = [sys.executable, "-m", "mmlspark_tpu_torch.cli", "serve",
                "--host", self.host, "--port", "0"]
        for spec in self.model_flags:
            argv += ["--model", spec]
        if self.events_dir:
            argv += ["--events-dir", self.events_dir]
        argv += self.extra_args
        return argv

    def slot_of(self, name: str) -> int:
        """The worker's stable slot index (assigned at first spawn)."""
        slot = self._slots.get(name)
        if slot is None:
            slot = len(self._slots)
            self._slots[name] = slot
        return slot

    def device_env(self, name: str) -> Dict[str, str]:
        """Per-worker accelerator pinning: with ``devices_per_worker=K``,
        slot ``i`` sees chips ``[i*K, (i+1)*K)`` — disjoint visible-device
        sets, so N single-host workers split the host's cards instead of
        all sharing card 0. Exported in every runtime's spelling (as the
        reference does); platforms ignore the vars they don't read. 0 = no
        pinning: the workers share the visible cards, each with its own
        CUDA context."""
        k = self.devices_per_worker
        if k <= 0:
            return {}
        chips = ",".join(str(self.slot_of(name) * k + j) for j in range(k))
        return {"TPU_VISIBLE_CHIPS": chips,
                "CUDA_VISIBLE_DEVICES": chips,
                "HIP_VISIBLE_DEVICES": chips}

    def build_env(self, name: Optional[str] = None) -> Dict[str, str]:
        from mmlspark_tpu_torch import compile_cache
        env = dict(os.environ)
        import mmlspark_tpu_torch as _pkg
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(_pkg.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep \
            + env.get("PYTHONPATH", "") if env.get("PYTHONPATH") \
            else pkg_root
        env["PYTHONUNBUFFERED"] = "1"
        env.update(compile_cache.worker_env(self.compile_cache_dir))
        if name is not None:
            env.update(self.device_env(name))
        env.update(self.env)
        return env

    def spawn(self, name: str) -> ProcessWorker:
        log_path = None
        if self.events_dir:
            os.makedirs(self.events_dir, exist_ok=True)
            log_path = os.path.join(self.events_dir, f"worker-{name}.log")
        return ProcessWorker(name, self.build_argv(name),
                             env=self.build_env(name), log_path=log_path)


class _ReplicaState:
    """Supervisor-side lifecycle state for one replica slot."""

    __slots__ = ("name", "replica", "handle", "started_at", "confirmed",
                 "consecutive", "spawns", "ready_spawns", "next_restart_at",
                 "saved_weight", "gave_up_emitted")

    def __init__(self, name: str, replica: HttpReplica):
        self.name = name
        self.replica = replica
        self.handle = None
        self.started_at = 0.0
        self.confirmed = False       # survived min_uptime this incarnation
        self.consecutive = 0         # crashes since the last confirmed run
        self.spawns = 0
        self.ready_spawns = 0        # incarnations that reached _on_ready
        self.next_restart_at: Optional[float] = None
        self.saved_weight = 1.0
        self.gave_up_emitted = False


def _default_ready(replica: HttpReplica, handle) -> bool:
    try:
        return replica.probe_readyz()
    except ReplicaUnavailable:
        return False


class Supervisor:
    """Restart-on-crash supervision of N replica worker processes.

    One :class:`HttpReplica` object per slot is created at construction
    (placeholder addr until the first announce) — hand ``sup.replicas``
    to the :class:`Router` and :meth:`attach_router` back, and restarts
    re-register transparently: same object, same name, new addr.

    The restart state machine is pure against ``clock``/``sleep`` (both
    injectable) and is stepped by :meth:`poll_once`; :meth:`start_monitor`
    runs it on a daemon thread for real deployments. ``spawner`` is any
    object with ``spawn(name) -> handle``; tests inject fakes, production
    uses :class:`ProcessSpawner`.
    """

    def __init__(self, spawner, names: Sequence[str], *,
                 router=None,
                 min_uptime_s: Optional[float] = None,
                 base_delay_s: Optional[float] = None,
                 max_delay_s: Optional[float] = None,
                 ready_timeout_s: Optional[float] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 ready_fn: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        if not names:
            raise ValueError("supervisor needs at least one replica name")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names in {list(names)!r}")
        self.spawner = spawner
        self.clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self.min_uptime_s = float(
            min_uptime_s if min_uptime_s is not None
            else mmlconfig.get("fleet.supervisor_min_uptime_s"))
        self.ready_timeout_s = float(
            ready_timeout_s if ready_timeout_s is not None
            else mmlconfig.get("fleet.supervisor_ready_timeout_s"))
        base = float(base_delay_s if base_delay_s is not None
                     else mmlconfig.get("fleet.supervisor_base_delay_s"))
        cap = float(max_delay_s if max_delay_s is not None
                    else mmlconfig.get("fleet.supervisor_max_delay_s"))
        # only .delay(attempt) is used: the supervisor schedules restarts
        # on its own clock instead of sleeping inside a policy loop, so a
        # crash-looper's growing backoff never blocks the other replicas
        self._backoff = RetryPolicy(
            max_attempts=1_000_000, base_delay=base, max_delay=cap,
            jitter=0.0, name="supervisor.backoff", clock=self.clock)
        failures = int(
            breaker_failures if breaker_failures is not None
            else mmlconfig.get("fleet.supervisor_breaker_failures"))
        reset_s = float(
            breaker_reset_s if breaker_reset_s is not None
            else mmlconfig.get("fleet.supervisor_breaker_reset_s"))
        self._breaker_failures = failures
        self._breaker_reset_s = reset_s
        self.breakers: Dict[str, CircuitBreaker] = {
            n: CircuitBreaker(f"supervisor.{n}", failure_threshold=failures,
                              reset_timeout_s=reset_s, clock=self.clock)
            for n in names}
        self.replicas: List[HttpReplica] = [
            HttpReplica("127.0.0.1:0", name=n) for n in names]
        self._states: Dict[str, _ReplicaState] = {
            n: _ReplicaState(n, r) for n, r in zip(names, self.replicas)}
        self.router = router
        self._ready_fn = ready_fn if ready_fn is not None else _default_ready
        self._lock = threading.Lock()
        self._closed = False
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._restarts = metrics.counter("supervisor.restarts")
        # elasticity bookkeeping: spawn->ready latencies (ms, most recent
        # first-in) and the names currently mid-retire, both surfaced by
        # stats() for the dashboard/report elasticity panel
        self._ready_ms: List[float] = []
        self._retiring: set = set()

    # -- wiring -------------------------------------------------------------
    def attach_router(self, router) -> None:
        """Give restarts a Router to re-register with (weight restore +
        breaker reset + probe). The Router was necessarily built AFTER
        the replicas it routes to."""
        self.router = router

    def replica(self, name: str) -> HttpReplica:
        return self._states[name].replica

    def breaker_state(self, name: str) -> str:
        return self.breakers[name].state

    def pid(self, name: str) -> Optional[int]:
        h = self._states[name].handle
        return h.pid if h is not None else None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Spawn every replica once. A slot that fails to come ready is
        left to the normal crash accounting in :meth:`poll_once` — start
        never raises for one bad replica."""
        for st in self._states.values():
            self._spawn(st)

    def _spawn(self, st: _ReplicaState) -> bool:
        st.handle = self.spawner.spawn(st.name)
        st.started_at = self.clock()
        st.confirmed = False
        st.spawns += 1
        st.next_restart_at = None
        st.gave_up_emitted = False
        logger.info("spawned replica %s pid=%s attempt=%d",
                    st.name, getattr(st.handle, "pid", None), st.spawns)
        if events.recording_enabled():
            events.emit("supervisor", "spawn", replica=st.name,
                        pid=getattr(st.handle, "pid", None),
                        attempt=st.spawns)
        if not self._wait_ready(st):
            # either the child already died (poll_once reaps and schedules
            # the backoff) or it wedged before ready — kill the wedge so
            # the crash accounting sees a clean exit
            if st.handle is not None and st.handle.poll() is None:
                st.handle.kill()
                st.handle.wait(5.0)
            return False
        self._on_ready(st)
        return True

    def _wait_ready(self, st: _ReplicaState) -> bool:
        deadline = self.clock() + self.ready_timeout_s
        h = st.handle
        if hasattr(h, "await_announce"):
            if not h.await_announce(self.ready_timeout_s):
                return False
        if getattr(h, "addr", ""):
            addr = str(h.addr)
            st.replica.addr = addr if "://" in addr else "http://" + addr
        while self.clock() < deadline:
            if h.poll() is not None:
                return False
            try:
                if self._ready_fn(st.replica, h):
                    return True
            except ReplicaUnavailable:
                pass  # restart window: refused connections are expected
            self._sleep(0.05)
        return False

    def _on_ready(self, st: _ReplicaState) -> None:
        if self.router is not None:
            self.router.set_weight(st.name, st.saved_weight)
            self.router.reset_breaker(st.name)
            try:
                self.router.probe()
            except Exception as e:  # probe must not kill supervision
                logger.warning("post-restart probe failed: %s", e)
        ready_ms = (self.clock() - st.started_at) * 1e3
        self._ready_ms.append(round(ready_ms, 3))
        del self._ready_ms[:-64]   # bounded: the last 64 scale/restart events
        if events.recording_enabled():
            events.emit("supervisor", "ready", replica=st.name,
                        pid=getattr(st.handle, "pid", None),
                        attempt=st.spawns,
                        spawn_to_ready_ms=round(ready_ms, 3))
        if st.spawns > 1:
            self._restarts.inc()
            ready_s = self.clock() - st.started_at
            logger.info("replica %s restarted warm pid=%s in %.2fs",
                        st.name, getattr(st.handle, "pid", None), ready_s)
            if events.recording_enabled():
                events.emit("supervisor", "restart", replica=st.name,
                            pid=getattr(st.handle, "pid", None),
                            attempt=st.spawns, ready_s=round(ready_s, 4))
        # bumped LAST: a stats() reader seeing ready_spawns == spawns
        # knows the CURRENT incarnation's addr and router registration
        # are already in place (stats() deliberately skips the lock so
        # it stays responsive while _wait_ready rides out a cold start)
        st.ready_spawns = st.spawns

    def poll_once(self) -> None:
        """One supervision step: reap exits, confirm uptimes, schedule
        and perform restarts. Deterministic against the injected clock."""
        with self._lock:
            if self._closed:
                return
            for st in self._states.values():
                self._poll_replica(st)

    def _poll_replica(self, st: _ReplicaState) -> None:
        now = self.clock()
        h = st.handle
        if h is not None:
            rc = h.poll()
            if rc is None:
                if not st.confirmed \
                        and now - st.started_at >= self.min_uptime_s:
                    # survived the min uptime: this incarnation is healthy
                    st.confirmed = True
                    st.consecutive = 0
                    self.breakers[st.name].record_success()
                return
            self._on_exit(st, h, rc, now)
            return
        if st.next_restart_at is None or now < st.next_restart_at:
            return
        if not self.breakers[st.name].allow():
            if not st.gave_up_emitted:
                st.gave_up_emitted = True
                logger.warning(
                    "replica %s crash-looping (%d consecutive); breaker "
                    "%s — holding out of rotation", st.name,
                    st.consecutive, self.breakers[st.name].state)
                if events.recording_enabled():
                    events.emit("supervisor", "giveup", replica=st.name,
                                consecutive=st.consecutive,
                                breaker=self.breakers[st.name].state)
            return
        self._spawn(st)

    def _on_exit(self, st: _ReplicaState, h, rc: int, now: float) -> None:
        uptime = now - st.started_at
        st.handle = None
        if hasattr(h, "close"):
            h.close()
        st.consecutive += 1
        self.breakers[st.name].record_failure()
        if self.router is not None:
            w = self.router.stats()["replicas"].get(
                st.name, {}).get("weight", 1.0)
            if w and w > 0:
                st.saved_weight = float(w)
            self.router.set_weight(st.name, 0.0)
        delay = self._backoff.delay(st.consecutive)
        st.next_restart_at = now + delay
        st.gave_up_emitted = False
        logger.warning(
            "replica %s pid=%s exited rc=%s after %.2fs; restart in %.2fs "
            "(crash %d)", st.name, getattr(h, "pid", None), rc, uptime,
            delay, st.consecutive)
        if events.recording_enabled():
            events.emit("supervisor", "exit", replica=st.name,
                        pid=getattr(h, "pid", None), returncode=rc,
                        uptime_s=round(uptime, 4))
            events.emit("supervisor", "backoff", replica=st.name,
                        attempt=st.consecutive, delay_s=round(delay, 4))

    # -- chaos lever --------------------------------------------------------
    def kill_replica(self, name: str) -> Optional[int]:
        """SIGKILL one child — the host-failure chaos lever. Returns the
        pid killed, or None when the slot has no live process (idempotent:
        the host scenario double-kills under race)."""
        st = self._states[name]
        h = st.handle
        if h is None or h.poll() is not None:
            return None
        pid = getattr(h, "pid", None)
        h.kill()
        return pid

    # -- elasticity ---------------------------------------------------------
    def _next_name(self) -> str:
        """Auto-name for a new slot: the smallest ``w<i>`` not in use.
        Caller holds ``self._lock``."""
        i = 0
        while f"w{i}" in self._states or f"w{i}" in self._retiring:
            i += 1
        return f"w{i}"

    def add_slot(self, name: Optional[str] = None) -> str:
        """Grow the fleet by one supervised worker process.

        Registers a fresh :class:`HttpReplica` with the router at weight
        0.0 FIRST (so the restart machinery's weight/breaker calls always
        find the name), then spawns through the normal announce-handshake
        path — :meth:`_on_ready` lifts the weight to 1.0 once ``/readyz``
        answers. A spawn that dies mid-handshake is reconciled by the
        ordinary supervision loop: :meth:`poll_once` reaps it, schedules
        the backoff, and respawns — the slot is never half-registered.
        Returns the new slot's name.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("supervisor is shut down")
            if name is None:
                name = self._next_name()
            if name in self._states:
                raise ValueError(f"replica name {name!r} already in use")
            rep = HttpReplica("127.0.0.1:0", name=name)
            st = _ReplicaState(name, rep)
            self.breakers[name] = CircuitBreaker(
                f"supervisor.{name}",
                failure_threshold=self._breaker_failures,
                reset_timeout_s=self._breaker_reset_s,
                clock=self.clock)
            self._states[name] = st
            self.replicas.append(rep)
        if events.recording_enabled():
            events.emit("supervisor", "add_slot", replica=name,
                        desired=len(self._states))
        logger.info("adding slot %s (desired=%d)", name, len(self._states))
        if self.router is not None:
            self.router.add_replica(rep, weight=0.0)
        self._spawn(st)
        if self._closed and st.handle is not None:
            st.handle.terminate()   # lost the race with shutdown()
        return name

    def retire_slot(self, name: str,
                    drain_timeout_s: Optional[float] = None) -> bool:
        """Shrink the fleet by one worker, gracefully.

        Weight goes to 0 first (no new requests land), then SIGTERM lets
        the child drain through its own preemption handler, SIGKILL
        reaps stragglers past ``serving.drain_timeout_s``, and finally
        the slot's router registration, state, and breaker are removed.
        Idempotent: an unknown or already-retired name emits a
        ``retire_noop`` event and returns False — the autopilot racing a
        crash may double-retire, and that must not throw inside the
        control loop.
        """
        with self._lock:
            st = self._states.get(name)
            if st is None or self._closed:
                if events.recording_enabled():
                    events.emit("supervisor", "retire_noop", replica=name)
                logger.info("retire_slot(%r): no such live slot", name)
                return False
            del self._states[name]
            self._retiring.add(name)
        try:
            if self.router is not None:
                try:
                    self.router.set_weight(name, 0.0)
                except KeyError:
                    pass  # never registered (spawn still in flight)
            h = st.handle
            drained = True
            if h is not None and h.poll() is None:
                timeout = float(
                    drain_timeout_s if drain_timeout_s is not None
                    else mmlconfig.get("serving.drain_timeout_s"))
                h.terminate()
                if h.wait(max(timeout, 0.0)) is None:
                    drained = False
                    logger.warning(
                        "slot %s did not drain in %.1fs; killing",
                        name, timeout)
                    h.kill()
                    h.wait(5.0)
            if h is not None and hasattr(h, "close"):
                h.close()
            if self.router is not None:
                try:
                    self.router.remove_replica(name)
                except KeyError:
                    pass  # never registered
                except ValueError:
                    # last replica: the router refuses to go empty; the
                    # slot stays registered at weight 0 (out of rotation)
                    logger.warning(
                        "slot %s is the router's last replica; left "
                        "registered at weight 0", name)
            with self._lock:
                if st.replica in self.replicas:
                    self.replicas.remove(st.replica)
                self.breakers.pop(name, None)
        finally:
            self._retiring.discard(name)
        if events.recording_enabled():
            events.emit("supervisor", "retire", replica=name,
                        drained=drained, desired=len(self._states))
        logger.info("retired slot %s (drained=%s, desired=%d)",
                    name, drained, len(self._states))
        return True

    # -- monitor thread -----------------------------------------------------
    def start_monitor(self, poll_s: Optional[float] = None) -> None:
        if self._monitor is not None:
            return
        poll = float(poll_s if poll_s is not None
                     else mmlconfig.get("fleet.supervisor_poll_s"))

        def run() -> None:
            while not self._monitor_stop.wait(poll):
                try:
                    self.poll_once()
                except Exception as e:  # supervision outlives one bad round
                    logger.warning("supervision round failed: %s", e)

        self._monitor = threading.Thread(
            target=run, name="mmlspark-tpu-torch-supervisor", daemon=True)
        self._monitor.start()

    def stop_monitor(self) -> None:
        if self._monitor is None:
            return
        self._monitor_stop.set()
        self._monitor.join(timeout=10)
        self._monitor = None
        self._monitor_stop = threading.Event()

    # -- drain --------------------------------------------------------------
    def shutdown(self, reason: str = "shutdown",
                 drain_timeout_s: Optional[float] = None) -> None:
        """SIGTERM every child (each drains through its own preemption
        handler), SIGKILL stragglers past the drain budget, and stop
        restarting. Idempotent — the preemption monitor and the CLI's
        finally block may both call it."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.stop_monitor()
        timeout = float(drain_timeout_s if drain_timeout_s is not None
                        else mmlconfig.get("serving.drain_timeout_s"))
        live = [st for st in self._states.values()
                if st.handle is not None and st.handle.poll() is None]
        for st in self._states.values():
            st.next_restart_at = None
        for st in live:
            st.handle.terminate()
        deadline = self.clock() + max(timeout, 0.0)
        for st in live:
            budget = max(deadline - self.clock(), 0.0)
            if st.handle.wait(budget) is None:
                logger.warning("replica %s did not drain in %.1fs; killing",
                               st.name, timeout)
                st.handle.kill()
                st.handle.wait(5.0)
        if events.recording_enabled():
            events.emit("supervisor", "shutdown", reason=reason,
                        workers=len(live))
        logger.info("supervisor shut down (%s): %d worker(s) stopped",
                    reason, len(live))

    def stats(self) -> Dict[str, object]:
        """Per-replica lifecycle stats plus the fleet-level
        ``desired_replicas`` vs ``live_replicas`` pair — the gap between
        "what the supervisor is supposed to keep running" and "what is
        actually up right now" that scale decisions are judged by."""
        # lock-free on purpose (see _on_ready); add_slot/retire_slot can
        # resize the dict mid-iteration, so snapshot with a short retry
        states: List[_ReplicaState] = []
        for _ in range(8):
            try:
                states = list(self._states.values())
                break
            except RuntimeError:   # dict changed size during iteration
                continue
        reps: Dict[str, object] = {}
        for st in states:
            h = st.handle
            breaker = self.breakers.get(st.name)
            reps[st.name] = {
                "pid": getattr(h, "pid", None) if h is not None else None,
                "running": h is not None and h.poll() is None,
                "spawns": st.spawns,
                "ready_spawns": st.ready_spawns,
                "consecutive_crashes": st.consecutive,
                "breaker": breaker.state if breaker is not None
                else "retired",
                "addr": st.replica.addr,
            }
        ready_ms = sorted(self._ready_ms)
        n = len(ready_ms)

        def _pct(p: float) -> float:
            if not n:
                return 0.0
            return ready_ms[min(n - 1, max(0, int(p / 100.0 * n + 0.5) - 1))]

        return {
            "replicas": reps,
            "desired_replicas": len(states),
            "live_replicas": sum(1 for r in reps.values()
                                 if r["running"]),
            # elasticity: slots mid-spawn (handle live but the current
            # incarnation not yet through _on_ready) / mid-retire, plus
            # the spawn->ready latency distribution over the last 64
            "spawns_in_flight": sum(
                1 for st in states
                if st.handle is not None and st.handle.poll() is None
                and st.ready_spawns < st.spawns),
            "retiring": len(self._retiring),
            "spawn_to_ready_ms": {
                "count": n,
                "p50": round(_pct(50), 3),
                "p99": round(_pct(99), 3),
                "max": round(ready_ms[-1], 3) if n else 0.0,
            },
        }

    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
