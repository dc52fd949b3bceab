"""Multi-host fan-out: one supervisor fleet per machine, one control plane.

The port's copy of ``mmlspark_tpu/serve/launcher.py``; each host runs
``python -m mmlspark_tpu_torch.cli fleet``.

The layer above :class:`~mmlspark_tpu_torch.serve.supervisor.Supervisor` that
the ROADMAP's "beyond one machine" rung requires, kept deliberately
thin: a :class:`HostLauncher` starts one ``mmlspark-tpu-torch fleet`` process
per host (each of which supervises its own worker processes, writes its
own ``supervisor.*`` event sidecars, and fronts its workers with a local
router), reads each fleet's one-line JSON announce to learn its front
address, and exposes the set as plain
:class:`~mmlspark_tpu_torch.serve.router.HttpReplica` objects — the existing
host-agnostic :class:`~mmlspark_tpu_torch.serve.router.Router` /
:class:`~mmlspark_tpu_torch.observability.aggregate.FleetScraper` stitch them
into one control plane with no new code.

The transport is a seam, not a dependency: :class:`LocalExec` runs the
per-host command on this machine (how tests and single-host smoke runs
exercise the exact production wiring), :class:`SshExec` wraps the same
argv in a non-interactive ``ssh`` invocation. Both reuse
:class:`~mmlspark_tpu_torch.serve.supervisor.ProcessWorker`'s announce
handshake and drain machinery through its ``popen=`` parameter.

Like the supervisor, this module is a home of process management; its
levers are ``launch_host`` / ``stop_host``.
"""
from __future__ import annotations

import os
import shlex
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

from mmlspark_tpu_torch.observability import events
from mmlspark_tpu_torch.serve.router import HttpReplica
from mmlspark_tpu_torch.serve.supervisor import ProcessWorker
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.launcher")

_LOCAL_HOSTS = ("local", "localhost", "127.0.0.1")


def parse_hosts(spec: str) -> List[str]:
    """``"h1,h2, h3"`` -> ``["h1", "h2", "h3"]`` (order kept, blanks
    dropped, duplicates rejected — two supervisors on one host would
    fight over chips)."""
    hosts = [h.strip() for h in (spec or "").split(",") if h.strip()]
    if len(set(hosts)) != len(hosts):
        raise ValueError(f"duplicate hosts in {spec!r}")
    return hosts


def read_hosts_file(path: str) -> List[str]:
    """One host per line; blank lines and ``#`` comments skipped."""
    hosts: List[str] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if line:
                hosts.append(line)
    if len(set(hosts)) != len(hosts):
        raise ValueError(f"duplicate hosts in {path}")
    return hosts


class LocalExec:
    """Run the per-host command on THIS machine — the transport tests
    (and single-host smoke runs) use to exercise the exact launcher
    wiring without ssh."""

    def __init__(self, host: str = "local"):
        self.host = host

    def wrap(self, argv: Sequence[str]) -> List[str]:
        return list(argv)

    def popen(self, argv: Sequence[str], **kw):
        return subprocess.Popen(self.wrap(argv), **kw)


class SshExec:
    """Run the per-host command over non-interactive ssh. The remote
    command is shell-quoted verbatim; stdout (the fleet's JSON announce
    + logs) rides the ssh channel back, so the same
    :class:`ProcessWorker` handshake works unchanged. The remote
    environment comes from the remote login profile — ``env`` is
    intentionally NOT forwarded (ssh drops it anyway)."""

    def __init__(self, host: str, ssh_args: Sequence[str] = ()):
        self.host = host
        self.ssh_args = list(ssh_args)

    def wrap(self, argv: Sequence[str]) -> List[str]:
        cmd = " ".join(shlex.quote(a) for a in argv)
        return ["ssh", "-o", "BatchMode=yes", *self.ssh_args,
                self.host, "--", cmd]

    def popen(self, argv: Sequence[str], **kw):
        kw["env"] = None  # remote env comes from the remote profile
        return subprocess.Popen(self.wrap(argv), **kw)


def default_exec_factory(host: str):
    """Local names run locally, anything else goes over ssh."""
    if host in _LOCAL_HOSTS:
        return LocalExec(host)
    return SshExec(host)


class HostLauncher:
    """Fan one ``mmlspark-tpu-torch fleet`` supervisor out per host.

    Each host runs its own supervisor (restart-on-crash, chip pinning,
    per-pid event sidecars under ``<events_dir>/host-<host>/``) and
    fronts its workers behind one announced address; the launcher
    collects those addresses as :class:`HttpReplica` objects for the
    caller's router/scraper. ``exec_factory(host)`` is the transport
    seam — tests inject fakes, production uses
    :func:`default_exec_factory`.
    """

    def __init__(self, hosts: Sequence[str], model_flags: Sequence[str], *,
                 replicas_per_host: Optional[int] = None,
                 events_dir: str = "",
                 extra_args: Sequence[str] = (),
                 exec_factory: Optional[Callable] = None,
                 ready_timeout_s: Optional[float] = None):
        hosts = list(hosts)
        if not hosts:
            raise ValueError("launcher needs at least one host")
        if len(set(hosts)) != len(hosts):
            raise ValueError(f"duplicate hosts in {hosts!r}")
        if not model_flags:
            raise ValueError("launcher needs at least one --model flag")
        self.hosts = hosts
        self.model_flags = list(model_flags)
        self.replicas_per_host = int(
            replicas_per_host if replicas_per_host is not None
            else mmlconfig.get("fleet.replicas"))
        self.events_dir = events_dir
        self.extra_args = list(extra_args)
        self.exec_factory = exec_factory if exec_factory is not None \
            else default_exec_factory
        self.ready_timeout_s = float(
            ready_timeout_s if ready_timeout_s is not None
            else mmlconfig.get("fleet.supervisor_ready_timeout_s"))
        self.workers: Dict[str, ProcessWorker] = {}
        self._replicas: Dict[str, HttpReplica] = {}

    # -- per-host command ---------------------------------------------------
    def host_events_dir(self, host: str) -> str:
        return os.path.join(self.events_dir, f"host-{host}") \
            if self.events_dir else ""

    def build_argv(self, host: str) -> List[str]:
        argv = [sys.executable, "-m", "mmlspark_tpu_torch.cli", "fleet",
                "--replicas", str(self.replicas_per_host)]
        for spec in self.model_flags:
            argv += ["--model", spec]
        hdir = self.host_events_dir(host)
        if hdir:
            argv += ["--events-dir", hdir]
        argv += self.extra_args
        return argv

    # -- levers -------------------------------------------------------------
    def launch_host(self, host: str) -> HttpReplica:
        """Start one host's fleet and wait for its announce; returns the
        host front's :class:`HttpReplica` (name ``host:<host>``)."""
        if host in self.workers:
            raise ValueError(f"host {host!r} already launched")
        ex = self.exec_factory(host)
        hdir = self.host_events_dir(host)
        log_path = None
        if hdir and (host in _LOCAL_HOSTS or isinstance(ex, LocalExec)):
            os.makedirs(hdir, exist_ok=True)
            log_path = os.path.join(hdir, f"fleet-{host}.log")
        w = ProcessWorker(f"host:{host}", self.build_argv(host),
                          env=None, log_path=log_path, popen=ex.popen)
        self.workers[host] = w
        if events.recording_enabled():
            events.emit("launcher", "launch", host=host, pid=w.pid)
        logger.info("launching fleet on %s pid=%s", host, w.pid)
        if not w.await_announce(self.ready_timeout_s):
            raise RuntimeError(
                f"host {host!r} fleet did not announce within "
                f"{self.ready_timeout_s:.0f}s")
        addr = str(w.addr)
        rep = HttpReplica(addr if "://" in addr else "http://" + addr,
                          name=f"host:{host}")
        self._replicas[host] = rep
        return rep

    def stop_host(self, host: str,
                  drain_timeout_s: Optional[float] = None) -> bool:
        """SIGTERM one host's fleet (its supervisor drains its workers),
        SIGKILL past the drain budget. Idempotent on unknown hosts."""
        w = self.workers.pop(host, None)
        self._replicas.pop(host, None)
        if w is None:
            return False
        timeout = float(drain_timeout_s if drain_timeout_s is not None
                        else mmlconfig.get("serving.drain_timeout_s"))
        if w.poll() is None:
            w.terminate()
            if w.wait(max(timeout, 0.0)) is None:
                logger.warning("host %s fleet did not drain in %.1fs; "
                               "killing", host, timeout)
                w.kill()
                w.wait(5.0)
        w.close()
        if events.recording_enabled():
            events.emit("launcher", "stop", host=host)
        logger.info("stopped fleet on %s", host)
        return True

    # -- aggregates ---------------------------------------------------------
    def launch(self) -> List[HttpReplica]:
        """Launch every host; on any failure, stop what already started
        (no half-launched control plane) and re-raise."""
        try:
            return [self.launch_host(h) for h in self.hosts]
        except Exception:
            self.shutdown()
            raise

    def replicas(self) -> List[HttpReplica]:
        return [self._replicas[h] for h in self.hosts
                if h in self._replicas]

    def shutdown(self, drain_timeout_s: Optional[float] = None) -> None:
        for host in list(self.workers):
            self.stop_host(host, drain_timeout_s=drain_timeout_s)

    def stats(self) -> Dict[str, object]:
        return {
            "hosts": {
                h: {"pid": w.pid,
                    "running": w.poll() is None,
                    "addr": str(w.addr),
                    "announce": dict(w.announce)}
                for h, w in self.workers.items()},
            "desired_hosts": len(self.hosts),
            "live_hosts": sum(1 for w in self.workers.values()
                              if w.poll() is None),
        }

    def __enter__(self) -> "HostLauncher":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
