"""A pool of ``torch.distributed`` ranks on one host, for tests and checks.

Each rank is a process started with the ``spawn`` method (so it imports
only what it is asked to) that joins a process group over TCP on
``127.0.0.1`` and then runs named functions on request:
``pool.run("module:function", *args)`` calls the function on every rank
with ``(rank, world, *args)`` and returns the ranks' results in rank
order. Torch is imported once a rank, not once a call.

Every wait is bounded: joining the group and each call time out
(``timeout_s``); a rank that fails or times out fails the call, and the
pool then replaces all its ranks (a collective that broke on one rank
leaves the others' group unusable). :meth:`close` reaps every rank.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Dict, List, Optional


def free_port() -> int:
    """A TCP port free on this host now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankError(RuntimeError):
    """A call failed on at least one rank (the message holds each failing
    rank's traceback)."""


def _worker(rank: int, world: int, port: int, env: Dict[str, str],
            paths: List[str], inbox, outbox, timeout_s: float) -> None:
    import datetime
    import importlib
    import sys
    os.environ.update(env)
    sys.path[:0] = [p for p in paths if p not in sys.path]
    try:
        import torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        from mmlspark_tpu_torch.utils import config
        backend = str(config.get("runtime.dist_backend"))
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        outbox.put((rank, "ready", None))
    except BaseException:
        outbox.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = inbox.get()
        if job is None:
            break
        target, args = job
        try:
            mod, _, name = target.partition(":")
            fn = getattr(importlib.import_module(mod), name)
            outbox.put((rank, "ok", fn(rank, world, *args)))
        except BaseException:
            outbox.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` ranks on this host; ``env`` is added to each rank's
    environment (the port's config keys, e.g. ``runtime.device`` and
    ``runtime.dist_backend`` as ``MMLSPARK_TPU_TORCH_*``), ``paths`` to
    its ``sys.path`` (where the named functions' modules live)."""

    def __init__(self, world: int, env: Optional[Dict[str, str]] = None,
                 paths: Optional[List[str]] = None,
                 timeout_s: float = 120.0):
        self.world = world
        self.env = {"MMLSPARK_TPU_TORCH_RUNTIME_DEVICE": "cpu",
                    "MMLSPARK_TPU_TORCH_RUNTIME_DIST_BACKEND": "gloo",
                    **(env or {})}
        self.paths = list(paths or [])
        self.timeout_s = timeout_s
        self._procs: List[Any] = []
        self._start()

    def _start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self._out = ctx.Queue(maxsize=0)
        self._ins = [ctx.Queue(maxsize=0) for _ in range(self.world)]
        self._procs = [
            ctx.Process(target=_worker, daemon=True,
                        args=(r, self.world, port, self.env, self.paths,
                              self._ins[r], self._out, self.timeout_s))
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        try:
            self._collect("ready")
        except BaseException:
            self.close()
            raise

    def _collect(self, what: str) -> List[Any]:
        results: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        deadline = time.monotonic() + self.timeout_s
        while len(results) + len(errors) < self.world:
            missing = sorted(set(range(self.world)) - set(results)
                             - set(errors))
            try:
                rank, kind, value = self._out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in missing if not self._procs[r].is_alive()]
                if dead or time.monotonic() > deadline:
                    why = (f"ranks {dead} died" if dead else
                           f"ranks {missing} gave no answer in "
                           f"{self.timeout_s} s")
                    raise RankError(f"{what}: {why}; failed ranks: "
                                    f"{errors}") from None
                continue
            if kind == "error":
                errors[rank] = value
            else:
                results[rank] = value
        if errors:
            raise RankError(f"{what} failed on ranks {sorted(errors)}:\n"
                            + "\n".join(f"-- rank {r}:\n{t}"
                                        for r, t in sorted(errors.items())))
        return [results[r] for r in range(self.world)]

    def run(self, target: str, *args: Any) -> List[Any]:
        """``module:function`` called as ``fn(rank, world, *args)`` on every
        rank; its results in rank order. On a failure the ranks are
        replaced before the error is raised."""
        for inbox in self._ins:
            inbox.put((target, args))
        try:
            return self._collect(target)
        except RankError:
            self.close()
            self._start()
            raise

    def close(self) -> None:
        """Stop and reap every rank (killed if it does not exit in 10 s)."""
        for inbox, p in zip(self._ins, self._procs):
            if p.is_alive():
                try:
                    inbox.put(None)
                except (OSError, ValueError):
                    pass
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
        self._procs = []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
