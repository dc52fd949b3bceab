"""Serving programs: one CUDA graph per padded shape, or the eager function.

The port's counterpart of the ahead-of-time executables behind the
reference's two compile seams (``ModelEntry._compile`` for scoring,
``GenerativeEntry._compile`` for the decode lane). A program runs a
function over fixed-shape operands:

- on a CUDA device, :class:`GraphProgram` captures the function once as a
  ``torch.cuda.CUDAGraph`` over static input buffers and replays it per
  call: the padded host operands are copied into the buffers, the graph is
  replayed, and the output is fetched through
  :func:`~mmlspark_tpu_torch.observability.syncs.device_get`, a counted
  sync. The function runs once eagerly on the capture stream first, which
  builds the hand-written kernels at first use, sets their launch
  attributes and warms the cuBLAS and cuDNN handles. A capture that fails
  raises: there is no eager fallback on the card;
- on the CPU, :class:`EagerProgram` calls the function on tensors made
  from the operands, with the same call signature;
- over a mesh of ranks, :class:`MeshProgram` hands the host operands to
  the function (a meshed apply, ``parallel/leader.py``), which runs it
  eagerly on every rank of the placement; each rank counts the kernel
  launches it made under the program's key. It is not captured: gloo,
  which serves two ranks sharing one card, moves its data through the
  host, and a host path cannot live in a CUDA graph.

Kernel launches under replay: a kernel wrapper called during capture
records its launch instead of making it, so each :class:`GraphProgram`
keeps the launches its capture recorded (``launches``) and adds them to
the kernels' counts at every replay.

One process-wide lock, :data:`DEVICE_LOCK`, covers every capture and every
call (copy in, replay, fetch). The scoring executor and a generate lane
run on separate threads, and a capture in one while the other allocates or
syncs fails with "operation not permitted when stream is capturing"; the
graphs of one model also share one memory pool, so a graph's output must
be fetched before another graph of the pool replays. Both hold because no
two programs ever overlap.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.kernels import build as kbuild
from mmlspark_tpu_torch.observability import spans, syncs

DEVICE_LOCK = threading.RLock()

Spec = Tuple[Tuple[int, ...], torch.dtype]


class EagerProgram:
    """``fn`` called on the operands as tensors on ``device`` (the CPU
    program). It captures nothing; ``replays`` counts its calls."""

    def __init__(self, fn: Callable, specs: Sequence[Spec],
                 device: torch.device):
        self.fn = fn
        self.specs = list(specs)
        self.device = device
        self.launches: dict = {}
        self.replays = 0

    def __call__(self, *operands, fetch: Optional[str] = None):
        """Run on ``operands`` (numpy arrays or scalars, one per spec);
        returns the output as numpy through a counted fetch at site
        ``fetch``, or None when ``fetch`` is None."""
        with spans.span("batch", "copy_in", hot=True):
            args = [_host(x, shape).to(self.device, d)
                    for x, (shape, d) in zip(operands, self.specs)]
        with DEVICE_LOCK:
            with spans.span("batch", "replay", hot=True):
                out = self.fn(*args)
                self.replays += 1
            return _fetch(out, fetch)


class GraphProgram:
    """``fn`` captured once as a CUDA graph over static inputs of
    ``specs`` on ``device``, in the memory pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()``, shared by one model's graphs).
    ``launches`` are the kernel launches one replay makes, by kernel name
    (``kernels/build.py::launches_since``); ``replays`` counts the calls;
    ``capture_s`` is the host time the warm-up run and the capture took."""

    def __init__(self, fn: Callable, specs: Sequence[Spec],
                 device: torch.device, pool=None):
        t0 = time.perf_counter()
        self.inputs = [torch.zeros(shape, dtype=dtype, device=device)  # lint: allow-alloc (the graph's static inputs)
                       for shape, dtype in specs]
        self.replays = 0
        with DEVICE_LOCK, torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                fn(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            before = kbuild.launch_counts()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.output = fn(*self.inputs)
            finally:
                # a capture records launches; only replays make them
                self.launches = kbuild.launches_since(before)
                kbuild.add_launches(self.launches, -1)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self, *operands, fetch: Optional[str] = None):
        """Copy ``operands`` into the static inputs, replay, and return
        the output as numpy through a counted fetch at site ``fetch`` (None
        when ``fetch`` is None)."""
        with DEVICE_LOCK:
            with spans.span("batch", "copy_in", hot=True):
                for buf, x in zip(self.inputs, operands):
                    buf.copy_(_host(x, buf.shape))
            with spans.span("batch", "replay", hot=True):
                self.graph.replay()
                self.replays += 1
                kbuild.add_launches(self.launches)
            return _fetch(self.output, fetch)


class MeshProgram:
    """``run(*operands, prog=key)`` over a mesh of ranks: ``run`` takes
    the padded host operands and returns the output on this (the
    leader's) device, every rank of its placement having run the same
    function on its shards. Same call signature and counted fetch as the
    other programs; ``replays`` counts the calls; :meth:`rank_launches`
    asks each rank for the kernel launches it made under ``key``."""

    capture_s = 0.0

    def __init__(self, run: Callable, specs: Sequence[Spec],
                 device: torch.device, key: str):
        self.launches: dict = {}     # nothing recorded: every call launches
        self.run = run
        self.specs = list(specs)
        self.device = device
        self.key = key
        self.replays = 0

    def __call__(self, *operands, fetch: Optional[str] = None):
        with spans.span("batch", "copy_in", hot=True):
            args = [_host(x, shape).to(d).numpy()  # lint: allow-sync (host operands)
                    for x, (shape, d) in zip(operands, self.specs)]
        with DEVICE_LOCK:
            with spans.span("batch", "replay", hot=True):
                out = self.run(*args, prog=self.key)
                self.replays += 1
            return _fetch(out, fetch)

    def rank_launches(self) -> list:
        """Each rank's kernel launches under this program, in rank order
        (``{kernel: (launches, by variant)}``)."""
        return self.run.rank_launches(self.key)


def _fetch(out, site: Optional[str]):
    """``out`` as numpy through a counted fetch at ``site`` (a hot
    ``batch:fetch`` span), or None when ``site`` is None."""
    if not site:
        return None
    with spans.span("batch", "fetch", hot=True):
        return syncs.device_get(out, site)


def _host(x, shape) -> torch.Tensor:
    """One operand as a CPU tensor, checked against its spec's shape (a
    copy into a static buffer would broadcast a wrong one silently)."""
    t = torch.as_tensor(np.asarray(x))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"operand of shape {tuple(t.shape)} for a program "
                         f"built at {tuple(shape)}")
    return t


def build(fn: Callable, specs: Sequence[Spec], device: torch.device,
          pool=None, key: str = ""):
    """The program of ``fn`` over operands of ``specs``: a
    :class:`MeshProgram` when ``fn`` is meshed (its ``meshed`` flag), a
    :class:`GraphProgram` on a CUDA device, an :class:`EagerProgram`
    elsewhere. ``key`` names a meshed program's launch counts."""
    if getattr(fn, "meshed", False):
        return MeshProgram(fn, specs, device, key)
    if device.type == "cuda":
        return GraphProgram(fn, specs, device, pool)
    return EagerProgram(fn, specs, device)
