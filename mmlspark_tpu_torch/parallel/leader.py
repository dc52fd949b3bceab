"""Serving on a mesh: rank 0 leads, the other ranks follow.

The reference scored on a *process-local* mesh: one Python process placed
each shard on its host's devices and XLA inserted the collectives, so it
refused a mesh spanning processes. The port's mesh is one rank a device
over ``torch.distributed`` (``parallel/mesh.py``), and serving keeps that
rank model:

- **Leader and followers.** Rank 0 of the world is the leader: it owns
  the ``Frame``, the ``Server``, the ``Fleet``, the registry, the router
  and the autopilot, exactly as one process does without a mesh. Ranks
  1..W-1 call :func:`follow` and run commands until the leader stops
  them. A meshed call (:meth:`Channel.call`) posts a small header (the
  command, its placement key, program key, operand shapes and dtypes) in
  the process group's store, broadcasts the padded host operands over a
  gloo group, runs the same command on every rank of the placement's
  sub-mesh (each on its shards), and ends with an exchange of the ranks'
  statuses. Outputs come back to the leader inside the command: gathered
  over the data axes by the mesh's collectives, tensor-split outputs
  already reduced by the module.
- **Order.** A call holds the channel's lock, and a serving program holds
  ``serve/programs.py::DEVICE_LOCK`` around it, so commands never
  interleave: the broadcast order is the lock's order.
- **Per host.** Each rank states its hostname when it joins; a scoring
  sub-mesh whose ranks are not all on the leader's host is refused
  (``sharding.mesh_spans_hosts``, checked by ``TorchModel``).
- **A sub-mesh of the world.** A mesh of n <= W ranks lies over ranks
  0..n-1 (:meth:`Channel.mesh`, a ``DeviceMesh`` made on every rank of the
  world, which ``new_group`` needs); ranks outside it skip its commands.
- **Placement from host, per shard.** :meth:`Channel.acquire` places a
  model: every rank builds the module on the host, the leader slices each
  leaf by ``sharding.param_shardings`` (after the bf16 cast, on the host)
  and sends each follower only its own blocks; modules with ``bind_mesh``
  compute on their shards, every other split leaf is gathered for its use
  (:meth:`Placement.using`). A placement is keyed and counted by
  reference on the leader; the last :meth:`Channel.release` frees it on
  every rank.
- **Every wait is bounded.** The command channel's transfers time out
  after ``runtime.mesh_timeout_s``; a follower that dies, times out or
  breaks a collective fails the call with :class:`MeshPeerLost`, a
  ``ConnectionError`` the router treats as retryable, and the channel
  stays broken: the leader never scores a batch alone instead. A
  follower's wait for the next command ends when the leader stops it,
  when the leader's store goes away, or after ``follow(idle_s=)``.

Commands are named ``"module:function"`` (imported on first use on every
rank) and called as ``fn(channel, header, tensors, local)``: ``tensors``
are the broadcast operands on the host, ``local`` what the leader passed
for its own part only (None on the followers).
"""
from __future__ import annotations

import contextlib
import datetime
import importlib
import math
import pickle
import socket
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.utils import config as mmlconfig

_PREFIX = "mmlspark_tpu_torch/mesh_serve/"
# commands kept in the store behind the newest (a follower outside a
# sub-mesh may still be reading its way past the older ones)
_KEEP = 1024


class MeshPeerLost(ConnectionError):
    """A rank of the mesh died, timed out or broke a collective during a
    meshed call, or the channel is down since one did. Retryable: the
    router fails the request over, and the replica holding the placement
    is dead."""
    retryable = True


class FollowerError(RuntimeError):
    """A command raised on a rank (each failing rank's traceback in the
    message). The command ran to its end on every rank."""


def _dist():
    import torch.distributed as dist
    return dist


def _hostname() -> str:
    return socket.gethostname()


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(mmlconfig.get("runtime.mesh_timeout_s")))


def _resolve(name: str) -> Callable:
    mod, _, fn = name.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _peer_error(e: BaseException) -> bool:
    """True for a failure of the transport (a closed connection, a
    timeout, a broken collective), as opposed to a command's own error."""
    dist = _dist()
    kinds = tuple(k for k in (getattr(dist, "DistError", None),
                              getattr(dist, "DistBackendError", None),
                              getattr(dist, "DistNetworkError", None),
                              getattr(dist, "DistStoreError", None))
                  if k is not None)
    if kinds and isinstance(e, kinds):
        return True
    text = str(e).lower()
    return isinstance(e, (RuntimeError, ConnectionError, OSError)) and any(
        w in text for w in ("gloo", "nccl", "connection", "timed out",
                            "timeout", "broken pipe", "peer"))


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor as its bytes (any dtype crosses gloo as uint8)."""
    return t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)


def _from_wire(buf: torch.Tensor, shape, dtype) -> torch.Tensor:
    return buf.view(dtype).reshape(shape)


class Placement:
    """A model placed over a mesh on one rank: its module holding this
    rank's shards, the rank's ``MeshLayout``, the gathers of the split
    leaves its modules do not compute on, and what the builder's finish
    made of the placed module (``parts``). ``launches`` counts, by
    program key, the kernel launches this rank made running that
    program."""

    def __init__(self, key: str, mesh, layout, module, shardings, gathers,
                 device: torch.device, parts: Any):
        self.key = key
        self.mesh = mesh
        self.layout = layout
        self.module = module
        self.shardings = shardings
        self.gathers = gathers
        self.device = device
        self.parts = parts
        self.launches: Dict[str, Dict[str, Tuple[int, Dict[str, int]]]] = {}
        self.extras: Dict[str, Any] = {}

    @contextlib.contextmanager
    def using(self):
        """Run code on the module as a meshed forward: the layout is
        ``sharding.current()`` and each split leaf its module uses whole
        is gathered for the duration (collective: every rank of the mesh
        enters it)."""
        from mmlspark_tpu_torch.parallel import collectives, sharding
        layout = self.layout
        swapped = []
        with sharding.activate(layout), torch.no_grad():
            try:
                for owner, attr, p, ops, kept in self.gathers:
                    full = p.detach()
                    for d, axes in ops:
                        full = collectives.all_gather(
                            full.contiguous(), d, layout.group(*axes))
                    if kept is not None:
                        full._mesh_sharding = kept
                    del owner._parameters[attr]
                    swapped.append((owner, attr, p))
                    setattr(owner, attr, full)
                yield self.module
            finally:
                for owner, attr, p in reversed(swapped):
                    delattr(owner, attr)
                    owner._parameters[attr] = p

    def counted(self, prog: Optional[str], fn: Callable, *args):
        """``fn(*args)``, its kernel launches on this rank added to
        ``launches[prog]``."""
        from mmlspark_tpu_torch.kernels import build as kbuild
        if prog is None:
            return fn(*args)
        before = kbuild.launch_counts()
        try:
            return fn(*args)
        finally:
            made = kbuild.launches_since(before)
            mine = self.launches.setdefault(prog, {})
            for name, (n, variants) in made.items():
                n0, v0 = mine.get(name, (0, {}))
                v = dict(v0)
                for k, c in variants.items():
                    v[k] = v.get(k, 0) + c
                mine[name] = (n0 + n, v)


class Channel:
    """The command channel of this process (one a process, made by
    :func:`channel` on rank 0 and :func:`follow` elsewhere; joining is
    collective over the world)."""

    def __init__(self):
        dist = _dist()
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        from torch.distributed import distributed_c10d
        self.store = dist.PrefixStore(_PREFIX,
                                      distributed_c10d._get_default_store())
        timeout = _timeout()
        # one gloo group a sub-mesh size, over ranks 0..n-1: the host
        # operands, the blocks of a placement and the statuses
        self.groups = {n: dist.new_group(list(range(n)), backend="gloo",
                                         timeout=timeout)
                       for n in range(2, self.world + 1)}
        hosts: List[Optional[str]] = [None] * self.world
        if self.world > 1:
            dist.all_gather_object(hosts, _hostname(),
                                   group=self.groups[self.world])
        else:
            hosts = [_hostname()]
        self.hosts = [str(h) for h in hosts]
        self.seq = 0
        self.lock = threading.RLock()
        self.broken: Optional[str] = None
        self.meshes: Dict[Tuple, Any] = {}
        self.placements: Dict[str, Placement] = {}
        self.refs: Dict[str, int] = {}
        self.commands = 0

    # -- the leader's side -------------------------------------------------
    def call(self, op: str, header: Optional[dict] = None,
             arrays: Sequence[np.ndarray] = (), n: Optional[int] = None,
             results: bool = False, local: Any = None) -> Any:
        """Run command ``op`` on ranks 0..n-1 (all by default): the
        leader's own part's return value, or with ``results`` every
        rank's, in rank order. Raises :class:`MeshPeerLost` when a rank
        is lost (and from then on), :class:`FollowerError` when the
        command raised on some rank."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 (the leader) issues commands")
        n = self.world if n is None else int(n)
        dist = _dist()
        with self.lock:
            if self.broken is not None:
                raise MeshPeerLost(f"the mesh channel is down: "
                                   f"{self.broken}")
            arrays = [np.ascontiguousarray(a) for a in arrays]
            self.seq += 1
            msg = {"op": op, "n": n, "header": header or {},
                   "specs": [(a.shape, a.dtype.str) for a in arrays],
                   "results": results}
            group = self.groups.get(n)
            try:
                self.store.set(f"cmd/{self.seq}", pickle.dumps(msg))
                if self.seq > _KEEP:
                    self.store.delete_key(f"cmd/{self.seq - _KEEP}")
                tensors = [torch.from_numpy(a) for a in arrays]
                if group is not None:
                    for t in tensors:
                        dist.broadcast(_to_wire(t), src=0, group=group)
                out, err = self._run(op, msg["header"], tensors, local)
                outs = self._finish(group, n, out, err, results)
            except MeshPeerLost:
                raise
            except Exception as e:
                if not _peer_error(e):
                    raise
                self.broken = f"{type(e).__name__}: {e}"
                raise MeshPeerLost(
                    f"mesh command {op} lost a rank: {self.broken}") from e
            return outs if results else outs[0]

    def _run(self, op, header, tensors, local):
        """This rank's part of a command: (its result, its error text or
        None). A transport failure propagates."""
        try:
            fn = _CORE.get(op) or _resolve(op)
            self.commands += 1
            return fn(self, header, tensors, local), None
        except Exception as e:
            if _peer_error(e):
                raise
            return None, traceback.format_exc()

    def _finish(self, group, n, out, err, results) -> List[Any]:
        """Exchange the ranks' statuses (and results): raise
        :class:`FollowerError` with every failing rank's traceback."""
        dist = _dist()
        if group is None:
            if err is not None:
                raise FollowerError(f"rank 0:\n{err}")
            return [out]
        flag = torch.tensor([0 if err is None else 1], dtype=torch.int32)
        dist.all_reduce(flag, group=group)
        if int(flag[0]):
            errs: List[Any] = [None] * n
            dist.all_gather_object(errs, err, group=group)
            raise FollowerError("\n".join(
                f"-- rank {r}:\n{t}" for r, t in enumerate(errs) if t))
        if not results:
            return [out]
        outs: List[Any] = [None] * n
        dist.all_gather_object(outs, out, group=group)
        return outs

    def send(self, tensors: Sequence[torch.Tensor], dst: int, n: int
             ) -> None:
        """Send ``tensors`` (any dtype, on the host) to rank ``dst``
        inside a command of ranks 0..n-1."""
        dist = _dist()
        for t in tensors:
            dist.send(_to_wire(t), dst=dst, group=self.groups[n])

    def recv(self, specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
             n: int) -> List[torch.Tensor]:
        """Receive tensors of ``specs`` from the leader (the twin of
        :meth:`send`)."""
        dist = _dist()
        out = []
        for shape, dtype in specs:
            nbytes = math.prod(shape) * torch.empty((), dtype=dtype
                                                    ).element_size()
            buf = torch.empty(nbytes, dtype=torch.uint8)
            dist.recv(buf, src=0, group=self.groups[n])
            out.append(_from_wire(buf, shape, dtype))
        return out

    def mesh(self, sizes: Dict[str, int]):
        """The ``DeviceMesh`` of ``sizes`` over ranks 0..n-1, made once on
        every rank of the world (with the groups over several of its
        axes, which ``new_group`` makes collectively)."""
        key = tuple(sorted(sizes.items()))
        if key not in self.meshes:
            self.call(_MAKE_MESH, {"sizes": dict(sizes)})
        return self.meshes[key]

    def acquire(self, key: str, sizes: Dict[str, int], builder: str,
                recipe: Any, params: Dict[str, Any],
                seq_axis: Optional[str] = None) -> Placement:
        """The placement ``key`` (one more reference to it), placed on
        the sub-mesh of ``sizes`` when new: ``builder`` (``module:fn``)
        makes ``(module on the host, finish)`` from ``recipe`` on every
        rank, each rank gets its blocks of ``params`` (a host state dict,
        already cast to the dtypes the module computes in), and
        ``finish(module, device)`` makes the placement's ``parts``.
        ``seq_axis`` names the axis the inputs' sequence is split over
        (the layout's)."""
        with self.lock:
            if key in self.refs:
                self.refs[key] += 1
                return self.placements[key]
            mesh = self.mesh(sizes)
            n = mesh.size()
            dtypes = {k: str(v.dtype).replace("torch.", "")
                      for k, v in params.items()}
            self.call(_PLACE, {"key": key, "sizes": dict(sizes),
                               "builder": builder, "recipe": recipe,
                               "dtypes": dtypes, "seq_axis": seq_axis},
                      n=n, local=params)
            self.refs[key] = 1
            return self.placements[key]

    def release(self, key: str) -> None:
        """Drop one reference to placement ``key``; the last frees it on
        every rank of its sub-mesh."""
        with self.lock:
            if key not in self.refs:
                return
            self.refs[key] -= 1
            if self.refs[key] > 0:
                return
            del self.refs[key]
            pl = self.placements.get(key)
            if pl is None:
                return
            if self.broken is None:
                try:
                    self.call(_RELEASE, {"key": key}, n=pl.mesh.size())
                except MeshPeerLost:
                    pass
            self.placements.pop(key, None)

    def rank_launches(self, key: str, prog: str) -> List[Dict]:
        """Each rank's kernel launches running program ``prog`` of
        placement ``key``, in rank order."""
        pl = self.placements[key]
        return self.call(_LAUNCHES, {"key": key, "prog": prog},
                         n=pl.mesh.size(), results=True)

    def rank_stats(self, reset: bool = False,
                   n: Optional[int] = None) -> List[Dict]:
        """Each rank's kernel launch counts, transport host copies and
        allocator bytes (``reset``: zeroed first, the peak too), in rank
        order: how a meshed run reads every rank's counts."""
        return self.call(_STATS, {"reset": reset}, n=n, results=True)

    def set_tf32(self, on: bool, n: Optional[int] = None) -> None:
        """Turn TF32 on or off for the fp32 GEMMs and convolutions of every
        rank (fp32 parity work turns it off on all of them, or a
        follower's half of a split layer rounds otherwise)."""
        self.call(_TF32, {"on": bool(on)}, n=n)

    # -- the followers' side -----------------------------------------------
    def _next(self, idle_s: float) -> dict:
        """The next command from the store (bounded by ``idle_s`` when
        positive); raises :class:`MeshPeerLost` when the store is gone."""
        key = f"cmd/{self.seq + 1}"
        deadline = time.monotonic() + idle_s if idle_s > 0 else None
        while True:
            try:
                self.store.wait([key], datetime.timedelta(seconds=5.0))
                break
            except Exception as e:
                try:
                    ready = self.store.check([key])
                except Exception as gone:
                    raise MeshPeerLost(
                        f"rank {self.rank}: the leader's store is gone "
                        f"({gone})") from e
                if ready:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"rank {self.rank}: no command in {idle_s} s "
                        "(follow's idle_s)") from e
        self.seq += 1
        return pickle.loads(self.store.get(key))

    def serve_one(self, idle_s: float) -> str:
        """Run the next command of the leader (when this rank is in its
        sub-mesh); returns its name."""
        msg = self._next(idle_s)
        n = msg["n"]
        if self.rank >= n:
            return msg["op"]
        dist = _dist()
        group = self.groups.get(n)
        tensors = []
        for shape, dt in msg["specs"]:
            dtype = torch.from_numpy(np.zeros((), np.dtype(dt))).dtype
            nbytes = math.prod(shape) * np.dtype(dt).itemsize
            buf = torch.empty(nbytes, dtype=torch.uint8)
            dist.broadcast(buf, src=0, group=group)
            tensors.append(_from_wire(buf, tuple(shape), dtype))
        out, err = self._run(msg["op"], msg["header"], tensors, None)
        self._finish(group, n, out, err, msg["results"])
        return msg["op"]


_channel: Optional[Channel] = None
_channel_lock = threading.Lock()


def joined() -> Optional[Channel]:
    """This process's channel, or None before it joined one."""
    return _channel


def channel() -> Channel:
    """This process's channel, joined on first use (collective over the
    world: the followers must be in :func:`follow`)."""
    global _channel
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    with _channel_lock:
        if _channel is None:
            if not meshlib.is_initialized():
                raise RuntimeError(
                    "serving on a mesh needs a torch.distributed process "
                    "group with a rank a device: start the ranks with "
                    "`python -m mmlspark_tpu_torch.cli run script.py "
                    "--nprocs N` (or mmlspark_tpu_torch.testing.ranks."
                    "RankPool), have ranks 1..N-1 call "
                    "mmlspark_tpu_torch.parallel.leader.follow(), and "
                    "serve from rank 0")
            _channel = Channel()
        return _channel


def follow(idle_s: float = 0.0) -> int:
    """Run the leader's commands on this rank (1..W-1) until the leader
    stops the followers; returns the number of commands this rank ran.
    Raises :class:`MeshPeerLost` when the leader goes away, and
    ``TimeoutError`` after ``idle_s`` seconds without a command (0: no
    bound of its own)."""
    ch = channel()
    if ch.rank == 0:
        raise RuntimeError("rank 0 leads; follow() is for ranks 1..W-1")
    start = ch.commands
    while ch.serve_one(float(idle_s)) != _STOP:
        pass
    return ch.commands - start


def stop() -> None:
    """Stop the followers (on the leader; a no-op anywhere else or on a
    broken channel) and drop every placement on every rank."""
    ch = _channel
    if ch is None or ch.rank != 0 or ch.world == 1:
        return
    with ch.lock:
        ch.refs.clear()
        if ch.broken is None:
            ch.call(_STOP)


@contextlib.contextmanager
def lead():
    """On rank 0: join the channel, yield it, and stop the followers at
    the end."""
    ch = channel()
    if ch.rank != 0:
        raise RuntimeError("only rank 0 leads")
    try:
        yield ch
    finally:
        stop()


# -- the commands every rank knows -------------------------------------------

def _make_mesh(ch: Channel, header, tensors, local) -> None:
    from mmlspark_tpu_torch.parallel import sharding
    from mmlspark_tpu_torch.parallel.mesh import AXES, MeshSpec, make_mesh
    sizes = header["sizes"]
    n = math.prod(sizes.values())
    mesh = make_mesh(MeshSpec(**sizes), ranks=range(n))
    # the groups over two or more of its axes: new_group is collective
    # over the world, so every rank makes them here, in one order
    live = [a for a in AXES if sizes.get(a, 1) > 1]
    for k in range(2, len(live) + 1):
        for i in range(1 << len(live)):
            axes = [a for j, a in enumerate(live) if i >> j & 1]
            if len(axes) == k:
                sharding.axis_group(mesh, axes)
    ch.meshes[tuple(sorted(sizes.items()))] = mesh


def _place(ch: Channel, header, tensors, local) -> None:
    """Build the module on the host, receive (or, on the leader, cut and
    send) the rank's blocks, bind the modules that compute on shards."""
    from mmlspark_tpu_torch.parallel import sharding
    from mmlspark_tpu_torch.utils.config import resolve_device
    mesh = ch.meshes[tuple(sorted(header["sizes"].items()))]
    n = mesh.size()
    device = resolve_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    module, finish = _resolve(header["builder"])(header["recipe"], mesh)
    shardings = sharding.param_shardings(module, mesh)
    state = module.state_dict()
    names = list(state)
    if ch.rank == 0:
        host = {k: local[k] for k in names}
        for r in range(1, n):
            blocks = sharding.host_blocks(
                host, shardings, sharding.coordinate_of(mesh, r))
            ch.send([blocks[k] for k in names], r, n)
        mine = sharding.host_blocks(host, shardings,
                                    sharding.coordinate_of(mesh, 0))
        blocks = [mine[k] for k in names]
    else:
        specs = []
        for k in names:
            sh = shardings.get(k)
            shape = sh.shard_shape() if sh is not None and sh.sharded \
                else tuple(state[k].shape)
            specs.append((shape, getattr(torch, header["dtypes"][k])))
        blocks = ch.recv(specs, n)
    layout = sharding.MeshLayout(mesh, header.get("seq_axis"))
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    for k, block in zip(names, blocks):
        t = torch.as_tensor(block).contiguous().to(device)
        if k in params:
            p = params[k]
            p.data = t
            p.requires_grad_(False)
            p._mesh_sharding = shardings[k]
            p._mesh_layout = layout
        elif k in buffers:
            buffers[k].data = t
    module = module.to(device).eval()
    claimed, _ = sharding.bind_shards(module, shardings, layout)
    gathers = sharding.gather_plan(module, shardings, claimed)
    ch.placements[header["key"]] = Placement(
        header["key"], mesh, layout, module, shardings, gathers, device,
        finish(module, device))


def _release(ch: Channel, header, tensors, local) -> None:
    pl = ch.placements.pop(header["key"], None)
    if pl is not None:
        for close in pl.extras.values():
            getattr(close, "close", lambda: None)()


def _launches(ch: Channel, header, tensors, local) -> Dict:
    pl = ch.placements.get(header["key"])
    return dict(pl.launches.get(header["prog"], {})) if pl else {}


def _stats(ch: Channel, header, tensors, local) -> Dict:
    from mmlspark_tpu_torch.kernels import build as kbuild
    from mmlspark_tpu_torch.parallel import collectives
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if header.get("reset"):
        kbuild.reset_launches()
        collectives.reset_host_copies()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
    return {"launches": kbuild.launch_counts(),
            "host_copies": collectives.host_copies(),
            "allocated_bytes": int(torch.cuda.memory_allocated())
            if cuda else 0,
            "max_allocated_bytes": int(torch.cuda.max_memory_allocated())
            if cuda else 0}


def _tf32(ch: Channel, header, tensors, local) -> None:
    torch.backends.cuda.matmul.allow_tf32 = header["on"]
    torch.backends.cudnn.allow_tf32 = header["on"]


def _stop(ch: Channel, header, tensors, local) -> None:
    for key in list(ch.placements):
        _release(ch, {"key": key}, (), None)


_MAKE_MESH, _PLACE, _RELEASE = "mesh", "place", "release"
_LAUNCHES, _STATS, _TF32, _STOP = "launches", "stats", "tf32", "stop"
_CORE = {_MAKE_MESH: _make_mesh, _PLACE: _place, _RELEASE: _release,
         _LAUNCHES: _launches, _STATS: _stats, _TF32: _tf32, _STOP: _stop}
