"""Device meshes over the ranks of a ``torch.distributed`` process group.

The port of ``mmlspark_tpu/parallel/mesh.py``. There a mesh laid the
devices of a JAX program out on named axes; here one rank is one process
on one device, as ``torch.distributed`` has it, and a mesh lays the
world's ranks out on the same named axes, as a
``torch.distributed.device_mesh.DeviceMesh``:

- ``data`` (batch), ``fsdp`` (batch, with parameters sharded and gathered
  on use), ``pipe`` (stacked pipeline stages, ``parallel/
  pipeline_parallel.py``), ``expert`` (MoE expert banks, ``models/zoo/
  moe.py``), ``seq`` (sequence / context parallelism), ``tensor`` (heads
  and hidden features split inside a layer, embedding table rows) -- in
  the JAX order, ``tensor`` and ``seq`` last;
- :func:`initialize_multihost` joins the process group
  (``init_process_group``) with the reference's argument checks; its
  backend is the port's ``runtime.dist_backend`` key: ``"nccl"`` on the
  cards, ``"gloo"`` on the CPU (or on ranks that share one card, which
  NCCL refuses). NCCL with fewer visible cards than local ranks raises;
  nothing switches backend by itself.

A mesh needs an initialized process group: a single process that never
joined one trains on its one device, the trainer's path without a mesh
(:func:`mesh_from_config` returns None there).
"""
from __future__ import annotations

import datetime
import math
import os
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

AXES = ("data", "fsdp", "pipe", "expert", "seq", "tensor")


@dataclass(frozen=True)
class MeshSpec:
    """Sizes per logical axis; -1 on ``data`` means "absorb the remaining
    ranks"."""
    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {"data": self.data, "fsdp": self.fsdp, "pipe": self.pipe,
                 "expert": self.expert, "seq": self.seq, "tensor": self.tensor}
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {fixed}")
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"only one axis may be -1, got {free}")
        if free:
            sizes[free[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"axis sizes {sizes} do not multiply to {n_devices} devices")
        return sizes


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The ranks of the joined process group (1 outside one)."""
    return _dist().get_world_size() if is_initialized() else 1


def make_mesh(spec: Optional[MeshSpec] = None,
              ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over the world's ranks (or ``ranks``), its
    dimensions named :data:`AXES` in that order, rank-major as the JAX
    package reshapes its device list."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from mmlspark_tpu_torch.utils import config
    if not is_initialized():
        raise RuntimeError(
            "a device mesh spans the ranks of a torch.distributed process "
            "group: join one first (initialize_multihost, or run the "
            "script under `python -m mmlspark_tpu_torch.cli run`)")
    ranks = list(range(_dist().get_world_size())) if ranks is None \
        else list(ranks)
    sizes = (spec or MeshSpec()).resolve(len(ranks))
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        tuple(sizes[a] for a in AXES))
    # the mesh's device type is that of runtime.device, where ranks compute
    return DeviceMesh(config.resolve_device().type, grid,
                      mesh_dim_names=AXES)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh (the JAX ``Mesh.shape``); an
    ``{axis: size}`` dict stands for a mesh of those sizes."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def data_parallel_mesh(ranks: Optional[Sequence[int]] = None):
    return make_mesh(MeshSpec(data=-1), ranks)


def parse_mesh_axes(text: str) -> Dict[str, int]:
    """'data=-1,tensor=2' -> {'data': -1, 'tensor': 2}, validated against
    AXES. The one parser behind both the launcher's --mesh flag and the
    ``runtime.mesh`` config key."""
    axes: Dict[str, int] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        axis, eq, size = part.partition("=")
        if not eq or not size:
            raise ValueError(f"bad mesh entry {part!r}: want axis=size")
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; have {AXES}")
        n = int(size)
        if n == 0 or n < -1:
            raise ValueError(
                f"bad size {n} for mesh axis {axis!r}: want a positive "
                "size or -1 (absorb remaining devices)")
        axes[axis] = n
    return axes


def parse_mesh_shape(text: str) -> MeshSpec:
    """'4x2' -> MeshSpec(data=4, tensor=2): the (data, model[, pipe])
    shorthand behind the ``parallel.mesh_shape`` config key; a single
    factor means pure data parallel, and only the data factor may be -1."""
    parts = [p.strip() for p in text.lower().split("x") if p.strip()]
    if not parts or len(parts) > 3:
        raise ValueError(
            f"bad mesh shape {text!r}: want 'DATAxMODEL' (e.g. '4x2'), "
            "'DATAxMODELxPIPE' (e.g. '2x2x2'), or a single data-parallel "
            "size")
    sizes = [int(p) for p in parts]
    for n in sizes:
        if n == 0 or n < -1:
            raise ValueError(
                f"bad size {n} in mesh shape {text!r}: want a positive "
                "size or -1 (absorb remaining devices)")
    if len(sizes) == 1:
        return MeshSpec(data=sizes[0])
    if any(n == -1 for n in sizes[1:]):
        raise ValueError(
            f"bad mesh shape {text!r}: only the data factor may be -1")
    if len(sizes) == 2:
        return MeshSpec(data=sizes[0], tensor=sizes[1])
    return MeshSpec(data=sizes[0], tensor=sizes[1], pipe=sizes[2])


def mesh_from_config(ranks: Optional[Sequence[int]] = None):
    """Mesh from config: ``parallel.mesh_shape`` first, else
    ``runtime.mesh`` (the launcher's ``--mesh``), else all ranks data
    parallel. Without a process group there are no ranks to lay out: None
    (the one-device path), unless a mesh was configured, which raises."""
    from mmlspark_tpu_torch.utils import config
    shape = config.get("parallel.mesh_shape", "")
    text = config.get("runtime.mesh")
    if not is_initialized():
        if shape or text:
            raise RuntimeError(
                f"a mesh is configured ({shape or text!r}) but no "
                "torch.distributed process group is initialized; run the "
                "script under `python -m mmlspark_tpu_torch.cli run`")
        return None
    if shape:
        return make_mesh(parse_mesh_shape(shape), ranks)
    if not text:
        return data_parallel_mesh(ranks)
    return make_mesh(MeshSpec(**parse_mesh_axes(text)), ranks)


def data_shard(rank: Optional[int] = None):
    """(index, count) of ``rank``'s (default: this rank's) share of the
    input rows: its block on the data axes of the configured mesh
    (``parallel.mesh_shape``, else ``runtime.mesh``) and the number of
    blocks, so ranks that differ only on other axes (``tensor``,
    ``seq``, ...) hold the same rows. Without a configured mesh every
    rank is its own block, ``(rank, world)``; outside a process group
    ``(0, 1)``. Computed from the sizes alone: no group is made, so a
    rank may ask at any time."""
    from mmlspark_tpu_torch.utils import config
    if not is_initialized():
        return 0, 1
    dist = _dist()
    world = dist.get_world_size()
    rank = dist.get_rank() if rank is None else int(rank)
    shape = config.get("parallel.mesh_shape", "")
    text = config.get("runtime.mesh")
    if not (shape or text):
        return rank, world
    spec = parse_mesh_shape(shape) if shape \
        else MeshSpec(**parse_mesh_axes(text))
    sizes = spec.resolve(world)
    # row-major coordinate of `rank` over AXES, as make_mesh lays it out
    coord, rest = {}, rank
    for a in reversed(AXES):
        coord[a], rest = rest % sizes[a], rest // sizes[a]
    index, count = 0, 1
    for a in ("data", "fsdp"):         # sharding.BATCH_AXES
        index = index * sizes[a] + coord[a]
        count *= sizes[a]
    return index, count


def resolve_mesh(mesh_spec):
    """MeshSpec | axis-size dict | "data=2,tensor=4" string | DeviceMesh |
    None -> DeviceMesh (None: :func:`mesh_from_config`, which is None
    outside a process group)."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh_spec is None:
        return mesh_from_config()
    if isinstance(mesh_spec, DeviceMesh):
        return mesh_spec
    if isinstance(mesh_spec, str):
        mesh_spec = parse_mesh_axes(mesh_spec)
    if isinstance(mesh_spec, dict):
        unknown = sorted(set(mesh_spec) - set(AXES))
        if unknown:
            raise ValueError(
                f"unknown mesh axes {unknown}; valid axes are {AXES}")
        mesh_spec = MeshSpec(**mesh_spec)
    return make_mesh(mesh_spec)


def check_backend(backend: str, local_ranks: int) -> None:
    """Refuse a backend the host cannot give ``local_ranks`` ranks:
    NCCL takes one card a rank, so fewer visible cards than local ranks
    (or no CUDA) raises. Nothing here picks another backend."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"runtime.dist_backend {backend!r}: want 'nccl' "
                         "or 'gloo'")
    if backend != "nccl":
        return
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < local_ranks:
        raise RuntimeError(
            f"runtime.dist_backend='nccl' needs one CUDA card a rank: "
            f"{local_ranks} local ranks, {cards} visible cards; ranks that "
            "share a card (or run on the CPU) need runtime.dist_backend="
            "'gloo'")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         timeout_s: float = 600.0) -> None:
    """Join the ``torch.distributed`` process group (idempotent).

    ``coordinator_address`` (``host:port`` of rank 0's rendezvous) with
    ``num_processes`` and ``process_id`` joins over TCP; worker flags
    without a coordinator raise (they would train alone while the rest of
    the cluster waits). With nothing given, an already joined group or an
    environment without ``MASTER_ADDR`` is left as it is, and one set up
    by a launcher (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) is joined.
    The backend is ``runtime.dist_backend``; the local rank count for its
    check is ``LOCAL_WORLD_SIZE`` when set, else ``num_processes``."""
    from mmlspark_tpu_torch.utils import config
    dist = _dist()
    if coordinator_address is None and (num_processes is not None
                                        or process_id is not None):
        raise ValueError(
            "num_processes/process_id were given without a "
            "coordinator_address; pass all three (or none, for "
            "single-process / auto-detected cluster runs)")
    if coordinator_address is not None and (num_processes is None
                                            or process_id is None):
        raise ValueError(
            "coordinator_address needs num_processes and process_id")
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "RANK",
                                             "WORLD_SIZE")):
            return      # nothing to join: a single-process run
        init = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        init = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
        if not 0 <= rank < world:
            raise ValueError(f"process_id {rank} outside [0, {world})")
    backend = str(config.get("runtime.dist_backend"))
    check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def device_count_summary() -> Dict[str, int]:
    """The ``nvidia-smi -L`` replacement: this process's rank, the world
    size, and the cards it can see."""
    import torch
    dist = _dist()
    joined = is_initialized()
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_devices": torch.cuda.device_count()
        if torch.cuda.is_available() else 0,
        "global_devices": dist.get_world_size() if joined else 1,
    }
