"""The port's meshes, sharding rules and launcher against the JAX package.

Parsing and sizing run here in both packages. What needs a process group
runs on gloo ranks of one module-scoped pool of 4
(``mmlspark_tpu_torch.testing.ranks.RankPool``, functions in
``tests/torch_mesh_ranks.py``, no JAX there); the JAX side uses the
first devices of conftest's 8 virtual CPU devices. Placements are
compared leaf by leaf through ``models/convert.py``'s name and layout
map: the port's rules are written on its names with torch-order dims, so
each JAX leaf's spec is carried onto the torch dims its dims become.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.serialization import _mesh_to_dict as jmesh_to_dict
from mmlspark_tpu.models.zoo import build_model as jbuild
from mmlspark_tpu.observability import memory as jmemory
from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu.parallel.sharding import param_shardings as jshardings
from mmlspark_tpu_torch.core.serialization import load_stage, save_stage
from mmlspark_tpu_torch.models.convert import _convert_leaf
from mmlspark_tpu_torch.models.zoo import build_model
from mmlspark_tpu_torch.observability import memory as tmemory
from mmlspark_tpu_torch.parallel import mesh as tmesh
from mmlspark_tpu_torch.parallel.sharding import (
    _axes, param_shardings,
)
from mmlspark_tpu_torch.testing.ranks import RankPool
from mmlspark_tpu_torch.train.deep import DeepClassifier

import torch_mesh_ranks as R

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
AXES = tmesh.AXES


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, paths=[TESTS, REPO]) as p:
        yield p


def _same_outcome(port_fn, jax_fn, arg):
    """Both raise the same exception type, or both return equal values
    (MeshSpecs compared field by field)."""
    def run(fn):
        try:
            out = fn(arg)
        except (ValueError, TypeError) as e:
            return type(e).__name__
        return dataclasses.asdict(out) if dataclasses.is_dataclass(out) \
            else out
    assert run(port_fn) == run(jax_fn), arg


@pytest.mark.parametrize("spec,n", [
    (dict(data=-1), 8), (dict(data=-1, tensor=2), 8), (dict(data=3), 8),
    (dict(data=-1, fsdp=-1), 8), (dict(data=2, seq=2, tensor=2), 8),
    (dict(data=4, tensor=4), 8), (dict(data=1, tensor=2), 2)])
def test_mesh_spec_resolution_matches_reference(spec, n):
    _same_outcome(lambda s: tmesh.MeshSpec(**s).resolve(n),
                  lambda s: jmesh.MeshSpec(**s).resolve(n), spec)


@pytest.mark.parametrize("text", [
    "data=-1,tensor=2", "data=2,,tensor=4", " seq = 2", "bogus=2", "data",
    "data=", "data=0", "data=-2", "tensor=x", ""])
def test_parse_mesh_axes_matches_reference(text):
    _same_outcome(tmesh.parse_mesh_axes, jmesh.parse_mesh_axes, text)


@pytest.mark.parametrize("text", [
    "4x2", "2X2x2", "8", "-1x2", "2x-1", "", "2x2x2x2", "0x2", "4 x 2"])
def test_parse_mesh_shape_matches_reference(text):
    _same_outcome(tmesh.parse_mesh_shape, jmesh.parse_mesh_shape, text)


def test_make_mesh_lays_ranks_out_as_the_reference_lays_devices(pool):
    """data 2 x tensor 2 over 4 ranks: the JAX axis order and sizes, rank
    r at the coordinate of device r in the JAX mesh; the batch splits in
    two blocks by the data coordinate."""
    axes = {"data": 2, "tensor": 2}
    jm = jmesh.make_mesh(jmesh.MeshSpec(**axes), jax.devices()[:4])
    ranks = pool.run("torch_mesh_ranks:mesh_facts", axes)
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    for r, facts in enumerate(ranks):
        assert facts["names"] == list(jm.axis_names) == list(AXES)
        assert facts["shape"] == dict(jm.shape)
        where = dict(zip(AXES, (int(i) for i in
                                np.argwhere(grid == r)[0])))
        assert facts["coord"] == where
        assert facts["block"] == where["data"]
        assert tuple(facts["share"]) == (1, 2)
        assert facts["spans"] and facts["cpu"]
        assert facts["resolved"] == facts["shape"]
        assert facts["summary"]["process_index"] == r
        assert facts["summary"]["global_devices"] == 4
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(tmesh.MeshSpec(data=2))
    assert tmesh.mesh_from_config() is None


@pytest.mark.parametrize("axes", [dict(data=8), dict(data=2, fsdp=2, tensor=2),
                                  dict(data=1, seq=4, tensor=2),
                                  dict(data=2, seq=2, tensor=2)])
def test_batch_specs_match_reference(axes):
    """The batch, epoch-cache and QKV specs and the batch share of a mesh
    of these sizes are the reference's."""
    from mmlspark_tpu.parallel import sharding as jsh
    from mmlspark_tpu.parallel.sequence import _qkv_spec as jqkv
    from mmlspark_tpu_torch.parallel import sharding as tsh
    from mmlspark_tpu_torch.parallel.sequence import _qkv_spec as tqkv
    jm = jmesh.make_mesh(jmesh.MeshSpec(**axes))
    sizes = jmesh.MeshSpec(**axes).resolve(8)
    assert tsh.active_batch_axes(sizes) == jsh.active_batch_axes(jm)
    assert tsh.tensor_axis_size(sizes) == jsh.tensor_axis_size(jm)
    assert tsh.batch_share(sizes)[1] == jsh.batch_share(jm)[1]
    assert tsh.local_batch_rows(sizes, 64) == 64 // jsh.batch_share(jm)[1]
    def norm(spec):     # PartitionSpec writes a one-axis tuple as the axis
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)
    for seq in (None, "seq"):
        assert norm(tsh.batch_sharding(sizes, seq_axis=seq)) == \
            norm(jsh.batch_sharding(jm, seq_axis=seq).spec)
        for ndim in (2, 3):
            assert norm(tsh.epoch_cache_sharding(sizes, ndim, seq)) == norm(
                jsh.epoch_cache_sharding(jm, ndim, seq).spec)
    for heads in (4, 3):
        assert norm(tqkv(sizes, "seq", heads)) == \
            norm(jqkv(jm, "seq", heads))


# -- rules: every leaf placed as the reference places it ----------------------

PRIMES = (2, 3, 5, 7)


def _torch_dims(module, leaf, ndim):
    """(port leaf name, [JAX dims of each torch dim, major first]) from the
    converter's own layout map, run on an array of distinct primes."""
    shape = PRIMES[:ndim]
    name, arr = _convert_leaf(module, leaf, np.zeros(shape))
    return name, [[i for i, p in enumerate(shape) if n % p == 0]
                  for n in arr.shape]


def _expected(jax_tree, mesh):
    """{port name: per torch dim, the mesh axes the JAX spec puts there}."""
    specs = jshardings(jax_tree, mesh)
    out = {}

    def walk(path, node, spec_node):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(path + [key], value, spec_node[key])
                continue
            jspec = list(spec_node[key].spec) + [None] * len(value.shape)
            name, dims = _torch_dims(path[-1] if path else "", key,
                                     len(value.shape))
            out[".".join(path + [name])] = [
                tuple(a for a in AXES if any(a in _axes(jspec[d])
                                             for d in src))
                for src in dims]
    walk([], jax_tree["params"], specs["params"])
    return out


MODELS = {
    "transformer_lm": ({}, (1, 2048), jnp.int32),
    "resnet50": ({"num_classes": 10}, (1, 224, 224, 3), jnp.float32),
    "vit_b16": ({"num_classes": 10, "image_size": 32}, (1, 32, 32, 3),
                jnp.float32),
}


@pytest.mark.parametrize("axes", [dict(data=2, fsdp=2, tensor=2),
                                  dict(data=2, tensor=4)],
                         ids=["data2xfsdp2xtensor2", "data2xtensor4"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_rules_place_every_leaf_as_the_reference(model, axes):
    """transformer_lm, ResNet-50 and ViT-B/16 (at a 32x32 image): every
    leaf's split dims and axes under the port's rules equal the JAX
    rules' carried through the layout map, conv spatial dims never
    split; the JAX projected per-device bytes equal the port's."""
    kwargs, in_shape, dtype = MODELS[model]
    jmodule = jbuild(model, **kwargs)["module"]
    abstract = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros(in_shape, dtype)))
    mesh = jmesh.make_mesh(jmesh.MeshSpec(**axes))
    want = _expected(abstract, mesh)
    with torch.device("meta"):
        tmodule = build_model(model, **kwargs)["module"]
    got = param_shardings(tmodule, jmesh.MeshSpec(**axes).resolve(8))
    assert sorted(got) == sorted(want)
    for name, sh in got.items():
        port = [tuple(_axes(e)) for e in sh.spec]
        assert port == want[name], name
        if sh.shape and len(sh.shape) == 4:
            assert sh.spec[2:] == (None, None), name
    shapes = {n: np.broadcast_to(np.float32(0), s.shape)
              for n, s in got.items()}
    jleaves = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.float32(0), a.shape), abstract)
    assert tmemory.projected_shard_bytes(
        shapes, mesh=jmesh.MeshSpec(**axes).resolve(8)) \
        == jmemory.projected_shard_bytes(jleaves, mesh)


# -- accounting, codec, launcher ---------------------------------------------

def test_per_shard_bytes_sum_to_unsharded_total(pool):
    """The tiny LM placed at data 2 x tensor 2: each leaf's distinct
    shards over the ranks cover it exactly (their bytes sum to its whole
    bytes, each the slice of the host init), a rank's resident bytes are
    below the logical total and equal the projection of the host state."""
    from mmlspark_tpu_torch.models.zoo import init_state
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerLM
    params = init_state(TransformerLM(**R.LM, dtype=torch.float32), 0)
    ranks = pool.run("torch_mesh_ranks:placed_shards",
                     {"data": 2, "tensor": 2}, params)
    for name, value in params.items():
        uniq = {}
        for r in ranks:
            leaf = r["leaves"][name]
            assert leaf["whole"], name
            uniq[tuple(map(tuple, leaf["index"]))] = leaf["bytes"]
        assert sum(uniq.values()) == value.nbytes, name
    for r in ranks:
        assert r["param_bytes"] == sum(v.nbytes for v in params.values())
        assert r["shard_bytes"] == r["projected"] < r["param_bytes"]


def test_mesh_spec_codec_round_trips_like_the_reference(pool, tmp_path):
    """A MeshSpec-valued meshSpec saves as the reference's axis-size dict
    and loads back as one; a live DeviceMesh saves as its shape."""
    est = DeepClassifier(meshSpec=tmesh.MeshSpec(data=2, tensor=2))
    save_stage(est, str(tmp_path / "est"))
    loaded = load_stage(str(tmp_path / "est"))
    want = jmesh_to_dict(jmesh.MeshSpec(data=2, tensor=2))
    assert loaded.get("meshSpec") == want
    with open(tmp_path / "est" / "metadata.json") as f:
        assert "tensor" in f.read()
    jm = jmesh.make_mesh(jmesh.MeshSpec(data=2, tensor=2), jax.devices()[:4])
    for got in pool.run("torch_mesh_ranks:mesh_codec",
                        {"data": 2, "tensor": 2}):
        assert got == jmesh_to_dict(jm)


RUN_SCRIPT = '''
import json, os, sys
from mmlspark_tpu_torch.parallel import mesh
from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
from mmlspark_tpu_torch.parallel.optim import sgd
from mmlspark_tpu_torch.utils import config
import torch.distributed as dist
trainer = DistributedTrainer(lambda m, b, g: None, sgd(0.1))
out = {"argv": sys.argv[1:], "mesh": mesh.mesh_shape(trainer.mesh),
       "runtime_mesh": config.get("runtime.mesh"),
       "device": str(config.resolve_device()),
       "rank": dist.get_rank(), "world": dist.get_world_size(),
       "local": os.environ["LOCAL_RANK"]}
with open(os.path.join(sys.argv[1], f"rank{dist.get_rank()}.json"), "w") as f:
    json.dump(out, f)
'''


def test_cli_run_nprocs_starts_ranks_with_the_mesh(tmp_path):
    """``cli run --nprocs 2 --mesh data=1,tensor=2 --platform cpu``: two
    ranks join one gloo group, the script's default trainer takes the
    launcher's mesh, the script gets its arguments, each rank states its
    device, and the launcher returns 0 with no rank left running."""
    script = tmp_path / "job.py"
    script.write_text(RUN_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO,
               MMLSPARK_TPU_TORCH_RUNTIME_DIST_BACKEND="gloo")
    proc = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.cli", "run", str(script),
         "--nprocs", "2", "--mesh", "data=1,tensor=2", "--platform", "cpu",
         "--", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    stated = [json.loads(line) for line in proc.stderr.splitlines()
              if line.startswith('{"rank"')]
    assert sorted(s["rank"] for s in stated) == [0, 1]
    assert all(s["device"] == "cpu" and s["backend"] == "gloo"
               for s in stated)
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            out = json.load(f)
        assert out["argv"] == [str(tmp_path)]
        assert out["mesh"]["tensor"] == 2 and out["mesh"]["data"] == 1
        assert out["runtime_mesh"] == "data=1,tensor=2"
        assert (out["rank"], out["world"], out["local"]) == (r, 2, str(r))
