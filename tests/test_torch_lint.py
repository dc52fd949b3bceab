"""The port's reliability lint (``mmlspark_tpu_torch/reliability/lint.py``)
and ``cli check`` against the JAX package's.

- The reference's 56 lint tests, as cases here: the ones of the rules the
  port keeps verbatim (1-6, 8, 12, 15, 16, 18, and the syntax-error case)
  run the reference's own test functions against the port's lint, each
  snippet checked by both lints with equal findings; the rules restated for
  torch (7, 9, 10, 11, 13, 14, 17) get their torch spellings, homes and
  markers here; the repository cases lint the port's tree.
- ``cli check mmlspark_tpu_torch`` exits 0: the port's tree is clean.
"""
import importlib.util
import textwrap
from pathlib import Path

import pytest

from mmlspark_tpu.reliability import lint as jlint
from mmlspark_tpu_torch.reliability import lint

REPO = Path(__file__).resolve().parent.parent


def _reference_tests():
    spec = importlib.util.spec_from_file_location(
        "_reference_lint_tests", REPO / "tests" / "test_reliability_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Both:
    """The port's lint, with every ``check_source`` also run through the
    JAX package's lint and the findings required equal."""

    def check_source(self, src, filename="<src>"):
        got = lint.check_source(src, filename=filename)
        assert got == jlint.check_source(src, filename=filename)
        return got

    def check_file(self, path):
        got = lint.check_file(path)
        assert got == jlint.check_file(path)
        return got


SHARED = [
    "test_flags_urlopen_without_timeout",
    "test_accepts_urlopen_with_timeout_kw_or_positional",
    "test_flags_bare_except_and_swallowed_exception",
    "test_accepts_narrow_or_handled_excepts",
    "test_flags_print_in_library_code",
    "test_accepts_marked_print_and_non_builtin_print",
    "test_flags_thread_without_explicit_daemon",
    "test_accepts_thread_with_explicit_daemon_either_way",
    "test_flags_queue_without_maxsize",
    "test_accepts_queue_with_explicit_maxsize",
    "test_flags_signal_signal_outside_preemption_module",
    "test_accepts_signal_signal_in_its_home_module",
    "test_accepts_signal_signal_with_marker_and_non_installer_calls",
    "test_syntax_error_is_reported_not_crashing",
    "test_flags_direct_replica_call_in_serve",
    "test_replica_rule_scoped_to_serve_and_home_exempt",
    "test_replica_rule_marker_and_non_replica_receivers",
    "test_process_rule_flags_popen_and_os_kill",
    "test_process_rule_flags_bare_popen_everywhere",
    "test_process_rule_home_exempt",
    "test_process_rule_marker_and_non_os_receivers",
    "test_process_rule_launcher_home_exempt",
    "test_actuate_rule_flags_elasticity_and_launcher_levers",
    "test_actuate_rule_lever_homes_exempt",
    "test_actuate_rule_flags_reshard_levers",
    "test_actuate_rule_reshard_homes_and_escape",
    "test_handload_rule_flags_private_rng_in_chaos",
    "test_handload_rule_flags_draws_inside_comprehensions",
    "test_handload_rule_statement_level_draws_are_fine",
    "test_handload_rule_marker_and_other_files_exempt",
    "test_affinity_rule_flags_ring_points_and_vnode_bucketing",
    "test_affinity_rule_home_exempt_and_marker_honored",
    "test_affinity_rule_benign_int_parsing_not_flagged",
]


@pytest.mark.parametrize("name", SHARED)
def test_shared_rule_matches_the_reference(name, tmp_path):
    mod = _reference_tests()
    mod.lint = _Both()
    fn = getattr(mod, name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[
        :fn.__code__.co_argcount] else fn()


def test_every_reference_case_is_accounted_for():
    mod = _reference_tests()
    names = {n for n in dir(mod) if n.startswith("test_")}
    assert len(names) == 56
    assert set(SHARED) <= names
    assert len(SHARED) + len(RESTATED) + len(REPO_CASES) == 56


def _problems(src: str, filename: str = "mod.py") -> list:
    return lint.check_source(textwrap.dedent(src), filename=filename)


# -- rule 7: raw host syncs ---------------------------------------------------

def _flags_raw_host_syncs():
    probs = _problems("""
        import torch

        def fetch(x):
            return x.item()

        def host(x):
            return x.cpu()

        def rows(x):
            return x.tolist()

        def arr(x):
            return x.detach().numpy()

        def wait():
            torch.cuda.synchronize()

        def event(ev):
            ev.synchronize()
    """)
    assert len(probs) == 6
    assert all("uncounted host sync" in p for p in probs)
    assert "allow-sync" in probs[0]
    assert "mod.py:5" in probs[0]


def _accepts_wrappers_numpy_and_marked_syncs():
    assert _problems("""
        import numpy as np
        from mmlspark_tpu_torch.observability import syncs as obssyncs

        def fetch(x):
            return obssyncs.device_get(x, "site")       # the wrapper

        def wait(x):
            syncs.synchronize("site")                   # also the wrapper

        def host(y):
            return np.asarray(y).tolist()               # numpy-built

        def key(v):
            return v.item() if isinstance(v, np.generic) else v

        def deliberate(x):
            return x.tolist()  # lint: allow-sync (a host tensor)

        def unrelated(obj, q):
            obj.to("cpu")
            q.get(timeout=1)
            return obj.items()
    """) == []


def _raw_syncs_in_the_accounting_home():
    src = textwrap.dedent("""
        import torch

        def synchronize(site, device):
            torch.cuda.synchronize(device)
            return device.item()
    """)
    assert lint.check_source(
        src, filename="mmlspark_tpu_torch/observability/syncs.py") == []
    assert len(lint.check_source(src, filename="mmlspark_tpu_torch/x.py")) \
        == 2


# -- rule 9: compile sites in serve/ -----------------------------------------

def _flags_compile_sites_in_serve():
    probs = _problems("""
        import torch

        def build(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn(x)
            return torch.compile(fn)

        def bare():
            return CUDAGraph()
    """, filename="mmlspark_tpu_torch/serve/lane.py")
    assert len(probs) == 4
    assert all("compile site in serve/" in p for p in probs)
    assert "allow-compile" in probs[0]


def _compile_rule_scoped_to_serve_and_homes_exempt():
    src = textwrap.dedent("""
        import torch
        graph = torch.cuda.CUDAGraph()
        step = torch.compile(lambda x: x)
    """)
    for fn in ("mmlspark_tpu_torch/serve/programs.py",
               "mmlspark_tpu_torch/compile_cache.py",
               "mmlspark_tpu_torch/parallel/trainer.py"):
        assert lint.check_source(src, filename=fn) == [], fn


def _compile_rule_marker_and_unrelated_compiles():
    assert _problems("""
        import re
        import torch
        pat = re.compile("x+")
        g = torch.cuda.CUDAGraph()  # lint: allow-compile (a test harness)
        code = compile("1", "f", "eval")
        plot.graph(data)
    """, filename="mmlspark_tpu_torch/serve/x.py") == []


# -- rule 10: device allocations in serve/ -----------------------------------

def _flags_device_allocs_in_serve():
    probs = _problems("""
        import torch

        def scratch(n, dev, like):
            a = torch.zeros(n, device=dev)
            b = torch.empty((n, 4), dtype=torch.int8, device=dev)
            c = torch.full((n,), 7, device="cuda")
            d = torch.ones_like(like)
            return a, b, c, d
    """, filename="mmlspark_tpu_torch/serve/generate.py")
    assert len(probs) == 4
    assert all("device allocation in serve/" in p for p in probs)


def _alloc_rule_scoped_to_serve_and_homes_exempt():
    src = textwrap.dedent("""
        import torch
        arena = torch.zeros(8, device="cuda")
    """)
    for fn in ("mmlspark_tpu_torch/serve/kvcache.py",
               "mmlspark_tpu_torch/serve/registry.py",
               "mmlspark_tpu_torch/parallel/trainer.py"):
        assert lint.check_source(src, filename=fn) == [], fn
    assert len(lint.check_source(
        src, filename="mmlspark_tpu_torch/serve/fleet.py")) == 1


def _alloc_rule_marker_and_host_allocs():
    assert _problems("""
        import numpy as np
        import torch
        host = np.zeros(8)
        cpu = torch.zeros(8)
        pinned = torch.empty(8, pin_memory=True)
        x = torch.zeros(8, device=dev)  # lint: allow-alloc (static input)
        cols = torch.where(valid, rows, 0)
    """, filename="mmlspark_tpu_torch/serve/x.py") == []


# -- rule 11: device-byte arithmetic in serve/ --------------------------------

def _flags_byte_arithmetic_in_serve():
    probs = _problems("""
        def size(t, a):
            return t.numel() * t.element_size() + a.nbytes + a.itemsize
    """, filename="mmlspark_tpu_torch/serve/registry.py")
    assert len(probs) == 3
    assert all("device-byte arithmetic" in p for p in probs)


def _bytes_rule_scoped_to_serve_and_home_exempt():
    src = textwrap.dedent("""
        def size(t):
            return t.numel() * t.element_size() + t.nbytes
    """)
    for fn in ("mmlspark_tpu_torch/observability/memory.py",
               "mmlspark_tpu_torch/parallel/trainer.py"):
        assert lint.check_source(src, filename=fn) == [], fn


def _bytes_rule_marker_and_delegation_spelling():
    assert _problems("""
        from mmlspark_tpu_torch.observability import memory
        def size(t):
            n = memory.nbytes_of(t)
            m = t.element_size()  # lint: allow-bytes (one dtype's width)
            return n + m
    """, filename="mmlspark_tpu_torch/serve/x.py") == []


# -- rule 13: int8 quantization in serve/ -------------------------------------

def _quant_rule_flags_int8_cast_and_scale_math():
    probs = _problems("""
        import numpy as np
        import torch

        def quant(x, amax):
            scale = amax / 127.0
            q = (x / scale).round().to(torch.int8)
            r = x.to(dtype=torch.int8)
            h = np.asarray(x).astype(np.int8)
            return q, r, h, 127 * scale
    """, filename="mmlspark_tpu_torch/serve/generate.py")
    assert len(probs) == 5
    assert sum("int8 quantization cast" in p for p in probs) == 3
    assert sum("quantization scale math" in p for p in probs) == 2


def _quant_rule_scoped_to_serve_and_home_exempt():
    src = textwrap.dedent("""
        import torch
        def q(x):
            return (x / 127.0).to(torch.int8)
    """)
    for fn in ("mmlspark_tpu_torch/serve/kvcache.py",
               "mmlspark_tpu_torch/models/zoo/moe.py"):
        assert lint.check_source(src, filename=fn) == [], fn


def _quant_rule_marker_and_benign_arithmetic():
    assert _problems("""
        import torch
        def f(x, n):
            y = x.to(torch.bfloat16)
            z = x.to(torch.int32)
            w = n * 128 + 126
            v = x.to(torch.int8)  # lint: allow-quant (a test of the arena)
            return y, z, w, v
    """, filename="mmlspark_tpu_torch/serve/x.py") == []


# -- rule 14: sharding specs outside their homes ------------------------------

def _spec_rule_flags_open_coded_specs():
    probs = _problems("""
        from torch.distributed.tensor import Replicate, Shard
        from mmlspark_tpu_torch.parallel.sharding import ParamSharding

        def place(shape, sizes):
            a = ParamSharding(("tensor", None), shape, sizes)
            b = [Shard(0), Replicate()]
            return a, b, P("data")
    """, filename="mmlspark_tpu_torch/parallel/optim.py")
    assert len(probs) == 4
    assert all("sharding-spec construction" in p for p in probs)


def _spec_rule_homes_exempt_and_marker_honored():
    src = textwrap.dedent("""
        def rule(shape, sizes):
            return ParamSharding(("tensor", None), shape, sizes)
    """)
    for fn in ("mmlspark_tpu_torch/parallel/sharding.py",
               "mmlspark_tpu_torch/parallel/mesh.py"):
        assert lint.check_source(src, filename=fn) == [], fn
    assert _problems("""
        from mmlspark_tpu_torch.parallel import sharding
        a = sharding.without_dim(sh, 1)
        b = [Shard(0)]  # lint: allow-spec (a DTensor view local to a test)
    """) == []


# -- rule 17: embedding gather/scatter ----------------------------------------

def _embed_rule_flags_gather_scatter_and_bucketing():
    probs = _problems("""
        import torch.nn.functional as F

        def grads(table, ids, g, rows_per_shard, num_shards, w):
            table.index_add_(0, ids, g)
            table.scatter_add_(0, ids[:, None].expand_as(g), g)
            bags = F.embedding_bag(ids, w, mode="sum")
            owner = ids // rows_per_shard
            slot = ids % num_shards
            return bags, owner, slot, segment_sum(g, ids)
    """, filename="mmlspark_tpu_torch/models/zoo/x.py")
    assert len(probs) == 6
    assert sum("embedding gather/scatter" in p for p in probs) == 4
    assert sum("id-bucketing" in p for p in probs) == 2


def _embed_rule_home_exempt_and_marker_honored():
    src = textwrap.dedent("""
        def lookup(table, ids, g, rows_per_shard):
            table.index_add_(0, ids, g)
            return ids // rows_per_shard
    """)
    assert lint.check_source(
        src, filename="mmlspark_tpu_torch/embed/tables.py") == []
    assert _problems("""
        def counts(cm, flat, ones):
            cm.index_add_(0, flat, ones)  # lint: allow-embed (histogram)
    """) == []


def _embed_rule_benign_arithmetic_not_flagged():
    assert _problems("""
        def f(width, grid, n, ids, k):
            a = width // grid
            b = n % 8
            c = ids // k
            return a, b, c, ids.index_select(0, ids)
    """) == []


RESTATED = {
    "test_flags_raw_host_sync_calls": _flags_raw_host_syncs,
    "test_accepts_counted_wrappers_and_marked_raw_syncs":
        _accepts_wrappers_numpy_and_marked_syncs,
    "test_accepts_raw_syncs_in_the_accounting_home":
        _raw_syncs_in_the_accounting_home,
    "test_flags_compile_sites_in_serve": _flags_compile_sites_in_serve,
    "test_compile_rule_scoped_to_serve_and_seam_exempt":
        _compile_rule_scoped_to_serve_and_homes_exempt,
    "test_compile_rule_marker_and_unrelated_compiles":
        _compile_rule_marker_and_unrelated_compiles,
    "test_flags_device_allocs_in_serve": _flags_device_allocs_in_serve,
    "test_alloc_rule_scoped_to_serve_and_home_exempt":
        _alloc_rule_scoped_to_serve_and_homes_exempt,
    "test_alloc_rule_marker_and_host_allocs":
        _alloc_rule_marker_and_host_allocs,
    "test_flags_byte_arithmetic_in_serve": _flags_byte_arithmetic_in_serve,
    "test_bytes_rule_scoped_to_serve_and_home_exempt":
        _bytes_rule_scoped_to_serve_and_home_exempt,
    "test_bytes_rule_marker_and_delegation_spelling":
        _bytes_rule_marker_and_delegation_spelling,
    "test_quant_rule_flags_int8_cast_and_scale_math":
        _quant_rule_flags_int8_cast_and_scale_math,
    "test_quant_rule_scoped_to_serve_and_home_exempt":
        _quant_rule_scoped_to_serve_and_home_exempt,
    "test_quant_rule_marker_and_benign_arithmetic":
        _quant_rule_marker_and_benign_arithmetic,
    "test_spec_rule_flags_open_coded_partition_specs":
        _spec_rule_flags_open_coded_specs,
    "test_spec_rule_homes_exempt_and_marker_honored":
        _spec_rule_homes_exempt_and_marker_honored,
    "test_embed_rule_flags_gather_scatter_and_bucketing":
        _embed_rule_flags_gather_scatter_and_bucketing,
    "test_embed_rule_home_exempt_and_marker_honored":
        _embed_rule_home_exempt_and_marker_honored,
    "test_embed_rule_benign_arithmetic_not_flagged":
        _embed_rule_benign_arithmetic_not_flagged,
}


@pytest.mark.parametrize("name", sorted(RESTATED))
def test_restated_rule(name):
    RESTATED[name]()


# -- the repository ------------------------------------------------------------

def _repo_is_clean():
    problems = lint.check_roots(["mmlspark_tpu_torch"], base=REPO)
    assert problems == [], "\n".join(problems)


def _missing_root_fails_loudly():
    probs = lint.check_roots(["definitely_missing_dir"], base=REPO)
    assert probs == ["definitely_missing_dir: root not found"]


def _cli_check_subcommand_runs_the_same_lint():
    import contextlib
    import io
    import os
    from mmlspark_tpu_torch.cli import main
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with contextlib.redirect_stdout(out):
            assert main(["check", "mmlspark_tpu_torch"]) == 0
            assert main(["check", "definitely_missing_dir"]) == 1
    finally:
        os.chdir(cwd)
    text = out.getvalue()
    assert "check_reliability: clean (mmlspark_tpu_torch)" in text
    assert "root not found" in text


REPO_CASES = {
    "test_repo_is_clean": _repo_is_clean,
    "test_missing_root_fails_loudly": _missing_root_fails_loudly,
    "test_cli_check_subcommand_runs_the_same_lint":
        _cli_check_subcommand_runs_the_same_lint,
}


@pytest.mark.parametrize("name", sorted(REPO_CASES))
def test_repository(name):
    REPO_CASES[name]()
