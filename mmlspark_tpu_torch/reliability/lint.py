"""Static reliability lint: the two bug classes this subsystem exists for.

The port's copy of ``mmlspark_tpu/reliability/lint.py``. Rules 1-6, 8, 12,
15, 16 and 18 keep the reference's matchers and homes; rules 7, 9, 10, 11,
13, 14 and 17 are restated for torch (their text below names the torch
spellings). ``mmlspark-tpu-torch check`` runs it over
``mmlspark_tpu_torch/``.

Rule 1 — ``urlopen(...)`` without an explicit ``timeout=``: a stalled
connection hangs the caller forever (the pre-reliability downloader did
exactly this on MANIFEST and model fetches).

Rule 2 — ``except:`` (bare) or ``except Exception: pass`` / ``except
BaseException: pass``: a swallowed error turns a crash into silent
corruption — the failure mode the fault-injection harness exists to make
reproducible, and the one a reliability subsystem must not ship.

Rule 3 — ``print(...)`` in library code: stdout bypasses the framework
logger tree AND the telemetry layer (observability/), so the output is
invisible to log levels, event logs, and run reports. Route through
``get_logger`` or ``observability.events.emit``. CLI entry points whose
CONTRACT is stdout (e.g. ``mmlspark-tpu info`` printing JSON) mark the
line with ``# lint: allow-print``.

Rule 4 — ``threading.Thread(...)`` without an explicit ``daemon=``: the
default (inherit the creator's daemon flag) decides whether interpreter
shutdown BLOCKS on the thread, and an implicit choice is how a serving
executor or prefetch worker quietly turns Ctrl-C into a hang. Every
library-code thread states its shutdown contract at the constructor.

Rule 5 — ``queue.Queue(...)`` without an explicit ``maxsize=``: the
default is unbounded, which silently removes backpressure — a stalled
consumer (a wedged device, a slow decode stage) lets the producer buffer
the whole stream in host memory instead of blocking. Every library-code
queue states its bound; a deliberate unbounded queue writes ``maxsize=0``
so the choice is greppable.

Rule 6 — ``signal.signal(...)`` outside ``reliability/preemption.py``:
signal handlers are PROCESS-GLOBAL and last-installer-wins, so a handler
registered in some corner of the library silently clobbers the
preemption layer's SIGTERM->clean-checkpoint path. All handler
installation goes through ``reliability.preemption``; intentional
exceptions mark the line ``# lint: allow-signal``.

Rule 7 — raw host syncs outside ``observability/syncs.py``: ``.item()``,
``.cpu()``, ``.tolist()`` and ``.numpy()`` (the fetches of a device
tensor), ``torch.cuda.synchronize()`` and ``<event or stream>.
synchronize()``: every one is a host<->device round trip the sync
accounter cannot see, which silently falsifies the "syncs per step"
scoreboard. Route through ``syncs.device_get`` / ``syncs.block_until_ready``
/ ``syncs.synchronize`` (calls whose receiver mentions ``sync`` are
recognized as the wrappers). A static matcher cannot see where a tensor
lives, so two host spellings are exempt by their form: a receiver built by
numpy (``np.asarray(x).tolist()``) and the numpy-scalar idiom
``v.item() if isinstance(v, np.generic) else v``; other host-side calls (a
CPU tensor's ``.tolist()``, a numpy array's) mark the line
``# lint: allow-sync`` with the reason.

Rule 8 — direct replica calls (``<x>replica.submit/submit_async/
submit_many/score(...)``) in ``serve/`` outside ``serve/router.py``: a
cross-replica call that bypasses the router bypasses its circuit
breaker, failover retry, and fairness accounting — the exact wrappers
the fleet layer exists to enforce — so one unrouted call site quietly
loses a request when its replica dies. All cross-replica traffic goes
through the Router; deliberate direct calls (a rollout warming a
drained replica) mark the line ``# lint: allow-direct-replica``.

Rule 9 — compile sites (``torch.cuda.graph(...)``, ``CUDAGraph()``,
``torch.compile(...)``) in ``serve/`` outside ``serve/programs.py`` and
``compile_cache.py``: the port's serving programs are CUDA graphs captured
once per bucket by ``serve/programs.py`` (the registry counts each capture
as a compile), and an unsanctioned capture elsewhere in the serving layer
is invisible to the ``compiles`` counters and the capture lock. All
serve-side capture goes through ``serve.programs``; deliberate exceptions
mark the line ``# lint: allow-compile``.

Rule 10 — device allocations (``torch.zeros/ones/full/empty(...,
device=...)`` and their ``_like`` forms) in ``serve/`` outside
``serve/kvcache.py`` and ``serve/registry.py``: serving-side HBM is a budgeted arena — params under
the registry's ``runtime.device_cache_mb`` LRU, decode KV pages under the
``KVCacheManager`` free list — and an ad-hoc allocation is invisible to
both accountants, so occupancy gauges and eviction decisions quietly lie
until the real device OOMs. All serve-side device memory goes through
``KVCacheManager`` or ``ModelRegistry``; deliberate exceptions mark the
line ``# lint: allow-alloc``.

Rule 11 — device-byte arithmetic (``.nbytes`` / ``.itemsize`` /
``.element_size()``) in ``serve/`` outside ``observability/memory.py``: HBM accounting lives in
one ledger so totals stay mutually consistent — a private size formula
in a serve/ module drifts from the ledger's (padding, dtype, layout) and
the occupancy gauges stop summing. Size arithmetic goes through
``memory.nbytes_of`` / ``memory.param_bytes``; deliberate exceptions
mark the line ``# lint: allow-bytes``.

Rule 12 — process management (``subprocess.Popen(...)``, ``os.kill(...)``,
``os.waitpid(...)``) outside ``serve/supervisor.py`` /
``serve/launcher.py``: child processes need exactly one owner per layer
— a worker spawned (or signalled) from some corner of the library is
invisible to the supervisor's restart/backoff/breaker machinery and its
drain path (and a per-host fleet started outside the launcher is
invisible to its stop/drain fan-in), so it leaks on shutdown and
double-restarts under chaos. All process lifecycle goes through the
supervisor (workers) or the host launcher (per-host fleets); deliberate
exceptions mark the line ``# lint: allow-process``.

Rule 13 — quantization arithmetic (``torch.int8`` casts: ``.to(torch.int8)``,
``.to(dtype=torch.int8)``, ``.astype(np.int8)``; ``127``-range scale math)
in ``serve/`` outside ``serve/kvcache.py``:
the int8 KV arena keeps ONE quantization scheme (symmetric per-row
absmax, ``quantize_rows``/``dequantize_rows``) so stored blocks and
every program that reads them agree bit-for-bit — an open-coded cast or
scale formula in a program builder silently diverges from the arena's
(rounding mode, clip range, scale epsilon) and decodes garbage KV.
Quant math goes through the ``kvcache`` helpers; deliberate exceptions
mark the line ``# lint: allow-quant``.

Rule 14 — sharding-spec construction (the port's ``ParamSharding``, torch's
``Shard`` / ``Replicate`` placements, and the reference's ``PartitionSpec`` /
``NamedSharding`` / ``P(...)`` spellings) outside ``parallel/sharding.py`` /
``parallel/mesh.py``: placement decisions live in ONE home so the 2-D
``(data, model)`` mesh mode can change topology without auditing every
module — an open-coded spec in a trainer or the serving lane silently
disagrees with the param-sharding rules (axis names, divisibility
clamps) and either crashes at dispatch or replicates a tensor the mesh
was supposed to split. Route through the sharding helpers
(``param_shardings``, ``replicated``, ``kv_arena_sharding``,
``epoch_cache_sharding``, ...); genuinely local spec construction (e.g.
``shard_map`` in/out specs naming module-private axes) marks the line
``# lint: allow-spec``.

Rule 15 — fleet actuator calls (``set_weight`` / ``kill_replica`` /
``scale_up`` / ``scale_down`` / ``add_replica`` / ``remove_replica`` /
``set_capacity`` / ``reset_breaker`` / ``add_slot`` / ``retire_slot`` /
``launch_host`` / ``stop_host`` / ``reshard`` / ``reshard_to``, plus
``.kill()`` on a replica/fleet receiver) outside ``control/`` and the
existing
rollout/supervisor/launcher homes: every control action must stay
attributable —
an actuation from a random module is invisible to the autopilot's
decision telemetry (``autopilot.*`` events), so a post-mortem can no
longer explain why a weight moved or a replica died. Route actions
through ``control.autopilot`` (or the fleet/supervisor machinery that
owns them); deliberate out-of-band actuations (a chaos scenario's kill,
an operator script) mark the line ``# lint: allow-actuate``.

Rule 16 — hand-rolled load construction in ``reliability/chaos.py``:
a private ``default_rng(...)`` generator, or ``randrange``/``randint``
draws inside a comprehension, is how a scenario builds its own request
stream — payloads and prompts that exist outside the shared, seeded
workload vocabulary (``testing/loadgen``: ``generate`` schedules,
``feature_rows``, ``token_prompts``, ``PromptPopulation``) and
therefore outside the byte-identical replay contract the open-loop
rework established. Scenarios draw load ONLY from loadgen; a
deliberate hand-rolled stream marks the line
``# lint: allow-handload``.

Rule 17 — embedding gather/scatter arithmetic (``index_add_`` /
``scatter_add_`` / ``embedding_bag`` / ``segment_sum`` / ``scatter_add``
calls) or id-bucketing math (``ids // rows_per_shard``,
``id % num_shards`` — floor-div/mod pairing an id operand with a shard
operand) outside ``embed/tables.py``: the fused all-to-all lookup and
the sparse scatter-add gradient are bit-identical to the unsharded
reference ONLY because every step (bucket capacity, stable sort,
segment order) lives in one audited home — a private re-implementation
in a model or serving module silently diverges in association order
and breaks the recommender's cross-topology bit-identity contract.
Route through ``embed.tables`` (``make_bag_lookup``,
``bag_lookup_reference``, ``sparse_table_grads``); deliberate
exceptions mark the line ``# lint: allow-embed``.

Rule 18 — consistent-hash / digest-scoring arithmetic outside
``serve/affinity.py``: a ring point minted from a truncated
cryptographic digest (``int(sha256(...).hexdigest()[:16], 16)``) or
vnode/ring modular bucketing math is placement policy the WHOLE fleet
must agree on — a private ring in a scenario, bench, or second serving
module assigns the same session key to a different replica than the
router does, and the "N replicas, one KV cache" contract silently
splits. The scoring/ring home is ``serve.affinity``
(``ConsistentHashRing``, ``score_digest``); deliberate exceptions mark
the line ``# lint: allow-affinity``.

Shared core for ``tools/check_reliability.py`` (standalone CLI),
``mmlspark-tpu-torch check`` (installed CLI), and the in-pytest gate
(tests/test_torch_lint.py) — same single source of truth pattern as
``tools/namecheck.py``.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Sequence, Union

# The canonical scope: production code only. tests/ legitimately use broad
# excepts in fixtures; examples/ and tools/ are not on the serving path.
DEFAULT_ROOTS = ["mmlspark_tpu_torch"]


def _is_urlopen(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Name) and f.id == "urlopen") or \
        (isinstance(f, ast.Attribute) and f.attr == "urlopen")


def _is_thread_ctor(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Name) and f.id == "Thread") or \
        (isinstance(f, ast.Attribute) and f.attr == "Thread")


def _is_queue_ctor(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Name) and f.id == "Queue") or \
        (isinstance(f, ast.Attribute) and f.attr == "Queue")


def _catches_everything(node: ast.expr) -> bool:
    """Does this except clause name Exception/BaseException (alone or in a
    tuple)?"""
    names = node.elts if isinstance(node, ast.Tuple) else [node]
    return any(isinstance(n, ast.Name)
               and n.id in ("Exception", "BaseException") for n in names)


_ALLOW_PRINT = "# lint: allow-print"
_ALLOW_SIGNAL = "# lint: allow-signal"
_ALLOW_SYNC = "# lint: allow-sync"
# the ONE module allowed to install process-global signal handlers
_SIGNAL_HOME = "reliability/preemption.py"
# the ONE module allowed to call the raw blocking primitives
_SYNC_HOME = "observability/syncs.py"
# the fetches of a device tensor and the blocking waits
_SYNC_FETCHES = ("item", "cpu", "tolist", "numpy")
_ALLOW_REPLICA = "# lint: allow-direct-replica"
# the ONE serve/ module allowed to call replicas directly (it IS the
# breaker/retry wrapper layer)
_REPLICA_HOME = "serve/router.py"
_REPLICA_CALLS = ("submit", "submit_async", "submit_many", "score")
_ALLOW_COMPILE = "# lint: allow-compile"
# the ONE module allowed to compile serve-side programs (it IS the
# persistent AOT cache seam)
_COMPILE_HOMES = ("compile_cache.py", "serve/programs.py")
_ALLOW_ALLOC = "# lint: allow-alloc"
# the ONE serve/ module allowed to allocate device memory directly (it IS
# the KV arena accountant; params are the registry's job)
_ALLOC_HOMES = ("serve/kvcache.py", "serve/registry.py")
_ALLOC_CALLS = ("zeros", "ones", "full", "empty", "zeros_like",
                "ones_like", "full_like", "empty_like")
_ALLOW_BYTES = "# lint: allow-bytes"
# the ONE module allowed to do device-byte arithmetic (it IS the ledger)
_BYTES_HOME = "observability/memory.py"
_BYTES_ATTRS = ("nbytes", "itemsize")
_BYTES_CALLS = ("element_size",)
_ALLOW_PROCESS = "# lint: allow-process"
# the modules allowed to manage OS processes: the supervisor (worker
# lifecycle on one host) and the host launcher (fleet-per-host fan-out)
_PROCESS_HOMES = ("serve/supervisor.py", "serve/launcher.py")
_PROCESS_OS_CALLS = ("kill", "waitpid")
_ALLOW_QUANT = "# lint: allow-quant"
# the ONE serve/ module allowed to open-code KV quantization arithmetic
# (it owns quantize_rows/dequantize_rows — the single scheme every
# arena reader and writer must share)
_QUANT_HOME = "serve/kvcache.py"
_ALLOW_SPEC = "# lint: allow-spec"
# the modules allowed to construct placement specs directly (they ARE the
# sharding policy: the rule table, the topology resolver)
_SPEC_HOMES = ("parallel/sharding.py", "parallel/mesh.py")
_SPEC_CTORS = ("ParamSharding", "Shard", "Replicate", "PartitionSpec",
               "NamedSharding")
_ALLOW_ACTUATE = "# lint: allow-actuate"
# the modules allowed to move fleet levers: the decision loop itself,
# and the serve/ machinery that OWNS each lever (router weights, fleet
# scale/rollout, supervisor restart + slot elasticity, host launcher)
_ACTUATE_HOMES = ("control/autopilot.py", "serve/router.py",
                  "serve/fleet.py", "serve/supervisor.py",
                  "serve/launcher.py")
_ACTUATE_CALLS = ("set_weight", "kill_replica", "scale_up", "scale_down",
                  "add_replica", "remove_replica", "set_capacity",
                  "reset_breaker", "add_slot", "retire_slot",
                  "launch_host", "stop_host", "reshard", "reshard_to")
_ALLOW_HANDLOAD = "# lint: allow-handload"
# the ONE module chaos scenarios may construct load through (schedules,
# feature streams, token prompts, prefix populations — all seeded,
# all replayable)
_HANDLOAD_HOME = "testing/loadgen.py"
# Rule 16 scope: the chaos scenario harness only
_HANDLOAD_SCOPE = "reliability/chaos.py"
_HANDLOAD_DRAWS = ("randrange", "randint")
_ALLOW_EMBED = "# lint: allow-embed"
# the ONE module allowed to open-code embedding gather/scatter and
# id-bucketing arithmetic (it IS the fused lookup / sparse-grad home
# whose association order defines the bit-identity contract)
_EMBED_HOME = "embed/tables.py"
_EMBED_CALLS = ("index_add_", "scatter_add_", "embedding_bag",
                "segment_sum", "scatter_add")
_ALLOW_AFFINITY = "# lint: allow-affinity"
# the ONE module allowed to mint ring points from digests and open-code
# vnode/ring bucketing (it IS the placement policy every router, bench,
# and scenario must agree with)
_AFFINITY_HOME = "serve/affinity.py"


def _receiver_name(v: ast.expr) -> str:
    return v.id if isinstance(v, ast.Name) else (
        v.attr if isinstance(v, ast.Attribute) else "")


def _is_numpy_built(v: ast.expr) -> bool:
    """A receiver made by numpy: ``np.asarray(x)``, ``numpy.array(x)``."""
    return (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
            and isinstance(v.func.value, ast.Name)
            and v.func.value.id in ("np", "numpy"))


def _numpy_scalar_guards(tree: ast.AST) -> set:
    """``id()`` of the ``<v>.item()`` calls in the numpy-scalar idiom
    ``v.item() if isinstance(v, np.generic) else v``."""
    out = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.IfExp)
                and isinstance(node.test, ast.Call)
                and isinstance(node.test.func, ast.Name)
                and node.test.func.id == "isinstance"
                and len(node.test.args) == 2
                and isinstance(node.test.args[0], ast.Name)
                and isinstance(node.test.args[1], ast.Attribute)
                and node.test.args[1].attr == "generic"):
            continue
        name = node.test.args[0].id
        body = node.body
        if (isinstance(body, ast.Call) and isinstance(body.func, ast.Attribute)
                and body.func.attr == "item"
                and isinstance(body.func.value, ast.Name)
                and body.func.value.id == name):
            out.add(id(body))
    return out


def _is_raw_sync(call: ast.Call) -> bool:
    """``<x>.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` (no
    arguments: the fetch of a tensor), ``torch.cuda.synchronize(...)`` and
    ``<event or stream>.synchronize()`` — the raw blocking primitives.
    Calls routed through the accounting wrappers are exempt: an attribute
    call whose receiver NAME mentions ``sync`` (``syncs.synchronize``) is
    the wrapper, not the primitive; so is a receiver numpy built."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if "sync" in _receiver_name(f.value).lower():
        return False
    if f.attr == "synchronize":
        return True
    if f.attr in _SYNC_FETCHES and not call.args and not call.keywords:
        return not _is_numpy_built(f.value)
    return False


def _is_direct_replica_call(call: ast.Call) -> bool:
    """``<recv>.submit/submit_async/submit_many/score(...)`` where the
    receiver's terminal name mentions ``replica`` (``replica.submit``,
    ``h.replica.submit``, ``self.replica.score``) — a raw cross-replica
    call. Router-mediated traffic never spells the replica receiver at
    the call site, so the name is the signal."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr in _REPLICA_CALLS):
        return False
    v = f.value
    if isinstance(v, ast.Name):
        name = v.id
    elif isinstance(v, ast.Attribute):
        name = v.attr
    else:
        return False
    return "replica" in name.lower()


def _is_compile_site(call: ast.Call) -> bool:
    """A serve-side capture or compile: ``torch.cuda.graph(...)`` (the
    capture context), ``CUDAGraph()`` in any spelling, and
    ``torch.compile(...)``. The ``torch``-receiver requirement keeps
    ``re.compile(...)`` out of scope."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id == "CUDAGraph"
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "CUDAGraph":
        return True
    if f.attr == "graph":
        return _receiver_name(f.value) == "cuda"
    return f.attr == "compile" and isinstance(f.value, ast.Name) \
        and f.value.id == "torch"


def _is_device_alloc(call: ast.Call) -> bool:
    """A device-memory allocation site: ``torch.zeros(..., device=...)``
    (any factory in :data:`_ALLOC_CALLS` on a receiver named ``torch``
    with a ``device=`` keyword), and the ``_like`` forms on ``torch``,
    which allocate wherever their source tensor lives. Host-side
    ``np.zeros`` and a factory without ``device=`` (the CPU) are NOT
    flagged — host RAM is not the budgeted device memory the serve-side
    accountants track."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr in _ALLOC_CALLS
            and isinstance(f.value, ast.Name) and f.value.id == "torch"):
        return False
    return f.attr.endswith("_like") or any(kw.arg == "device"
                                           for kw in call.keywords)


def _is_process_call(call: ast.Call) -> bool:
    """``subprocess.Popen(...)`` (any receiver, or a bare ``Popen(...)``
    name call) plus ``os.kill(...)`` / ``os.waitpid(...)`` — process
    lifecycle management. The ``os.``-receiver restriction mirrors
    :func:`_is_signal_signal`: ``proc.kill()`` / ``replica.kill()`` are
    object methods with their own contracts, not the raw syscall."""
    f = call.func
    if isinstance(f, ast.Name) and f.id == "Popen":
        return True
    if isinstance(f, ast.Attribute) and f.attr == "Popen":
        return True
    return (isinstance(f, ast.Attribute) and f.attr in _PROCESS_OS_CALLS
            and isinstance(f.value, ast.Name) and f.value.id == "os")


def _mentions_int8(node: ast.expr) -> bool:
    """``torch.int8`` / ``np.int8`` / bare ``int8`` / the string
    ``"int8"`` — any spelling of the quantized storage dtype."""
    if isinstance(node, ast.Attribute):
        return node.attr == "int8"
    if isinstance(node, ast.Name):
        return node.id == "int8"
    return isinstance(node, ast.Constant) and node.value == "int8"


def _is_quant_cast(call: ast.Call) -> bool:
    """``<x>.to(torch.int8)`` / ``.to(dtype=torch.int8)`` /
    ``.astype(np.int8)`` (any int8 spelling) — the narrowing cast at the
    heart of open-coded KV quantization. Widening casts and casts to other
    dtypes are not quantization and stay out of scope."""
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr in ("to", "astype")
            and (any(_mentions_int8(a) for a in call.args)
                 or any(kw.arg == "dtype" and _mentions_int8(kw.value)
                        for kw in call.keywords)))


def _is_quant_scale_math(node: ast.BinOp) -> bool:
    """Arithmetic against the ``127``/``127.0`` quantization range
    constant on either side — scale-factor math (``amax / 127.0``,
    ``q * scale`` spelled with the range). The magic number IS the
    signal: no other serve-side arithmetic has a reason to touch it."""
    def _is_range(n: ast.expr) -> bool:
        return isinstance(n, ast.Constant) and n.value in (127, 127.0)
    return _is_range(node.left) or _is_range(node.right)


def _is_spec_ctor(call: ast.Call) -> bool:
    """``PartitionSpec(...)`` / ``NamedSharding(...)`` in any spelling
    (bare name, module-qualified, or the conventional
    ``P(...)`` alias) — a placement decision being made at the call
    site. A bare ``P`` name call is only ever the PartitionSpec alias
    in this codebase; Rule 14's scope is library code, where that
    convention holds."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in _SPEC_CTORS or f.id == "P"
    return isinstance(f, ast.Attribute) and f.attr in _SPEC_CTORS


def _is_actuator_call(call: ast.Call) -> bool:
    """A fleet-lever actuation: any attribute call named in
    :data:`_ACTUATE_CALLS` (the lever methods are distinctive enough
    that the name alone is the signal), plus ``.kill(...)`` where the
    receiver's terminal name mentions ``replica`` or ``fleet`` (the
    chaos kill lever; ``proc.kill()``/``handle.kill()`` keep their own
    Rule 12 contract)."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr in _ACTUATE_CALLS:
        return True
    if f.attr != "kill":
        return False
    v = f.value
    if isinstance(v, ast.Name):
        name = v.id
    elif isinstance(v, ast.Attribute):
        name = v.attr
    else:
        return False
    return "replica" in name.lower() or "fleet" in name.lower()


def _is_handload_rng(call: ast.Call) -> bool:
    """``default_rng(...)`` in any spelling (``np.random.default_rng``,
    an aliased import, a bare name) — a private numpy Generator is the
    signature of a scenario hand-rolling its own feature stream instead
    of drawing from :data:`_HANDLOAD_HOME`."""
    f = call.func
    return (isinstance(f, ast.Name) and f.id == "default_rng") or \
        (isinstance(f, ast.Attribute) and f.attr == "default_rng")


def _is_signal_signal(call: ast.Call) -> bool:
    """``signal.signal(...)`` (or any ``<x>.signal(...)`` attribute call on
    a name ending in ``signal``) — the handler-installation form. A bare
    ``signal(...)`` name call is NOT flagged: that's someone's local
    function, not the stdlib installer."""
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "signal"
            and isinstance(f.value, ast.Name) and f.value.id == "signal")


def _is_embed_call(call: ast.Call) -> bool:
    """``segment_sum(...)`` / ``scatter_add(...)`` under any spelling
    (bare name or any receiver: ``x.index_add_``, ``F.embedding_bag``)."""
    f = call.func
    return (isinstance(f, ast.Name) and f.id in _EMBED_CALLS) or \
        (isinstance(f, ast.Attribute) and f.attr in _EMBED_CALLS)


def _mentions_token(node: ast.expr, tokens) -> bool:
    """Does any identifier in the expression carry one of ``tokens`` as
    an underscore-separated word (``ids``, ``flat_ids``, ``num_shards``,
    ``rows_per_shard``)? Word-level matching so ``width``/``grid`` never
    false-positive on the substring ``id``."""
    for sub in ast.walk(node):
        name = sub.id if isinstance(sub, ast.Name) else (
            sub.attr if isinstance(sub, ast.Attribute) else None)
        if name and any(t in name.lower().split("_") for t in tokens):
            return True
    return False


def _is_id_bucketing(binop: ast.BinOp) -> bool:
    """``ids // rows_per_shard`` / ``id % num_shards``: floor-div or mod
    pairing an id-named operand with a shard-named one — the owner
    computation at the heart of the bucketized lookup."""
    if not isinstance(binop.op, (ast.FloorDiv, ast.Mod)):
        return False
    return _mentions_token(binop.left, ("id", "ids")) \
        and _mentions_token(binop.right, ("shard", "shards"))


def _is_ring_point(call: ast.Call) -> bool:
    """``int(<...>.hexdigest()<...>, 16)`` — a cryptographic digest
    truncated into a base-16 integer, the signature of a ring point (or
    any other hash-derived placement key) being minted inline."""
    f = call.func
    if not (isinstance(f, ast.Name) and f.id == "int"):
        return False
    if len(call.args) != 2:
        return False
    base = call.args[1]
    if not (isinstance(base, ast.Constant) and base.value == 16):
        return False
    return any(isinstance(sub, ast.Attribute) and sub.attr == "hexdigest"
               for sub in ast.walk(call.args[0]))


def _is_ring_bucketing(binop: ast.BinOp) -> bool:
    """``point % num_vnodes`` / ``h // ring_size``: mod or floor-div
    arithmetic with a vnode/ring-named operand — ring ownership math
    deciding which replica a key lands on."""
    if not isinstance(binop.op, (ast.FloorDiv, ast.Mod)):
        return False
    toks = ("vnode", "vnodes", "ring")
    return _mentions_token(binop.left, toks) \
        or _mentions_token(binop.right, toks)


def check_source(src: str, filename: str = "<src>") -> List[str]:
    """Return ``"file:line: message"`` problems for one module's source."""
    problems: List[str] = []
    tree = ast.parse(src, filename=filename)
    lines = src.splitlines()
    norm = str(filename).replace("\\", "/")
    signal_home = norm.endswith(_SIGNAL_HOME)
    sync_home = norm.endswith(_SYNC_HOME)
    numpy_scalars = _numpy_scalar_guards(tree)
    # Rule 8 scope: serve/ modules only (the fleet layer), router exempt
    replica_scoped = "serve/" in norm and not norm.endswith(_REPLICA_HOME)
    # Rule 9 scope: serve/ modules only, the program seam exempt
    compile_scoped = "serve/" in norm and not any(
        norm.endswith(h) for h in _COMPILE_HOMES)
    # Rule 10 scope: serve/ modules only, the KV arena and registry exempt
    alloc_scoped = "serve/" in norm and not any(
        norm.endswith(h) for h in _ALLOC_HOMES)
    # Rule 11 scope: serve/ modules only (the ledger home is outside it)
    bytes_scoped = "serve/" in norm and not norm.endswith(_BYTES_HOME)
    # Rule 12 scope: everywhere, the process-management homes exempt
    # (supervisor + host launcher ARE the owners)
    process_home = any(norm.endswith(h) for h in _PROCESS_HOMES)
    # Rule 13 scope: serve/ modules only, the quant-scheme home exempt
    quant_scoped = "serve/" in norm and not norm.endswith(_QUANT_HOME)
    # Rule 14 scope: everywhere, the sharding-policy homes exempt
    spec_scoped = not any(norm.endswith(h) for h in _SPEC_HOMES)
    # Rule 15 scope: everywhere, the decision loop + lever owners exempt
    actuate_scoped = not any(norm.endswith(h) for h in _ACTUATE_HOMES)
    # Rule 16 scope: the chaos scenario harness only
    handload_scoped = norm.endswith(_HANDLOAD_SCOPE)
    # Rule 17 scope: everywhere, the fused lookup/sparse-grad home exempt
    embed_scoped = not norm.endswith(_EMBED_HOME)
    # Rule 18 scope: everywhere, the ring/digest-scoring home exempt
    affinity_scoped = not norm.endswith(_AFFINITY_HOME)

    def _allowed(lineno: int) -> bool:
        # marker anywhere on the offending line opts that line out
        return (0 < lineno <= len(lines)
                and _ALLOW_PRINT in lines[lineno - 1])

    def _signal_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_SIGNAL in lines[lineno - 1])

    def _sync_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_SYNC in lines[lineno - 1])

    def _replica_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_REPLICA in lines[lineno - 1])

    def _compile_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_COMPILE in lines[lineno - 1])

    def _alloc_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_ALLOC in lines[lineno - 1])

    def _bytes_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_BYTES in lines[lineno - 1])

    def _process_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_PROCESS in lines[lineno - 1])

    def _quant_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_QUANT in lines[lineno - 1])

    def _spec_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_SPEC in lines[lineno - 1])

    def _actuate_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_ACTUATE in lines[lineno - 1])

    def _handload_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_HANDLOAD in lines[lineno - 1])

    def _embed_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_EMBED in lines[lineno - 1])

    def _affinity_allowed(lineno: int) -> bool:
        return (0 < lineno <= len(lines)
                and _ALLOW_AFFINITY in lines[lineno - 1])

    if handload_scoped:
        # Rule 16, comprehension form: randrange/randint draws inside a
        # list/generator comprehension are a prompt/payload stream being
        # built inline — needs its own pass because the draw's context
        # (the comprehension) is what makes it load construction
        for comp in ast.walk(tree):
            if not isinstance(comp, (ast.ListComp, ast.GeneratorExp,
                                     ast.SetComp)):
                continue
            for sub in ast.walk(comp):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in _HANDLOAD_DRAWS
                        and not _handload_allowed(sub.lineno)):
                    problems.append(
                        f"{filename}:{sub.lineno}: hand-rolled load "
                        f"construction ({sub.func.attr} in a "
                        f"comprehension) in chaos (request streams come "
                        f"from {_HANDLOAD_HOME} — feature_rows/"
                        "token_prompts/PromptPopulation — so they stay "
                        "seeded and replayable; mark deliberate "
                        f"exceptions `{_ALLOW_HANDLOAD}`)")

    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
                and not _allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: print() in library code "
                "(route through get_logger or the event log; stdout CLI "
                f"contracts mark the line `{_ALLOW_PRINT}`)")
        elif isinstance(node, ast.Call) and _is_thread_ctor(node):
            has_daemon = any(kw.arg == "daemon" for kw in node.keywords)
            has_star_kwargs = any(kw.arg is None for kw in node.keywords)
            if not (has_daemon or has_star_kwargs):
                problems.append(
                    f"{filename}:{node.lineno}: Thread() without explicit "
                    "daemon= (state the shutdown contract; an inherited "
                    "flag hangs or kills by accident)")
        elif isinstance(node, ast.Call) and _is_queue_ctor(node):
            has_maxsize = any(kw.arg == "maxsize" for kw in node.keywords)
            has_star_kwargs = any(kw.arg is None for kw in node.keywords)
            # positional signature is Queue(maxsize=0): a first positional
            # arg IS the maxsize
            has_positional = len(node.args) >= 1
            if not (has_maxsize or has_star_kwargs or has_positional):
                problems.append(
                    f"{filename}:{node.lineno}: Queue() without explicit "
                    "maxsize= (unbounded queues hide backpressure; state "
                    "the bound, or maxsize=0 to make unbounded deliberate)")
        elif isinstance(node, ast.Call) and _is_urlopen(node):
            has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
            has_star_kwargs = any(kw.arg is None for kw in node.keywords)
            # positional signature is urlopen(url, data, timeout, ...):
            # a third positional arg IS the timeout
            has_positional = len(node.args) >= 3
            if not (has_timeout or has_star_kwargs or has_positional):
                problems.append(
                    f"{filename}:{node.lineno}: urlopen() without timeout= "
                    "(a stalled connection hangs forever)")
        elif (isinstance(node, ast.Call) and _is_signal_signal(node)
                and not signal_home
                and not _signal_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: signal.signal() outside "
                f"{_SIGNAL_HOME} (handlers are process-global and "
                "last-installer-wins; route through "
                "reliability.preemption, or mark the line "
                f"`{_ALLOW_SIGNAL}`)")
        elif (isinstance(node, ast.Call) and replica_scoped
                and _is_direct_replica_call(node)
                and not _replica_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: direct replica call in serve/ "
                f"outside {_REPLICA_HOME} (bypasses the router's breaker/"
                "failover/fairness wrappers; route through Router.submit, "
                f"or mark the line `{_ALLOW_REPLICA}`)")
        elif (isinstance(node, ast.Call) and compile_scoped
                and _is_compile_site(node)
                and not _compile_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: compile site in serve/ "
                f"outside {'/'.join(_COMPILE_HOMES)} (a capture the "
                "registry's compile counters and the capture lock cannot "
                "see; route through serve.programs, or mark the "
                f"line `{_ALLOW_COMPILE}`)")
        elif (isinstance(node, ast.Call) and alloc_scoped
                and _is_device_alloc(node)
                and not _alloc_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: device allocation in serve/ "
                f"outside {'/'.join(_ALLOC_HOMES)} (memory the registry "
                "LRU and KV "
                "arena accountants cannot see; route through "
                "KVCacheManager/ModelRegistry, or mark the line "
                f"`{_ALLOW_ALLOC}`)")
        elif (isinstance(node, ast.Attribute) and bytes_scoped
                and node.attr in _BYTES_ATTRS
                and not _bytes_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: device-byte arithmetic "
                f"(.{node.attr}) in serve/ outside {_BYTES_HOME} (private "
                "size formulas drift from the HBM ledger's; route through "
                "memory.nbytes_of/memory.param_bytes, or mark the line "
                f"`{_ALLOW_BYTES}`)")
        elif (isinstance(node, ast.Call) and bytes_scoped
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _BYTES_CALLS
                and not _bytes_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: device-byte arithmetic "
                f"(.{node.func.attr}()) in serve/ outside {_BYTES_HOME} "
                "(private size formulas drift from the ledger's; route "
                "through memory.nbytes_of/memory.param_bytes, or mark the "
                f"line `{_ALLOW_BYTES}`)")
        elif (isinstance(node, ast.Call) and _is_process_call(node)
                and not process_home
                and not _process_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: process management "
                "(Popen/os.kill/os.waitpid) outside "
                f"{'/'.join(_PROCESS_HOMES)} (workers need ONE owner — "
                "the supervisor's restart/drain machinery, per-host "
                "fleets the launcher's; route through serve.supervisor "
                f"or serve.launcher, or mark the line "
                f"`{_ALLOW_PROCESS}`)")
        elif (isinstance(node, ast.Call) and quant_scoped
                and _is_quant_cast(node)
                and not _quant_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: int8 quantization cast in "
                f"serve/ outside {_QUANT_HOME} (a private quant scheme "
                "diverges from the arena's rounding/clip/scale rules; "
                "route through kvcache.quantize_rows/dequantize_rows, "
                f"or mark the line `{_ALLOW_QUANT}`)")
        elif (isinstance(node, ast.BinOp) and quant_scoped
                and _is_quant_scale_math(node)
                and not _quant_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: quantization scale math "
                f"(127-range constant) in serve/ outside {_QUANT_HOME} "
                "(the scheme lives in ONE place so blocks and readers "
                "agree bit-for-bit; route through kvcache."
                "quantize_rows/dequantize_rows, or mark the line "
                f"`{_ALLOW_QUANT}`)")
        elif (isinstance(node, ast.Call) and spec_scoped
                and _is_spec_ctor(node)
                and not _spec_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: sharding-spec "
                f"construction outside {'/'.join(_SPEC_HOMES)} (placement "
                "policy lives in ONE home so mesh topology can change "
                "without auditing every module; route through the "
                "sharding helpers, or mark the line "
                f"`{_ALLOW_SPEC}`)")
        elif (isinstance(node, ast.Call) and actuate_scoped
                and _is_actuator_call(node)
                and not _actuate_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: fleet actuator call outside "
                f"control/ and {'/'.join(_ACTUATE_HOMES[1:])} (control "
                "actions must stay attributable in the autopilot's "
                "decision telemetry; route through control.autopilot, "
                f"or mark the line `{_ALLOW_ACTUATE}`)")
        elif (isinstance(node, ast.Call) and embed_scoped
                and _is_embed_call(node)
                and not _embed_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: embedding gather/scatter "
                f"({node.func.attr if isinstance(node.func, ast.Attribute) else node.func.id}) "  # noqa: E501
                f"outside {_EMBED_HOME} (bag association order defines "
                "the sharded-vs-reference bit-identity contract; route "
                "through embed.tables make_bag_lookup/"
                "bag_lookup_reference/sparse_table_grads, or mark the "
                f"line `{_ALLOW_EMBED}`)")
        elif (isinstance(node, ast.BinOp) and embed_scoped
                and _is_id_bucketing(node)
                and not _embed_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: id-bucketing arithmetic "
                f"(id //|% shard) outside {_EMBED_HOME} (shard ownership "
                "math lives in ONE home so every path agrees which chip "
                "owns a row; route through embed.tables, or mark the "
                f"line `{_ALLOW_EMBED}`)")
        elif (isinstance(node, ast.Call) and affinity_scoped
                and _is_ring_point(node)
                and not _affinity_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: hash-ring point minted "
                f"inline (int(hexdigest, 16)) outside {_AFFINITY_HOME} "
                "(placement keys the whole fleet must agree on; route "
                "through affinity.ConsistentHashRing/score_digest, or "
                f"mark the line `{_ALLOW_AFFINITY}`)")
        elif (isinstance(node, ast.BinOp) and affinity_scoped
                and _is_ring_bucketing(node)
                and not _affinity_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: vnode/ring bucketing "
                f"arithmetic outside {_AFFINITY_HOME} (a private ring "
                "assigns sessions differently than the router's; route "
                "through affinity.ConsistentHashRing, or mark the line "
                f"`{_ALLOW_AFFINITY}`)")
        elif (isinstance(node, ast.Call) and handload_scoped
                and _is_handload_rng(node)
                and not _handload_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: hand-rolled load "
                "construction (private default_rng generator) in chaos "
                f"(request streams come from {_HANDLOAD_HOME} — "
                "feature_rows/token_prompts/PromptPopulation — so they "
                "stay seeded and replayable; mark deliberate "
                f"exceptions `{_ALLOW_HANDLOAD}`)")
        elif (isinstance(node, ast.Call) and _is_raw_sync(node)
                and not sync_home and id(node) not in numpy_scalars
                and not _sync_allowed(node.lineno)):
            problems.append(
                f"{filename}:{node.lineno}: raw host sync "
                f"(.{node.func.attr}()) outside "
                f"{_SYNC_HOME} (uncounted host sync; route through "
                "syncs.device_get/syncs.block_until_ready/syncs."
                f"synchronize, or mark the line `{_ALLOW_SYNC}`)")
        elif isinstance(node, ast.ExceptHandler):
            if node.type is None:
                problems.append(
                    f"{filename}:{node.lineno}: bare `except:` (swallows "
                    "SystemExit/KeyboardInterrupt; name the exceptions)")
            elif _catches_everything(node.type) \
                    and len(node.body) == 1 \
                    and isinstance(node.body[0], ast.Pass):
                problems.append(
                    f"{filename}:{node.lineno}: `except Exception: pass` "
                    "(silently swallowed error; narrow it or handle it)")
    return problems


def check_file(path: Union[str, Path]) -> List[str]:
    path = Path(path)
    try:
        src = path.read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    try:
        return check_source(src, filename=str(path))
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax error ({e.msg})"]


def check_roots(roots: Sequence[Union[str, Path]],
                base: Union[str, Path, None] = None) -> List[str]:
    """Lint every ``.py`` under each root (a file or a directory).

    A missing root is itself a problem — a bad invocation must fail loudly,
    not silently shrink coverage (the namecheck.py convention).
    """
    problems: List[str] = []
    base = Path(base) if base is not None else Path.cwd()
    for root in roots:
        p = Path(root)
        if not p.is_absolute():
            p = base / p
        if not p.exists():
            problems.append(f"{root}: root not found")
            continue
        files = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in files:
            problems.extend(check_file(f))
    return problems


def main(argv: Sequence[str] = ()) -> int:
    roots = list(argv) or DEFAULT_ROOTS
    problems = check_roots(roots)
    for p in problems:
        print(p)  # lint: allow-print
    if problems:
        print(f"check_reliability: {len(problems)} problem(s)")  # lint: allow-print
        return 1
    print(f"check_reliability: clean ({', '.join(map(str, roots))})")  # lint: allow-print
    return 0
