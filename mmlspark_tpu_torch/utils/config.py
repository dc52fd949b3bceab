"""Global configuration tier: namespaced knobs with env-var overrides.

The PyTorch port's own copy of ``mmlspark_tpu/utils/config.py``. Every key
resolves, in order: programmatic ``set()`` > environment variable
``MMLSPARK_TPU_TORCH_<NAMESPACE>_<KEY>`` (upper-cased) > registered
default. Only the keys the port reads are registered, with the JAX
package's defaults; later slices add theirs as they port the modules that
read them. The JAX package's ``observability.peak_tflops`` is a TPU peak
and is not carried: the port's MFU divides by the H100 data-sheet peak
``observability.metrics.H100_SXM_BF16_DENSE_FLOPS``.

``runtime.dist_backend`` (the port's own) names the ``torch.distributed``
backend a process group joins with (``parallel/mesh.py``).

``runtime.device`` names the torch device every entry point runs on. It
defaults to ``"cuda"``; when CUDA is missing the entry points raise
(:func:`resolve_device`) instead of carrying on on the CPU, so a run never
reports host numbers as device numbers. Tests and CPU users set it to
``"cpu"`` explicitly.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List

_DEFAULTS: Dict[str, Any] = {
    "runtime.device": "cuda",         # torch device of every entry point
    "runtime.device_cache_mb": 1024,  # device-memory budget for resident
                                      # scoring inputs and epoch caches
    "runtime.prefetch_depth": 2,      # host->device prefetch queue depth
    "runtime.mesh": "",               # launcher default, e.g. "data=-1,tensor=2"
    "runtime.dist_backend": "nccl",   # torch.distributed backend: "nccl"
                                      # (one card a rank) or "gloo" (the
                                      # CPU, or ranks sharing a card)
    "runtime.mesh_timeout_s": 120.0,  # serving on a mesh (parallel/
                                      # leader.py): the bound on each
                                      # command's transfers between the
                                      # leader and its followers
    # parallel (mesh topology; parallel/mesh.py)
    "parallel.mesh_shape": "",        # "DxT" shorthand, e.g. "4x2" =
                                      # data 4 x tensor 2; overrides
                                      # runtime.mesh; "" defers to it
    # embed (row-sharded recommender tables; embed/)
    "embed.row_multiple": 8,          # table rows round up to this multiple
                                      # so any tensor axis up to it splits
                                      # every table evenly (rows beyond
                                      # the declared count are zero pad)
    "embed.fused_lookup": True,       # tensor meshes use the fused
                                      # bucketize/all-to-all lookup and the
                                      # sparse all-gather scatter-add
                                      # gradient; False gathers each table
                                      # for the reference lookup
    "train.metrics_flush_steps": 16,  # steps between reads of the trainer's
                                      # device-resident metrics ring
    "evaluate.device_rows": 1_000_000,  # rows from which
                                        # ComputeModelStatistics runs on
                                        # the device
    "logging.level": "INFO",
    "logging.metrics_every": 0,       # default train-metric log cadence
    "logging.history_max": 1000,      # MetricLogger history cap (entries)
    "observability.metrics": False,   # hot-path (per-step) metric collection
    "observability.events_path": "",  # non-empty = append JSONL events here
    "observability.trace_slow_ms": 0.0,  # >0 = served requests at least
                                         # this slow emit their span
                                         # timeline (tail sampling)
    "observability.annotate": False,  # span() also opens a
                                      # torch.profiler.record_function
    "observability.flight_recorder_size": 256,  # last-N in-memory event
                                                # ring, dumped on a watchdog
                                                # stall or a CLI crash
                                                # (0 = off)
    "profiling.trace_dir": "",        # non-empty = utils/profiling.trace()
                                      # writes torch.profiler traces here
    "runtime.compile_cache_dir": "",  # the compile seam's cache root; a
                                      # CUDA graph cannot be stored, so
                                      # set or not every program is built
                                      # afresh (compile_cache.py)
    # reliability: the per-model circuit breaker of the serving registry
    "reliability.breaker_failures": 5,    # consecutive failures -> open
    "reliability.breaker_reset_s": 30.0,  # open -> half-open probe delay
    # serving (micro-batching inference server; serve/)
    "serving.max_batch": 64,          # rows per flushed micro-batch
    "serving.max_wait_ms": 5.0,       # max coalescing wait before flush
    "serving.queue_depth": 256,       # bounded admission queue
    "serving.buckets": "",            # "" = {1, max/8, max/2, max}
    "serving.default_deadline_ms": 0.0,  # 0 = requests never expire
    "serving.drain_timeout_s": 10.0,  # graceful-drain budget before close
    "serving.retry_after_s": 0.0,     # Retry-After hint on a queue-full shed
    # generate (the decode lane; serve/generate.py, serve/kvcache.py)
    "generate.max_seq_len": 512,      # hard cap on prompt + generated
    "generate.prefill_buckets": "",   # "" = powers of two from
                                      # kv_block_tokens up to max_seq_len
    "generate.kv_block_tokens": 16,   # tokens per paged KV block
    "generate.max_sequences": 8,      # in-flight sequence cap
    "generate.max_new_tokens": 64,    # default generation budget
    "generate.arena_mb": 0.0,         # fixed arena size; 0 = derive it from
                                      # max_sequences x max_seq_len
    "generate.prefix_cache": True,    # shared-prefix KV reuse
    "generate.prefill_chunk": 0,      # >0: prompts prefill in chunks of
                                      # this many tokens between decode steps
    "generate.advertise_top_k": 8,    # resident prefix chains in kv stats
    "generate.kv_dtype": "",          # "" = model dtype; "int8" stores KV
                                      # blocks quantized (per-row scales)
    "generate.draft_model": "",       # registered model name proposing
                                      # draft tokens (speculative decode);
                                      # "" disables speculation
    "generate.spec_tokens": 3,        # draft tokens proposed+verified per
                                      # target step when draft_model is set
    "generate.shard_kv": True,        # on a mesh, the KV arena's heads
                                      # split over `tensor` (as the
                                      # attention projections); False
                                      # keeps a whole arena on every rank
    # reliability: per-urlopen timeout (HttpReplica, the downloader) and
    # the default RetryPolicy of the downloader
    "reliability.http_timeout": 30.0,
    "reliability.max_attempts": 3,     # default RetryPolicy attempt cap
    "reliability.base_delay": 0.2,     # first backoff delay (seconds)
    # fleet (the in-process multi-replica router; serve/{router,affinity,
    # fleet}.py)
    "fleet.replicas": 2,              # in-process replicas per Fleet
    "fleet.failover_attempts": 2,     # routing tries per request (1 = no
                                      # failover; 2 = one retry elsewhere)
    "fleet.failover_delay_s": 0.0,    # backoff between failover attempts
    "fleet.probe_interval_s": 1.0,    # background health-probe cadence
    "fleet.capacity_rows": 0,         # tenant-fairness capacity (0 =
                                      # derive from replica queue depths)
    "fleet.tenant_weights": "",       # "gold=3,free=1"; unlisted tenants
                                      # get fleet.tenant_default_weight
    "fleet.tenant_default_weight": 1.0,
    "fleet.affinity_enabled": True,   # False = prefix-blind WRR only
    "fleet.affinity_min_depth": 1,    # matched blocks required before
                                      # prefix affinity overrides WRR
    "fleet.affinity_vnodes": 64,      # virtual nodes per replica on the
                                      # session consistent-hash ring
    "fleet.affinity_seed": 0,         # ring placement seed
    "fleet.affinity_prewarm": 4,      # hottest prompt prefixes replayed
                                      # through a rollout canary's prefill
                                      # before it takes weight (0 = off)
    "fleet.affinity_spill_factor": 1.5,  # an affinity leader whose
                                      # in-flight count exceeds
                                      # factor*(fleet mean + 1) spills the
                                      # pick back to WRR (0 = never spill)
    # the process fleet (serve/supervisor.py, serve/launcher.py)
    "fleet.supervisor_min_uptime_s": 5.0,   # a child dying sooner counts
                                            # as a crash-loop failure
    "fleet.supervisor_base_delay_s": 0.5,   # first restart backoff
    "fleet.supervisor_max_delay_s": 30.0,   # restart backoff cap
    "fleet.supervisor_ready_timeout_s": 120.0,  # spawn -> ready budget
                                                # (child imports and CUDA
                                                # start-up included)
    "fleet.supervisor_breaker_failures": 3,  # consecutive short-lived
                                             # crashes -> breaker open
    "fleet.supervisor_breaker_reset_s": 60.0,  # open -> one probe respawn
    "fleet.supervisor_poll_s": 0.2,          # monitor thread cadence
    "fleet.devices_per_worker": 0,    # >0: worker slot i sees cards
                                      # [i*K, (i+1)*K) (CUDA_VISIBLE_DEVICES);
                                      # 0 = workers share the visible cards
    "fleet.hosts": "",                # comma list of hosts for the
                                      # multi-host launcher; "" = one host
    "observability.scrape_interval_s": 5.0,  # FleetScraper background poll
    "observability.memory_poll_s": 0.0,      # >0 = periodic device-memory
                                             # ledger audit
    "reliability.stall_timeout_s": 0.0,   # 0 = watchdog stall detection off
    "reliability.watchdog_poll_s": 1.0,   # monitor thread poll cadence
    # the streaming input pipeline (data/pipeline.py)
    "data.shuffle_window": 1024,   # records per windowed-shuffle block
    "data.decode_workers": 4,      # parallel decode worker threads
    "data.prefetch_depth": 0,      # to_device_iterator queue depth
    # SLO objectives (observability/slo.py)
    "slo.availability_target": 0.999,  # 1 - bad/admitted objective
    "slo.latency_p99_ms": 0.0,         # >0 = p99 total-latency budget (ms)
    "slo.ttft_p99_ms": 0.0,            # >0 = generate-lane TTFT p99 budget
    "slo.fast_window_s": 300.0,        # fast burn window
    "slo.slow_window_s": 3600.0,       # slow burn window
    "slo.fast_burn": 14.4,             # burn-rate threshold, fast window
    "slo.slow_burn": 6.0,              # burn-rate threshold, slow window
    # autopilot (control/autopilot.py): the SLO-driven control loop
    "autopilot.enabled": False,        # `serve --autopilot` flips this on
    "autopilot.tick_s": 5.0,           # evaluation cadence
    "autopilot.min_replicas": 1,       # scale floor, also the repair target
    "autopilot.max_replicas": 8,       # scale ceiling
    "autopilot.hbm_limit_bytes": 0,    # >0 = veto scale-up past this
                                       # projected fleet device memory
    "autopilot.scale_up_queue": 4.0,   # mean queue depth a ready replica
                                       # at/above which the fleet grows
    "autopilot.scale_down_queue": 0.0,  # mean queue depth at/below which
                                        # an idle fleet shrinks
    "autopilot.scale_cooldown_s": 25.0,
    "autopilot.shift_error_rate": 0.5,  # per-tick failure fraction that
                                        # ramps traffic off a replica
    "autopilot.shift_recover_rate": 0.05,  # fraction that ramps it back
    "autopilot.shift_step": 0.5,       # router weight moved per action
    "autopilot.shift_cooldown_s": 20.0,
    "autopilot.admission_factor": 0.5,  # capacity_rows multiplier a tighten
    "autopilot.admission_floor_frac": 0.25,  # tighten floor (of baseline)
    "autopilot.admission_relax_burn": 1.0,  # fast burn at/below which a
                                            # tightened quota relaxes
    "autopilot.admission_cooldown_s": 25.0,
    "autopilot.reshard_wide": "",      # mesh shape to reshard to under
                                       # memory pressure ("" = off)
    "autopilot.reshard_narrow": "",    # mesh shape to reshard to when the
                                       # scale lever is at its ceiling
    "autopilot.reshard_hbm_frac": 0.85,  # memory fraction of
                                         # hbm_limit_bytes that fires wide
    "autopilot.reshard_cooldown_s": 60.0,  # shared by both directions
    "autopilot.window_s": 120.0,       # rolling actuation-budget window
    "autopilot.max_actions_per_window": 8,  # decisions past it suppressed
    "autopilot.scale_backend": "auto",  # "inprocess" = Fleet, "process" =
                                        # supervised workers (ProcessFleet),
                                        # "auto" = process under a supervisor
}

_lock = threading.Lock()
_overrides: Dict[str, Any] = {}
_listeners: List[Callable[[str], None]] = []


def _env_key(key: str) -> str:
    return "MMLSPARK_TPU_TORCH_" + key.replace(".", "_").upper()


def get(key: str, default: Any = None) -> Any:
    """Resolve a config key (``namespace.name``)."""
    with _lock:
        if key in _overrides:
            return _overrides[key]
    env = os.environ.get(_env_key(key))
    if env is not None:
        base = _DEFAULTS.get(key, default)
        return _coerce(env, base)
    if key in _DEFAULTS:
        return _DEFAULTS[key]
    if default is not None:
        return default
    raise KeyError(f"unknown config key {key!r}; known: {sorted(_DEFAULTS)}")


def set(key: str, value: Any) -> None:  # noqa: A001 - mirrors typesafe API
    """Programmatic override (highest precedence). Unknown keys are allowed
    so applications can park their own knobs in the same tree."""
    with _lock:
        _overrides[key] = value
    _changed(key)


def unset(key: str) -> None:
    with _lock:
        _overrides.pop(key, None)
    _changed(key)


def on_change(fn: Callable[[str], None]) -> None:
    """Call ``fn(key)`` after every :func:`set` / :func:`unset` (a module
    that caches what some keys resolve to, ``observability/spans.py``)."""
    _listeners.append(fn)


def _changed(key: str) -> None:
    for fn in _listeners:
        fn(key)


def snapshot() -> Dict[str, Any]:
    """Fully-resolved view of every known key (for logs / debugging)."""
    merged = dict(_DEFAULTS)
    with _lock:
        merged.update(_overrides)
    return {k: get(k, merged[k]) for k in sorted(merged)}


def resolve_device():
    """The ``torch.device`` named by ``runtime.device``.

    Raises ``RuntimeError`` when it names CUDA and CUDA is not available:
    the port never falls back to the CPU on its own."""
    import torch
    device = torch.device(str(get("runtime.device")))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"runtime.device is {str(device)!r} but torch.cuda.is_available() "
            "is False; set runtime.device='cpu' (config.set or "
            "MMLSPARK_TPU_TORCH_RUNTIME_DEVICE=cpu) to run on the CPU")
    return device


def _coerce(text: str, like: Any) -> Any:
    if isinstance(like, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(text)
    if isinstance(like, float):
        return float(text)
    return text
