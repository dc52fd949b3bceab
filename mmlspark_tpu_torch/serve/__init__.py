"""Online serving: micro-batching, the generate lane and the in-process fleet.

The port of ``mmlspark_tpu/serve``: a :class:`Server` scores requests
through per-bucket CUDA graphs (:class:`ModelRegistry`), and its generate
lane (:class:`GenerateLane` + :class:`KVCacheManager`) decodes continuously
batched sequences over a paged KV arena, with speculative decoding and
int8 KV blocks. A :class:`Fleet` runs N in-process replicas behind a
:class:`Router` (smooth weighted round-robin, failover, tenant fairness,
prefix affinity); :class:`HttpReplica` puts a remote server behind the
same router. A :class:`Supervisor` runs each replica as a worker process
(``python -m mmlspark_tpu_torch.cli serve``, spawned by
:class:`ProcessSpawner`), restarts it after a crash and drains it on
SIGTERM; :class:`ProcessFleet` puts it behind the fleet's scale surface.
"""
from mmlspark_tpu_torch.serve.batcher import (      # noqa: F401
    MicroBatcher, Ticket, bucket_for, default_buckets, parse_buckets,
)
from mmlspark_tpu_torch.serve.fleet import (        # noqa: F401
    Fleet, InProcessReplica, ProcessFleet, RolloutAborted,
)
from mmlspark_tpu_torch.serve.generate import (      # noqa: F401
    ContinuousBatcher, GenerateLane, GenerateRequest, GenerativeEntry,
)
from mmlspark_tpu_torch.serve.kvcache import (       # noqa: F401
    KVCacheManager, blocks_needed,
)
from mmlspark_tpu_torch.serve.registry import (      # noqa: F401
    ModelEntry, ModelRegistry,
)
from mmlspark_tpu_torch.serve.router import (        # noqa: F401
    HttpReplica, ReplicaUnavailable, Router, TenantThrottled,
    WeightedFairAdmission,
)
from mmlspark_tpu_torch.serve.server import (        # noqa: F401
    RequestExpired, ServeError, Server, ServerClosed, ServerOverloaded,
)
from mmlspark_tpu_torch.serve.supervisor import (    # noqa: F401
    ProcessSpawner, ProcessWorker, Supervisor,
)

__all__ = [
    "MicroBatcher", "Ticket", "bucket_for", "default_buckets",
    "parse_buckets", "ModelEntry", "ModelRegistry", "Server",
    "ServeError", "ServerOverloaded", "RequestExpired", "ServerClosed",
    "ContinuousBatcher", "GenerateLane", "GenerateRequest",
    "GenerativeEntry", "KVCacheManager", "blocks_needed",
    "Fleet", "InProcessReplica", "RolloutAborted", "HttpReplica",
    "ReplicaUnavailable", "Router", "TenantThrottled",
    "WeightedFairAdmission", "ProcessFleet", "ProcessSpawner",
    "ProcessWorker", "Supervisor",
]
