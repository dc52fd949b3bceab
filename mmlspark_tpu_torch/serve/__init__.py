"""Online serving: dynamic micro-batching and the generate lane on one device.

The port of ``mmlspark_tpu/serve``'s single-replica half: a
:class:`Server` scores requests through per-bucket CUDA graphs
(:class:`ModelRegistry`), and its generate lane (:class:`GenerateLane` +
:class:`KVCacheManager`) decodes continuously batched sequences over a
paged KV arena. The fleet, router, supervisor and speculative decoding are
later slices (ROADMAP queue A).
"""
from mmlspark_tpu_torch.serve.batcher import (      # noqa: F401
    MicroBatcher, Ticket, bucket_for, default_buckets, parse_buckets,
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
from mmlspark_tpu_torch.serve.server import (        # noqa: F401
    RequestExpired, ServeError, Server, ServerClosed, ServerOverloaded,
)

__all__ = [
    "MicroBatcher", "Ticket", "bucket_for", "default_buckets",
    "parse_buckets", "ModelEntry", "ModelRegistry", "Server",
    "ServeError", "ServerOverloaded", "RequestExpired", "ServerClosed",
    "ContinuousBatcher", "GenerateLane", "GenerateRequest",
    "GenerativeEntry", "KVCacheManager", "blocks_needed",
]
