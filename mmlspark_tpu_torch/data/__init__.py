"""Streaming input pipeline: sharded, shuffled, resumable datasets.

``FileSource -> ShuffleBuffer -> ParallelDecode -> Batcher -> device``,
every stage checkpointable (``state_dict``/``load_state_dict``) so
training resumes mid-epoch bit-identically. The port's copy of
``mmlspark_tpu/data``.
"""
from mmlspark_tpu_torch.data.pipeline import (  # noqa: F401
    Batcher,
    Dataset,
    FileSource,
    MapRecords,
    ParallelDecode,
    PipelineIterator,
    Repeat,
    ShuffleBuffer,
    default_decode,
)
from mmlspark_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: F401
