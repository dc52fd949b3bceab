"""Row-sharded embedding tables and the DLRM-lite recommender.

The port of ``mmlspark_tpu/embed``: tables split by row over the
``tensor`` mesh axis, a fused lookup (bucketize the ids by owning shard,
all-to-all the requests, gather locally, all-to-all the rows back, sum
the bags) and a sparse gradient that scatter-adds straight into each
rank's row shard (``tables.py``); ``model.py`` wraps the tables in a
DLRM-lite module registered in the zoo as ``recommender_dlrm``, which
``DistributedTrainer`` trains on a mesh with the fused path.
"""
from mmlspark_tpu_torch.embed.tables import (EmbeddingCollection,
                                             EmbeddingTable, RowResidency,
                                             bag_lookup_reference,
                                             make_bag_lookup,
                                             sparse_table_grads)

__all__ = ["EmbeddingCollection", "EmbeddingTable", "RowResidency",
           "bag_lookup_reference", "make_bag_lookup", "sparse_table_grads"]
