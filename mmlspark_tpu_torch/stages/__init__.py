from mmlspark_tpu_torch.stages.stages import (  # noqa: F401
    CheckpointData,
    DataConversion,
    DropColumns,
    PartitionSample,
    RenameColumn,
    Repartition,
    SelectColumns,
    SummarizeData,
)
