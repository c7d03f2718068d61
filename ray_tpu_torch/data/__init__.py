"""ray_tpu_torch.data: streaming, block-distributed datasets (the port of
``ray_tpu.data``: the same names, signatures and defaults, without the
tracing spans and ``res_debug`` registrations).

Parity target: the reference Ray Data surface (python/ray/data/__init__ —
Dataset, read_*/from_* constructors). Blocks are column dicts of numpy
arrays living as first-class objects in the shm store; only REFS move
between operators.

Two physical executors share one logical plan (`_streaming.py` holds the
plan, the optimizer — map fusion, limit pushdown; `Dataset.explain()`
shows the result — and the pull executor):

- **streaming** (default on the cluster runtime): the optimized plan is
  rewritten so each map stage runs on long-lived operator-actor *lanes*
  wired by bounded channel queues (`_executor.py` over `_queues.py` —
  shm SPSC rings same-node, peer sockets cross-node). Per-block
  steady-state cost is a channel hop + store get/put instead of a task
  RPC.
- **pull** (`data_executor='pull'`, the in-process runtime, worker-hosted
  pipelines): one task per block per operator.

Both are row-identical on the same plan. Shuffle/sort/groupby ride the
same plane: `_exchange.py` streams partition pieces through an M x R
mapper/reducer channel mesh, falling back to the wave-admitted task
pipeline at out-of-core sizes. `iter_batches(device_put=...)` is
double-buffered (`_ingest.py`): a loader thread overlaps host block
loading with pinned-memory copies to the card on a side stream while the
device steps. Execution is backpressured by a pipeline-wide memory
budget (`data_memory_budget_bytes`) plus per-edge channel capacity
(`data_queue_capacity`).
"""

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.llm import build_llm_processor
from ray_tpu_torch.data.dataset import (Dataset, GroupedData,
                                        MaterializedDataset,
                                        StreamSplitIterator, from_arrow,
                                        from_generators, from_huggingface,
                                        from_items, from_numpy, from_pandas,
                                        from_torch,
                                        range, read_avro, read_binary_files,
                                        read_csv, read_images, read_json,
                                        read_numpy, read_parquet, read_text,
                                        read_tfrecords, read_webdataset)

__all__ = [
    "Block", "BlockAccessor", "BlockMetadata", "Dataset", "GroupedData",
    "MaterializedDataset", "StreamSplitIterator", "from_arrow",
    "from_generators", "from_huggingface", "from_items",
    "from_numpy", "from_pandas", "from_torch", "build_llm_processor",
    "range", "read_avro", "read_binary_files", "read_csv",
    "read_images", "read_json", "read_numpy", "read_parquet", "read_text",
    "read_tfrecords", "read_webdataset",
]
