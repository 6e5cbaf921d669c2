"""paddle.io in the port (``paddle_tpu/io``): datasets, samplers, DataLoader.

Reference parity: python/paddle/fluid/dataloader/ (dataset.py,
batch_sampler.py, collate), fluid/reader.py DataLoader :123 (multiprocess
worker loop :870, shared-memory transport), operators/reader/
buffered_reader.cc (double-buffered copy to the device).

Workers collate numpy batches and send them over the port's shared-memory
ring (``_native/shm_ring.cpp``) or the ``multiprocessing`` queue; the
prefetcher copies them to the card through pinned memory on a side stream
(``dataloader.py``).
"""
from .dataset import (  # noqa: F401
    ChainDataset,
    ComposeDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
    WeightedRandomSampler,
)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .feed import (  # noqa: F401
    DatasetBase,
    DatasetFactory,
    InMemoryDataset,
    QueueDataset,
)
