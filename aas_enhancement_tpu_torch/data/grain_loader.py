"""Multi-worker batch loading (counterpart of
``aas_enhancement_tpu/data/grain_loader.py``).

The JAX package runs the dataset's batch construction in grain's worker
processes; grain is not on the card's machine, so this runs the same
``_EpochBatchSource`` under a ``torch.utils.data.DataLoader``.  Both take an
epoch's batch composition from ``epoch_chunks``, so the workers serve the
in-process iterator's batches in its order, and wav decode and padding never
block the device step.  The workers are spawned, not forked: they import
numpy and the dataset afresh and never touch CUDA, which the trainer has
already initialised.  ``DataConfig.use_grain`` and ``grain_workers`` keep
their names, so one JSON config loads in both packages.
"""

from __future__ import annotations

import multiprocessing
from typing import Iterator

from aas_enhancement_tpu_torch.data.dataset import AudioDataset, Batch, epoch_chunks


class _EpochBatchSource:
    """Random-access view of one epoch's batches: item lists are made here
    (cheap), wavs are decoded in ``__getitem__``, i.e. in the workers."""

    def __init__(self, dataset: AudioDataset, batch_size: int, seed: int, epoch: int,
                 sorted_order: bool = False, start: int = 0):
        self.ds = dataset
        self.epoch = epoch
        self._chunks = epoch_chunks(dataset, batch_size, seed, epoch,
                                    sorted_order=sorted_order)[start:]

    def __len__(self) -> int:
        return len(self._chunks)

    def __getitem__(self, idx: int) -> Batch:
        chunk, orig = self._chunks[idx]
        return self.ds.make_batch(chunk, real_size=orig, epoch=self.epoch)


def _as_is(batch: Batch) -> Batch:
    """The loader's collate function: the batch as the worker made it (the
    default would turn its arrays into tensors and refuse a None clean_wav)."""
    return batch


def grain_batches(dataset: AudioDataset, batch_size: int, seed: int = 0,
                  epoch: int = 0, worker_count: int = 2,
                  sorted_order: bool = False, start: int = 0) -> Iterator[Batch]:
    """One epoch's batches, decoded in ``worker_count`` worker processes (0:
    in this process), in the order of ``dataset.batches``."""
    from torch.utils.data import DataLoader

    source = _EpochBatchSource(dataset, batch_size, seed, epoch,
                               sorted_order=sorted_order, start=start)
    ctx = multiprocessing.get_context("spawn") if worker_count > 0 else None
    yield from DataLoader(source, batch_size=None, shuffle=False,
                          num_workers=worker_count, collate_fn=_as_is,
                          multiprocessing_context=ctx)
