"""Data of the port: synthetic corpora and the checkpointable pipeline
(numpy copies of ``repro.data``: the same batches bit for bit)."""

from repro_torch.data.pipeline import PrefetchIterator, TokenDataset

__all__ = ["PrefetchIterator", "TokenDataset"]
