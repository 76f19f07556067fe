"""Synthetic streams and featurizers (numpy copies of ``repro.data``)."""
from repro_torch.data.features import hash_bow, hash_ids
from repro_torch.data.streams import (
    BENCHMARKS, Stream, StreamSpec, benchmark_spec, lm_batches, make_stream)

__all__ = ["BENCHMARKS", "Stream", "StreamSpec", "benchmark_spec",
           "hash_bow", "hash_ids", "lm_batches", "make_stream"]
