"""Synthetic streams, arrival schedules and featurizers (numpy copies of
``repro.data``)."""
from repro_torch.data.features import hash_bow, hash_ids
from repro_torch.data.streams import (
    BENCHMARKS, Request, Stream, StreamSpec, arrival_schedule,
    benchmark_spec, burst_requests, lm_batches, lockstep_requests,
    make_stream, poisson_requests)

__all__ = ["BENCHMARKS", "Request", "Stream", "StreamSpec",
           "arrival_schedule", "benchmark_spec", "burst_requests",
           "hash_bow", "hash_ids", "lm_batches", "lockstep_requests",
           "make_stream", "poisson_requests"]
