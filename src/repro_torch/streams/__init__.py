"""Synthetic streams and heavy-hitter workloads, numpy (port of
``repro/streams``)."""
from repro_torch.streams.heavy_hitters import (  # noqa: F401
    HHWorkload,
    exact_heavy_hitters,
    group_candidates,
    zipf_hh_workload,
)
from repro_torch.streams.synthetic import Stream, zipf_graph_stream  # noqa: F401
