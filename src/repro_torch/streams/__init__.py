"""Synthetic streams, heavy-hitter workloads, exact statistics and uniform
samplers, numpy (port of ``repro/streams``)."""
from repro_torch.streams.heavy_hitters import (  # noqa: F401
    HHWorkload,
    exact_heavy_hitters,
    group_candidates,
    zipf_hh_workload,
)
from repro_torch.streams.synthetic import Stream, zipf_graph_stream  # noqa: F401
from repro_torch.streams.stats import (  # noqa: F401
    average_relative_error,
    degree_stats,
    exact_f2,
    exact_marginals,
    observed_error,
    sketch_f2_upper,
)
