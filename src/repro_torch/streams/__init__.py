"""Synthetic streams, heavy-hitter workloads, exact statistics, uniform
samplers, the windowed streaming harness and live statistics (port of
``repro/streams``)."""
from repro_torch.streams.synthetic import (  # noqa: F401
    Stream,
    ipv4_stream,
    reinterpret_modularity,
    telecom_stream,
    zipf_graph_stream,
)
from repro_torch.streams.heavy_hitters import (  # noqa: F401
    HHWorkload,
    exact_heavy_hitters,
    group_candidates,
    ngram_hh_workload,
    zipf_hh_workload,
)
from repro_torch.streams.stats import (  # noqa: F401
    average_relative_error,
    degree_stats,
    exact_f2,
    exact_marginals,
    observed_error,
    sketch_f2_upper,
)
from repro_torch.streams.dstream import (  # noqa: F401
    Batch,
    BatchReport,
    DStreamHarness,
    ExactWindowCounter,
    drifting_batches,
    skew_flip_batches,
    timestamped_batches,
)
from repro_torch.streams.livestats import (  # noqa: F401
    LiveStats,
    collect_live_stats,
    group_marginal_mass,
    propose_spec,
)
