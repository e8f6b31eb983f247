"""Hand-written Hopper kernels for the sketch hot path (K0-K4, the signed
K6-K9, K7m and K9m, and the conservative K5/K5i in ``csrc/``), their plain
PyTorch versions, and the wrappers in ops.py.

The wrappers ``sketch_update``, ``sketch_query`` and ``hier_update`` share
their modules' names, so import them (and their signed twins) from the
modules.  Importing this
package builds nothing: the kernels are compiled with nvcc at their first
launch (``_cuda.library``)."""
from repro_torch.kernels.hashes import IndexPlan, make_plan  # noqa: F401
from repro_torch.kernels.hier_query import (  # noqa: F401
    hier_candidate_median_signed,
    hier_candidate_median_signed_ref,
    hier_candidate_query,
    hier_candidate_query_batched,
    hier_candidate_query_batched_ref,
    hier_candidate_query_ref,
    hier_candidate_query_signed,
    hier_candidate_query_signed_ref,
)
from repro_torch.kernels.hier_update import HierPlan, make_hier_plan  # noqa: F401
from repro_torch.kernels.ops import KernelHierarchy, KernelSketch  # noqa: F401
