"""A whole cohort's share of the card's dense bf16 peak, in %: the model
FLOPs of one cohort (``counts_serve``: its prefill and every decode step)
over the host seconds of the traced run's untraced cohort, over 989.4
TFLOP/s.  A cohort, not the traced window, since prefill is a third of
the traced window's device time and a seventeenth of a cohort's."""
from perfbench import counts_serve


def read(r):
    flops, seconds = r.counters.get("cohort_flops"), r.counters.get("cohort_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / seconds / counts_serve.BF16_FLOPS_PER_S
