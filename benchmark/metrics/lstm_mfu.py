"""The recurrent iteration's share of the card's peak: the model FLOPs its
algorithm needs (`_lstm_counts.iteration_flops`) over its mean time by CUDA
events, over the peak of the configuration's precision."""

import statistics

from metrics._lstm_counts import iteration_flops


def read(bundle, _kind):
    times = bundle["spans"].get("iteration")
    if not times:
        return None
    seconds = statistics.fmean(times) * 1e-3
    return 100.0 * iteration_flops(bundle) / seconds / bundle["config"]["peak_flops_per_s"]
