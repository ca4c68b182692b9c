"""The whole iteration's share of the card's peak: the model FLOPs the
iteration's algorithm needs (`_counts.train_iteration_flops`) over its mean
time by CUDA events, over the peak of the configuration's precision."""

import statistics

from metrics._counts import train_iteration_flops


def read(bundle, _kind):
    times = bundle["spans"].get("iteration")
    if not times:
        return None
    seconds = statistics.fmean(times) * 1e-3
    return 100.0 * train_iteration_flops(bundle) / seconds / bundle["config"]["peak_flops_per_s"]
