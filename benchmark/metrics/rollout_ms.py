"""The policy loop's time an iteration (`training/ppo.collect_rollout`): CUDA
events from the iteration's start to `on_phase("rollout")`, the mean over
the window's iterations that the profiler did not hold."""

import statistics


def read(bundle, _kind):
    times = bundle["spans"].get("rollout")
    return statistics.fmean(times) if times else None
