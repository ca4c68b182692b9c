"""The learner's time an iteration (`make_ppo`'s epochs: the loss, the
backward pass, the clip, Adam, the KL update): CUDA events from
`on_phase("advantages")` to the iteration's return, the mean over the
window's iterations that the profiler did not hold."""

import statistics


def read(bundle, _kind):
    times = bundle["spans"].get("sgd")
    return statistics.fmean(times) if times else None
