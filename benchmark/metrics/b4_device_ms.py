"""B4's device time a call (`csrc/fused_pool_rollout.cu` through
`ops/fused_pool`): the mean duration of its launches in the traced part of
the window, from the profiler's device timeline."""

KERNEL = "rollout_kernel"


def read(bundle, _kind):
    trace = bundle.get("trace")
    if trace is None:
        return None
    seconds, launches = trace.kernel_seconds(KERNEL)
    return 1e3 * seconds / launches if launches else None
