"""B1's share of its roofline: the least time a launch could take, its
interface bytes (`_counts.b1_bytes`) over the card's memory bandwidth, over
its mean device time a launch in the traced iteration."""

from metrics._counts import b1_bytes

KERNEL = "train_step_kernel"


def read(bundle, _kind):
    trace = bundle.get("trace")
    if trace is None:
        return None
    seconds, launches = trace.kernel_seconds(KERNEL)
    if not launches:
        return None
    least = b1_bytes(bundle["traffic"]["num_envs"], bundle["height"], bundle["width"]) / \
        bundle["config"]["peak_bytes_per_s"]
    return 100.0 * least / (seconds / launches)
