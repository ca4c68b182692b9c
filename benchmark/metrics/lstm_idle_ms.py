"""The device's idle time put down to what the host was doing in the
recurrent cell, `lstm_idle_ms.<phase>`: `_spans.idle_ns_by_phase` (each idle
interval of the traced window cut among the innermost spans open on the
host, by overlap, and summed by their phase; the `lstm.*` spans take their
ancestor's), over the recording's `ppo.iteration` spans, so the phases
times the iterations sum to `device_idle` times the window."""

from metrics import _lstm_counts, _spans

CACHE = "_lstm_idle_ns_by_phase"  # the bundle's key: one cut for all of a run's phases


def read(bundle, phase):
    trace, spans = bundle.get("trace"), _spans.recording()
    n = _lstm_counts.iterations(spans) if spans else 0
    if trace is None or not n:
        return None
    if CACHE not in bundle:
        bundle[CACHE] = _spans.idle_ns_by_phase(trace, spans)
    return 1e-6 * bundle[CACHE].get(phase, 0) / n
