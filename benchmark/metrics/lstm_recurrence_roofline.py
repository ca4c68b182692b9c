"""The SGD's forward recurrence against its roofline: the cell's FLOPs on
every trained sample of every epoch (`_lstm_counts.recurrence_flops`, the
input projection and the hidden product) over the summed card time of the
traced iteration's `lstm.recurrence` spans, over the float32 peak. The
count is the algorithm's, so a fused cell is read on the same work."""

from metrics import _lstm_counts, _spans


def read(bundle, _kind):
    spans = _spans.recording()
    n = _lstm_counts.iterations(spans) if spans else 0
    times = [s.device_ms for s in spans or () if s.name == "lstm.recurrence"]
    if not n or not times or None in times:
        return None
    seconds = 1e-3 * sum(times) / n
    return 100.0 * _lstm_counts.recurrence_flops(bundle) / seconds / \
        bundle["config"]["peak_flops_per_s"]
