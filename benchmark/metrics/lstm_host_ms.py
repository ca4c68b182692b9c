"""The recurrence's host time an iteration, `lstm_host_ms.<part>`: the summed
host time of the program's `lstm.step` spans (the cell of each rollout
step: its input projection and its ops' dispatch) or `lstm.recurrence`
spans (the SGD's forward recurrence, 20 cell steps a minibatch), over the
traced recording's `ppo.iteration` spans."""

from metrics import _lstm_counts, _spans


def read(_bundle, part):
    spans = _spans.recording()
    n = _lstm_counts.iterations(spans) if spans else 0
    mine = [s for s in spans or () if s.name == f"lstm.{part}" and s.end_ns is not None]
    if not n or not mine:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in mine) / n
