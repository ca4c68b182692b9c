"""The recurrent SGD's device time an iteration by part,
`lstm_sgd_device_ms.<part>`: the summed card time (a CUDA event pair on the
stream) of the program's `lstm.torso` (the convs and dense layers over a
minibatch's chunks), `lstm.recurrence` (the input projection and the 20
steps of the cell), `sgd.backward` (`zero_grad` and the backward pass) or
`sgd.optimizer` (the clip and Adam's step) spans of the traced iteration,
over its `ppo.iteration` spans."""

from metrics import _lstm_counts, _spans

SPAN = {"torso": "lstm.torso", "recurrence": "lstm.recurrence", "backward": "sgd.backward",
        "optimizer": "sgd.optimizer"}


def read(_bundle, part):
    spans = _spans.recording()
    n = _lstm_counts.iterations(spans) if spans else 0
    times = [s.device_ms for s in spans or () if s.name == SPAN[part]]
    if not n or not times or None in times:
        return None
    return sum(times) / n
