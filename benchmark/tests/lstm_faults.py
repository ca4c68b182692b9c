"""Faults of the recurrent learner, planted underneath the timed path as
`faults.py`'s are, for the tests and for the readings on the card: each
patches the port in place and returns an undo."""

from faults import _patch


def zeroed_carry():
    """The rollout records a zero carry at every chunk's start, so each
    chunk of the SGD runs from zeros."""
    from overcooked_ai_tpu_torch.training import ppo_lstm

    real = ppo_lstm._Recurrent.__call__

    def call(self, obs):
        k, r = divmod(self.t, ppo_lstm.MAX_SEQ_LEN)
        out = real(self, obs)
        if r == 0 and k < self.c0.shape[0]:
            self.c0[k].zero_()
            self.h0[k].zero_()
        return out
    return _patch(ppo_lstm._Recurrent, "__call__", call)


def half_batch():
    """The recurrent learner's loss over the first half of each minibatch's
    chunks alone."""
    from overcooked_ai_tpu_torch.training import ppo_lstm

    real = ppo_lstm.ppo_loss

    def loss(logits, value, batch, *args, **kw):
        n = logits.shape[0] // 2  # chunk-major rows: the first half of the chunks
        return real(logits[:n], value[:n], tuple(x[:n] for x in batch), *args, **kw)
    return _patch(ppo_lstm, "ppo_loss", loss)


PLANT = {"lstm_zeroed_carry": zeroed_carry, "lstm_half_batch": half_batch}
