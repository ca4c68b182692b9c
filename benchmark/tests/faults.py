"""Faults planted underneath the timed path, for the tests and for the
readings on the card: each patches the port in place and returns an undo."""

import torch


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def half_batch():
    """The learner's loss over the first half of each minibatch alone."""
    from overcooked_ai_tpu_torch.training import ppo

    real = ppo.loss_fn

    def loss_fn(net, batch, *args, **kw):
        n = batch[0].shape[0] // 2
        return real(net, tuple(x[:n] for x in batch), *args, **kw)
    return _patch(ppo, "loss_fn", loss_fn)


def unchanged_learner():
    """Adam's step leaves the net as it was."""
    return _patch(torch.optim.Adam, "step", lambda self, closure=None: None)


def adam_reset():
    """Adam's state (its moments and step count) emptied at the end of each
    iteration."""
    from overcooked_ai_tpu_torch.training import ppo

    real = ppo.finish_iteration

    def finish(ts, *args, **kw):
        ts.opt.state.clear()
        return real(ts, *args, **kw)
    return _patch(ppo, "finish_iteration", finish)


def frozen_kl():
    """The adaptive KL coefficient kept as it was at the iteration's start."""
    from overcooked_ai_tpu_torch.training import ppo

    real = ppo.finish_iteration

    def finish(ts, *args, **kw):
        out, metrics = real(ts, *args, **kw)
        return out._replace(kl_coeff=ts.kl_coeff), metrics
    return _patch(ppo, "finish_iteration", finish)


def altered_env_step():
    """B1's third launch reports one env's sparse reward one higher."""
    from overcooked_ai_tpu_torch.training import ppo

    real, calls = ppo.fused_train_step_tiles, []

    def step(*args, **kw):
        out = list(real(*args, **kw))
        calls.append(1)
        if len(calls) == 3:
            out[2] = out[2].clone()
            out[2][0, 0] += 1
        return tuple(out)
    return _patch(ppo, "fused_train_step_tiles", step)


def broken_pool_rollout(kind):
    """B4's public entry with its state unchanged, half its lanes left
    unstepped, or one lane's return altered."""
    from overcooked_ai_tpu_torch.ops import fused_pool

    real = fused_pool.fused_pool_rollout_random

    def broken(spec0, lay, st, seed, num_steps, horizon=400):
        out, ret = real(spec0, lay, st, seed, num_steps, horizon)
        if kind == "unchanged":
            return st, torch.zeros_like(ret)
        if kind == "half_batch":
            B = ret.shape[0]
            out = type(out)(*(torch.cat([o[..., :B // 2], s[..., B // 2:]], -1)
                              for o, s in zip(out, st)))
            return out, torch.cat([ret[:B // 2], torch.zeros_like(ret[B // 2:])])
        ret = ret.clone()
        ret[1] += 1
        return out, ret
    return _patch(fused_pool, "fused_pool_rollout_random", broken)


PLANT = {"half_batch": half_batch, "unchanged": unchanged_learner, "altered": altered_env_step,
         "adam_reset": adam_reset, "frozen_kl": frozen_kl,
         "pool_unchanged": lambda: broken_pool_rollout("unchanged"),
         "pool_half_batch": lambda: broken_pool_rollout("half_batch"),
         "pool_altered": lambda: broken_pool_rollout("altered")}
