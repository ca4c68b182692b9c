"""Recurrent training traffic: `make_ppo_lstm`'s `train_iteration`, back to back
(a closed loop).

`drivers/train.py`'s window, set-up and kept iterations, for the recurrent
learner (`LSTMPPONet`, truncated BPTT over 20-step chunks). The traffic file
gives the layout and the iteration's shape; every draw (the policy's Gumbel
noise, each epoch's permutation of the chunks) comes from the seed through
`train.Feed` and reaches `train_iteration` through its hooks. The weights
are Glorot-uniform kernels and zero biases over `LSTMPPONet`'s own leaves.

Set-up drives the first `check_iterations` iterations through the window's
own call and keeps what they produced, with the carries that the rollout
recorded at the chunks' starts (read from the learner's recurrent policy,
`ppo_lstm._Recurrent`, whose instances set-up notes). After the window
`reference/lstm.py` replays each kept iteration and the check compares
`train.py`'s numbers and `carry_gap`: the recorded chunk-start carries (c
and h) against the reference's, max |diff| / max |reference|.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time

from harness.core import Check, load_module
from harness.device import Profiler, device_record
from harness.weights import glorot_weights, ppo_shapes

train = load_module("drivers", "train")
TRACED_ITERATIONS = train.TRACED_ITERATIONS


def lstm_shapes(net: dict, height: int, width: int) -> dict:
    """name -> shape of `LSTMPPONet`'s leaves: `ppo_shapes`' torso, the
    cell's kernels and bias, the `logits` and `values` heads."""
    shapes = {k: v for k, v in ppo_shapes(net, height, width).items()
              if k.startswith(("convs.", "dense."))}
    cell, size = net["cell_size"], net["size_hidden_layers"]
    shapes.update({"lstm.weight_ih": (4 * cell, size), "lstm.weight_hh": (4 * cell, cell),
                   "lstm.bias": (4 * cell,), "logits.weight": (net["num_actions"], cell),
                   "logits.bias": (net["num_actions"],), "values.weight": (1, cell),
                   "values.bias": (1,)})
    return shapes


def run(ctx):
    import torch

    from overcooked_ai_tpu_torch.core.layout import build_layout
    from overcooked_ai_tpu_torch.training import ppo_lstm

    train._set_precision(ctx.control)
    dev, tr = ctx.device, ctx.traffic
    spec = build_layout(tr["layout"], train._layout_config(tr["layout"]))
    config = train._ppo_config(ctx)
    init_fn, train_iteration = ppo_lstm.make_ppo_lstm(spec, config, device=dev)
    ts = init_fn(0)
    ts.net.load_state_dict(glorot_weights(lstm_shapes(ctx.config["net"], spec.height,
                                                      spec.width), ctx.seed, dev))

    B, T, P = config.num_envs, config.horizon, spec.num_players
    chunks = P * B * T // ppo_lstm.MAX_SEQ_LEN  # what each epoch permutes
    timed = {"iteration": [], "rollout": [], "sgd": []}
    state = {"ts": ts}

    def event():
        ev = torch.cuda.Event(enable_timing=True) if dev == "cuda" else None
        if ev is not None:
            ev.record()
        return ev

    def iterate(it, keep=None, time_it=True):
        feed = train.Feed(ctx.seed, it, B, T, P, chunks, config.num_sgd_iter, False, dev)
        marks = {"start": event()}

        def on_phase(name, out):
            marks[name] = event()
            if keep is not None:
                keep[name] = out

        state["ts"], metrics = train_iteration(state["ts"], sample_fn=feed.sample,
                                               perm_fn=feed.perm, on_phase=on_phase)
        marks["end"] = event()
        if keep is not None:  # held on the host until the check: no deployment holds it
            keep.update(rollout=train._to(keep["rollout"], "cpu"),
                        advantages=train._to(keep["advantages"], "cpu"), metrics=metrics)
        spans = [("rollout", marks["start"], marks["rollout"]),
                 ("gae", marks["rollout"], marks["advantages"]),
                 ("sgd", marks["advantages"], marks["end"])]
        if time_it and dev == "cuda":
            timed["iteration"].append((marks["start"], marks["end"]))
            for name, a, b in spans:
                if name != "gae":
                    timed[name].append((a, b))
        return spans

    # set-up: the first iterations, through the window's own call, kept
    kept, first_grad = [], {}
    names = [n for n, _ in ts.net.named_parameters()]

    def grab_first(opt, *_):  # after Adam's first step: exp_avg = (1 - b1) g
        if not first_grad:
            for n, p in zip(names, opt.param_groups[0]["params"]):
                if "exp_avg" in opt.state[p]:
                    first_grad[n] = opt.state[p]["exp_avg"].detach() / (1 - 0.9)

    def snapshot():
        """The learner's state: the net, Adam's moments and the KL coefficient."""
        ts_now = state["ts"]
        adam = {}
        for n, p in zip(names, ts_now.opt.param_groups[0]["params"]):
            st = ts_now.opt.state.get(p, {})
            if "exp_avg" in st:
                adam[n] = (st["exp_avg"].clone(), st["exp_avg_sq"].clone(), int(st["step"]))
        return {"params": {n: p.detach().clone() for n, p in ts_now.net.named_parameters()},
                "adam": adam, "kl_coeff": float(ts_now.kl_coeff)}

    # the recurrent policies that the kept iterations build, for their carries
    made, recurrent = [], ppo_lstm._Recurrent

    class Noted(recurrent):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    hook = ts.opt.register_step_post_hook(grab_first)
    ppo_lstm._Recurrent = Noted
    try:
        for it in range(ctx.check_iterations):
            keep = {"start": snapshot()}
            iterate(it, keep, time_it=False)
            keep["carries"] = (made[-1].c0.cpu(), made[-1].h0.cpu())
            made.clear()  # the card holds no kept carries through the window
            kept.append(keep)
    finally:
        ppo_lstm._Recurrent = recurrent
        hook.remove()
    final = snapshot()
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the peak of the window's iterations

    # the window
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    n_iter, prof, traced = 0, None, ()
    it = ctx.check_iterations
    least = TRACED_ITERATIONS if ctx.trace else 1
    while n_iter < least or time.perf_counter() - t_start < ctx.seconds:
        if ctx.trace and n_iter == 1:  # one whole iteration under the profiler
            prof = Profiler()
            prof.start()
            traced = iterate(it, time_it=False)
            prof.stop()
        else:
            iterate(it)
        it += 1
        n_iter += 1
    if dev == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    device = device_record(1) if dev == "cuda" else None
    trace = prof.read(traced) if prof is not None else None
    spans = {k: [a.elapsed_time(b) for a, b in v] for k, v in timed.items()}
    print("window iterations (ms): " + " ".join(f"{t!r}" for t in spans["iteration"]),
          file=sys.stderr)
    del state["ts"], ts, train_iteration, init_fn
    if dev == "cuda":
        torch.cuda.empty_cache()

    check = Check(ctx.limits)
    t_check = time.perf_counter()
    _reference_check(ctx, check, config, chunks, kept, first_grad, final)
    print(f"check seconds: {time.perf_counter() - t_check!r}", file=sys.stderr)
    return {
        "attempted": n_iter, "failed": 0, "device": device, "check": check, "trace": trace,
        "e2e": {tr["metric"]: n_iter * B * T / window_s},
        "setup_s": setup_s,
        "layer": {"spans": spans, "traffic": tr, "config": ctx.config, "trace": trace,
                  "height": spec.height, "width": spec.width, "bc_seat_envs": 0.0},
    }


def _reference_check(ctx, check, config, chunks, kept, first_grad, final):
    """Replay each kept iteration in `reference/lstm.py` from the program's
    state at its start (its net, Adam's moments, the KL coefficient; the
    first from the benchmark's weights), under the program's actions, carry
    the reference's own state to its end, and record each number compared,
    that state against the program's at the next iteration's start."""
    import torch

    from reference import learner as L
    from reference import lstm as R
    from reference.layout import build_layout, layout_on

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, tr = ctx.device, ctx.traffic
    spec = build_layout(tr["layout"], train._layout_config(tr["layout"]))
    lay = layout_on(spec.layout, dev)
    P, B, T = spec.num_players, config.num_envs, config.horizon
    n_convs, n_dense = config.net.num_conv_layers, config.net.num_hidden_layers
    hp = dataclasses.asdict(config)
    ref_first = {}
    for it, k in enumerate(kept):
        start = k["start"]
        params = {n: v.clone() for n, v in start["params"].items()}
        keys = list(params)
        adam = L.Adam(params, config.lr)
        for n, (m, v, count) in start["adam"].items():
            adam.m[n], adam.v[n], adam.count = m.clone(), v.clone(), count
        kl_coeff, env_steps = start["kl_coeff"], it * B * T
        feed = train.Feed(ctx.seed, it, B, T, P, chunks, config.num_sgd_iter, False, dev)
        ro_p = train._to(k["rollout"], dev)
        gap = torch.zeros((), device=dev)

        def choose(t, logits):
            """The program's action, and how far its Gumbel score lies below
            the best under the reference's logits and the same noise."""
            nonlocal gap
            score = logits + L.gumbel(feed.u[t])
            a = ro_p.action[t]
            behind = score.max(1).values - score.gather(1, a[:, None])[:, 0]
            gap = torch.maximum(gap, behind.max())
            return a

        factor = L.anneal(config.reward_shaping_factor, env_steps, config.reward_shaping_horizon)
        ro = R.rollout(lay, params, choose, T, B, factor, n_convs, n_dense, dev)
        mismatch = sum(int((a != b).sum()) for a, b in (
            (ro.obs, ro_p.obs), (ro.sparse, ro_p.sparse), (ro.shaped, ro_p.shaped),
            (ro.events, ro_p.events)))
        c_p, h_p = (x.to(dev) for x in k["carries"])
        readings = {"env_mismatch": mismatch, "action_gap": float(gap),
                    "logit_gap": train._rel((ro.logits - ro_p.logits).abs().max(),
                                            ro.logits.abs().max()),
                    "value_gap": train._rel((ro.value - ro_p.value).abs().max(),
                                            ro.value.abs().max()),
                    "reward_gap": train._rel((ro.reward - ro_p.reward).abs().max(),
                                             ro.reward.abs().max()),
                    "carry_gap": train._rel(
                        torch.maximum((ro.c0 - c_p).abs().max(), (ro.h0 - h_p).abs().max()),
                        torch.maximum(ro.c0.abs().max(), ro.h0.abs().max()))}
        adv, vt = L.gae(ro.reward, ro.value, config.gamma, config.lmbda)
        adv = L.standardize(adv, torch.ones_like(adv))
        readings["adv_gap"] = train._rel((adv - k["advantages"][0].to(dev)).abs().max(),
                                         adv.abs().max())

        def on_grad(grads):
            if not ref_first:
                ref_first.update({n: g.clone() for n, g in grads.items()})

        ent_coeff = L.anneal(config.entropy_coeff_start, env_steps, config.entropy_coeff_horizon,
                             config.entropy_coeff_end)
        terms, ref_total = R.epochs(params, adam, ro, ro_p.action, adv, vt, feed.perms, kl_coeff,
                                    ent_coeff, hp, n_convs, n_dense, on_grad)
        del ro, ro_p
        pm = k["metrics"]  # the program's last minibatch: its loss from its four terms
        prog_total = (float(pm.policy_loss) + start["kl_coeff"] * float(pm.kl)
                      + config.vf_loss_coeff * float(pm.vf_loss)
                      - float(pm.entropy_coeff) * float(pm.entropy))
        ref_total = float(ref_total)
        readings["loss_gap"] = train._rel(abs(prog_total - ref_total), abs(ref_total))
        print(f"iteration {it} loss terms (program, reference): " + " ".join(
            f"{n} {float(p)!r} {float(r)!r}" for n, p, r in zip(
                ("policy_loss", "vf_loss", "kl", "entropy"),
                (pm.policy_loss, pm.vf_loss, pm.kl, pm.entropy), terms)), file=sys.stderr)
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone under Adam: left out by a rule on that gradient
        g_norm = {n: float(g.norm()) for n, g in ref_first.items()}
        floor = 1e-3 * statistics.median(g_norm.values())
        moved = [n for n in keys if g_norm[n] >= floor]
        if it == 0:
            readings["grad_gap"] = train._leaf_gap(first_grad, ref_first, moved)
        end = kept[it + 1]["start"] if it + 1 < len(kept) else final
        readings["update_gap"] = train._leaf_gap(
            {n: end["params"][n] - start["params"][n] for n in keys},
            {n: params[n] - start["params"][n] for n in keys}, moved)
        # the state the learner hands to the next iteration (train.py's rule)
        kl = float(terms[2])
        kl_step = (1.5 if kl > 2.0 * config.kl_target
                   else 0.5 if kl < 0.5 * config.kl_target else 1.0)
        kl_next = float(torch.tensor(kl_coeff, dtype=torch.float32) * kl_step)
        readings["kl_coeff_gap"] = train._rel(abs(end["kl_coeff"] - kl_next), kl_next)
        readings["adam_count_mismatch"] = max(
            abs((end["adam"][n][2] if n in end["adam"] else 0) - adam.count) for n in keys)
        for i, name in ((0, "adam_m_gap"), (1, "adam_v_gap")):
            prog = {n: end["adam"][n][i] for n in keys if n in end["adam"]}
            readings[name] = train._leaf_gap(prog, adam.m if i == 0 else adam.v, moved)
        for name, value in readings.items():
            check.add(name, value)
        print(f"iteration {it}: " + " ".join(f"{n} {v!r}" for n, v in readings.items()),
              file=sys.stderr)
