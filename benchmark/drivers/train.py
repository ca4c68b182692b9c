"""Training traffic: `make_ppo`'s `train_iteration`, back to back (a closed loop).

The traffic file gives the layout, the iteration's shape (envs, horizon,
minibatch, epochs), the learning rate and, for human-aware PPO, the BC
partner's schedule and model and the phi shaping. Every draw of an
iteration (the policy's Gumbel noise, the partner's seats and noise, each
epoch's permutation) is made by the benchmark from the seed and handed to
`train_iteration` through its hooks, so the plain reference can follow it.

Set-up builds the learner once, loads the benchmark's weights, and drives
it through the first `check_iterations` iterations through the window's own
call, keeping what they produced; the window then runs whole iterations on
that same object until `--seconds` have passed, and its rate is all their
env steps over all its time. After the window the reference replays those
first iterations from the same weights and draws and compares: the env's
integers (the obs the policy saw, rewards, events) exactly, the net's
logits and values, the sampled actions (the gap by which the program's
action's Gumbel score lies below the best under the reference's logits),
the rewards with phi, the standardised advantages, the loss of each
iteration's last minibatch, the first clipped gradient as Adam holds it
after its first step, each leaf's change over each iteration, and the
state the learner hands to the next iteration: Adam's step count and the
KL coefficient exactly, Adam's moments by the worst leaf. The kept
iterations' outputs wait on the host through the window.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from harness.core import BENCH_DIR, Check
from harness.device import Profiler, device_record
from harness.weights import generator, glorot_weights, ppo_shapes

NUM_ACTIONS = 6
TRACED_ITERATIONS = 4  # a traced window's least: the profiled one and 3 timed


def _layout_config(name):
    with open(os.path.join(BENCH_DIR, "layouts", f"{name}.json")) as f:
        return json.load(f)


class Feed:
    """An iteration's draws, made in a few calls at its start."""

    def __init__(self, seed, it, B, T, P, n_samples, epochs, bc, device):
        import torch

        g = generator(seed, "iteration", it, device=device)
        self.u = torch.rand((T, P * B, NUM_ACTIONS), generator=g, device=device)
        self.perms = torch.stack([torch.randperm(n_samples, generator=g, device=device)
                                  for _ in range(epochs)])
        self.bc_draws = self.bc_u = None
        if bc:
            self.bc_draws = (torch.rand((B,), generator=g, device=device),
                             torch.randint(P, (B,), generator=g, device=device))
            self.bc_u = torch.rand((T, B * P, NUM_ACTIONS), generator=g, device=device)
        self.bc_seen = []  # the partner's (logits, actions) of each step

    def sample(self, logits, t):
        import torch

        return torch.argmax(logits - torch.log(-torch.log(self.u[t])), dim=-1)

    def bc_sample(self, logits, t):
        import torch

        act = torch.argmax(logits - torch.log(-torch.log(self.bc_u[t])), dim=-1)
        self.bc_seen.append((logits, act))
        return act

    def perm(self, epoch):
        return self.perms[epoch]


def _set_precision(control):
    """float32 with TF32 off, as the configurations state; the control
    `tf32` turns TF32 on for the program."""
    import torch

    tf32 = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _ppo_config(ctx):
    from overcooked_ai_tpu_torch.training.networks import NetConfig
    from overcooked_ai_tpu_torch.training.ppo import PPOConfig

    tr = ctx.traffic
    schedule = tuple((float(a), float(b)) for a, b in tr.get("bc_schedule", [[0, 0], ["inf", 0]]))
    return PPOConfig(num_envs=tr["num_envs"], horizon=tr["horizon"],
                     sgd_minibatch_size=tr["sgd_minibatch_size"], num_sgd_iter=tr["num_sgd_iter"],
                     lr=tr["lr"], use_phi=tr.get("use_phi", False),
                     phi_event_mix=tr.get("phi_event_mix", False), bc_schedule=schedule,
                     net=NetConfig(**ctx.config["net"]))


def run(ctx):
    import torch

    from overcooked_ai_tpu_torch.core.layout import build_layout
    from overcooked_ai_tpu_torch.training.ppo import make_ppo

    _set_precision(ctx.control)
    dev, tr = ctx.device, ctx.traffic
    spec = build_layout(tr["layout"], _layout_config(tr["layout"]))
    config = _ppo_config(ctx)
    partner = potential_fn = None
    bc = "bc_model" in ctx.config and any(v for _, v in config.bc_schedule)
    if bc:
        from overcooked_ai_tpu_torch.core.potential import make_potential_fn
        from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
        from overcooked_ai_tpu_torch.training.bc import bc_policy_batch, load_bc_model

        fc = build_motion_tables(spec.layout.terrain).feature_cost
        partner = bc_policy_batch(spec, fc, *load_bc_model(os.path.join(BENCH_DIR,
                                                                         ctx.config["bc_model"])))
        potential_fn = make_potential_fn(spec, fc) if config.use_phi else None
    elif config.use_phi:
        raise ValueError("phi shaping is built with the BC partner's motion tables")
    init_fn, train_iteration = make_ppo(spec, config, potential_fn, partner, device=dev)
    ts = init_fn(0)
    weights = glorot_weights(ppo_shapes(ctx.config["net"], spec.height, spec.width), ctx.seed,
                             dev)
    ts.net.load_state_dict(weights)

    B, T, P = config.num_envs, config.horizon, spec.num_players
    n_samples = P * B * T
    timed = {"iteration": [], "rollout": [], "sgd": []}
    state = {"ts": ts}

    def event():
        ev = torch.cuda.Event(enable_timing=True) if dev == "cuda" else None
        if ev is not None:
            ev.record()
        return ev

    def iterate(it, keep=None, time_it=True):
        feed = Feed(ctx.seed, it, B, T, P, n_samples, config.num_sgd_iter, bc, dev)
        marks = {"start": event()}

        def on_phase(name, out):
            marks[name] = event()
            if keep is not None:
                keep[name] = out

        state["ts"], metrics = train_iteration(
            state["ts"], sample_fn=feed.sample, perm_fn=feed.perm, on_phase=on_phase,
            bc_draws=feed.bc_draws, bc_sample_fn=feed.bc_sample if bc else None)
        marks["end"] = event()
        if keep is not None:  # held on the host until the check: no deployment holds it
            ro = keep["rollout"]
            keep.update(rollout=_to(ro, "cpu"), advantages=_to(keep["advantages"], "cpu"),
                        metrics=metrics, bc_seen=_to(feed.bc_seen, "cpu"),
                        bc_seats=None if ro.bc_seats is None else float(ro.bc_seats.sum()))
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

    hook = ts.opt.register_step_post_hook(grab_first)
    for it in range(ctx.check_iterations):
        keep = {"start": snapshot()}
        iterate(it, keep, time_it=False)
        kept.append(keep)
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
    # a traced run reports no rate: it runs 3 timed iterations beside the
    # profiled one, however long the profiler stretches the window
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
    _reference_check(ctx, check, config, bc, kept, first_grad, final)
    print(f"check seconds: {time.perf_counter() - t_check!r}", file=sys.stderr)
    bc_seats = [k["bc_seats"] for k in kept if k["bc_seats"] is not None]
    return {
        "attempted": n_iter, "failed": 0, "device": device, "check": check, "trace": trace,
        "e2e": {tr["metric"]: n_iter * B * T / window_s},
        "setup_s": setup_s,
        "layer": {"spans": spans, "traffic": tr, "config": ctx.config, "trace": trace,
                  "height": spec.height, "width": spec.width,
                  "bc_seat_envs": sum(bc_seats) / len(bc_seats) if bc_seats else 0.0},
    }


def _to(x, device):
    """`x`, its tensors (in tuples, named tuples and lists) moved to `device`."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        items = [_to(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def _rel(diff, ref):
    """max |diff| / max |ref| as a float (1 where the reference is all 0)."""
    d, r = float(diff), float(ref)
    return d / r if r > 0 else (0.0 if d == 0 else 1.0)


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    import statistics

    ref_norms = {k: float(v.norm()) for k, v in ref.items()}
    median = statistics.median(ref_norms.values())
    worst = 0.0
    for k in keep:
        p = float(prog[k].norm()) if k in prog else 0.0
        worst = max(worst, abs(p - ref_norms[k]) / max(ref_norms[k], median, 1e-30))
    return worst


def _reference_check(ctx, check, config, bc, kept, first_grad, final):
    """Replay each kept iteration in the plain reference from the program's
    state at its start (its net, Adam's moments, the KL coefficient; the
    first from the benchmark's weights), carry the reference's own state to
    its end, and record each number compared, that state against the
    program's at the next iteration's start."""
    import statistics

    import torch

    from reference import learner as L
    from reference.encoding import encode_nhwc
    from reference.env import batch_reset, clamp_stamps, env_step, pack_events
    from reference.layout import build_layout, layout_on

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, tr = ctx.device, ctx.traffic
    spec = build_layout(tr["layout"], _layout_config(tr["layout"]))
    lay = layout_on(spec.layout, dev)
    P, B, T = spec.num_players, config.num_envs, config.horizon
    H, W = spec.height, spec.width
    n_convs, n_dense = config.net.num_conv_layers, config.net.num_hidden_layers
    hp = dataclasses.asdict(config)
    if bc:
        from reference.featurize import featurize_batch
        from reference.potential import build_potential_tables, potential, tables_on
        from reference.tables import build_motion_tables

        fc = build_motion_tables(spec.layout.terrain).feature_cost
        layers = L.read_bc_mlp(os.path.join(BENCH_DIR, ctx.config["bc_model"], "params.msgpack"),
                               dev)
        ptab = tables_on(build_potential_tables(spec, config.gamma), dev)
        rows = torch.as_tensor(fc).to(torch.int32).reshape(4 * H * W, H * W).to(dev)
    ref_first = None
    for it, k in enumerate(kept):
        start = k["start"]
        params = {n: v.clone() for n, v in start["params"].items()}
        keys = list(params)
        adam = L.Adam(params, config.lr)
        for n, (m, v, count) in start["adam"].items():
            adam.m[n], adam.v[n], adam.count = m.clone(), v.clone(), count
        kl_coeff, env_steps = start["kl_coeff"], it * B * T
        feed = Feed(ctx.seed, it, B, T, P, P * B * T, config.num_sgd_iter, bc, dev)
        ro, bc_seen = _to(k["rollout"], dev), _to(k["bc_seen"], dev)
        zero = torch.zeros((), device=dev)
        worst = {n: zero for n in ("mismatch", "logit", "logit_ref", "value", "value_ref",
                                   "action", "bc_logit", "bc_logit_ref", "reward", "reward_ref")}
        state = batch_reset(lay, B, dev)
        factor = L.anneal(config.reward_shaping_factor, env_steps, config.reward_shaping_horizon)
        if bc:
            bc_mask = ((torch.arange(P, device=dev)[:, None] == feed.bc_draws[1][None])
                       & (feed.bc_draws[0] < L.bc_factor_at(config.bc_schedule, env_steps))[None])
            phi_s = potential(lay, ptab, rows, state) if config.use_phi else None
        obs = torch.empty((T, P * B, H, W, 26), dtype=torch.int8, device=dev)
        logp, value, reward = (torch.empty((T, P * B), device=dev) for _ in range(3))
        logits_all = torch.empty((T, P * B, NUM_ACTIONS), device=dev)
        for t in range(T):
            o = encode_nhwc(lay, state, T)
            worst["mismatch"] = worst["mismatch"] + (o != ro.obs[t]).sum()
            obs[t] = o
            lg, v = L.net_forward(params, o, n_convs, n_dense)
            logits_all[t], value[t] = lg, v
            a = ro.action[t]
            worst["logit"] = torch.maximum(worst["logit"], (lg - ro.logits[t]).abs().max())
            worst["logit_ref"] = torch.maximum(worst["logit_ref"], lg.abs().max())
            worst["value"] = torch.maximum(worst["value"], (v - ro.value[t]).abs().max())
            worst["value_ref"] = torch.maximum(worst["value_ref"], v.abs().max())
            score = lg + L.gumbel(feed.u[t])
            gap = score.max(1).values - score.gather(1, a[:, None])[:, 0]
            worst["action"] = torch.maximum(worst["action"], gap.max())
            logp[t] = torch.log_softmax(lg, -1).gather(1, a[:, None])[:, 0]
            act = a.to(torch.int32).reshape(P, B)
            if bc:
                feats = featurize_batch(lay, rows, state)
                blg = L.bc_forward(layers, feats.reshape(-1, feats.shape[-1]))
                p_lg, p_act = bc_seen[t]
                worst["bc_logit"] = torch.maximum(worst["bc_logit"], (blg - p_lg).abs().max())
                worst["bc_logit_ref"] = torch.maximum(worst["bc_logit_ref"], blg.abs().max())
                score = blg + L.gumbel(feed.bc_u[t])
                gap = score.max(1).values - score.gather(1, p_act[:, None])[:, 0]
                worst["action"] = torch.maximum(worst["action"], gap.max())
                act = torch.where(bc_mask, p_act.reshape(B, P).T.to(torch.int32), act)
            step = env_step(lay, state, act, T + 1)
            state = clamp_stamps(step.obs_state)
            worst["mismatch"] = (worst["mismatch"] + (step.sparse_reward != ro.sparse[t]).sum()
                                 + (step.shaped_reward != ro.shaped[t]).sum()
                                 + (pack_events(step.events) != ro.events[t]).sum())
            dense = step.shaped_reward.float()
            if config.use_phi:
                phi_sp = potential(lay, ptab, rows, state)
                delta = (phi_sp - phi_s)[None].expand(P, B)
                dense = delta + dense if config.phi_event_mix else delta
                phi_s = phi_sp
            r = (step.sparse_reward.sum(0, dtype=torch.int32)[None].float()
                 + factor * dense).reshape(P * B)
            reward[t] = r
            worst["reward"] = torch.maximum(worst["reward"], (r - ro.reward[t]).abs().max())
            worst["reward_ref"] = torch.maximum(worst["reward_ref"], r.abs().max())
        mask = (torch.ones(P * B, device=dev) if not bc
                else (~bc_mask).reshape(P * B).float())[None].expand(T, P * B)
        adv, vt = L.gae(reward, value, config.gamma, config.lmbda)
        adv = L.standardize(adv, mask)
        adv_p = k["advantages"][0].to(dev)
        readings = {"adv_gap": _rel((adv - adv_p).abs().max(), adv.abs().max()),
                    "env_mismatch": float(worst["mismatch"]),
                    "action_gap": float(worst["action"])}
        for name in ("logit", "value", "reward") + (("bc_logit",) if bc else ()):
            readings[f"{name}_gap"] = _rel(worst[name], worst[name + "_ref"])

        ent_coeff = L.anneal(config.entropy_coeff_start, env_steps, config.entropy_coeff_horizon,
                             config.entropy_coeff_end)
        flat = [x.reshape((-1,) + x.shape[2:]) for x in
                (obs, ro.action, logp, logits_all, value, adv, vt, mask)]
        mb = min(2 * config.sgd_minibatch_size, P * B * T)
        for epoch in range(config.num_sgd_iter):
            perm = feed.perms[epoch]
            for j in range((P * B * T) // mb):
                idx = perm[j * mb:(j + 1) * mb]
                leaves = {n: params[n].detach().requires_grad_(True) for n in keys}
                o, a, lp, lo, vo, ad, v_t, m = (x[idx] for x in flat)
                lg, v = L.net_forward(leaves, o, n_convs, n_dense)
                terms = L.ppo_terms(lg, v, a, lp, lo, vo, ad, v_t, m, hp)
                total = (terms[0] + kl_coeff * terms[2] + config.vf_loss_coeff * terms[1]
                         - ent_coeff * terms[3])
                grads = dict(zip(keys, torch.autograd.grad(total, [leaves[n] for n in keys])))
                grads = L.clip_global_norm(grads, config.grad_clip)
                if ref_first is None:
                    ref_first = {n: g.clone() for n, g in grads.items()}
                adam.step(params, grads)
        pm = k["metrics"]  # the program's last minibatch: its loss from its four terms
        prog_total = (float(pm.policy_loss) + start["kl_coeff"] * float(pm.kl)
                      + config.vf_loss_coeff * float(pm.vf_loss)
                      - float(pm.entropy_coeff) * float(pm.entropy))
        ref_total = float(total.detach())
        readings["loss_gap"] = _rel(abs(prog_total - ref_total), abs(ref_total))
        print(f"iteration {it} loss terms (program, reference): " + " ".join(
            f"{n} {float(p)!r} {float(r)!r}" for n, p, r in zip(
                ("policy_loss", "vf_loss", "kl", "entropy"),
                (pm.policy_loss, pm.vf_loss, pm.kl, pm.entropy), (t.detach() for t in terms))),
              file=sys.stderr)
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone under Adam: left out by a rule on that gradient
        g_norm = {n: float(g.norm()) for n, g in ref_first.items()}
        floor = 1e-3 * statistics.median(g_norm.values())
        moved = [n for n in keys if g_norm[n] >= floor]
        if it == 0:
            readings["grad_gap"] = _leaf_gap(first_grad, ref_first, moved)
        end = kept[it + 1]["start"] if it + 1 < len(kept) else final
        readings["update_gap"] = _leaf_gap(
            {n: end["params"][n] - start["params"][n] for n in keys},
            {n: params[n] - start["params"][n] for n in keys}, moved)
        # the state the learner hands to the next iteration: Adam's count and
        # moments, and the adaptive KL coefficient (rllib's update_kl from the
        # last minibatch's KL), as the reference carries them
        kl = float(terms[2].detach())
        kl_step = (1.5 if kl > 2.0 * config.kl_target
                   else 0.5 if kl < 0.5 * config.kl_target else 1.0)
        kl_next = float(torch.tensor(kl_coeff, dtype=torch.float32) * kl_step)  # as stated
        readings["kl_coeff_gap"] = _rel(abs(end["kl_coeff"] - kl_next), kl_next)
        readings["adam_count_mismatch"] = max(
            abs((end["adam"][n][2] if n in end["adam"] else 0) - adam.count) for n in keys)
        for i, name in ((0, "adam_m_gap"), (1, "adam_v_gap")):
            prog = {n: end["adam"][n][i] for n in keys if n in end["adam"]}
            ref = adam.m if i == 0 else adam.v
            readings[name] = _leaf_gap(prog, ref, moved)
        for name, value in readings.items():
            check.add(name, value)
        print(f"iteration {it}: " + " ".join(f"{n} {v!r}" for n, v in readings.items()),
              file=sys.stderr)
