"""Train behavior-cloning "human proxy" models on scripted rollouts (port of
`overcooked_ai_tpu.cli.train_bc_proxy`).

The reference pairs PPO agents with BC models trained on human data, which
it does not ship; the stand-in, here as in the JAX package, is a BC model fit
to the greedy human model's behavior, or with `--from-ppo` to a trained PPO
checkpoint's (the port's own).

    python -m overcooked_ai_tpu_torch.cli.train_bc_proxy --layouts cramped_room
    python -m overcooked_ai_tpu_torch.cli.train_bc_proxy --layouts cramped_room \\
        --num-games 2 --horizon 40 --epochs 2 --device cpu --out /tmp/bc

The demonstrations run on the card (`--device cuda`, the default: each env
step one launch of the B1 kernel, `agents/evaluation.run_agent_pair`), as do
the featurization and the BC training; `--device cpu` runs the plain
versions. Models go to `--out`/bc_proxy_<layout> (default `runs_torch/`).
"""

from __future__ import annotations

import argparse
import os

import torch

from overcooked_ai_tpu_torch.cli.train_ppo import check_device

DEFAULT_LAYOUTS = ["cramped_room", "asymmetric_advantages", "coordination_ring",
                   "forced_coordination", "counter_circuit_o_1order"]


class NoisyPolicy:
    """An agent's policy, epsilon-noisy: with probability `epsilon` a uniform
    action of the six instead of the agent's, the clone's stand-in for human
    imperfection. The wrapped agent draws under the names "g/..."; the
    noise draws "eps" (the coin) and "eps_action" (the action)."""

    def __init__(self, policy, epsilon: float):
        self.policy, self.epsilon = policy, epsilon

    def __call__(self, draws, layout, state, agent_index, carry, obs=None):
        a, carry = self.policy(draws.scoped("g"), layout, state, agent_index, carry, obs)
        if self.epsilon > 0:
            a = torch.where(draws.uniform("eps") < self.epsilon,
                            draws.randint("eps_action", 6), a)
        return a.to(torch.int32), carry


def noisy(agent, epsilon: float):
    """The AgentFn `agent` with its actions epsilon-noisy (`NoisyPolicy`)."""
    return agent._replace(policy=NoisyPolicy(agent.policy, epsilon))


def train_proxy(layout_name, out_dir, num_games, horizon, epochs, seed, epsilon=0.1,
                old_dynamics=False, from_ppo=None, device="cuda"):
    """Fit a BC clone on mixed-partner demonstrations and save it; returns
    the model directory.

    The greedy demonstrator plays itself, a Boltzmann-rational partner and a
    random partner (only the greedy seat is cloned in the mixed games), so
    the blockage states and the greedy model's unstuck responses are in
    the clone's data: a clone of greedy self-play alone deadlocks against
    itself. With `from_ppo` (a checkpoint of the port), that policy is the
    demonstrator, cloned from both seats, with random-partner games.
    """
    from overcooked_ai_tpu_torch.agents.agents import make_greedy_human_model, random_agent
    from overcooked_ai_tpu_torch.agents.evaluation import (
        greedy_agent_fn,
        run_agent_pair,
        stateless,
    )
    from overcooked_ai_tpu_torch.core.layout import from_layout_name
    from overcooked_ai_tpu_torch.human_data.pipeline import (
        featurize_trajectories,
        rollout_to_bc_trajectories,
    )
    from overcooked_ai_tpu_torch.planning.greedy_tables import (
        build_goal_tables,
        build_greedy_tables,
    )
    from overcooked_ai_tpu_torch.planning.tables import build_motion_tables
    from overcooked_ai_tpu_torch.training.bc import BCConfig, save_bc_model, train_bc_model

    spec = from_layout_name(layout_name, **({"old_dynamics": True} if old_dynamics else {}))
    mt = build_motion_tables(spec.layout.terrain)
    rand = stateless(random_agent)
    half = max(1, num_games // 2)
    if from_ppo:
        from overcooked_ai_tpu_torch.agents.loading import build_agent

        demo = noisy(build_agent(f"ppo:{from_ppo}", spec, mt, device), epsilon)
        # (seat 0, seat 1, the seats whose actions are cloned, games)
        pairings = [(demo, demo, [0, 1], num_games), (demo, rand, [0], half),
                    (rand, demo, [1], half)]
    else:
        tables = build_greedy_tables(spec, device=device)
        greedy = noisy(greedy_agent_fn(make_greedy_human_model(spec, tables)), epsilon)
        boltz = noisy(greedy_agent_fn(make_greedy_human_model(
            spec, tables, hl_boltzmann_rational=True, ll_boltzmann_rational=True,
            goal_tables=build_goal_tables(spec.layout.terrain))), epsilon)
        pairings = [(greedy, greedy, [0, 1], num_games), (greedy, boltz, [0], half),
                    (boltz, greedy, [1], half), (greedy, rand, [0], half),
                    (rand, greedy, [1], half)]
    trajectories = []
    for k, (a0, a1, seats, games) in enumerate(pairings):
        traj = run_agent_pair(spec, [a0, a1], num_games=games, horizon=horizon,
                              seed=seed * 1000 + k, device=device)
        trajectories.extend(rollout_to_bc_trajectories(spec, traj, games, horizon, seats))
    obs, actions = featurize_trajectories(spec, mt.feature_cost, trajectories, device=device)
    cfg = BCConfig(epochs=epochs)
    params, history = train_bc_model(obs, actions, cfg, seed=seed, device=device)
    model_dir = os.path.join(out_dir, f"bc_proxy_{layout_name}")
    source = (f"PPO demonstrations from {from_ppo} ({num_games} self-play + 2x{half} "
              f"random-partner games x {horizon} steps, epsilon={epsilon}; both seats cloned)"
              if from_ppo else
              f"mixed-partner greedy demonstrations ({num_games} self-play + 4x{half} mixed "
              f"games x {horizon} steps, epsilon={epsilon}; partners: boltzmann, random)")
    save_bc_model(model_dir, params, cfg, metadata={
        "layout": layout_name,
        "old_dynamics": old_dynamics,
        "source": source,
        "final_train_loss": float(history["loss"][-1]),
        "final_val_loss": float(history["val_loss"][-1]) if history["val_loss"] else None,
    })
    print(f"{layout_name}: {obs.shape[0]} samples, loss {history['loss'][0]:.3f} -> "
          f"{history['loss'][-1]:.3f}, saved {model_dir}", flush=True)
    return model_dir


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layouts", nargs="+", default=DEFAULT_LAYOUTS)
    ap.add_argument("--out", default="runs_torch/bc_proxy")
    ap.add_argument("--num-games", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--epsilon", type=float, default=0.1,
                    help="random-action rate in the cloned behavior (0 = pure greedy)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--old-dynamics", action="store_true",
                    help="demonstrate and clone under old (auto-cook) dynamics")
    ap.add_argument("--from-ppo", default=None,
                    help="a PPO checkpoint directory of the port to demonstrate instead of "
                    "the greedy model (the hand-off-capable proxy); applies to every "
                    "--layouts entry, so pass one layout per invocation")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = check_device(args.device)
    return [train_proxy(layout, args.out, args.num_games, args.horizon, args.epochs, args.seed,
                        epsilon=args.epsilon, old_dynamics=args.old_dynamics,
                        from_ppo=args.from_ppo, device=device)
            for layout in args.layouts]


if __name__ == "__main__":
    main()
