"""A run of a cell on the CPU at a tiny size, for the tests: the port's
plain versions stand in for its kernels, the look for a card is skipped."""

import run

TINY = {
    "selfplay_cramped": {"num_envs": 4, "horizon": 12, "sgd_minibatch_size": 8,
                         "num_sgd_iter": 2},
    "ppo_bc_phi_cramped": {"num_envs": 4, "horizon": 12, "sgd_minibatch_size": 8,
                           "num_sgd_iter": 2},
    "random_play_pool64": {"num_envs": 32, "steps_per_call": 450},
}


def cpu_run(cell, seed=2_147_483_901, control=None, device="cpu"):
    args = run.parse(["--workload", cell, "--seed", str(seed),
                      "--seconds", "0", "--trace", "0"])
    ctx = run.make_context(args, device=device, control=control,
                           traffic_overrides=TINY[cell], check_iterations=2)
    return run.execute(ctx)
