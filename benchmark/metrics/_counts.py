"""The work of a training iteration and of a B1 launch, from the shapes alone.

FLOPs count each multiply-add of a convolution or dense layer as 2 (bias
adds and activations are left out), so the count is the algorithm's and
reads the same whatever implements it. A backward pass is counted as twice
its forward. B1's bytes are those of its interface tensors, each input read
once and each output written once: the state and the actions in; the
state, the encoded obs, and the sparse and shaped rewards and event masks
out.
"""

STATE_WORDS_PER_PLAYER = 2 + 1 + 1 + 3 + 1  # pos, orient, held, held soup slots, its tick
STATE_WORDS_PER_CELL = 1 + 3 + 1 + 1  # object, soup slots, soup tick, stamp
OBS_LAYERS = 26


def ppo_forward_flops(net: dict, height: int, width: int, in_channels: int = OBS_LAYERS) -> int:
    """One sample through the policy net (convs, dense layers, both heads)."""
    flops, ch, h, w = 0, in_channels, height, width
    for i in range(net["num_conv_layers"]):
        k = 5 if i == 0 else 3
        if i > 0 and i == net["num_conv_layers"] - 1:
            h, w = h - k + 1, w - k + 1
        flops += 2 * ch * net["num_filters"] * k * k * h * w
        ch = net["num_filters"]
    size = ch * h * w
    for _ in range(net["num_hidden_layers"]):
        flops += 2 * size * net["size_hidden_layers"]
        size = net["size_hidden_layers"]
    return flops + 2 * size * (net["num_actions"] + 1)


def mlp_forward_flops(obs_dim: int, net_arch, num_actions: int) -> int:
    dims = [obs_dim, *net_arch, num_actions]
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def train_iteration_flops(bundle: dict) -> float:
    """The model FLOPs an iteration's algorithm needs: the learner's forward
    on every sample the rollout collects, forward and backward on every
    sample of every minibatch of every epoch, and the BC partner's forward
    on its seats."""
    tr, cfg = bundle["traffic"], bundle["config"]
    players, envs, horizon = 2, tr["num_envs"], tr["horizon"]
    per_sample = ppo_forward_flops(cfg["net"], bundle["height"], bundle["width"])
    samples = players * envs * horizon
    mb = min(2 * tr["sgd_minibatch_size"], samples)
    trained = (samples // mb) * mb * tr["num_sgd_iter"]
    flops = per_sample * (samples + 3 * trained)
    if "bc_net" in cfg:
        bc = cfg["bc_net"]
        flops += (mlp_forward_flops(bc["obs_dim"], bc["net_arch"], bc["num_actions"])
                  * bundle["bc_seat_envs"] * horizon)
    return float(flops)


def b1_bytes(envs: int, height: int, width: int, players: int = 2) -> int:
    """Bytes at B1's interface for one launch over `envs` envs."""
    state = 4 * (players * STATE_WORDS_PER_PLAYER + height * width * STATE_WORDS_PER_CELL + 1)
    per_env = (2 * state + 4 * players  # state in and out, int32 actions
               + players * OBS_LAYERS * height * width  # int8 obs
               + 3 * 4 * players)  # sparse, shaped, events
    return envs * per_env
