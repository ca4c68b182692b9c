"""The work of a recurrent training iteration (`make_ppo_lstm`), from the
shapes alone, and the iterations a recording holds.

FLOPs count each multiply-add as 2, as `_counts.py` does: the torso as
`_counts.ppo_forward_flops` counts it without its heads, the cell's input
and hidden products, 2 * (F + C) * 4C, and the logits and value heads over
the cell's C outputs. The forward counts on every rollout sample, and
three times (forward and a backward of twice its work) on every trained
sample of every epoch: `max(min(2 * sgd_minibatch_size // 20, n_chunks),
1)` chunks of 20 a minibatch, the tail of each permutation dropped.
"""

from metrics._counts import ppo_forward_flops

MAX_SEQ_LEN = 20
ITERATION = "ppo.iteration"  # the span of one `train_iteration`


def cell_flops(net: dict) -> int:
    """One sample through the cell: its input and hidden products."""
    return 2 * (net["size_hidden_layers"] + net["cell_size"]) * 4 * net["cell_size"]


def forward_flops(net: dict, height: int, width: int) -> int:
    """One sample through `LSTMPPONet`: torso, cell, heads."""
    heads = 2 * net["size_hidden_layers"] * (net["num_actions"] + 1)
    torso = ppo_forward_flops(net, height, width) - heads
    return torso + cell_flops(net) + 2 * net["cell_size"] * (net["num_actions"] + 1)


def samples(traffic: dict, players: int = 2):
    """(samples the rollout collects, samples trained on over the epochs)."""
    collected = players * traffic["num_envs"] * traffic["horizon"]
    chunks = collected // MAX_SEQ_LEN
    mb_chunks = max(min(2 * traffic["sgd_minibatch_size"] // MAX_SEQ_LEN, chunks), 1)
    trained = (chunks // mb_chunks) * mb_chunks * MAX_SEQ_LEN * traffic["num_sgd_iter"]
    return collected, trained


def iteration_flops(bundle: dict) -> float:
    net = bundle["config"]["net"]
    collected, trained = samples(bundle["traffic"])
    return float(forward_flops(net, bundle["height"], bundle["width"]) * (collected + 3 * trained))


def recurrence_flops(bundle: dict) -> float:
    """The SGD's forward recurrence an iteration: the cell on every trained sample."""
    return float(cell_flops(bundle["config"]["net"]) * samples(bundle["traffic"])[1])


def iterations(spans) -> int:
    return sum(s.name == ITERATION for s in spans)
