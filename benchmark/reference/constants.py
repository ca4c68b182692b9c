# Frozen copy of overcooked_ai_tpu_torch/core/constants.py at commit 594fcf2,
# its imports made relative: the benchmark's plain reference, which later
# changes to the port do not move.
"""Integer encodings for the TPU-native Overcooked MDP.

Everything in the hot path is an integer array; these constants define the
vocabulary. Action/direction indexing mirrors the reference ordering
(reference: overcooked_ai_py/mdp/actions.py:16,49) so that policy logits and
trajectory data are interchangeable with the reference:

    directions: NORTH=0, SOUTH=1, EAST=2, WEST=3
    actions:    N/S/E/W = 0..3, STAY=4, INTERACT=5
"""

import numpy as np

# --- Terrain codes (reference chars "XOPDST ", overcooked_mdp.py:2063-2115) ---
TERRAIN_EMPTY = 0  # " "
TERRAIN_COUNTER = 1  # "X"
TERRAIN_ONION_DISP = 2  # "O"
TERRAIN_TOMATO_DISP = 3  # "T"
TERRAIN_POT = 4  # "P"
TERRAIN_DISH_DISP = 5  # "D"
TERRAIN_SERVE = 6  # "S"

TERRAIN_CHAR_TO_CODE = {
    " ": TERRAIN_EMPTY,
    "X": TERRAIN_COUNTER,
    "O": TERRAIN_ONION_DISP,
    "T": TERRAIN_TOMATO_DISP,
    "P": TERRAIN_POT,
    "D": TERRAIN_DISH_DISP,
    "S": TERRAIN_SERVE,
}
TERRAIN_CODE_TO_CHAR = {v: k for k, v in TERRAIN_CHAR_TO_CODE.items()}

# --- Object / held-item codes ---
OBJ_NONE = 0
OBJ_ONION = 1
OBJ_TOMATO = 2
OBJ_DISH = 3
OBJ_SOUP = 4

OBJ_CODE_TO_NAME = {
    OBJ_ONION: "onion",
    OBJ_TOMATO: "tomato",
    OBJ_DISH: "dish",
    OBJ_SOUP: "soup",
}
OBJ_NAME_TO_CODE = {v: k for k, v in OBJ_CODE_TO_NAME.items()}

# Soup ingredient slot codes (same as object codes for onion/tomato; 0 = empty)
ING_NONE = 0
ING_ONION = 1
ING_TOMATO = 2
ING_CODE_TO_NAME = {ING_ONION: "onion", ING_TOMATO: "tomato"}

# --- Directions / actions (reference actions.py:12-17,47-57) ---
DIR_NORTH, DIR_SOUTH, DIR_EAST, DIR_WEST = 0, 1, 2, 3
ACTION_STAY = 4
ACTION_INTERACT = 5
NUM_ACTIONS = 6

# (dx, dy) per direction index; row 4 is STAY's zero vector so that
# DIR_VECTORS[min(action, 4)] is the movement delta of any action.
DIR_VECTORS = np.array(
    [[0, -1], [0, 1], [1, 0], [-1, 0], [0, 0], [0, 0]], dtype=np.int32
)

DIRECTION_TO_TUPLE = {
    DIR_NORTH: (0, -1),
    DIR_SOUTH: (0, 1),
    DIR_EAST: (1, 0),
    DIR_WEST: (-1, 0),
}
TUPLE_TO_DIRECTION = {v: k for k, v in DIRECTION_TO_TUPLE.items()}

# --- Event channels (exact order of reference EVENT_TYPES, overcooked_mdp.py:1027-1058) ---
EVENT_TYPES = (
    "tomato_pickup",
    "useful_tomato_pickup",
    "tomato_drop",
    "useful_tomato_drop",
    "potting_tomato",
    "onion_pickup",
    "useful_onion_pickup",
    "onion_drop",
    "useful_onion_drop",
    "potting_onion",
    "dish_pickup",
    "useful_dish_pickup",
    "dish_drop",
    "useful_dish_drop",
    "soup_pickup",
    "soup_delivery",
    "soup_drop",
    "optimal_onion_potting",
    "optimal_tomato_potting",
    "viable_onion_potting",
    "viable_tomato_potting",
    "catastrophic_onion_potting",
    "catastrophic_tomato_potting",
    "useless_onion_potting",
    "useless_tomato_potting",
)
NUM_EVENTS = len(EVENT_TYPES)
EVENT_INDEX = {name: i for i, name in enumerate(EVENT_TYPES)}

# --- Reward shaping defaults (reference BASE_REW_SHAPING_PARAMS, overcooked_mdp.py:1018) ---
BASE_REW_SHAPING_PARAMS = {
    "PLACEMENT_IN_POT_REW": 3,
    "DISH_PICKUP_REWARD": 3,
    "SOUP_PICKUP_REWARD": 5,
    "DISH_DISP_DISTANCE_REW": 0,
    "POT_DISTANCE_REW": 0,
    "SOUP_DISTANCE_REW": 0,
}

MAX_NUM_INGREDIENTS = 3


# --- Action/Direction micro-utilities over the INDEX vocabulary ---
# (reference actions.py:27-131; there they operate on tuple/str actions,
# here on the int indices that the whole framework speaks)

ACTION_TO_CHAR = {0: "↑", 1: "↓", 2: "→", 3: "←", 4: "stay", 5: "interact"}
MOTION_ACTIONS = (0, 1, 2, 3, 4)  # directions + stay (actions.py:57)


def get_adjacent_directions(direction: int):
    """Directions within 90 degrees of `direction` (actions.py:27-36)."""
    if direction in (DIR_NORTH, DIR_SOUTH):
        return [DIR_EAST, DIR_WEST]
    if direction in (DIR_EAST, DIR_WEST):
        return [DIR_NORTH, DIR_SOUTH]
    raise ValueError(f"Invalid direction: {direction}")


def move_in_direction(point, direction: int):
    """One step from (x, y) along a motion action (actions.py:69-80)."""
    assert direction in MOTION_ACTIONS
    dx, dy = DIR_VECTORS[direction]
    return (point[0] + int(dx), point[1] + int(dy))


def determine_action_for_change_in_pos(old_pos, new_pos) -> int:
    """Action index that moves old_pos -> new_pos (actions.py:82-91)."""
    if tuple(old_pos) == tuple(new_pos):
        return ACTION_STAY
    delta = (new_pos[0] - old_pos[0], new_pos[1] - old_pos[1])
    return TUPLE_TO_DIRECTION[delta]


def to_char(action: int) -> str:
    """actions.py:119-122."""
    return ACTION_TO_CHAR[int(action)]


def joint_action_to_char(joint_action):
    """actions.py:124-127."""
    return tuple(to_char(a) for a in joint_action)


def uniform_probs_over_actions():
    """actions.py:129-131."""
    return np.ones(NUM_ACTIONS) / NUM_ACTIONS


def sample_action(rng, action_probs) -> int:
    """Sample an action index from a distribution (actions.py:93-97;
    takes an explicit numpy Generator/RandomState instead of global
    np.random)."""
    return int(rng.choice(NUM_ACTIONS, p=np.asarray(action_probs)))


def argmax_action(action_probs) -> int:
    """actions.py:99-101."""
    return int(np.argmax(np.asarray(action_probs)))
