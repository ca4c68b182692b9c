"""overcooked_ai_tpu_torch: the PyTorch / CUDA (H100) port of overcooked_ai_tpu.

The batched Overcooked MDP, its lossless encoding and the PPO policy path,
with the env step and the whole-horizon rollout as hand-written CUDA
kernels (`csrc/`, built on first use by `ops/_build.py`). Importing the
package builds nothing and touches no GPU.
"""

__version__ = "0.1.0"
