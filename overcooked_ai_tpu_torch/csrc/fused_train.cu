// B1: the fused training env step for ONE layout (train_kernel.cuh).
//
// Replaces the TPU kernel overcooked_ai_tpu/ops/fused_train.py:83
// `_build_train_kernel` (pallas_call at :409). One thread runs one env; the
// transition is the one B2 runs (overcooked_step.cuh).
//
// Bound on the H100: bytes. Per env step the kernel reads and writes the
// int32 state, about 2 x (6 HW + 8 P) x 4 bytes (1,090 B for cramped_room),
// and writes 2 x 26 x HW bytes of obs (1,040 B), against a few hundred
// integer operations. Batch-last arrays keep every load and store coalesced.
#include "train_kernel.cuh"

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int oc_fused_train_step(const int* layout_words, const StateArrays* in,
                                   const StateArrays* out, const int* actions, int8_t* obs,
                                   int* sparse, int* shaped, int* events, int B, int horizon,
                                   int reset_horizon, void* stream) {
  return launch_train_step<false>(layout_words, LaneData{nullptr, nullptr}, in, out, actions, obs,
                                  sparse, shaped, events, B, horizon, reset_horizon, stream);
}
