// B1: the fused training env step for ONE layout (train_kernel.cuh).
//
// Replaces the TPU kernel overcooked_ai_tpu/ops/fused_train.py:83
// `_build_train_kernel` (pallas_call at :409). The players' transition is
// the one B2 runs (overcooked_step.cuh env_act); the rest of the step is
// spread over the block (train_kernel.cuh).
//
// Bound on the H100: bytes. Per env step the kernel reads and writes the
// int32 state, 2 x (6 HW + 8 P + 1) x 4 bytes (1,096 B for cramped_room),
// reads the actions (4 P) and writes 2 x 26 x HW bytes of obs (1,040 B) and
// the rewards and events (12 P), against a few hundred integer operations.
//
// What the design does about the earlier one-thread-per-env body, which
// ran 12.6x its bound at 2048 envs in 32 blocks of 64 threads:
//   - a block of 512 threads takes a tile of E = 32 envs (64 blocks at 2048
//     envs; the fastest of E = 8, 16, 32 and 128-512 threads on the main
//     path's two batches), and all its threads stage the state, cook the
//     cells and encode them; only the players' part of the transition
//     stays one thread per env;
//   - the state arrives in shared memory by cp.async, in 16-byte runs where
//     the batch and the tensors' alignment allow (fused_train.stage_wide),
//     every load of the step in flight at once, not one word at a time per
//     thread into a 512-byte local-memory frame; the layout's table row
//     comes from device memory, and the rest of the layout block is read in
//     place, not copied out of the parameter space;
//   - the obs leaves an obs tile in shared memory in 16-byte stores of
//     neighbouring envs, not 1,040 one-byte stores per thread, so the
//     8-env eval batch spreads its encoding over the whole block.
// What it leaves: a launch is a chain of dependent phases (stage, act,
// encode, store) with one block of 16 warps on each busy SM, so its time is
// latency, not bandwidth; PERF.md has the measurements.
#include "train_kernel.cuh"

// Returns the cudaError_t of the launch (0 = launched).
// table_row: the layout's RecipeTables words (52 int32) in device memory.
extern "C" int oc_fused_train_step(const int* layout_words, const int* table_row,
                                   const StateArrays* in, const StateArrays* out,
                                   const int* actions, int8_t* obs, int* sparse, int* shaped,
                                   int* events, int B, int horizon, int reset_horizon,
                                   int tile_envs, int threads, int smem_bytes, int vec, int wide,
                                   void* stream) {
  return launch_train_step<false>(layout_words, LaneData{nullptr, nullptr, table_row, nullptr}, in,
                                  out, actions, obs, sparse, shaped, events, B, horizon,
                                  reset_horizon, tile_envs, threads, smem_bytes, vec, wide, stream);
}
