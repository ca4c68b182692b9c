// The whole-horizon rollout, `num_steps` env steps in one launch, shared by
// B2 (fused_rollout.cu, one layout) and B4 (fused_pool_rollout.cu, a layout
// per env lane). One thread runs one env for the whole horizon. Device
// memory is touched twice per env (load the state, store it and the
// return), plus the (T, P, B) actions when they are given and, under POOL,
// the lane's reset words (terrain at load, start state at each auto-reset).
//
// Where the env lives during the launch:
//   - its cell words in the block's dynamic shared memory, cell-major with
//     the block's envs minor (cell l of thread j at [l * threads + j]), so a
//     warp's loads and stores of any cells fall in 32 distinct banks;
//     HW x threads x 4 bytes, at most 128 KB (HW <= 128, threads <= 256);
//   - its players, and two bit masks of its cells in registers: `floor`,
//     the cells a player may enter (fixed for the rollout: the layout's, or
//     the lane's terrain), and `live`, the cells whose word the next cook
//     tick changes (a cooking soup; under old dynamics also a full idle
//     one). Every store of a word updates its live bit, so the cook pass
//     visits only the live cells and gives the words a visit of every cell
//     gives.
//
// Actions come from an explicit (T, P, B) int32 tensor or from the murmur3
// counter hash of the TPU kernels (fused_rollout.py:762-787, fused_pool.py
// :321-333), keyed on the global env index b, bit for bit:
//   x = seed * 0x9E3779B9 + b + player * 0x85EBCA6B + step * 0x27D4EB2F
//   (uint32), two xor-shift-multiply rounds, action = ((x >> 8) * 6) >> 24.
// The source is a template parameter (RNG), not a flag tested every step.
#pragma once

#include "overcooked_step.cuh"

#define OC_ROLLOUT_MAX_THREADS 256

__device__ __forceinline__ int hash_action(uint32_t seed_base, uint32_t b, uint32_t player,
                                           uint32_t step) {
  uint32_t x = seed_base + b + player * 0x85EBCA6Bu + step * 0x27D4EB2Fu;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return (int)(((x >> 8) * 6u) >> 24);
}

// One bit per cell of an env (HW <= 128), in two registers.
struct CellMask {
  uint64_t lo = 0, hi = 0;
  __device__ __forceinline__ bool get(int l) const { return ((l < 64 ? lo : hi) >> (l & 63)) & 1; }
  __device__ __forceinline__ void set(int l, bool v) {
    const uint64_t bit = 1ull << (l & 63);
    if (l < 64) {
      lo = v ? lo | bit : lo & ~bit;
    } else {
      hi = v ? hi | bit : hi & ~bit;
    }
  }
};

// B2, B4: one env's cell words in the block's shared memory, and its masks.
struct RolloutCells {
  uint32_t* w;  // cell l at w[l * stride]
  int stride;   // threads a block
  const RecipeTables& R;
  CellMask floor_cells, live;

  __device__ __forceinline__ uint32_t load(int l) const { return w[l * stride]; }
  // stores word v of cell l, with its live bit (cook_cell(R, v) != v)
  __device__ __forceinline__ void store(int l, uint32_t v, bool is_live) {
    w[l * stride] = v;
    live.set(l, is_live);
  }
  __device__ __forceinline__ void store(int l, uint32_t v) { store(l, v, cook_cell(R, v) != v); }
  // as EnvCells::can_enter, without a branch: the mask is in registers, so
  // any index may be tested
  __device__ __forceinline__ bool can_enter(int a, int cl, int HW) const {
    return (a >= 0) & (a < 4) & (cl >= 0) & (cl < HW) & floor_cells.get(cl & (OC_MAX_HW - 1));
  }
};

// One cook tick on word w, and whether the tick after changes it too, from
// one decode of the word.
__device__ __forceinline__ uint32_t cook_live(const RecipeTables& R, uint32_t w, bool& live) {
  int n_o, n_t;
  count_slots(w, n_o, n_t);
  const int cook_time = R.time_table[n_o * 4 + n_t];
  const int tickp1 = next_tickp1(R, cell_tickp1(w), n_o + n_t, cook_time);
  live = cell_obj(w) == OC_OBJ_SOUP && next_tickp1(R, tickp1, n_o + n_t, cook_time) != tickp1;
  return cell_obj(w) == OC_OBJ_SOUP ? with_tickp1(w, tickp1) : w;
}

// The cook pass: one tick on each live cell (a soup), found with __ffsll,
// and the cell's live bit for the tick after, from one decode of its word.
__device__ __forceinline__ void cook_live_cells(RolloutCells& c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint64_t m = h ? c.live.hi : c.live.lo;
    while (m) {
      const int l = 64 * h + __ffsll((long long)m) - 1;
      m &= m - 1;
      bool live;
      const uint32_t w = cook_live(c.R, c.load(l), live);
      c.store(l, w, live);
    }
  }
}

// Thread b's env of a batch-last state -> packed cells (with the terrain
// and the masks) and players; returns its timestep.
template <int NP, bool POOL>
__device__ __forceinline__ int load_env(const LayoutData& L, const LaneData& lanes,
                                        const StateArrays& s, int B, int b, RolloutCells& cells,
                                        PlayerState* pl) {
  const size_t Bs = (size_t)B;
  for (int l = 0; l < L.num_cells; ++l) {
    const uint32_t terrain = POOL ? (uint32_t)lanes.reset_word[l * Bs + b] & OC_TERRAIN_BITS
                                  : (uint32_t)L.terrain[l] << OC_TERRAIN_SHIFT;
    cells.floor_cells.set(l, (terrain >> OC_TERRAIN_SHIFT) == OC_T_EMPTY);
    cells.store(l, pack_cell(s.obj[l * Bs + b], s.soup_ing[(3 * l + 0) * Bs + b],
                             s.soup_ing[(3 * l + 1) * Bs + b], s.soup_ing[(3 * l + 2) * Bs + b],
                             s.soup_tick[l * Bs + b], s.obj_seq[l * Bs + b], L.num_cells) |
                       terrain);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    pl[i].x = s.pos[(2 * i + 0) * Bs + b];
    pl[i].y = s.pos[(2 * i + 1) * Bs + b];
    pl[i].orient = s.orient[i * Bs + b];
    pl[i].held = s.held[i * Bs + b];
#pragma unroll
    for (int k = 0; k < 3; ++k) pl[i].slot[k] = s.held_soup[(3 * i + k) * Bs + b];
    pl[i].tick = s.held_soup_tick[i * Bs + b];
  }
  return s.t[b];
}

template <int NP>
__device__ __forceinline__ void store_env(const LayoutData& L, const StateArrays& s, int B, int b,
                                          const RolloutCells& cells, const PlayerState* pl,
                                          int t) {
  const size_t Bs = (size_t)B;
  for (int l = 0; l < L.num_cells; ++l) {
    const uint32_t w = cells.load(l);
    s.obj[l * Bs + b] = cell_obj(w);
#pragma unroll
    for (int k = 0; k < 3; ++k) s.soup_ing[(3 * l + k) * Bs + b] = cell_slot(w, k);
    s.soup_tick[l * Bs + b] = cell_tickp1(w) - 1;
    s.obj_seq[l * Bs + b] = cell_seq(w, L.num_cells);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    s.pos[(2 * i + 0) * Bs + b] = pl[i].x;
    s.pos[(2 * i + 1) * Bs + b] = pl[i].y;
    s.orient[i * Bs + b] = pl[i].orient;
    s.held[i * Bs + b] = pl[i].held;
#pragma unroll
    for (int k = 0; k < 3; ++k) s.held_soup[(3 * i + k) * Bs + b] = pl[i].slot[k];
    s.held_soup_tick[i * Bs + b] = pl[i].tick;
  }
  s.t[b] = t;
}

// Auto-reset of a whole env to the start state (the layout's, or the
// lane's own), cells and players.
template <int NP, bool POOL>
__device__ __forceinline__ void reset_env(const LayoutData& L, const LaneData& lanes, int B, int b,
                                          RolloutCells& cells, PlayerState* pl) {
  const size_t Bs = (size_t)B;
  for (int l = 0; l < L.num_cells; ++l)
    cells.store(l, POOL ? (uint32_t)lanes.reset_word[l * Bs + b]
                        : (uint32_t)L.reset_word[l] | (uint32_t)L.terrain[l] << OC_TERRAIN_SHIFT);
  reset_players<NP, POOL>(L, lanes, B, b, pl);
}

template <int NP, bool POOL, bool RNG>
__global__ void __launch_bounds__(OC_ROLLOUT_MAX_THREADS)
    rollout_kernel(const __grid_constant__ LayoutData lay, LaneData lanes, StateArrays in,
                   StateArrays out, const int* __restrict__ actions, int* __restrict__ ret, int B,
                   int num_steps, int horizon, uint32_t seed) {
  __shared__ LayoutData L;
  extern __shared__ uint32_t block_cells[];
  load_layout(L, lay);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  RolloutCells cells{block_cells + threadIdx.x, (int)blockDim.x, L.tab};
  PlayerState pl[NP];
  int t = load_env<NP, POOL>(L, lanes, in, B, b, cells, pl);
  const uint32_t seed_base = seed * 0x9E3779B9u;
  auto fetch = [&](int k, int* a) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if constexpr (RNG) {
        a[i] = hash_action(seed_base, (uint32_t)b, (uint32_t)i, (uint32_t)k);
      } else {
        a[i] = actions[((size_t)k * NP + i) * B + b];
      }
    }
  };
  int act[NP], sparse[NP];
  int total = 0, dishes = 0;
  const PotSnapshot snap{0, 0, 0};
  for (int k = 0; k < num_steps; ++k) {
    fetch(k, act);
    env_act<NP, false>(L, L.tab, cells, pl, t, act, sparse, nullptr, nullptr, dishes, snap);
    cook_live_cells(cells);
#pragma unroll
    for (int i = 0; i < NP; ++i) total += sparse[i];
    if (++t >= horizon) {
      reset_env<NP, POOL>(L, lanes, B, b, cells, pl);
      t = 0;
    }
  }
  store_env<NP>(L, out, B, b, cells, pl, t);
  ret[b] = total;
}

template <int NP, bool POOL, bool RNG>
static cudaError_t launch_rollout_np(const LayoutData& lay, const LaneData& lanes,
                                     const StateArrays& in, const StateArrays& out,
                                     const int* actions, int* ret, int B, int num_steps,
                                     int horizon, int seed, int threads, cudaStream_t stream) {
  const int smem_bytes = lay.num_cells * threads * 4;
  static int granted[OC_MAX_CARDS];
  const cudaError_t err =
      allow_smem((const void*)rollout_kernel<NP, POOL, RNG>, smem_bytes, granted);
  if (err != cudaSuccess) return err;
  const int blocks = (B + threads - 1) / threads;
  rollout_kernel<NP, POOL, RNG><<<blocks, threads, smem_bytes, stream>>>(
      lay, lanes, in, out, actions, ret, B, num_steps, horizon, (uint32_t)seed);
  return cudaGetLastError();
}

// Launches the kernel for the layout's player count (1-4) on `stream`, in
// blocks of `threads` (a multiple of 32, at most OC_ROLLOUT_MAX_THREADS),
// with the murmur3 stream of `seed` when `actions` is null; returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for arguments the
// kernel does not take.
template <bool POOL>
static int launch_rollout(const int* layout_words, const LaneData& lanes, const StateArrays* in,
                          const StateArrays* out, const int* actions, int* ret, int B,
                          int num_steps, int horizon, int seed, int threads, void* stream) {
  LayoutData lay;
  memcpy(&lay, layout_words, sizeof(LayoutData));
  if (B < 1 || num_steps < 0 || threads < 32 || threads > OC_ROLLOUT_MAX_THREADS ||
      threads % 32 != 0 || lay.num_cells < 1 || lay.num_cells > OC_MAX_HW)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lay.num_players) {
#define OC_CASE(NP)                                                                            \
  case NP:                                                                                     \
    return (int)(actions ? launch_rollout_np<NP, POOL, false>(lay, lanes, *in, *out, actions, \
                                                               ret, B, num_steps, horizon,    \
                                                               seed, threads, s)              \
                         : launch_rollout_np<NP, POOL, true>(lay, lanes, *in, *out, actions,  \
                                                              ret, B, num_steps, horizon,     \
                                                              seed, threads, s));
    OC_CASE(1)
    OC_CASE(2)
    OC_CASE(3)
    OC_CASE(4)
#undef OC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
