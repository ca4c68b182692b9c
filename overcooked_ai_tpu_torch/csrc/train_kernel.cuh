// The fused training env step, shared by B1 (fused_train.cu, one layout)
// and B3 (fused_pool_train.cu, a layout per env lane): in one launch, for
// every env, the exact next state with auto-reset at `reset_horizon`,
// per-player sparse and shaped rewards, the 25 events bit-packed per
// player, and the post-step 26-layer lossless encoding for both players as
// int8, laid out (P, 26, HW, B).
//
// One block takes a tile of E consecutive envs (ops/fused_train.py:tile_plan
// picks E, the block's threads, the dynamic shared memory and the width of
// the obs stores, and the C entry checks them). The block works in phases,
// with a barrier between each:
//   1. stage: every thread starts asynchronous copies (cp.async, 16 bytes
//      where the plan's `wide` allows: B and E multiples of 4 and every
//      staged row's base 16-byte aligned) of the tile's rows into shared
//      memory: the
//      timestep, the actions, the players and the raw cell rows (obj,
//      soup_ing, soup_tick, obj_seq and under POOL the reset words), and
//      the RecipeTables rows (each lane's under POOL, the layout's one row
//      in B1), so all of the step's device-memory loads are in flight
//      together. Then, from shared memory, one thread
//      per (cell, env) packs the cell word, with the cell's terrain in bits
//      28-30 in both kernels, and counts the env's dishes and its pot
//      snapshot with shared-memory atomics.
//   2. act: one thread per env runs the players' part of the transition
//      (overcooked_step.cuh env_act) on its staged cells, writes its
//      rewards, events, players and timestep, and resets its players at
//      the horizon.
//   3. cells: one thread per (cell, env) cooks the cell one tick (or, for
//      an env that reset, takes the start-state word), stores the next
//      state's cell rows, and writes that cell's 52 obs bytes (26 layers
//      for each player) into the obs tile in shared memory.
//   4. obs: the tile leaves shared memory in stores of `vec` bytes (16 when
//      E and B are multiples of 16), each a run of neighbouring envs of one
//      (player, layer, cell) row.
// The layout block stays in the kernel's parameter space: the kernel reads
// its uniform header there, and (B1) the per-cell terrain while packing and
// the start state at an auto-reset.
//
// Shared memory per block (tile_smem_bytes; sized from the layout's HW):
//   int        rows[8][E]          t, the two actions, reset, dishes, and the
//                                  pot snapshot (full, nonempty, pots)
//   int        players[16][E]      PlayerState word j of player i at row 8 i + j
//   RecipeTables tables[E or 1]    each lane's row (POOL), the layout's (B1)
//   uint32_t   cells[E][HW | 1]    env-major: a thread's env is one contiguous
//                                  array for env_act, and the odd stride puts
//                                  neighbouring envs' words in distinct banks
//   int8_t     obs[2][26][HW][E]   from the next 16-byte boundary; before
//                                  phase 3 it holds the raw cell rows
//                                  [6 or 7][HW][E] of int32
//
// The cook pass visits every cell of every env in both kernels, as
// core/step.py does.
//
// Channels (the reference LAYERS order): 0 own location, 1 other location,
// 2-5 own orientation, 6-9 other orientation, 10-15 pot / counter / onion /
// tomato / dish dispensers / serve (the lane's own terrain under POOL),
// 16-17 onions / tomatoes in idle pot soups, 18-19 onions / tomatoes in
// active or off-pot soups, 20 cook time remaining, 21 soup done, 22 dishes,
// 23 onions, 24 tomatoes, 25 urgency.
//
// The kernel does no matrix product, so the tensor cores have no part in it.
#pragma once

#include "overcooked_step.cuh"

#define OC_NUM_LAYERS 26
#define OC_URGENCY_WINDOW 40
#define OC_TRAIN_NP 2
#define OC_ENV_ROWS 8
#define OC_MAX_THREADS 512
enum { ENV_T, ENV_ACT, ENV_RESET = ENV_ACT + OC_TRAIN_NP, ENV_DISHES, ENV_FULL, ENV_NONEMPTY,
       ENV_POTS };

// Shared-memory plan of one block; ops/fused_train.py:tile_plan computes
// the same numbers.
__host__ __device__ inline int tile_obs_offset(int E, int HW, bool pool) {
  const int words = E * (OC_ENV_ROWS + 8 * OC_TRAIN_NP + (pool ? OC_TABLE_WORDS : 0) + (HW | 1)) +
                    (pool ? 0 : OC_TABLE_WORDS);
  return (words * 4 + 15) / 16 * 16;
}
inline int tile_smem_bytes(int E, int HW, bool pool) {
  return tile_obs_offset(E, HW, pool) + OC_TRAIN_NP * OC_NUM_LAYERS * HW * E;
}

// The tables an env's step reads: its lane's row (B3) or the layout's (B1),
// staged in shared memory.
template <bool POOL>
__device__ __forceinline__ const RecipeTables& tables_of(const RecipeTables* tabs, int e) {
  return tabs[POOL ? e : 0];
}

// Word j of player i's PlayerState (x, y, orient, held, slot0-2, tick) in
// the batch-last state arrays: the start of its (B,) row.
__device__ __forceinline__ int* player_row(const StateArrays& s, int i, int j, size_t Bs) {
  switch (j) {
    case 0: return s.pos + (2 * i) * Bs;
    case 1: return s.pos + (2 * i + 1) * Bs;
    case 2: return s.orient + i * Bs;
    case 3: return s.held + i * Bs;
    case 7: return s.held_soup_tick + i * Bs;
    default: return s.held_soup + (3 * i + j - 4) * Bs;
  }
}

// Asynchronous copies from device to shared memory (sm_80 and later).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
// The same through L1, for words that many threads of the block read.
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Phase 1: starts the copy of `rows` batch-last rows into dst[row][E], the
// tile's n_env words of each from b0 (row_at(r) is row r's start), four
// envs a copy when `wide`.
template <class RowAt>
__device__ __forceinline__ void stage_rows(int* dst, int rows, RowAt row_at, int E, int n_env,
                                           int b0, bool wide) {
  const int g = wide ? 4 : 1;
  const int per = n_env / g;
  for (int k = threadIdx.x; k < rows * per; k += blockDim.x) {
    const int r = k / per, c = (k - r * per) * g;
    if (wide) {
      cp_async16(dst + r * E + c, row_at(r) + b0 + c);
    } else {
      cp_async4(dst + r * E + c, row_at(r) + b0 + c);
    }
  }
}

// Phase 4: the obs tile (rows of E bytes) -> obs rows of B bytes, `sizeof(V)`
// bytes a store; n_env is a multiple of the width.
template <typename V>
__device__ __forceinline__ void store_obs_tile(const int8_t* tile, int8_t* obs, int rows, int E,
                                               int n_env, size_t Bs, int b0) {
  constexpr int vec = sizeof(V);
  const int n_vec = n_env / vec;
  for (int k = threadIdx.x; k < rows * n_vec; k += blockDim.x) {
    const int row = k / n_vec, j = k - row * n_vec;
    *reinterpret_cast<V*>(obs + row * Bs + b0 + j * vec) =
        *reinterpret_cast<const V*>(tile + row * E + j * vec);
  }
}

template <bool POOL>
__global__ void __launch_bounds__(OC_MAX_THREADS)
    train_step_kernel(const __grid_constant__ LayoutData lay, LaneData lanes, StateArrays in,
                      StateArrays out, const int* __restrict__ actions, int8_t* __restrict__ obs,
                      int* __restrict__ sparse_out, int* __restrict__ shaped_out,
                      int* __restrict__ events_out, int B, int horizon, int reset_horizon, int E,
                      int vec, bool wide) {
  constexpr int NP = OC_TRAIN_NP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = lay.num_cells;
  const int S = HW | 1;  // cell-word stride between envs
  int* rows = reinterpret_cast<int*>(smem);
  int* plw = rows + OC_ENV_ROWS * E;
  RecipeTables* tabs = reinterpret_cast<RecipeTables*>(plw + 8 * NP * E);
  uint32_t* cells = reinterpret_cast<uint32_t*>(tabs + (POOL ? E : 1));
  int8_t* tile = reinterpret_cast<int8_t*>(smem + tile_obs_offset(E, HW, POOL));
  int* raw = reinterpret_cast<int*>(tile);  // the raw cell rows, until phase 3

  const int tid = threadIdx.x, nth = blockDim.x;
  const int b0 = blockIdx.x * E;
  const int n_env = min(E, B - b0);
  const size_t Bs = (size_t)B;
  auto row = [&](int r, int e) -> int& { return rows[r * E + e]; };
  auto player = [&](int e, int i) {
    PlayerState p;
#pragma unroll
    for (int j = 0; j < 8; ++j) reinterpret_cast<int*>(&p)[j] = plw[(8 * i + j) * E + e];
    return p;
  };

  // ---- 1. stage the tile
  stage_rows(rows, 1 + NP, [&](int r) -> const int* { return r ? actions + (r - 1) * Bs : in.t; },
             E, n_env, b0, wide);
  stage_rows(plw, 8 * NP, [&](int r) -> const int* { return player_row(in, r / 8, r % 8, Bs); },
             E, n_env, b0, wide);
  stage_rows(raw, (POOL ? 7 : 6) * HW, [&](int r) -> const int* {
    const int p = r / HW, l = r - p * HW;
    switch (p) {
      case 0: return in.obj + l * Bs;
      case 1: case 2: case 3: return in.soup_ing + (3 * l + p - 1) * Bs;
      case 4: return in.soup_tick + l * Bs;
      case 5: return in.obj_seq + l * Bs;
      default: return lanes.reset_word + l * Bs;
    }
  }, E, n_env, b0, wide);
  // a table row is 13 runs of 16 bytes: each lane's, after its index (B3),
  // or the layout's one row (B1); the rows are shared by many envs, so the
  // copies go through L1
  for (int k = tid; k < (POOL ? n_env : 1) * (OC_TABLE_WORDS / 4); k += nth) {
    const int e = k / (OC_TABLE_WORDS / 4), j = (k - e * (OC_TABLE_WORDS / 4)) * 4;
    const size_t idx = POOL ? (size_t)lanes.table_idx[b0 + e] : 0;
    cp_async16_l1(reinterpret_cast<int*>(&tabs[e]) + j,
                  lanes.table_rows + idx * OC_TABLE_WORDS + j);
  }
  for (int e = tid; e < n_env; e += nth) {
    row(ENV_RESET, e) = row(ENV_DISHES, e) = row(ENV_FULL, e) = row(ENV_NONEMPTY, e) = 0;
    row(ENV_POTS, e) = POOL ? 0 : lay.num_pots;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int k = tid; k < HW * n_env; k += nth) {
    const int l = k / n_env, e = k - l * n_env;
    const int* r = raw + l * E + e;  // plane p at r[p * HW * E]
    const int HE = HW * E;
    uint32_t w = pack_cell(r[0], r[HE], r[2 * HE], r[3 * HE], r[4 * HE], r[5 * HE], HW);
    w |= POOL ? (uint32_t)r[6 * HE] & OC_TERRAIN_BITS : (uint32_t)lay.terrain[l] << OC_TERRAIN_SHIFT;
    cells[e * S + l] = w;
    if (cell_obj(w) == OC_OBJ_DISH) atomicAdd(&row(ENV_DISHES, e), 1);
    if ((int)(w >> OC_TERRAIN_SHIFT) == OC_T_POT) {
      int full = 0, nonempty = 0;
      snapshot_pot(tables_of<POOL>(tabs, e), w, full, nonempty);
      if constexpr (POOL) atomicAdd(&row(ENV_POTS, e), 1);
      if (full) atomicAdd(&row(ENV_FULL, e), 1);
      if (nonempty) atomicAdd(&row(ENV_NONEMPTY, e), 1);
    }
  }
  __syncthreads();

  // ---- 2. the players' transition, one thread per env
  if (tid < n_env) {
    const int e = tid, b = b0 + e;
    PlayerState pl[NP];
    int act[NP], sparse[NP], shaped[NP], events[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      pl[i] = player(e, i);
      act[i] = row(ENV_ACT + i, e);
    }
    int t = row(ENV_T, e), dishes = row(ENV_DISHES, e);
    const PotSnapshot snap{row(ENV_FULL, e), row(ENV_NONEMPTY, e), row(ENV_POTS, e)};
    EnvCells env_cells{cells + e * S};
    env_act<NP, true>(lay, tables_of<POOL>(tabs, e), env_cells, pl, t, act, sparse, shaped,
                      events, dishes, snap);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      sparse_out[i * Bs + b] = sparse[i];
      shaped_out[i * Bs + b] = shaped[i];
      events_out[i * Bs + b] = events[i];
    }
    const bool reset = ++t >= reset_horizon;
    if (reset) {
      reset_players<NP, POOL>(lay, lanes, B, b, pl);
      t = 0;
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int word = reinterpret_cast<int*>(&pl[i])[j];
        plw[(8 * i + j) * E + e] = word;
        player_row(out, i, j, Bs)[b] = word;
      }
    }
    out.t[b] = t;
    row(ENV_T, e) = t;
    row(ENV_RESET, e) = reset;
  }
  __syncthreads();

  // ---- 3. per (cell, env): cook or reset, store the cell, encode it
  const int W = lay.width;
  for (int k = tid; k < HW * n_env; k += nth) {
    const int l = k / n_env, e = k - l * n_env;
    const RecipeTables& R = tables_of<POOL>(tabs, e);
    const size_t i = l * Bs + b0 + e;
    uint32_t w = cells[e * S + l];
    if (row(ENV_RESET, e)) {
      w = POOL ? (uint32_t)lanes.reset_word[i]
               : (uint32_t)lay.reset_word[l] | (uint32_t)lay.terrain[l] << OC_TERRAIN_SHIFT;
    } else {
      w = cook_cell(R, w);
    }

    const int obj = cell_obj(w);
    const int tick = cell_tickp1(w) - 1;
    out.obj[i] = obj;
#pragma unroll
    for (int s = 0; s < 3; ++s) out.soup_ing[(3 * l + s) * Bs + b0 + e] = cell_slot(w, s);
    out.soup_tick[i] = tick;
    out.obj_seq[i] = cell_seq(w, HW);

    const int tt = (int)(w >> OC_TERRAIN_SHIFT);
    int n_o, n_t;
    count_slots(w, n_o, n_t);
    const bool soup = obj == OC_OBJ_SOUP;
    const bool at_pot = tt == OC_T_POT;
    const bool idle_at_pot = soup && at_pot && tick < 0;
    const bool active_at_pot = soup && at_pot && tick >= 0;
    const bool off_pot = soup && !at_pot;
    const int cook_time = R.time_table[n_o * 4 + n_t];
    int ch[OC_NUM_LAYERS];
    ch[16] = idle_at_pot ? n_o : 0;
    ch[17] = idle_at_pot ? n_t : 0;
    ch[18] = active_at_pot || off_pot ? n_o : 0;
    ch[19] = active_at_pot || off_pot ? n_t : 0;
    ch[20] = active_at_pot ? cook_time - tick : 0;
    ch[21] = (active_at_pot && tick >= cook_time) || off_pot;
    ch[22] = obj == OC_OBJ_DISH;
    ch[23] = obj == OC_OBJ_ONION;
    ch[24] = obj == OC_OBJ_TOMATO;
    // held objects count at the holder's position
    const int ly = l / W, lx = l - ly * W;
    PlayerState pl[NP];
    bool loc[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      pl[p] = player(e, p);
      loc[p] = pl[p].x == lx && pl[p].y == ly;
      if (loc[p]) {
        const int h = pl[p].held;
        if (h == OC_OBJ_SOUP) {
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            ch[18] += pl[p].slot[s] == OC_OBJ_ONION;
            ch[19] += pl[p].slot[s] == OC_OBJ_TOMATO;
          }
          ch[21] += 1;
        }
        ch[22] += h == OC_OBJ_DISH;
        ch[23] += h == OC_OBJ_ONION;
        ch[24] += h == OC_OBJ_TOMATO;
      }
    }
    ch[10] = tt == OC_T_POT;
    ch[11] = tt == OC_T_COUNTER;
    ch[12] = tt == OC_T_ONION_DISP;
    ch[13] = tt == OC_T_TOMATO_DISP;
    ch[14] = tt == OC_T_DISH_DISP;
    ch[15] = tt == OC_T_SERVE;
    ch[25] = horizon - row(ENV_T, e) < OC_URGENCY_WINDOW;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int q = 1 - p;
      ch[0] = loc[p];
      ch[1] = loc[q];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        ch[2 + d] = loc[p] && pl[p].orient == d;
        ch[6 + d] = loc[q] && pl[q].orient == d;
      }
      int8_t* o = tile + (p * OC_NUM_LAYERS * HW + l) * E + e;
#pragma unroll
      for (int c = 0; c < OC_NUM_LAYERS; ++c) o[c * HW * E] = (int8_t)ch[c];
    }
  }
  __syncthreads();

  // ---- 4. the obs tile to device memory, `vec` bytes a store
  const int obs_rows = NP * OC_NUM_LAYERS * HW;
  switch (vec) {
    case 16: store_obs_tile<uint4>(tile, obs, obs_rows, E, n_env, Bs, b0); break;
    case 8: store_obs_tile<uint2>(tile, obs, obs_rows, E, n_env, Bs, b0); break;
    case 4: store_obs_tile<uint32_t>(tile, obs, obs_rows, E, n_env, Bs, b0); break;
    case 2: store_obs_tile<uint16_t>(tile, obs, obs_rows, E, n_env, Bs, b0); break;
    default: store_obs_tile<uint8_t>(tile, obs, obs_rows, E, n_env, Bs, b0); break;
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Launches the kernel on `stream` with the wrapper's tile plan (E envs a
// block, `threads` threads, `smem_bytes` of dynamic shared memory, obs
// stores of `vec` bytes, 16-byte staging copies if `wide`); returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a plan that does
// not fit this layout, batch and these pointers.
template <bool POOL>
static int launch_train_step(const int* layout_words, const LaneData& lanes,
                             const StateArrays* in, const StateArrays* out, const int* actions,
                             int8_t* obs, int* sparse, int* shaped, int* events, int B,
                             int horizon, int reset_horizon, int E, int threads, int smem_bytes,
                             int vec, int wide, void* stream) {
  LayoutData lay;
  memcpy(&lay, layout_words, sizeof(LayoutData));
  const bool vec_ok = (vec == 1 || vec == 2 || vec == 4 || vec == 8 || vec == 16) &&
                      E % vec == 0 && B % vec == 0 && aligned16(obs);
  // the rows staged four envs a copy; the table rows always go 16 bytes a copy
  const void* staged[] = {in->t, actions, in->pos, in->orient, in->held, in->held_soup,
                          in->held_soup_tick, in->obj, in->soup_ing, in->soup_tick,
                          in->obj_seq, POOL ? lanes.reset_word : nullptr};
  bool wide_ok = B % 4 == 0 && E % 4 == 0;
  for (const void* p : staged) wide_ok = wide_ok && aligned16(p);
  if (lay.num_players != OC_TRAIN_NP || B < 1 || E < 1 || E > threads || threads % 32 != 0 ||
      threads > OC_MAX_THREADS || !vec_ok || (wide && !wide_ok) ||
      !aligned16(lanes.table_rows) || smem_bytes != tile_smem_bytes(E, lay.num_cells, POOL))
    return (int)cudaErrorInvalidValue;
  static int granted[OC_MAX_CARDS];
  const cudaError_t err =
      allow_smem((const void*)train_step_kernel<POOL>, smem_bytes, granted);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + E - 1) / E;
  train_step_kernel<POOL><<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      lay, lanes, *in, *out, actions, obs, sparse, shaped, events, B, horizon, reset_horizon, E,
      vec, wide != 0);
  return (int)cudaGetLastError();
}
