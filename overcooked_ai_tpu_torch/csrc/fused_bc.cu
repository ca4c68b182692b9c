// The BC partner's logits for every seat of every env of a batch in one launch:
// the hand-crafted featurization and the BC MLP (ops/fused_bc.py; the plain
// version is core/featurize.py `featurize_batch` followed by training/bc.py
// `BCNet`).
//
// Replaces no TPU kernel: in the JAX package featurize and the BC MLP are XLA
// ops (overcooked_ai_tpu/core/featurize.py `featurize_batch`,
// overcooked_ai_tpu/training/bc.py `BCNet`), which XLA fuses inside the jitted
// rollout. Run op by op, the port's plain version is about 270 PyTorch ops of
// featurize and the MLP's six a step: the card finishes each in a few
// microseconds while the host spends milliseconds dispatching them.
//
// Bound on the H100: launch latency. An env reads about 540 bytes of state and
// writes 48 bytes of logits, so 2048 envs move about 1.2 MB, 0.36 us at 3.35
// TB/s; the MLP (96 -> 64 -> 64 -> 6) is 10,758 multiply-adds a row, 4096 rows
// 88 MFLOP, 1.3 us at 67 TFLOP/s float32. So the bound is about 1.3 us a
// launch, against a launch's few microseconds.
//
// What the design does about that: one launch a step, and the features never
// leave shared memory. A block takes 16 envs (32 rows, one per seat) and 128
// threads. The weights start copying into shared memory (cp.async) first and
// land behind the features' work. Each of the four warps scans a quarter of
// the grid's cells for the block's 32 (env, player) lanes: the six
// closest-feature queries as least keys in the plain version's tie order (the
// key cost * 4096 + rank, terrain cells by cell, counter objects after every
// terrain cell by placement stamp, the first minimum winning). Warp 0 merges
// the four scans, finds the `num_pots` closest pots and the wall bits, and
// writes each player's 26 + 10 * num_pots values into its own row and its
// partner's. Then each thread runs the MLP on a 4 x 4 tile of rows and
// outputs, two 16-byte shared loads feeding 16 float32 FMAs on the CUDA cores
// (the configuration is float32 with TF32 off). The layout's tables
// (terrain, cook times, pot cells, cost rows) are one block of int32 words an
// entry, packed once per device (ops/fused_bc.py `pack_words`); a pool's
// entries are stacked and each lane reads the entry its pool index names, a
// single layout being a pool of one. The features are the plain version's bit
// for bit; the logits differ from cuBLAS's in the order of the sums only.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kEnvs = 16;                 // envs a block
constexpr int kPlayers = 2;               // ops/fused_bc.py NUM_PLAYERS
constexpr int kRows = kEnvs * kPlayers;   // rows a block, one per seat
constexpr int kThreads = 128;
constexpr int kScanWarps = kThreads / kRows;  // warps splitting the cells' scan
constexpr int kMaxPots = 4;               // ops/fused_bc.py MAX_POTS
constexpr int kMaxHidden = 4;             // ops/fused_bc.py MAX_HIDDEN
constexpr int kMaxWidth = 64;             // ops/fused_bc.py MAX_WIDTH
constexpr int kMaxHW = 128;               // ops/_build.py MAX_HW
constexpr int kMaxDevices = 64;
constexpr int kInfCost = 1 << 20;         // planning/tables.py INF_COST
constexpr int kRankStride = 4096;         // core/featurize.py _RANK_STRIDE
constexpr int kKeyMax = 0x7fffffff;       // core/featurize.py _KEY_MAX
constexpr int kSlots = 3;                 // MAX_NUM_INGREDIENTS
constexpr int kEmpty = 0, kCounter = 1, kOnionDisp = 2, kTomatoDisp = 3, kDishDisp = 5,
              kServe = 6;
constexpr int kObjNone = 0, kObjOnion = 1, kObjTomato = 2, kObjDish = 3, kObjSoup = 4;

// An entry's words (ops/fused_bc.py `entry_layout`): the terrain (HW), the
// cook times (16, [n_onions * 4 + n_tomatoes]), the number of pot cells and
// the pot cells (HW words, row-major), the cost rows (4HW x HW).
struct EntryLayout {
  int terrain, time, num_pots, pots, rows, words;
};

__host__ __device__ inline EntryLayout entry_layout(int HW) {
  EntryLayout e;
  e.terrain = 0;
  e.time = HW;
  e.num_pots = HW + 16;
  e.pots = HW + 17;
  e.rows = 2 * HW + 17;
  e.words = e.rows + 4 * HW * HW;
  return e;
}

// The MLP's widths: width[0] features, then each Linear's outputs, the last
// the actions. The weights are, Linear by Linear, W^T (in x out) row-major
// with its columns padded with zeros to a multiple of 4, then the bias,
// padded the same way (ops/fused_bc.py `pack_weights`).
struct NetDims {
  int layers;
  int width[kMaxHidden + 2];
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int weight_count(const NetDims& d) {
  int n = 0;
  for (int l = 0; l < d.layers; ++l) n += (d.width[l] + 1) * pad4(d.width[l + 1]);
  return n;
}

// The features of an activation buffer: the widest layer's, padded.
__host__ __device__ inline int buffer_span(const NetDims& d) {
  int m = 0;
  for (int l = 0; l <= d.layers; ++l) m = m > pad4(d.width[l]) ? m : pad4(d.width[l]);
  return m;
}

// A block's shared memory: the weights, two activation buffers of 32 rows
// by feature, and the four scans' keys and cells.
__host__ inline size_t shared_bytes(const NetDims& d) {
  return sizeof(float) * (weight_count(d) + 2 * buffer_span(d) * kRows) +
         sizeof(int) * 2 * kScanWarps * 6 * kRows;
}

__device__ __forceinline__ int key_of(int cost, int rank) {
  // cost * 4096 + rank in int32, wrapping as the plain version's int32 ops do
  return static_cast<int>(static_cast<unsigned>(cost) * kRankStride +
                          static_cast<unsigned>(min(rank, kRankStride - 1)));
}

// The six closest-feature queries of one player over the cells c0, c0 +
// kScanWarps, ...: the closest onion, tomato and dish (dispensers, then
// counter objects), soup (counter objects), serving cell and empty counter,
// each as its least key and the first cell holding it.
__device__ __forceinline__ void scan_cells(const int* __restrict__ terrain,
                                           const int* __restrict__ row, int HW, int B, int b,
                                           int c0, const int* __restrict__ obj,
                                           const int* __restrict__ obj_seq, int* best, int* at) {
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    best[q] = kKeyMax;
    at[q] = 0;
  }
#pragma unroll 4
  for (int c = c0; c < HW; c += kScanWarps) {
    const int cost = __ldg(row + c), ter = __ldg(terrain + c);
    const int ob = obj[c * B + b], obj_rank = obj_seq[c * B + b] + 2 * HW;
    if (cost >= kInfCost) continue;
    const bool counter = ter == kCounter;
    const bool disp[3] = {ter == kOnionDisp, ter == kTomatoDisp, ter == kDishDisp};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int key = key_of(cost, disp[q] ? c : obj_rank);
      if ((disp[q] || (counter && ob == q + 1)) && key < best[q]) {
        best[q] = key;
        at[q] = c;
      }
    }
    const int k_obj = key_of(cost, obj_rank), k_cell = key_of(cost, c);
    if (counter && ob == kObjSoup && k_obj < best[3]) {
      best[3] = k_obj;
      at[3] = c;
    }
    if (ter == kServe && k_cell < best[4]) {
      best[4] = k_cell;
      at[4] = c;
    }
    if (counter && ob == kObjNone && k_cell < best[5]) {
      best[5] = k_cell;
      at[5] = c;
    }
  }
}

// The rest of player p of env b's features, from its queries' least keys and
// cells: its 26 + 10K values into column `row` (its own features) and column
// `partner` (from blk on, its partner's view of it) of the features, then
// its partner's position relative to its own and its own.
__device__ __forceinline__ void finish(const int* __restrict__ tab, int K, int H, int W, int B,
                                       int b, int p,
                                       const int* best, const int* at,
                                       const int* __restrict__ pos,
                                       const int* __restrict__ orient,
                                       const int* __restrict__ held_in,
                                       const int* __restrict__ held_soup,
                                       const int* __restrict__ obj,
                                       const int* __restrict__ soup_ing,
                                       const int* __restrict__ soup_tick, float* x, int row,
                                       int partner) {
  const int HW = H * W;
  const int blk = 26 + 10 * K;
  const EntryLayout lay = entry_layout(HW);
  const int* terrain = tab + lay.terrain;
  const int x0 = pos[(2 * p) * B + b], y0 = pos[(2 * p + 1) * B + b];
  const int o = orient[p * B + b], held = held_in[p * B + b];
  const int* costs = tab + lay.rows + ((o * H + y0) * W + x0) * HW;
  auto put = [&](int i, int v) {
    x[i * kRows + row] = static_cast<float>(v);
    x[(blk + i) * kRows + partner] = static_cast<float>(v);
  };

  int dx[6], dy[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const bool found = best[q] < kKeyMax;
    // a held onion, tomato, dish or soup zeroes the delta to its kind
    const bool use = q >= 4 || held != q + 1;
    dx[q] = found && use ? at[q] % W - x0 : 0;
    dy[q] = found && use ? at[q] / W - y0 : 0;
  }

  // the closest soup's ingredient counts: a held soup's, else the soup at
  // the closest soup counter
  int n_o = 0, n_t = 0;
  if (held == kObjSoup || best[3] < kKeyMax) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int v = held == kObjSoup ? held_soup[(p * kSlots + s) * B + b]
                                     : soup_ing[(at[3] * kSlots + s) * B + b];
      n_o += v == kObjOnion;
      n_t += v == kObjTomato;
    }
  }

  put(0, o == 0);
  put(1, o == 1);
  put(2, o == 2);
  put(3, o == 3);
  put(4, held == kObjOnion);
  put(5, held == kObjSoup);
  put(6, held == kObjDish);
  put(7, held == kObjTomato);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    put(8 + 2 * q, dx[q]);
    put(9 + 2 * q, dy[q]);
  }
  put(16, n_o);
  put(17, n_t);
  put(18, dx[4]);
  put(19, dy[4]);
  put(20, dx[5]);
  put(21, dy[5]);

  // the K closest pots (row-major among equal costs), each [found, empty,
  // full, cooking, ready, onions, tomatoes, cook time left, dx, dy]; the
  // finite keys differ from cell to cell, so the next pot is the least key
  // above the last one's
  const int num_pots = __ldg(tab + lay.num_pots);
  int last = -1;
  for (int k = 0; k < K; ++k) {
    int bk = kKeyMax, bc = 0;
    for (int i = 0; i < num_pots; ++i) {
      const int c = __ldg(tab + lay.pots + i), cost = __ldg(costs + c);
      const int key = key_of(cost, c);
      if (cost < kInfCost && key > last && key < bk) {
        bk = key;
        bc = c;
      }
    }
    last = bk;
    int v[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    if (bk < kKeyMax) {
      int c_o = 0, c_t = 0;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int ing = soup_ing[(bc * kSlots + s) * B + b];
        c_o += ing == kObjOnion;
        c_t += ing == kObjTomato;
      }
      const int tick = soup_tick[bc * B + b];
      const int cook = __ldg(tab + lay.time + c_o * 4 + c_t);
      const bool has = obj[bc * B + b] == kObjSoup, idle = tick < 0;
      const bool ready = has && !idle && tick >= cook;
      const bool cooking = has && !idle && !ready;
      const bool full = cooking || ready || (has && idle && c_o + c_t == kSlots);
      v[0] = 1;
      v[1] = !has;
      v[2] = full;
      v[3] = cooking;
      v[4] = ready;
      v[5] = has ? c_o : 0;
      v[6] = has ? c_t : 0;
      v[7] = has && !idle ? max(cook - tick, 0) : 0;
      v[8] = bc % W - x0;
      v[9] = bc / W - y0;
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) put(22 + 10 * k + i, v[i]);
  }

  // wall bits, north, south, east, west (core/constants.py DIR_VECTORS[:4]):
  // the cell's terrain is not empty (off the grid: empty)
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int ax = x0 + (d == 2) - (d == 3), ay = y0 + (d == 1) - (d == 0);
    const bool inside = ax >= 0 && ax < W && ay >= 0 && ay < H;
    put(blk - 4 + d, inside && __ldg(terrain + ay * W + ax) != kEmpty);
  }

  const int q = 1 - p;
  x[(2 * blk) * kRows + row] = static_cast<float>(pos[(2 * q) * B + b] - x0);
  x[(2 * blk + 1) * kRows + row] = static_cast<float>(pos[(2 * q + 1) * B + b] - y0);
  x[(2 * blk + 2) * kRows + row] = static_cast<float>(x0);
  x[(2 * blk + 3) * kRows + row] = static_cast<float>(y0);
}

// One Linear over the block's rows, activations stored by feature ([k][32
// rows]): dst[j][r] = sum_k src[k][r] w[k][j] + bias[j], then ReLU if
// `relu` (NaN kept, as F.relu keeps it). Thread t takes the 4 x 4 tile of
// rows 4 (t / 16) .. + 3 and columns 4 (t % 16) .. + 3: per k, one 16-byte
// load of the inputs and one of the weights feed 16 FMAs. `w` holds W^T
// with its columns padded to n4, a multiple of 4, then the padded bias.
__device__ __forceinline__ void dense(const float* __restrict__ src, float* __restrict__ dst,
                                      const float* __restrict__ w, int in, int n4, bool relu) {
  const int cq = threadIdx.x % 16, rq = threadIdx.x / 16;
  if (4 * cq >= n4) return;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  // k + 1's loads are issued before k's FMAs
  const float* xp = src + 4 * rq;
  const float* wp = w + 4 * cq;
  float4 xv = *reinterpret_cast<const float4*>(xp), wv = *reinterpret_cast<const float4*>(wp);
#pragma unroll 4
  for (int k = 0; k < in; ++k) {
    const int next = k + 1 < in ? k + 1 : k;
    const float4 xn = *reinterpret_cast<const float4*>(xp + next * kRows);
    const float4 wn = *reinterpret_cast<const float4*>(wp + next * n4);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ws[j], acc[i][j]);
    xv = xn;
    wv = wn;
  }
  const float4 bv = *reinterpret_cast<const float4*>(w + in * n4 + 4 * cq);
  const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = acc[i][j] + bs[j];
      v[i] = relu && v[i] < 0.0f ? 0.0f : v[i];
    }
    *reinterpret_cast<float4*>(dst + (4 * cq + j) * kRows + 4 * rq) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    bc_kernel(const int* __restrict__ words, int entry_words, int num_entries,
              const long long* __restrict__ pool_idx, int K, int H, int W, int B,
              const float* __restrict__ weights, NetDims dims, const int* __restrict__ pos,
              const int* __restrict__ orient, const int* __restrict__ held,
              const int* __restrict__ held_soup, const int* __restrict__ obj,
              const int* __restrict__ soup_ing, const int* __restrict__ soup_tick,
              const int* __restrict__ obj_seq, float* __restrict__ logits,
              float* __restrict__ features) {
  extern __shared__ __align__(16) float smem[];
  const int num_weights = weight_count(dims), span = buffer_span(dims);
  float* sw = smem;
  float* buf[2] = {smem + num_weights, smem + num_weights + span * kRows};
  int* part_key = reinterpret_cast<int*>(smem + num_weights + 2 * span * kRows);
  int* part_at = part_key + kScanWarps * 6 * kRows;

  // the weights, copied to shared memory behind the features' work
  for (int i = 4 * threadIdx.x; i < num_weights; i += 4 * kThreads)
    __pipeline_memcpy_async(sw + i, weights + i, 16);
  __pipeline_commit();

  // warp w scans the cells w, w + 4, ... for the block's 32 (env, player)
  // lanes; warp 0 merges the four scans and finishes the features
  const int HW = H * W, lane = threadIdx.x % kRows, warp = threadIdx.x / kRows;
  const int e = lane % kEnvs, p = lane / kEnvs, b0 = blockIdx.x * kEnvs, b = b0 + e;
  const long long entry = b >= B ? -1 : pool_idx ? pool_idx[b] : 0;
  const bool valid = entry >= 0 && entry < num_entries;
  const int* tab = words + (valid ? entry : 0) * static_cast<long long>(entry_words);
  int best[6], at[6];
  if (valid) {
    const EntryLayout lay = entry_layout(HW);
    const int x0 = pos[(2 * p) * B + b], y0 = pos[(2 * p + 1) * B + b];
    const int* row = tab + lay.rows + ((orient[p * B + b] * H + y0) * W + x0) * HW;
    scan_cells(tab + lay.terrain, row, HW, B, b, warp, obj, obj_seq, best, at);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      part_key[(warp * 6 + q) * kRows + lane] = best[q];
      part_at[(warp * 6 + q) * kRows + lane] = at[q];
    }
  }
  __syncthreads();
  const int rows = min(kRows, kPlayers * (B - b0));  // the block's rows that exist
  const int F = dims.width[0];
  const int row = e * kPlayers + p;
  if (warp == 0 && valid) {
    // the least key of the four scans, the lower cell among equal keys
    for (int w = 1; w < kScanWarps; ++w) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const int k = part_key[(w * 6 + q) * kRows + lane];
        const int c = part_at[(w * 6 + q) * kRows + lane];
        if (k < best[q] || (k == best[q] && c < at[q])) {
          best[q] = k;
          at[q] = c;
        }
      }
    }
    finish(tab, K, H, W, B, b, p, best, at, pos, orient, held, held_soup, obj, soup_ing,
           soup_tick, buf[0], row, e * kPlayers + 1 - p);
  } else if (warp == 0 && b < B) {  // a pool index out of range reads NaN
    for (int f = 0; f < F; ++f) buf[0][f * kRows + row] = __int_as_float(0x7fc00000);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (features) {
    for (int i = threadIdx.x; i < rows * F; i += kThreads)
      features[static_cast<long long>(b0) * kPlayers * F + i] = buf[0][(i % F) * kRows + i / F];
  }

  const float* w = sw;
  int cur = 0;
  for (int l = 0; l < dims.layers; ++l) {
    const int in = dims.width[l], n4 = pad4(dims.width[l + 1]);
    dense(buf[cur], buf[1 - cur], w, in, n4, l + 1 < dims.layers);
    w += (in + 1) * n4;
    cur = 1 - cur;
    __syncthreads();
  }
  const int A = dims.width[dims.layers];
  for (int i = threadIdx.x; i < rows * A; i += kThreads)
    logits[static_cast<long long>(b0) * kPlayers * A + i] = buf[cur][(i % A) * kRows + i / A];
}

}  // namespace

// The words of one table entry of a layout of `num_cells` cells
// (ops/fused_bc.py checks its own count against it).
extern "C" int oc_bc_entry_words(int num_cells) { return entry_layout(num_cells).words; }

// The BC partner's logits of every seat: logits (B * 2, A) float32, row
// b * 2 + p for player p of env b, and, unless `features` is null, the
// features (B * 2, F) float32 in the same rows. words: `num_entries` entries
// of `entry_words` int32 in device memory; pool_idx (B,) int64 names each
// lane's entry, or is null for entry 0. weights: the MLP's `num_layers`
// Linears packed as struct NetDims says, widths[0..num_layers] its widths
// (host memory); the features' width widths[0] = 56 + 20 * K sets the K pot
// blocks. The state leaves are the batch-last int32 planes of
// core/state.py. Returns the cudaError_t of the launch (0 = launched); what
// the kernel does not take returns cudaErrorInvalidValue without launching.
extern "C" int oc_fused_bc(const int* words, int entry_words, int num_entries,
                           const long long* pool_idx, int H, int W, int B,
                           const float* weights, int num_layers, const int* widths,
                           const int* pos, const int* orient, const int* held,
                           const int* held_soup, const int* obj, const int* soup_ing,
                           const int* soup_tick, const int* obj_seq, float* logits,
                           float* features, void* stream) {
  const int HW = H * W;
  const int num_pots = (widths[0] - 56) / 20;
  if (widths[0] != 56 + 20 * num_pots || num_pots < 1 || num_pots > kMaxPots || B < 1 ||
      HW < 1 || HW > kMaxHW || entry_words != entry_layout(HW).words || num_layers < 2 ||
      num_layers > kMaxHidden + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  NetDims dims;
  dims.layers = num_layers;
  for (int l = 0; l <= num_layers; ++l) {
    if (l > 0 && (widths[l] < 1 || widths[l] > kMaxWidth))
      return static_cast<int>(cudaErrorInvalidValue);
    dims.width[l] = widths[l];
  }
  const size_t smem = shared_bytes(dims);
  // above 48 KB a block's dynamic shared memory has to be allowed, once per
  // device and size
  static size_t allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > allowed[device]) {
    err = cudaFuncSetAttribute(bc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = smem;
  }
  bc_kernel<<<(B + kEnvs - 1) / kEnvs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      words, entry_words, num_entries, pool_idx, num_pots, H, W, B, weights, dims, pos, orient,
      held, held_soup, obj, soup_ing, soup_tick, obj_seq, logits, features);
  return static_cast<int>(cudaGetLastError());
}
