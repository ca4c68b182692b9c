// The weight and bias gradient of a stride-1 convolution in float32: for a
// batch X (N, C, H, W) and the gradient dY (N, O, Ho, Wo) of its output,
//
//   dW[o, c, kh, kw] = sum over n, y, x of dY[n, o, y, x] * X[n, c, y + kh - p, x + kw - p]
//                      (in-bounds taps only)
//   db[o]            = sum over n, y, x of dY[n, o, y, x]
//
// (ops/conv_wgrad.py; its plain version `weight_grad_plain`). The learner's
// backward of the torso's convolutions calls it, the data gradient staying
// with cuDNN.
//
// Replaces no TPU kernel: in the JAX package the conv gradient is XLA's
// (jax.grad through flax's nn.Conv in overcooked_ai_tpu/training/networks.py).
// It was added because cuDNN's float32 weight gradient
// (wgrad_alg1_engine_NHWC) ran the learner's three convolutions at about 15%
// of the card's float32 rate, 1.21 s of each 3.6 s self-play iteration.
//
// Bound on the H100: float32 FMAs on the CUDA cores (67 TFLOP/s; the
// configuration is float32 with TF32 off, so no tensor core may take it).
// The PPO torso on cramped room (4 x 5 cells, 26 channels in, 25 filters, a
// 5x5 SAME, a 3x3 SAME and a 3x3 VALID conv) needs 942,500 FLOPs a sample
// counting the padded taps, 575,800 without them: 65,536 samples a
// minibatch are 61.8 GFLOP padded (0.92 ms) and 37.7 GFLOP in-bounds (0.56
// ms, the kernel's bound, since it issues no FMA of a padded tap). Reading X
// and dY once is 0.54 GB, 0.16 ms at 3.35 TB/s: the kernel is
// compute-bound.
//
// What the design does about that. The reduction runs over N * Ho * Wo
// (65,536 * 20) into only O * C * K * K outputs, so the sample axis is split
// across blocks, one block an SM (blocks_x), and the outputs of every tap
// live in registers: a warp owns one tap and a group of 32 o by 28 c, each
// lane a register tile of 4 o by 7 c (the 28 c include a column of ones,
// channel C, whose tap (p, p) sums dY into db). A block stages its samples
// a stage at a time in shared memory, double-buffered by cp.async, each
// (cell, sample) a row of 32 floats: per sample and in-bounds (output cell,
// input cell) pair of its tap, a lane reads one 16-byte dY vector and two X
// vectors and issues 28 FMAs. A tap's loops run over its in-bounds output
// cells only, so no FMA of a padded tap is issued. Taps with few warps (the
// 3x3 convs: 9) put several groups of warps in a block: each group sums
// every sample of the stage over every groups-th pair of its tap (on a
// 16x8 grid a stage holds only 3 samples, and a group of its own samples
// would have a loop one sample long), and the groups' sums are added in
// shared memory in group order before the block writes its partial. A second
// launch sums the blocks' partials in block order. The order of every sum
// is fixed, so the result is the same from run to run. X and dY are read
// through their strides: any memory format, no copy.
//
// Measured (H100 SXM, 700 W): 1.02, 0.59 and 0.29 ms for the three convs
// at 65,536 rows, 1.90 ms a minibatch against cuDNN's 6.11; on a 16x8 grid
// 11.2, 5.1 and 3.8 ms against cuDNN's 15.8, 12.4 and 8.4. Shared memory
// holds the inner loop: it serves a 16-byte load a quarter-warp a cycle, so
// a warp's step takes 12 of the SM's shared-memory cycles for its three
// loads and 7 of its four schedulers' cycles for its 28 FMAs, which caps
// the FMAs at 7/12 = 58% of the rate. Larger tiles (8 or 7 o by 7 c over a
// tap and its mirror, 49-56 registers of sums) cut the loads but left too
// few warps to hide their latency, and ran no faster; so did 16-byte staging
// copies.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanesO = 8;                    // o-lanes of a warp (lane & 7)
constexpr int kTileO = 4;                     // o's a lane holds
constexpr int kTileC = 7;                     // c's a lane holds
constexpr int kSlotC = 8;                     // floats of a lane's c's in a row: two 16-byte loads
constexpr int kGroupO = kLanesO * kTileO;     // 32: a warp's o's
constexpr int kGroupC = 4 * kTileC;           // 28: a warp's c's (lane >> 3 picks 7 of them)
constexpr int kRow = 32;                      // floats of a (group, cell, sample) row
constexpr int kAcc = kTileO * kTileC;         // a lane's accumulators
constexpr int kUnitFloats = kAcc * 32;        // a warp's partial
constexpr int kMaxWarps = 27;                 // warps a block
constexpr int kMaxChannels = 64;              // channels in and out at most
constexpr int kMaxDevices = 64;
constexpr int kReduceChunks = 8;              // threads summing one output's partials

struct Params {
  const float* x;
  const float* dy;
  long long xs_n, xs_c, xs_h, xs_w;  // X's strides, in floats
  long long ds_n, ds_o, ds_h, ds_w;  // dY's
  int N, C, H, W, O, Ho, Wo, K, pad;
  int og, cg;        // o-groups of 32 and c-groups of 28 (the ones column included)
  int units;         // K * K * og * cg: one warp each
  int unit_warps;    // units a block takes (blockIdx.y picks which)
  int groups;        // pair groups a block: its warps are groups * unit_warps
  int stage;         // samples a stage holds for each group: groups * stage in all
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// floats of one stage buffer: X's rows [cg][H * W][S], then dY's [og][Ho * Wo][S]
__host__ __device__ inline int stage_floats(const Params& p) {
  return (p.cg * p.H * p.W + p.og * p.Ho * p.Wo) * p.groups * p.stage * kRow;
}

// the cells' offsets in X and dY (8 bytes each), then two stage buffers, or
// the groups' partials when more (ops/conv_wgrad.py `smem_bytes`)
__host__ inline int smem_bytes(const Params& p) {
  const int buffers = 2 * stage_floats(p) * 4;
  const int partials = (p.groups - 1) * p.unit_warps * kUnitFloats * 4;
  return align16((p.H * p.W + p.Ho * p.Wo) * 8) + (buffers > partials ? buffers : partials);
}

// where channel c of a cell and sample lands in X's rows: its c-group's
// plane, then the slot of its lane (c % 28 / 7) and tile place (c % 28 % 7)
__device__ __forceinline__ int x_column(int c, int plane) {
  const int r = c % kGroupC;
  return (c / kGroupC) * plane + (r / kTileC) * kSlotC + r % kTileC;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1) wgrad_kernel(Params p, float* partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = p.H * p.W, HWo = p.Ho * p.Wo;
  const int S = p.groups * p.stage;  // samples a stage
  long long* xoff = reinterpret_cast<long long*>(smem);
  long long* doff = xoff + HW;
  float* buf = reinterpret_cast<float*>(smem + align16((HW + HWo) * 8));
  const int sf = stage_floats(p);
  const int x_plane = HW * S * kRow;  // a c-group's floats in a stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;

  // the block's samples: an even share of N
  const long long n0 = static_cast<long long>(p.N) * blockIdx.x / gridDim.x;
  const long long n1 = static_cast<long long>(p.N) * (blockIdx.x + 1) / gridDim.x;
  const int stages = static_cast<int>((n1 - n0 + S - 1) / S);

  for (int i = tid; i < 2 * sf; i += nthreads) buf[i] = 0.f;  // padded channels and slots
  for (int i = tid; i < HW; i += nthreads)
    xoff[i] = (i / p.W) * p.xs_h + (i % p.W) * p.xs_w;
  for (int i = tid; i < HWo; i += nthreads)
    doff[i] = (i / p.Wo) * p.ds_h + (i % p.Wo) * p.ds_w;
  __syncthreads();
  {  // the ones column, channel C, in every row of its c-group in both buffers
    float* ones = buf + x_column(p.C, x_plane);
    for (int i = tid; i < HW * S; i += nthreads) ones[i * kRow] = ones[sf + i * kRow] = 1.f;
  }

  // a lane copies channel `lane` (and lane + 32) of one X row, or filter
  // `lane` (and lane + 32) of one dY row; a warp takes every nwarps-th row
  const int xcol0 = lane < p.C ? x_column(lane, x_plane) : -1;
  const int xcol1 = lane + 32 < p.C ? x_column(lane + 32, x_plane) : -1;
  const int dplane = HWo * S * kRow;
  const int dcol0 = lane < p.O ? lane : -1;
  const int dcol1 = lane + 32 < p.O ? dplane + lane : -1;
  const long long xc0 = lane * p.xs_c, xc1 = (lane + 32) * p.xs_c;
  const long long dc0 = lane * p.ds_o, dc1 = (lane + 32) * p.ds_o;
  const int rows = HW + HWo;  // a sample's rows: its X cells, then its dY cells

  auto stage_in = [&](int st) {
    float* b = buf + (st & 1) * sf;
    const long long first = n0 + static_cast<long long>(st) * S;
    const int count = static_cast<int>(n1 - first < S ? n1 - first : S);
    int s = 0, q = warp;
    while (q >= rows) q -= rows, ++s;
    for (; s < count;) {
      if (q < HW) {
        const float* src = p.x + (first + s) * p.xs_n + xoff[q];
        float* dst = b + (q * S + s) * kRow;
        if (xcol0 >= 0) __pipeline_memcpy_async(dst + xcol0, src + xc0, 4);
        if (xcol1 >= 0) __pipeline_memcpy_async(dst + xcol1, src + xc1, 4);
      } else {
        const int c = q - HW;
        const float* src = p.dy + (first + s) * p.ds_n + doff[c];
        float* dst = b + p.cg * x_plane + (c * S + s) * kRow;
        if (dcol0 >= 0) __pipeline_memcpy_async(dst + dcol0, src + dc0, 4);
        if (dcol1 >= 0) __pipeline_memcpy_async(dst + dcol1, src + dc1, 4);
      }
      q += nwarps;
      while (q >= rows) q -= rows, ++s;
    }
    __pipeline_commit();
  };

  // this warp's unit: a tap, an o-group and a c-group; and its pair group
  const int wu = warp % p.unit_warps, group = warp / p.unit_warps;
  const int u = blockIdx.y * p.unit_warps + wu;
  const bool active = u < p.units;
  const int tap = u / (p.og * p.cg), og = (u / p.cg) % p.og, cg = u % p.cg;
  const int dh = tap / p.K - p.pad, dw = tap % p.K - p.pad;
  // the output cells whose input cell under this tap is in bounds
  const int y0 = max(0, -dh), y1 = min(p.Ho, p.H - dh);
  const int x0 = max(0, -dw), x1 = min(p.Wo, p.W - dw);
  const int ol = lane & 7, cl = lane >> 3;

  float acc[kTileO][kTileC];
#pragma unroll
  for (int i = 0; i < kTileO; ++i)
#pragma unroll
    for (int j = 0; j < kTileC; ++j) acc[i][j] = 0.f;

  __syncthreads();  // the zeros and the ones before any copy lands
  if (stages > 0) stage_in(0);
  for (int st = 0; st < stages; ++st) {
    __pipeline_wait_prior(0);
    // every copy of this stage landed, and every warp is done with the last
    // stage's buffer, which the next stage's copies now fill behind the sums
    __syncthreads();
    if (st + 1 < stages) stage_in(st + 1);
    const long long first = n0 + static_cast<long long>(st) * S;
    const int count = static_cast<int>(n1 - first < S ? n1 - first : S);
    // the group sums the stage's samples over every groups-th in-bounds
    // (output cell, input cell) pair of the tap, from its own
    if (active && y0 < y1 && x0 < x1) {
      const float* b = buf + (st & 1) * sf;
      const float* xb = b + cg * x_plane + cl * kSlotC;
      const float* db = b + p.cg * x_plane + og * dplane + ol * kTileO;
      const int nx = x1 - x0;
      int y = y0, xo = x0 + group;
      while (xo >= x1) xo -= nx, ++y;
      while (y < y1) {
        const float* a_p = db + ((y * p.Wo + xo) * S) * kRow;
        const float* b_p = xb + (((y + dh) * p.W + xo + dw) * S) * kRow;
#pragma unroll 4
        for (int s = 0; s < count; ++s) {
          const float4 a = *reinterpret_cast<const float4*>(a_p + s * kRow);
          const float4 b0 = *reinterpret_cast<const float4*>(b_p + s * kRow);
          const float4 b1 = *reinterpret_cast<const float4*>(b_p + s * kRow + 4);
          const float av[kTileO] = {a.x, a.y, a.z, a.w};
          const float bv[kTileC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z};
#pragma unroll
          for (int i = 0; i < kTileO; ++i)
#pragma unroll
            for (int j = 0; j < kTileC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        xo += p.groups;
        while (xo >= x1) xo -= nx, ++y;
      }
    }
  }
  __syncthreads();  // the buffers are free for the groups' sums

  // the groups' sums in group order, then the block's partial
  float* red = reinterpret_cast<float*>(buf);
  if (p.groups > 1) {
    if (group > 0 && active) {
      float* r = red + ((group - 1) * p.unit_warps + wu) * kUnitFloats + lane;
#pragma unroll
      for (int i = 0; i < kTileO; ++i)
#pragma unroll
        for (int j = 0; j < kTileC; ++j) r[(i * kTileC + j) * 32] = acc[i][j];
    }
    __syncthreads();
    if (group == 0 && active) {
      for (int g = 1; g < p.groups; ++g) {
        const float* r = red + ((g - 1) * p.unit_warps + wu) * kUnitFloats + lane;
#pragma unroll
        for (int i = 0; i < kTileO; ++i)
#pragma unroll
          for (int j = 0; j < kTileC; ++j) acc[i][j] += r[(i * kTileC + j) * 32];
      }
    }
  }
  if (group == 0 && active) {
    float* out = partial + (static_cast<long long>(blockIdx.x) * p.units + u) * kUnitFloats + lane;
#pragma unroll
    for (int i = 0; i < kTileO; ++i)
#pragma unroll
      for (int j = 0; j < kTileC; ++j) out[(i * kTileC + j) * 32] = acc[i][j];
  }
}

// One output of dW or db a column of threads: kReduceChunks threads sum
// consecutive runs of the blocks' partials, then the first adds the runs in
// order. A partial's float e is unit e / 896, accumulator e % 896 / 32 (o
// e % 896 / 32 / 7 and c e % 896 / 32 % 7 of the lane's tile), lane e % 32.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, int replicas, Params p,
                              float* __restrict__ grad_w, float* __restrict__ grad_b) {
  __shared__ float runs[kReduceChunks][32];
  const int col = threadIdx.x & 31, chunk = threadIdx.x >> 5;
  const int total = p.units * kUnitFloats;
  const int e = blockIdx.x * 32 + col;
  float sum = 0.f;
  if (e < total) {
    const int r1 = replicas * (chunk + 1) / kReduceChunks;
    for (int r = replicas * chunk / kReduceChunks; r < r1; ++r)
      sum += partial[static_cast<long long>(r) * total + e];
  }
  runs[chunk][col] = sum;
  __syncthreads();
  if (chunk != 0 || e >= total) return;
  sum = runs[0][col];
  for (int k = 1; k < kReduceChunks; ++k) sum += runs[k][col];
  const int u = e / kUnitFloats, acc = e % kUnitFloats / 32, lane = e % 32;
  const int tap = u / (p.og * p.cg), og = (u / p.cg) % p.og, cg = u % p.cg;
  const int o = og * kGroupO + (lane & 7) * kTileO + acc / kTileC;
  const int c = cg * kGroupC + (lane >> 3) * kTileC + acc % kTileC;
  if (o >= p.O) return;
  if (c < p.C)
    grad_w[(o * p.C + c) * p.K * p.K + tap] = sum;
  else if (c == p.C && tap == p.pad * p.K + p.pad)  // every output cell in bounds under it
    grad_b[o] = sum;
}

}  // namespace

// dW (O, C, K, K) and db (O,) of a stride-1 convolution of padding `pad`
// from X (N, C, H, W) and dY (N, O, Ho, Wo), float32, each read through its
// strides (in floats); grad_w contiguous. partial: blocks_x * units * 896
// floats of scratch, units = K * K * ceil(O / 32) * ceil((C + 1) / 28).
// The plan (ops/conv_wgrad.py `plan`): blocks_x blocks over the samples,
// blocks_y over the units, unit_warps units a block, `groups` pair groups
// a block, groups * stage samples a stage. Two launches on `stream`.
// Returns the cudaError_t of the launches (0 = launched); a shape or plan
// the kernel does not take returns cudaErrorInvalidValue without launching.
extern "C" int oc_conv_wgrad(const float* x, const float* dy, float* partial, float* grad_w,
                             float* grad_b, int N, int C, int H, int W, int O, int K, int pad,
                             long long xs_n, long long xs_c, long long xs_h, long long xs_w,
                             long long ds_n, long long ds_o, long long ds_h, long long ds_w,
                             int blocks_x, int blocks_y, int unit_warps, int groups, int stage,
                             void* stream) {
  Params p;
  p.x = x;
  p.dy = dy;
  p.xs_n = xs_n, p.xs_c = xs_c, p.xs_h = xs_h, p.xs_w = xs_w;
  p.ds_n = ds_n, p.ds_o = ds_o, p.ds_h = ds_h, p.ds_w = ds_w;
  p.N = N, p.C = C, p.H = H, p.W = W, p.O = O, p.K = K, p.pad = pad;
  p.Ho = H + 2 * pad - K + 1;
  p.Wo = W + 2 * pad - K + 1;
  p.og = (O + kGroupO - 1) / kGroupO;
  p.cg = (C + 1 + kGroupC - 1) / kGroupC;
  p.units = K * K * p.og * p.cg;
  p.unit_warps = unit_warps, p.groups = groups, p.stage = stage;
  if (N < 1 || C < 1 || C > kMaxChannels || O < 1 || O > kMaxChannels || K < 1 || pad < 0 ||
      2 * pad > K - 1 || p.Ho < 1 || p.Wo < 1 || blocks_x < 1 || blocks_y < 1 ||
      unit_warps < 1 || groups < 1 || stage < 1 || unit_warps * groups > kMaxWarps ||
      (blocks_y - 1) * unit_warps >= p.units || blocks_y * unit_warps < p.units)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(p);
  // above 48 KB a block's dynamic shared memory has to be allowed, once per
  // device and size, up to what the device lets a block opt in to
  static int allowed[kMaxDevices] = {};
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > allowed[device]) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_kernel<<<dim3(blocks_x, blocks_y), unit_warps * groups * 32, smem, s>>>(p, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = p.units * kUnitFloats;
  wgrad_reduce_kernel<<<(outputs + 31) / 32, 32 * kReduceChunks, 0, s>>>(partial, blocks_x, p,
                                                                         grad_w, grad_b);
  return static_cast<int>(cudaGetLastError());
}

// The layout constants ops/conv_wgrad.py plans with, in its CONSTANTS order
// (ops/_build.load checks them): warps a block, floats of a warp's partial,
// a warp's filters and channels, floats of a row, channels in and out at
// most.
extern "C" void oc_conv_wgrad_constants(int* out) {
  const int constants[] = {kMaxWarps, kUnitFloats, kGroupO, kGroupC, kRow, kMaxChannels};
  for (int i = 0; i < 6; ++i) out[i] = constants[i];
}
