// Block-local connected-components convergence: every row stripe to its
// local fixed point, in shared memory.
//
// Replaces cellseg_tpu/ops/pallas/local_cc.py:stripe_converge (_kernel,
// _sweep3x3_vmem). Each full-width row stripe of `stripe` rows is an image
// of its own. It repeats one round until a round changes no label of the
// stripe or `cap` rounds have run. One round, plain mode: for connectivity
// 2 a masked 3x3 min sweep (Jacobi: every pixel reads the round's input;
// INF beyond the stripe's four edges; INF off the mask), then the row
// segmented min-scan over the full width, then the column segmented
// min-scan inside the stripe, whose top and bottom rows close the runs.
// Region mode: the row and the column region scans (runs of equal mask
// value), nothing masked. The scans are the exact folds of scans.cu:
// forward  f[i] = open_f[i] ? min(f[i-1], v[i]) : v[i],  then backward
// g[i] = open_b[i] ? min(g[i+1], f[i]) : f[i]  over the forward values,
// which equals min(forward, backward) of the Hillis-Steele recurrence
// (both are the run's min, with the bordering pixels in plain mode).
//
// Bound on the H100: what must move is 9 bytes per pixel per launch
// (labels and mask in, labels out), against 11 to 20 int32 operations per
// pixel and round (connectivity 1 to 2), so the operations bound it once
// the stripes run more than about 8 rounds. Design: the stripe's labels
// (int32) and mask (uint8) live in dynamic shared memory for all its
// rounds, so a launch reads and writes device memory once; the stripe
// height is chosen so that 5 bytes a pixel fit in the 227 KB a block may
// have (16 rows at 2176 columns). One block of 1024 threads per stripe,
// three barriers per round:
//   - column passes (the sweep's vertical 3-min, the in-stripe column
//     scan): one thread walks a column, rolling the pre-pass values in
//     registers, in place;
//   - row passes (the sweep's horizontal 3-min with the mask, the row
//     scan): one warp walks a row in groups of 32 adjacent pixels; a
//     group's scan is a shuffle scan over (value, open) pairs, joined to
//     the previous group by a carry, and the sweep's neighbours come by
//     shuffles with the next group prefetched, so every lane reads and
//     writes only its own pixels and the pass runs in place;
//   - the change vote is __syncthreads_or over a flag that ORs every
//     pass's changes (each pass is non-increasing on masked pixels, and
//     an unmasked pixel changes exactly when it was not INF, so the OR is
//     "the round changed a pixel").
// The 3x3 min is separable (min over the window = min of the row mins of
// the column mins), so the vertical then horizontal pass is the Pallas
// sweep bit for bit. A 2176-wide plane has 136 stripes of 16 rows, one
// block of 174 KB per SM: two waves on 132 SMs. Measured on an H100 at
// 2176^2 (density 0.5, 16 rounds, connectivity 2): about 49 us per round
// and wave, 69x the operations bound. It is latency-bound: at 16 rows only
// 16 of the 32 warps walk rows, each through dependent shuffle scans.
// Optionally the number of rounds each stripe ran is written out.

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Vertical half of the 3x3 sweep: every pixel takes the min of itself and
// its upper and lower neighbours (INF beyond the stripe). The change flag
// counts a masked pixel that moved and an unmasked pixel that was not INF
// (the horizontal pass sets it to INF).
__device__ __forceinline__ bool sweep_columns(int* s_lab, const uint8_t* s_m,
                                              int w, int stripe) {
  bool moved = false;
  for (int x = threadIdx.x; x < w; x += kThreads) {
    int prev = CELLSEG_INF;
    int cur = s_lab[x];
    for (int y = 0; y < stripe; ++y) {
      const int at = y * w + x;
      const int nxt = y + 1 < stripe ? s_lab[at + w] : CELLSEG_INF;
      const int v = min(prev, min(cur, nxt));
      moved |= s_m[at] ? v != cur : cur != CELLSEG_INF;
      s_lab[at] = v;
      prev = cur;
      cur = nxt;
    }
  }
  return moved;
}

// Horizontal half of the 3x3 sweep on one row, by one warp, then the mask.
__device__ __forceinline__ bool sweep_row(int* row, const uint8_t* mrow, int w,
                                          int lane) {
  bool moved = false;
  const int groups = (w + 31) / 32;
  int cur = lane < w ? row[lane] : CELLSEG_INF;
  int left_carry = CELLSEG_INF;
  for (int j = 0; j < groups; ++j) {
    const int x = j * 32 + lane;
    const int nxt = x + 32 < w ? row[x + 32] : CELLSEG_INF;
    int left = __shfl_up_sync(kFull, cur, 1);
    int right = __shfl_down_sync(kFull, cur, 1);
    const int next_first = __shfl_sync(kFull, nxt, 0);
    if (lane == 0) left = left_carry;
    if (lane == 31) right = next_first;
    left_carry = __shfl_sync(kFull, cur, 31);
    if (x < w) {
      const bool mk = mrow[x] != 0;
      const int v = mk ? min(cur, min(left, right)) : CELLSEG_INF;
      moved |= mk && v != cur;
      row[x] = v;
    }
    cur = nxt;
  }
  return moved;
}

// Segmented min-scan of one row, by one warp, in place: the forward fold,
// then the backward fold over the forward values (masked in plain mode).
template <bool REGION>
__device__ __forceinline__ bool scan_row(int* row, const uint8_t* mrow, int w,
                                         int lane) {
  bool moved = false;
  const int groups = (w + 31) / 32;
  int carry = CELLSEG_INF;
  for (int j = 0; j < groups; ++j) {
    const int x = j * 32 + lane;
    const bool in = x < w;
    const int v0 = in ? row[x] : CELLSEG_INF;
    int o = 1;
    if (in) {
      o = REGION ? (x > 0 && mrow[x] == mrow[x - 1]) : mrow[x] != 0;
    }
    int v = v0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int pv = __shfl_up_sync(kFull, v, d);
      const int po = __shfl_up_sync(kFull, o, d);
      if (lane >= d) {
        v = o ? min(pv, v) : v;
        o &= po;
      }
    }
    v = o ? min(carry, v) : v;
    carry = __shfl_sync(kFull, v, 31);
    if (in) {
      moved |= v != v0;
      row[x] = v;
    }
  }
  carry = CELLSEG_INF;
  for (int j = groups - 1; j >= 0; --j) {
    const int x = j * 32 + lane;
    const bool in = x < w;
    const int f = in ? row[x] : CELLSEG_INF;
    int o = 1;
    if (in) {
      o = REGION ? (x + 1 < w && mrow[x] == mrow[x + 1]) : mrow[x] != 0;
    }
    int v = f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int nv = __shfl_down_sync(kFull, v, d);
      const int no = __shfl_down_sync(kFull, o, d);
      if (lane + d < 32) {
        v = o ? min(nv, v) : v;
        o &= no;
      }
    }
    v = o ? min(carry, v) : v;
    carry = __shfl_sync(kFull, v, 0);
    if (in) {
      const int out = REGION || mrow[x] ? v : CELLSEG_INF;
      moved |= out != f;
      row[x] = out;
    }
  }
  return moved;
}

// Segmented min-scan of every column inside the stripe, in place: one
// thread folds a column forward, then backward.
template <bool REGION>
__device__ __forceinline__ bool scan_columns(int* s_lab, const uint8_t* s_m,
                                             int w, int stripe) {
  bool moved = false;
  for (int x = threadIdx.x; x < w; x += kThreads) {
    int acc = CELLSEG_INF;
    for (int y = 0; y < stripe; ++y) {
      const int at = y * w + x;
      const int v = s_lab[at];
      const bool o = REGION ? (y > 0 && s_m[at] == s_m[at - w]) : s_m[at] != 0;
      acc = o ? min(acc, v) : v;
      moved |= acc != v;
      s_lab[at] = acc;
    }
    acc = CELLSEG_INF;
    for (int y = stripe - 1; y >= 0; --y) {
      const int at = y * w + x;
      const int f = s_lab[at];
      const bool o =
          REGION ? (y + 1 < stripe && s_m[at] == s_m[at + w]) : s_m[at] != 0;
      acc = o ? min(acc, f) : f;
      const int out = REGION || s_m[at] ? acc : CELLSEG_INF;
      moved |= out != f;
      s_lab[at] = out;
    }
  }
  return moved;
}

template <bool REGION, bool SWEEP>
__global__ void __launch_bounds__(kThreads, 1)
stripe_converge_kernel(const int* __restrict__ lab,
                       const uint8_t* __restrict__ mask, int* __restrict__ out,
                       int* __restrict__ rounds, int w, int stripe, int cap) {
  extern __shared__ int smem[];
  const int n = stripe * w;
  int* s_lab = smem;
  uint8_t* s_m = reinterpret_cast<uint8_t*>(smem + n);
  const long long base = static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s_lab[i] = lab[base + i];
    s_m[i] = mask[base + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int it = 0;
  bool changed = true;
  while (changed && it < cap) {
    bool moved = false;
    if (SWEEP) {
      moved |= sweep_columns(s_lab, s_m, w, stripe);
      __syncthreads();
    }
    for (int y = warp; y < stripe; y += kWarps) {
      if (SWEEP) moved |= sweep_row(s_lab + y * w, s_m + y * w, w, lane);
      moved |= scan_row<REGION>(s_lab + y * w, s_m + y * w, w, lane);
    }
    __syncthreads();
    moved |= scan_columns<REGION>(s_lab, s_m, w, stripe);
    changed = __syncthreads_or(moved) != 0;
    ++it;
  }

  for (int i = threadIdx.x; i < n; i += kThreads) {
    out[base + i] = s_lab[i];
  }
  if (rounds != nullptr && threadIdx.x == 0) {
    rounds[blockIdx.x] = it;
  }
}

template <bool REGION, bool SWEEP>
int launch(const void* lab, const void* mask, void* out, void* rounds, int h,
           int w, int stripe, int cap, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = 5LL * stripe * w;
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory attribute holds for the kernel on its device until
  // the process ends: set it to the device's limit once per device
  static std::atomic<unsigned long long> attribute_set{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0;
  if (bit == 0 || (attribute_set.load() & bit) == 0) {
    err = cudaFuncSetAttribute(stripe_converge_kernel<REGION, SWEEP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set.fetch_or(bit);
  }
  stripe_converge_kernel<REGION, SWEEP>
      <<<h / stripe, kThreads, static_cast<size_t>(bytes), stream>>>(
          static_cast<const int*>(lab), static_cast<const uint8_t*>(mask),
          static_cast<int*>(out), static_cast<int*>(rounds), w, stripe, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lab: int32 (h, w); mask: uint8 (h, w) (0/1 in plain mode, any values in
// region mode); out: int32 (h, w), distinct from lab. All row-major and
// contiguous, on the device. stripe divides h and 5 * stripe * w bytes fit
// in a block's shared memory; connectivity 1 or 2 (plain mode only);
// cap >= 0. rounds: int32 (h / stripe) or null.
extern "C" int cellseg_stripe_converge(const void* lab, const void* mask,
                                       void* out, void* rounds, int h, int w,
                                       int stripe, int connectivity,
                                       int region, int cap, void* stream) {
  if (stripe < 1 || h % stripe != 0 || w < 1 || cap < 0 ||
      (connectivity != 1 && connectivity != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (region) {
    return launch<true, false>(lab, mask, out, rounds, h, w, stripe, cap, s);
  }
  if (connectivity == 2) {
    return launch<false, true>(lab, mask, out, rounds, h, w, stripe, cap, s);
  }
  return launch<false, false>(lab, mask, out, rounds, h, w, stripe, cap, s);
}
