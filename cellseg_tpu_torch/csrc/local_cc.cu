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
// the stripes run more than about 8 rounds. A stripe is a chain of
// dependent rounds, so what decides the time is the latency of one round
// and how many waves of stripes the card runs.
// Design: the stripe's labels (int32) and mask (uint8) live in dynamic
// shared memory for all its rounds, behind 512 bytes of warp totals, so a
// launch reads and writes device memory once. The stripe height
// (ops/kernels/local_cc.py:cc_stripe) is the largest divisor of H that
// fits: 17 rows at 2176 columns, 185 KB, 128 stripes, so one block per
// SM runs them all in one wave on 132 SMs. One block of 1024 threads per
// stripe; every thread works on every pass:
//   - column passes (the sweep's vertical 3-min, the in-stripe column
//     scan): one thread walks a column, rolling the pre-pass values in
//     registers, in place; the walks are unrolled so that their loads are
//     issued ahead of the min chain. At 2176 columns a thread takes 2 or
//     3 columns, and the last of the three passes is 12.5% full;
//   - row passes (the sweep's horizontal 3-min with the mask, the row
//     scan), a raking scan: all rows at once, 1024 / stripe threads on
//     each (60 at 17 rows; a warp may hold the end of one row and the
//     start of the next), each thread on a run of adjacent pixels (37,
//     odd, so that a warp's strided reads fall in distinct banks). A
//     thread folds its run serially into a (value, open) aggregate; a
//     shuffle scan joins a warp's aggregates, the row's first thread
//     starting afresh; after one barrier each thread folds the totals of
//     the row's earlier warps into its carry and walks its run again,
//     applying it. The forward fold's walk also forms the backward
//     aggregate, so a row scan is three walks and two barriers; the
//     sweep's horizontal pass reads each run's two outer neighbours
//     before a barrier and then runs in place;
//   - the change vote is __syncthreads_or over a flag that ORs every
//     pass's changes (each pass is non-increasing on masked pixels, and
//     an unmasked pixel changes exactly when it was not INF, so the OR is
//     "the round changed a pixel").
// The 3x3 min is separable (min over the window = min of the row mins of
// the column mins), so the vertical then horizontal pass is the Pallas
// sweep bit for bit. Optionally the number of rounds each stripe ran is
// written out.
// Measured (chip_smoke.py, three runs, NVIDIA H100 80GB HBM3, 700.00 W)
// at 2176^2, mask density 0.5, cap 16: connectivity 2 0.42-0.44 ms (16
// rounds, about 27 us per round, 19x the operations bound), connectivity
// 1 0.31-0.35 ms, region 0.42-0.44 ms; at 16 rows (136 stripes, two
// waves) connectivity 2 takes 0.75 ms. Per round a thread walks about
// 240 pixels one after another; what limits that walk (issue or latency)
// is not measured.

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
// shared memory ahead of the labels: the row scans' warp totals
constexpr int kScratchInts = 128;

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
#pragma unroll 4
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

// A segment of a segmented min-scan: the fold's value and whether the
// segment is open at its start (joins what comes before it in the scan's
// direction). join(a, b): a, then b.
struct Seg {
  int v;
  int o;
};

__device__ __forceinline__ Seg join(Seg a, Seg b) {
  return {b.o ? min(a.v, b.v) : b.v, a.o & b.o};
}

// How a row pass maps the block's threads onto the stripe's rows: `groups`
// rows at a time, `per_row` threads on each, every thread on a run of `run`
// adjacent pixels (odd, so that the strided shared-memory reads of a warp
// fall in distinct banks; the last runs of a row may be short or empty).
struct RowMap {
  int groups;
  int per_row;
  int run;
};

__device__ __forceinline__ RowMap row_map(int w, int stripe) {
  RowMap m;
  m.groups = min(stripe, kThreads);
  m.per_row = kThreads / m.groups;
  m.run = ((w + m.per_row - 1) / m.per_row) | 1;
  return m;
}

// The carry into each thread's run of a row: the segmented scan, left to
// right, of the runs' aggregates over the threads of the row (the first
// thread starts from INF). A shuffle scan in each warp, then every thread
// folds the totals of the row's earlier warps (tot: 32 values, then 32
// openness flags). One barrier.
__device__ __forceinline__ int carry_forward(Seg agg, int t, int first_warp,
                                             int* tot) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (t == 0) agg.o = 0;
  Seg inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int pv = __shfl_up_sync(kFull, inc.v, d);
    const int po = __shfl_up_sync(kFull, inc.o, d);
    if (lane >= d) inc = join({pv, po}, inc);
  }
  Seg ex = {__shfl_up_sync(kFull, inc.v, 1), __shfl_up_sync(kFull, inc.o, 1)};
  if (lane == 0) ex = {CELLSEG_INF, 1};
  if (lane == 31) {
    tot[warp] = inc.v;
    tot[32 + warp] = inc.o;
  }
  __syncthreads();
  Seg c = {CELLSEG_INF, 1};
  for (int wv = first_warp; wv < warp; ++wv) {
    c = join(c, {tot[wv], tot[32 + wv]});
  }
  c = join(c, ex);
  return t == 0 ? CELLSEG_INF : c.v;
}

// The same from right to left: the carry into each run from the runs to
// its right (the row's last thread starts from INF).
__device__ __forceinline__ int carry_backward(Seg agg, int t, int per_row,
                                              int last_warp, int* tot) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (t == per_row - 1) agg.o = 0;
  Seg inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int nv = __shfl_down_sync(kFull, inc.v, d);
    const int no = __shfl_down_sync(kFull, inc.o, d);
    if (lane + d < 32) inc = join({nv, no}, inc);
  }
  Seg ex = {__shfl_down_sync(kFull, inc.v, 1),
            __shfl_down_sync(kFull, inc.o, 1)};
  if (lane == 31) ex = {CELLSEG_INF, 1};
  if (lane == 0) {
    tot[warp] = inc.v;
    tot[32 + warp] = inc.o;
  }
  __syncthreads();
  Seg c = {CELLSEG_INF, 1};
  for (int wv = last_warp; wv > warp; --wv) {
    c = join(c, {tot[wv], tot[32 + wv]});
  }
  c = join(c, ex);
  return t == per_row - 1 ? CELLSEG_INF : c.v;
}

// Whether pixel x of a row joins its left (forward) or right (backward)
// neighbour in the scan: in plain mode the mask, in region mode an equal
// mask value next to it.
template <bool REGION>
__device__ __forceinline__ int open_fwd(const uint8_t* mrow, int x) {
  return REGION ? (x > 0 && mrow[x] == mrow[x - 1]) : mrow[x] != 0;
}

template <bool REGION>
__device__ __forceinline__ int open_bwd(const uint8_t* mrow, int x, int w) {
  return REGION ? (x + 1 < w && mrow[x] == mrow[x + 1]) : mrow[x] != 0;
}

// Every row pass of a round, by all the block's threads (a raking scan):
// for connectivity 2 the horizontal half of the 3x3 sweep with the mask,
// then the row segmented min-scan: the forward fold, then the backward
// fold over the forward values (masked in plain mode). Each thread walks
// its run serially three times: (sweep and) the run's forward aggregate;
// the forward fold from its carry, with the backward aggregate of the
// folded values; the backward fold from its carry. tot: 128 ints of
// shared memory (forward, then backward warp totals).
template <bool REGION, bool SWEEP>
__device__ __forceinline__ bool row_passes(int* s_lab, const uint8_t* s_m,
                                           int w, int stripe, RowMap rm,
                                           int* tot) {
  bool moved = false;
  const int g = threadIdx.x / rm.per_row;
  const int t = threadIdx.x - g * rm.per_row;
  const int xs = min(t * rm.run, w);
  const int xe = min(xs + rm.run, w);
  const int first_warp = min(g * rm.per_row, kThreads - 1) / 32;
  const int last_warp =
      min(g * rm.per_row + rm.per_row - 1, kThreads - 1) / 32;
  for (int y0 = 0; y0 < stripe; y0 += rm.groups) {
    const bool active = g < rm.groups && y0 + g < stripe;
    const int a = active ? xs : 0;  // this thread's run [a, b)
    const int b = active ? xe : 0;
    int* row = s_lab + (active ? y0 + g : 0) * w;
    const uint8_t* mrow = s_m + (active ? y0 + g : 0) * w;

    Seg agg = {CELLSEG_INF, 1};
    if (SWEEP) {
      // the run's outer neighbours, read before any thread writes its run
      int prev = CELLSEG_INF;
      int right = CELLSEG_INF;
      if (a < b) {
        if (a > 0) prev = row[a - 1];
        if (b < w) right = row[b];
      }
      __syncthreads();
      int cur = a < b ? row[a] : CELLSEG_INF;
#pragma unroll 4
      for (int x = a; x < b; ++x) {
        const int nxt = x + 1 < b ? row[x + 1] : right;
        const bool mk = mrow[x] != 0;
        const int v = mk ? min(cur, min(prev, nxt)) : CELLSEG_INF;
        moved |= mk && v != cur;
        row[x] = v;
        prev = cur;
        cur = nxt;
        agg = join(agg, {v, mk});
      }
    } else {
#pragma unroll 4
      for (int x = a; x < b; ++x) {
        agg = join(agg, {row[x], open_fwd<REGION>(mrow, x)});
      }
    }

    int acc = carry_forward(agg, t, first_warp, tot);
    Seg bagg = {CELLSEG_INF, 1};
#pragma unroll 4
    for (int x = a; x < b; ++x) {
      const int v = row[x];
      acc = open_fwd<REGION>(mrow, x) ? min(acc, v) : v;
      moved |= acc != v;
      row[x] = acc;
      // the backward aggregate: the min up to the first pixel closed to
      // its right, and whether there is none
      if (bagg.o) {
        bagg.v = min(bagg.v, acc);
        bagg.o = open_bwd<REGION>(mrow, x, w);
      }
    }

    acc = carry_backward(bagg, t, rm.per_row, last_warp, tot + 64);
#pragma unroll 4
    for (int x = b - 1; x >= a; --x) {
      const int f = row[x];
      acc = open_bwd<REGION>(mrow, x, w) ? min(acc, f) : f;
      const int out = REGION || mrow[x] ? acc : CELLSEG_INF;
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
#pragma unroll 4
    for (int y = 0; y < stripe; ++y) {
      const int at = y * w + x;
      const int v = s_lab[at];
      const bool o = REGION ? (y > 0 && s_m[at] == s_m[at - w]) : s_m[at] != 0;
      acc = o ? min(acc, v) : v;
      moved |= acc != v;
      s_lab[at] = acc;
    }
    acc = CELLSEG_INF;
#pragma unroll 4
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
  extern __shared__ __align__(16) int smem[];
  const int n = stripe * w;
  int* tot = smem;
  int* s_lab = smem + kScratchInts;
  uint8_t* s_m = reinterpret_cast<uint8_t*>(s_lab + n);
  const long long base = static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s_lab[i] = lab[base + i];
    s_m[i] = mask[base + i];
  }
  __syncthreads();

  const RowMap rm = row_map(w, stripe);
  int it = 0;
  bool changed = true;
  while (changed && it < cap) {
    bool moved = false;
    if (SWEEP) {
      moved |= sweep_columns(s_lab, s_m, w, stripe);
      __syncthreads();
    }
    moved |= row_passes<REGION, SWEEP>(s_lab, s_m, w, stripe, rm, tot);
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

// Checks that a stripe fits and sets the kernel's shared-memory attribute
// (once per device); *bytes receives the launch's dynamic shared memory.
template <bool REGION, bool SWEEP>
int prepare(int w, int stripe, long long* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = 4LL * kScratchInts + 5LL * stripe * w;
  if (*bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
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
  return 0;
}

template <bool REGION, bool SWEEP>
int launch(const void* lab, const void* mask, void* out, void* rounds, int h,
           int w, int stripe, int cap, cudaStream_t stream) {
  long long bytes = 0;
  const int err = prepare<REGION, SWEEP>(w, stripe, &bytes);
  if (err != 0) return err;
  stripe_converge_kernel<REGION, SWEEP>
      <<<h / stripe, kThreads, static_cast<size_t>(bytes), stream>>>(
          static_cast<const int*>(lab), static_cast<const uint8_t*>(mask),
          static_cast<int*>(out), static_cast<int*>(rounds), w, stripe, cap);
  return static_cast<int>(cudaGetLastError());
}

template <bool REGION, bool SWEEP>
int occupancy(int w, int stripe, int* blocks_per_sm) {
  long long bytes = 0;
  const int err = prepare<REGION, SWEEP>(w, stripe, &bytes);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, stripe_converge_kernel<REGION, SWEEP>, kThreads,
      static_cast<size_t>(bytes)));
}

}  // namespace

// lab: int32 (h, w); mask: uint8 (h, w) (0/1 in plain mode, any values in
// region mode); out: int32 (h, w), distinct from lab. All row-major and
// contiguous, on the device. stripe divides h and 512 + 5 * stripe * w
// bytes fit in a block's shared memory; connectivity 1 or 2 (plain mode
// only); cap >= 0. rounds: int32 (h / stripe) or null.
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

// Blocks of the kernel resident at once on one SM of the current device
// for stripes of `stripe` rows of a w-wide plane, into *blocks_per_sm.
extern "C" int cellseg_stripe_converge_occupancy(int w, int stripe,
                                                 int connectivity, int region,
                                                 void* blocks_per_sm) {
  if (stripe < 1 || w < 1 || (connectivity != 1 && connectivity != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* out = static_cast<int*>(blocks_per_sm);
  if (region) return occupancy<true, false>(w, stripe, out);
  if (connectivity == 2) return occupancy<false, true>(w, stripe, out);
  return occupancy<false, false>(w, stripe, out);
}
