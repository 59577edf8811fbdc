// Block-local watershed convergence: every row stripe to its local fixed
// point.
//
// Replaces cellseg_tpu/ops/pallas/ws_local.py:stripe_ws_converge (_kernel).
// Each full-width row stripe of `stripe` rows is an image of its own: the
// 8-neighbour lexicographic minimax relaxation of ops/watershed.py
// (relax_once, see ws_sweeps.cu for the step) runs on it, neighbours
// beyond the stripe being relax_once's padding, until one sweep changes no
// (cost, hops, label) of the stripe or `cap` sweeps have run. Sweeps are
// Jacobi (each reads the state before it), so every stripe's result is
// bit-equal to the Pallas kernel's while loop, whose fixed point can depend
// on the sweep order where (cost, hops) tie.
//
// Bound on the H100: what must move is 29 bytes per pixel per launch (e
// f32, mask u8, cost f32, hops i32, label i32 in; the three state planes
// out), against 144 int32/float32 operations per masked pixel and sweep,
// so the bound is the operations at the tens of sweeps a stripe needs.
// This first design is bound by latency: a stripe's state does not fit in
// shared memory (the stripe is up to 64K pixels, 1.5 MB of double-buffered
// state), so it lives in global memory, and one block on one SM walks a
// stripe's 34,816 pixels (68 per thread at 2176 columns) between two
// barriers per sweep. Measured on an H100 at 2176^2: about 141 us per
// sweep of the slowest stripe, 28.6x the operations bound.
// Design: one block of 512 threads per stripe, two blocks per SM, so the
// 136 stripes of a 2176-wide plane run in one wave. The state ping-pongs
// between the output planes and a scratch copy in global memory; a block
// barrier with a change vote (__syncthreads_or) ends each sweep, and the
// barrier also makes the sweep's global writes visible to the whole block.
// The state pointers carry no __restrict__, so the loads are coherent ones.
// Optionally the number of sweeps each stripe ran is written out.
// Comparisons are on exact float32 values: build without --use_fast_math.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads, 2)
stripe_ws_converge_kernel(const float* __restrict__ elev,
                          const uint8_t* __restrict__ mask,
                          const float* __restrict__ cost,
                          const int* __restrict__ hops,
                          const int* __restrict__ label, float* out_cost,
                          int* out_hops, int* out_label, float* tmp_cost,
                          int* tmp_hops, int* tmp_label, int* sweeps, int w,
                          int stripe, int cap) {
  const long long base = static_cast<long long>(blockIdx.x) * stripe * w;
  const int n = stripe * w;
  const float* es = elev + base;
  const uint8_t* ms = mask + base;
  float* ca = out_cost + base;
  int* ha = out_hops + base;
  int* la = out_label + base;
  float* cb = tmp_cost + base;
  int* hb = tmp_hops + base;
  int* lb = tmp_label + base;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    ca[i] = cost[base + i];
    ha[i] = hops[base + i];
    la[i] = label[base + i];
  }
  __syncthreads();

  // _SHIFTS_8 of ops/watershed.py, in its order
  const int dys[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
  const int dxs[8] = {0, 0, -1, 1, -1, 1, -1, 1};

  int it = 0;
  bool changed = true;
  while (changed && it < cap) {
    bool moved = false;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float oc = ca[i];
      const int oh = ha[i];
      const int ol = la[i];
      float bc = oc;
      int bh = oh;
      int bl = ol;
      if (ms[i]) {
        const int y = i / w;
        const int x = i - y * w;
        const float ev = es[i];
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int ny = y + dys[d];
          const int nx = x + dxs[d];
          if (ny < 0 || ny >= stripe || nx < 0 || nx >= w) continue;
          const int j = ny * w + nx;
          const int nl = la[j];
          if (nl <= 0) continue;
          const float nc = ca[j];
          const int nh = ha[j];
          const float cand = nc > ev ? nc : ev;
          const int cand_h =
              nh == CELLSEG_INF ? CELLSEG_INF : (ev > nc ? 1 : nh + 1);
          const bool better =
              cand < bc ||
              (cand == bc && (cand_h < bh || (cand_h == bh && nl < bl)));
          if (better) {
            bc = cand;
            bh = cand_h;
            bl = nl;
          }
        }
      }
      cb[i] = bc;
      hb[i] = bh;
      lb[i] = bl;
      moved |= bc != oc || bh != oh || bl != ol;
    }
    changed = __syncthreads_or(moved) != 0;
    float* tc = ca;
    ca = cb;
    cb = tc;
    int* th = ha;
    ha = hb;
    hb = th;
    int* tl = la;
    la = lb;
    lb = tl;
    ++it;
  }

  if (ca != out_cost + base) {  // the last sweep wrote the scratch copy
    for (int i = threadIdx.x; i < n; i += kThreads) {
      out_cost[base + i] = ca[i];
      out_hops[base + i] = ha[i];
      out_label[base + i] = la[i];
    }
  }
  if (sweeps != nullptr && threadIdx.x == 0) {
    sweeps[blockIdx.x] = it;
  }
}

}  // namespace

// elev, cost: float32 (h, w); mask: uint8 (h, w), 0/1; hops, label: int32
// (h, w); tmp_*: scratch planes like the outputs. The outputs and the
// scratch planes are distinct from the inputs and from each other.
// stripe divides h; cap >= 0. sweeps: int32 (h / stripe) or null.
extern "C" int cellseg_stripe_ws_converge(
    const void* elev, const void* mask, const void* cost, const void* hops,
    const void* label, void* out_cost, void* out_hops, void* out_label,
    void* tmp_cost, void* tmp_hops, void* tmp_label, void* sweeps, int h,
    int w, int stripe, int cap, void* stream) {
  if (stripe < 1 || h % stripe != 0 || cap < 0 ||
      static_cast<long long>(stripe) * w > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stripe_ws_converge_kernel<<<h / stripe, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(elev), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(cost), static_cast<const int*>(hops),
      static_cast<const int*>(label), static_cast<float*>(out_cost),
      static_cast<int*>(out_hops), static_cast<int*>(out_label),
      static_cast<float*>(tmp_cost), static_cast<int*>(tmp_hops),
      static_cast<int*>(tmp_label), static_cast<int*>(sweeps), w, stripe,
      cap);
  return static_cast<int>(cudaGetLastError());
}
