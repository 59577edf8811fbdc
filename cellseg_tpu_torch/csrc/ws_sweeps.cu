// k fused watershed relaxation sweeps (the minimax-path watershed).
//
// Replaces cellseg_tpu/ops/pallas/ws_sweeps.py:fused_ws_sweeps (_kernel,
// _relax_vmem). One sweep is ops/watershed.py:relax_once: every masked
// pixel folds its 8 neighbours, in the order of _SHIFTS_8, against its
// running (cost, hops, label) state. A neighbour with label > 0 offers
// cost max(its cost, own elevation) and hops INF if its hops are INF, else
// 1 on a climb (own elevation > its cost), else its hops + 1; the offer
// wins on the lexicographic (cost, hops, label) order. Neighbours are read
// from the state before the sweep (Jacobi), so k sweeps here are bit-equal
// to k calls of relax_once.
//
// Bound on the H100: memory for what must move per launch, 29 bytes per
// pixel (e f32, mask u8, cost f32, hops i32, label i32 in: 17 B; the three
// state planes out: 12 B), for all k sweeps together. This first design is
// bound by shared-memory traffic instead: each sweep reads up to 8
// neighbours of 12 bytes per cell.
// Design: a block owns a 32x32 output tile and loads it with a k-pixel
// halo into shared memory: the elevation, the mask and the three state
// planes, the state double-buffered (k Jacobi sweeps ping-pong between the
// buffers with a barrier between sweeps). Cells beyond the image hold
// relax_once's padding (cost 3.0e38f, hops INF, label 0) and are unmasked,
// so they are never updated and never win. A neighbour beyond the buffer
// is skipped; that error enters one pixel per sweep from the buffer edge,
// so the tile's centre, k pixels in, is exact and is all that is written
// back. The buffers take (32 + 2k)^2 * 29 bytes: 66,816 for k = 8, above
// the 48 KB of static shared memory, so the kernel uses dynamic shared
// memory after cudaFuncSetAttribute; one launch does at most 8 sweeps.
// Comparisons are on exact float32 values: build without --use_fast_math.

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kMaxK = 8;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr float kBig = 3.0e38f;

__host__ __device__ constexpr size_t smem_bytes(int k) {
  return static_cast<size_t>(kTile + 2 * k) * (kTile + 2 * k) *
         (sizeof(float) + 2 * (sizeof(float) + 2 * sizeof(int)) + 1);
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
fused_ws_sweeps_kernel(const float* __restrict__ elev,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ cost,
                       const int* __restrict__ hops,
                       const int* __restrict__ label,
                       float* __restrict__ out_cost,
                       int* __restrict__ out_hops,
                       int* __restrict__ out_label, int h, int w, int k) {
  extern __shared__ float smem[];
  const int e = kTile + 2 * k;  // buffer side
  const int n = e * e;
  float* es = smem;
  float* ca = es + n;
  float* cb = ca + n;
  int* ha = reinterpret_cast<int*>(cb + n);
  int* hb = ha + n;
  int* la = hb + n;
  int* lb = la + n;
  uint8_t* ms = reinterpret_cast<uint8_t*>(lb + n);

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int oy = blockIdx.y * kTile - k;  // image row of buffer row 0
  const int ox = blockIdx.x * kTile - k;

  for (int ly = ty; ly < e; ly += kThreadsY) {
    const int gy = oy + ly;
    for (int lx = tx; lx < e; lx += kThreadsX) {
      const int gx = ox + lx;
      const int c = ly * e + lx;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const long long at = static_cast<long long>(gy) * w + gx;
        es[c] = elev[at];
        ms[c] = mask[at] != 0;
        ca[c] = cost[at];
        ha[c] = hops[at];
        la[c] = label[at];
      } else {
        es[c] = kBig;
        ms[c] = 0;
        ca[c] = kBig;
        ha[c] = CELLSEG_INF;
        la[c] = 0;
      }
    }
  }
  __syncthreads();

  // _SHIFTS_8 of ops/watershed.py, in its order
  const int dys[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
  const int dxs[8] = {0, 0, -1, 1, -1, 1, -1, 1};

  for (int s = 0; s < k; ++s) {
    for (int ly = ty; ly < e; ly += kThreadsY) {
      for (int lx = tx; lx < e; lx += kThreadsX) {
        const int c = ly * e + lx;
        float nc_best = ca[c];
        int nh_best = ha[c];
        int nl_best = la[c];
        if (ms[c]) {
          const float ev = es[c];
#pragma unroll
          for (int d = 0; d < 8; ++d) {
            const int ny = ly + dys[d];
            const int nx = lx + dxs[d];
            if (ny < 0 || ny >= e || nx < 0 || nx >= e) continue;
            const int j = ny * e + nx;
            const int nl = la[j];
            if (nl <= 0) continue;
            const float nc = ca[j];
            const int nh = ha[j];
            const float cand = nc > ev ? nc : ev;
            const int cand_h =
                nh == CELLSEG_INF ? CELLSEG_INF : (ev > nc ? 1 : nh + 1);
            const bool better =
                cand < nc_best ||
                (cand == nc_best &&
                 (cand_h < nh_best || (cand_h == nh_best && nl < nl_best)));
            if (better) {
              nc_best = cand;
              nh_best = cand_h;
              nl_best = nl;
            }
          }
        }
        cb[c] = nc_best;
        hb[c] = nh_best;
        lb[c] = nl_best;
      }
    }
    __syncthreads();
    float* tc = ca;
    ca = cb;
    cb = tc;
    int* th = ha;
    ha = hb;
    hb = th;
    int* tl = la;
    la = lb;
    lb = tl;
  }

  for (int ly = k + ty; ly < k + kTile; ly += kThreadsY) {
    const int gy = oy + ly;
    const int gx = ox + k + tx;
    if (gy < h && gx < w) {
      const long long at = static_cast<long long>(gy) * w + gx;
      const int c = ly * e + k + tx;
      out_cost[at] = ca[c];
      out_hops[at] = ha[c];
      out_label[at] = la[c];
    }
  }
}

}  // namespace

// elev, cost: float32 (h, w); mask: uint8 (h, w), 0/1; hops, label: int32
// (h, w). The outputs are distinct from the inputs. 1 <= k <= 8.
extern "C" int cellseg_fused_ws_sweeps(const void* elev, const void* mask,
                                       const void* cost, const void* hops,
                                       const void* label, void* out_cost,
                                       void* out_hops, void* out_label, int h,
                                       int w, int k, void* stream) {
  if (k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  // the shared-memory attribute holds for the kernel on its device until
  // the process ends: set it on the first launch per device only
  static std::atomic<unsigned long long> attribute_set{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0;
  if (bit == 0 || (attribute_set.load() & bit) == 0) {
    err = cudaFuncSetAttribute(fused_ws_sweeps_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxK)));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    attribute_set.fetch_or(bit);
  }
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  fused_ws_sweeps_kernel<<<grid, block, smem_bytes(k),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(elev), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(cost), static_cast<const int*>(hops),
      static_cast<const int*>(label), static_cast<float*>(out_cost),
      static_cast<int*>(out_hops), static_cast<int*>(out_label), h, w, k);
  return static_cast<int>(cudaGetLastError());
}
