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
// on the sweep order where (cost, hops) tie. The number of sweeps each
// stripe ran is written out on request.
//
// Bound on the H100: what must move is 29 bytes per pixel per launch (e
// f32, mask u8, cost f32, hops i32, label i32 in; the three state planes
// out), 0.041 ms at 2176^2. The operations needed are 18 int32/float32
// per masked pixel and neighbour folded in: all 8 neighbours in a
// stripe's first sweep, then only those that changed in the sweep before
// (the fold is a minimum in a total order, so an unchanged neighbour
// offers nothing new). From the watershed's initial state at 2176^2 that
// is 2.25e9 operations, 0.034 ms, so the bytes bound it. A stripe is a
// chain of up to `cap` dependent sweeps, so what decides the time is the
// latency of one sweep of one stripe and how many stripes run at once.
//
// Two variants; the wrapper (ops/kernels/ws_local.py:ws_cluster_size)
// picks one from (h, w, stripe) before the launch: clusters of 16 blocks
// where a block can hold a 16th of a stripe's columns in shared memory
// (up to 12,360 columns in stripes of 8 rows), else the global variant.
//
// - cluster (cluster > 0): a thread-block cluster of `cluster` blocks of
//   384 threads per stripe (blocks past the plane's last column, where it
//   is narrower than the cluster, hold no pixel). Block r owns the slab of columns
//   [r * cw, (r + 1) * cw) and keeps, in dynamic shared memory for all
//   sweeps, its slab's e and mask, both Jacobi buffers of (cost, hops,
//   label) and two dirty planes, each with a one-cell frame: the rows
//   above and below the stripe and the columns beyond the plane are
//   relax_once's padding (label 0, never a candidate), the two other
//   frame columns are the neighbouring slabs' edge columns. A block writes
//   its slab's new edge columns straight into its neighbours' frames of
//   the next buffer (distributed shared memory), and one cluster barrier
//   (release/acquire) ends each sweep: it makes those writes, and the
//   change votes, visible. Each warp that moved a pixel sets the sweep's
//   flag in the leader block (rank 0); three flags rotate, and the leader
//   clears the flag of the sweep after next, which no block reads or
//   writes until two barriers later.
//   Work skipping, exact: a pixel that changes marks its 3x3
//   neighbourhood dirty for the next sweep (in the neighbouring slab too).
//   A warp takes 32 consecutive slab pixels and skips them where none is
//   dirty: no pixel of their neighbourhoods changed, so their new state
//   equals the old, which the buffer being written holds from two sweeps
//   ago, as do the neighbours' frames. The relaxation step has no branch
//   (bitwise logic and selects) and a pixel's 24 neighbour loads are
//   issued before its fold. At 2176^2: 16 blocks of 136 columns x 16 rows,
//   75,480 bytes each, three blocks per SM, 21 clusters resident.
//   Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W) at 2176^2
//   from the watershed's initial state (136 stripes, 86-241 sweeps): 5.14
//   ms, 125x the bytes bound, about 6 us per sweep of a cluster with 21
//   busy. Every neighbour of every masked pixel in every sweep would be
//   33x the operations needed; the kernel relaxes only dirty pixels, but
//   each against all 8 neighbours, and a sweep's cluster barrier costs
//   the same however little the sweep changes.
// - global (cluster == 0), for stripes whose slab does not fit in 227 KB
//   even at 16 blocks: one block of 512 threads walks the whole stripe, its
//   state double-buffered in global memory (the output planes and a
//   scratch copy, coherent loads), a __syncthreads_or change vote per
//   sweep.
//
// Comparisons are on exact float32 values: build without --use_fast_math.

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;         // global variant: one block a stripe
constexpr int kClusterThreads = 384;  // cluster variant: three blocks an SM
constexpr int kMaxCluster = 16;
constexpr float kBig = 3.0e38f;

// One relaxation step of a masked pixel against its neighbour (nc, nh, nl)
// (ws_sweeps.cu, relax_once): a neighbour with label <= 0 offers nothing.
// Written without branches (bitwise logic, selects), so that a warp's
// lanes never diverge and the neighbours' loads can all be issued first.
__device__ __forceinline__ void relax(float ev, float nc, int nh, int nl,
                                      float& bc, int& bh, int& bl) {
  const float cand = nc > ev ? nc : ev;
  const int cand_h = nh == CELLSEG_INF ? CELLSEG_INF : (ev > nc ? 1 : nh + 1);
  const bool tie_wins = (cand_h < bh) | ((cand_h == bh) & (nl < bl));
  const bool better = (nl > 0) & ((cand < bc) | ((cand == bc) & tie_wins));
  bc = better ? cand : bc;
  bh = better ? cand_h : bh;
  bl = better ? nl : bl;
}

// Bytes of a cluster block's dynamic shared memory: 3 flags (16 bytes),
// the two framed buffers of (cost, hops, label) and the two framed dirty
// planes, then e and the mask over the slab. Every offset depends on
// (stripe, cw) only, so it is the same in every block of the cluster.
__host__ __device__ constexpr long long cluster_smem_bytes(int stripe,
                                                           int cw) {
  return 16 + 26LL * (stripe + 2) * (cw + 2) + 5LL * stripe * cw;
}

__global__ void __launch_bounds__(kClusterThreads, 3)
stripe_ws_cluster_kernel(const float* __restrict__ elev,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ cost,
                         const int* __restrict__ hops,
                         const int* __restrict__ label,
                         float* __restrict__ out_cost,
                         int* __restrict__ out_hops,
                         int* __restrict__ out_label, int* sweeps, int w,
                         int stripe, int cw, int cap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int sidx = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  int* flags = reinterpret_cast<int*>(smem);
  const int pitch = cw + 2;
  const int framed = (stripe + 2) * pitch;
  // buffer b of a plane starts b * framed cells after buffer 0
  float* cbuf = reinterpret_cast<float*>(smem + 16);
  int* hbuf = reinterpret_cast<int*>(cbuf + 2 * framed);
  int* lbuf = hbuf + 2 * framed;
  float* es = reinterpret_cast<float*>(lbuf + 2 * framed);
  uint8_t* dirty = reinterpret_cast<uint8_t*>(es + stripe * cw);
  uint8_t* ms = dirty + 2 * framed;

  const int x0 = rank * cw;
  const int nx = max(0, min(cw, w - x0));  // this slab's columns
  const int n = stripe * nx;  // slab pixels, row-major with pitch nx
  // i / nx as a multiply-high: exact for i * nx < 2^32, and a slab that
  // fits in shared memory has fewer than 2^13 pixels; a slab of one
  // column (a plane narrower than the cluster) needs no division, and its
  // factor, 2^32, would not fit
  const unsigned inv_nx =
      static_cast<unsigned>((0x100000000ULL + nx - 1) / max(nx, 2));
  const auto row_of = [nx, inv_nx](int i) {
    return nx == 1 ? i
                   : static_cast<int>(
                         __umulhi(static_cast<unsigned>(i), inv_nx));
  };
  const long long base = static_cast<long long>(sidx) * stripe * w;

  // buffer 0: the input over the slab and its frame; buffer 1: the frame's
  // padding (its other cells are written before they are read). Every
  // pixel is dirty for the first sweep.
  for (int i = tid; i < framed; i += kClusterThreads) {
    const int ly = i / pitch;
    const int lx = i - ly * pitch;
    const int y = ly - 1;
    const int gx = x0 + lx - 1;
    const bool real = y >= 0 && y < stripe && lx <= nx + 1 && gx >= 0 &&
                      gx < w;
    if (real) {
      const long long at = base + static_cast<long long>(y) * w + gx;
      cbuf[i] = cost[at];
      hbuf[i] = hops[at];
      lbuf[i] = label[at];
    } else {
      cbuf[i] = kBig;
      hbuf[i] = CELLSEG_INF;
      lbuf[i] = 0;
    }
    if (!real || lx < 1 || lx > nx) {
      cbuf[framed + i] = kBig;
      hbuf[framed + i] = CELLSEG_INF;
      lbuf[framed + i] = 0;
    }
    dirty[i] = 1;
    dirty[framed + i] = 0;
  }
  for (int i = tid; i < n; i += kClusterThreads) {
    const int y = row_of(i);
    const long long at = base + static_cast<long long>(y) * w + x0 + i -
                         y * nx;
    es[i] = elev[at];
    ms[i] = mask[at] != 0;
  }
  if (tid < 4) flags[tid] = 0;
  // every block of the cluster is resident and loaded before any reads or
  // writes another's shared memory
  cluster.sync();

  // _SHIFTS_8 of ops/watershed.py, in its order
  const int dys[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
  const int dxs[8] = {0, 0, -1, 1, -1, 1, -1, 1};
  int* leader_flags = cluster.map_shared_rank(flags, 0);
  const bool push_left = x0 > 0;
  const bool push_right = x0 + nx < w;
  int it = 0;
  int cur = 0;  // offset of the buffers the sweep reads: 0 or framed
  while (it < cap) {
    const float* ca = cbuf + cur;
    const int* ha = hbuf + cur;
    const int* la = lbuf + cur;
    float* cb = cbuf + (framed - cur);
    int* hb = hbuf + (framed - cur);
    int* lb = lbuf + (framed - cur);
    uint8_t* dr = dirty + cur;
    uint8_t* dw = dirty + (framed - cur);
    bool moved = false;
    // a warp takes 32 consecutive slab pixels and skips them all where no
    // pixel of their 3x3 neighbourhoods changed in the last sweep: their
    // new state equals the old, which the buffer written now already holds
    // from two sweeps ago, as do the neighbours' frames
    for (int i0 = tid - lane; i0 < n; i0 += kClusterThreads) {
      const int i = i0 + lane;
      const int y = row_of(i);
      const int x = i - y * nx;
      const int c = (y + 1) * pitch + x + 1;
      const bool d = i < n && dr[c] != 0;
      if (!__any_sync(0xffffffffu, d) || !d) continue;
      dr[c] = 0;
      const float oc = ca[c];
      const int oh = ha[c];
      const int ol = la[c];
      const float ev = es[i];
      float nc[8];
      int nh[8];
      int nl[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = c + dys[k] * pitch + dxs[k];
        nc[k] = ca[j];
        nh[k] = ha[j];
        nl[k] = la[j];
      }
      float bc = oc;
      int bh = oh;
      int bl = ol;
#pragma unroll
      for (int k = 0; k < 8; ++k) relax(ev, nc[k], nh[k], nl[k], bc, bh, bl);
      if (!ms[i]) {
        bc = oc;
        bh = oh;
        bl = ol;
      }
      cb[c] = bc;
      hb[c] = bh;
      lb[c] = bl;
      // the slab's edge columns into the neighbours' frames
      if (x == 0 && push_left) {
        const int r = (y + 1) * pitch + cw + 1;
        *cluster.map_shared_rank(cb + r, rank - 1) = bc;
        *cluster.map_shared_rank(hb + r, rank - 1) = bh;
        *cluster.map_shared_rank(lb + r, rank - 1) = bl;
      }
      if (x == nx - 1 && push_right) {
        const int r = (y + 1) * pitch;
        *cluster.map_shared_rank(cb + r, rank + 1) = bc;
        *cluster.map_shared_rank(hb + r, rank + 1) = bh;
        *cluster.map_shared_rank(lb + r, rank + 1) = bl;
      }
      if (bc != oc || bh != oh || bl != ol) {
        moved = true;
        // the pixel's 3x3 neighbourhood is dirty for the next sweep (frame
        // cells are marked too and never read), in this slab and in the
        // neighbouring slab's edge column
        uint8_t* m = dw + c - pitch - 1;
        m[0] = m[1] = m[2] = 1;
        m[pitch] = m[pitch + 1] = m[pitch + 2] = 1;
        m[2 * pitch] = m[2 * pitch + 1] = m[2 * pitch + 2] = 1;
        if (x == 0 && push_left) {
          uint8_t* r = cluster.map_shared_rank(dw + y * pitch + cw, rank - 1);
          r[0] = r[pitch] = r[2 * pitch] = 1;
        }
        if (x == nx - 1 && push_right) {
          uint8_t* r = cluster.map_shared_rank(dw + y * pitch + 1, rank + 1);
          r[0] = r[pitch] = r[2 * pitch] = 1;
        }
      }
    }
    if (__any_sync(0xffffffffu, moved) && lane == 0) {
      leader_flags[it % 3] = 1;
    }
    if (rank == 0 && tid == 0) flags[(it + 1) % 3] = 0;
    cluster.sync();
    const bool changed =
        *static_cast<volatile int*>(leader_flags + it % 3) != 0;
    ++it;
    cur = framed - cur;
    if (!changed) break;
  }
  // no block leaves while another may still read the leader's flags
  cluster.sync();

  const float* ca = cbuf + cur;
  const int* ha = hbuf + cur;
  const int* la = lbuf + cur;
  for (int i = tid; i < n; i += kClusterThreads) {
    const int y = row_of(i);
    const int x = i - y * nx;
    const int c = (y + 1) * pitch + x + 1;
    const long long at = base + static_cast<long long>(y) * w + x0 + x;
    out_cost[at] = ca[c];
    out_hops[at] = ha[c];
    out_label[at] = la[c];
  }
  if (sweeps != nullptr && rank == 0 && tid == 0) sweeps[sidx] = it;
}

__global__ void __launch_bounds__(kThreads, 2)
stripe_ws_global_kernel(const float* __restrict__ elev,
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
          relax(ev, ca[j], ha[j], la[j], bc, bh, bl);
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

// The launch configuration of the cluster variant; sets the kernel's
// attributes once per device. Returns a CUDA error code.
int cluster_config(int h, int w, int stripe, int cluster,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cw = (w + cluster - 1) / cluster;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = cluster_smem_bytes(stripe, cw);
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  // the attributes hold for the kernel on its device until the process
  // ends: set them once per device
  static std::atomic<unsigned long long> attribute_set{0};
  const unsigned long long bit = device < 64 ? 1ULL << device : 0;
  if (bit == 0 || (attribute_set.load() & bit) == 0) {
    err = cudaFuncSetAttribute(stripe_ws_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(stripe_ws_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(stripe_ws_cluster_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set.fetch_or(bit);
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(h / stripe) * cluster);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

bool bad_shape(int h, int w, int stripe, int cap) {
  return stripe < 1 || w < 1 || h % stripe != 0 || cap < 0 ||
         static_cast<long long>(stripe) * w > (1LL << 30);
}

}  // namespace

// elev, cost: float32 (h, w); mask: uint8 (h, w), 0/1; hops, label: int32
// (h, w); tmp_*: scratch planes like the outputs, used (and then needed)
// only by the global variant (cluster == 0). The outputs and the scratch
// planes are distinct from the inputs and from each other. stripe divides
// h; cap >= 0; cluster 0 (global) or 1-16 blocks per stripe.
// sweeps: int32 (h / stripe) or null.
extern "C" int cellseg_stripe_ws_converge(
    const void* elev, const void* mask, const void* cost, const void* hops,
    const void* label, void* out_cost, void* out_hops, void* out_label,
    void* tmp_cost, void* tmp_hops, void* tmp_label, void* sweeps, int h,
    int w, int stripe, int cap, int cluster, void* stream) {
  if (bad_shape(h, w, stripe, cap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    stripe_ws_global_kernel<<<h / stripe, kThreads, 0, s>>>(
        static_cast<const float*>(elev), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(cost), static_cast<const int*>(hops),
        static_cast<const int*>(label), static_cast<float*>(out_cost),
        static_cast<int*>(out_hops), static_cast<int*>(out_label),
        static_cast<float*>(tmp_cost), static_cast<int*>(tmp_hops),
        static_cast<int*>(tmp_label), static_cast<int*>(sweeps), w, stripe,
        cap);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = cluster_config(h, w, stripe, cluster, &cfg, &attr, s);
  if (err != 0) return err;
  const int cw = (w + cluster - 1) / cluster;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, stripe_ws_cluster_kernel, static_cast<const float*>(elev),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(cost),
      static_cast<const int*>(hops), static_cast<const int*>(label),
      static_cast<float*>(out_cost), static_cast<int*>(out_hops),
      static_cast<int*>(out_label), static_cast<int*>(sweeps), w, stripe, cw,
      cap);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

// How many clusters of the cluster variant can be resident at once on the
// current device for an (h, w) plane in stripes of `stripe` rows
// (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int cellseg_ws_cluster_occupancy(int h, int w, int stripe,
                                            int cluster, void* active) {
  if (bad_shape(h, w, stripe, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = cluster_config(h, w, stripe, cluster, &cfg, &attr, nullptr);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      static_cast<int*>(active), stripe_ws_cluster_kernel, &cfg));
}
