// k fused masked neighbour-min sweeps (connected-components phase 2).
//
// Replaces cellseg_tpu/ops/pallas/sweeps.py:fused_sweeps (_kernel,
// _sweep_vmem). One sweep is ops/cc.py:_sweep_min: every pixel takes the
// min over its 3x3 window (connectivity 2) or its plus-shaped window
// (connectivity 1), centre included, with INF beyond the image, and
// unmasked pixels become INF. The result of k launches-worth of sweeps is
// bit-equal to k calls of _sweep_min.
//
// Bound on the H100: memory for the data that must move (lab 4 B + mask
// 1 B read, out 4 B written per pixel), but this first design is bound by
// shared-memory traffic: each sweep reads 5 or 9 neighbours per cell.
// Design: a block owns a 32x32 output tile and loads it with a k-pixel
// halo into shared memory (out-of-image cells: INF, unmasked). k Jacobi
// sweeps run there, ping-ponging between two buffers with a barrier
// between sweeps; a neighbour outside the buffer reads as INF, which only
// corrupts cells within s pixels of the buffer edge after s sweeps. Only
// the tile's centre, k or more pixels from that edge, is written back.
// So k sweeps cost one read and one write of the image.

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kMaxK = 16;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

template <int CONN>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
fused_sweeps_kernel(const int* __restrict__ lab,
                    const uint8_t* __restrict__ mask, int* __restrict__ out,
                    int h, int w, int k) {
  extern __shared__ int smem[];
  const int e = kTile + 2 * k;  // buffer side
  int* a = smem;
  int* b = a + e * e;
  uint8_t* m = reinterpret_cast<uint8_t*>(b + e * e);

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int oy = blockIdx.y * kTile - k;  // image row of buffer row 0
  const int ox = blockIdx.x * kTile - k;

  for (int ly = ty; ly < e; ly += kThreadsY) {
    const int gy = oy + ly;
    for (int lx = tx; lx < e; lx += kThreadsX) {
      const int gx = ox + lx;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const long long at = static_cast<long long>(gy) * w + gx;
      a[ly * e + lx] = in ? lab[at] : CELLSEG_INF;
      m[ly * e + lx] = in ? (mask[at] != 0) : 0;
    }
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    for (int ly = ty; ly < e; ly += kThreadsY) {
      for (int lx = tx; lx < e; lx += kThreadsX) {
        const int c = ly * e + lx;
        if (!m[c]) {
          b[c] = CELLSEG_INF;
          continue;
        }
        const bool up = ly > 0, dn = ly + 1 < e;
        const bool lf = lx > 0, rt = lx + 1 < e;
        int v = a[c];
        if (up) v = min(v, a[c - e]);
        if (dn) v = min(v, a[c + e]);
        if (lf) v = min(v, a[c - 1]);
        if (rt) v = min(v, a[c + 1]);
        if (CONN == 2) {
          if (up && lf) v = min(v, a[c - e - 1]);
          if (up && rt) v = min(v, a[c - e + 1]);
          if (dn && lf) v = min(v, a[c + e - 1]);
          if (dn && rt) v = min(v, a[c + e + 1]);
        }
        b[c] = v;
      }
    }
    __syncthreads();
    int* t = a;
    a = b;
    b = t;
  }

  for (int ly = k + ty; ly < k + kTile; ly += kThreadsY) {
    const int gy = oy + ly;
    const int gx = ox + k + tx;
    if (gy < h && gx < w) {
      out[static_cast<long long>(gy) * w + gx] = a[ly * e + k + tx];
    }
  }
}

}  // namespace

// lab: int32 (h, w); mask: uint8 (h, w), 0/1; out: int32 (h, w), distinct
// from lab. 1 <= k <= 16; connectivity 1 or 2.
extern "C" int cellseg_fused_sweeps(const void* lab, const void* mask,
                                    void* out, int h, int w, int k,
                                    int connectivity, void* stream) {
  if (k < 1 || k > kMaxK || (connectivity != 1 && connectivity != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int e = kTile + 2 * k;
  const size_t smem = static_cast<size_t>(e) * e * (2 * sizeof(int) + 1);
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const int* l = static_cast<const int*>(lab);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (connectivity == 2) {
    fused_sweeps_kernel<2><<<grid, block, smem, st>>>(l, m, o, h, w, k);
  } else {
    fused_sweeps_kernel<1><<<grid, block, smem, st>>>(l, m, o, h, w, k);
  }
  return static_cast<int>(cudaGetLastError());
}
