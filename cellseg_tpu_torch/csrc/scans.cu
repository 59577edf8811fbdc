// Segmented min-scans along rows and columns (connected-components hot loop).
//
// Replaces cellseg_tpu/ops/pallas/scans.py:row_segmented_min_scan and
// col_segmented_min_scan (_row_kernel / _col_kernel -> _segscan_vmem).
//
// Semantics (equal to the Hillis-Steele recurrence of ops/cc.py:
// _segmented_min_scan and _region_min_scan): each element carries a label
// and two flags, open_f (it absorbs its left/upper neighbour's running min)
// and open_b (it absorbs its right/lower neighbour's). Plain mode: both
// flags are mask != 0, and the output is min(forward, backward) on masked
// pixels and INF elsewhere. Region mode: open_f = m[i] == m[i-1] and
// open_b = m[i] == m[i+1] (closed at the ends), output unmasked.
// A forward scan is the fold  acc = open ? min(acc, lab) : lab,  which is
// associative over (val, open) pairs, so a line is cut into chunks that
// are folded independently and then joined.
//
// Bound on the H100: memory. The scan reads lab (4 B) and mask (1 B) and
// writes out (4 B) per pixel, 9 B/px, and does a handful of integer ops per
// byte. Design: one thread per chunk of a line. A column block is 32
// adjacent columns x 32 height chunks, so each warp reads 32 neighbouring
// columns of one row (coalesced 128 B). A row block is one row cut into 256
// chunks. Chunk summaries are joined by a log-step scan in shared memory,
// then every chunk is rescanned with its carry. Re-reads of a chunk hit L1
// or L2; no intermediate leaves the chip.

#include "common.cuh"

namespace {

struct Seg {
  int val;
  int open;
};

// Fold of span `a` followed by span `b` (b is nearer the scanned element).
__device__ __forceinline__ Seg join(Seg a, Seg b) {
  Seg r;
  r.val = b.open ? min(a.val, b.val) : b.val;
  r.open = a.open & b.open;
  return r;
}

template <bool REGION>
__device__ __forceinline__ int open_f(const uint8_t* m, long long base,
                                      long long step, int i) {
  const uint8_t mi = m[base + i * step];
  if (REGION) return i > 0 && mi == m[base + (i - 1) * step];
  return mi != 0;
}

template <bool REGION>
__device__ __forceinline__ int open_b(const uint8_t* m, long long base,
                                      long long step, int i, int n) {
  const uint8_t mi = m[base + i * step];
  if (REGION) return i + 1 < n && mi == m[base + (i + 1) * step];
  return mi != 0;
}

// Block (LX, TY): thread x owns line blockIdx.x * LX + x, thread y owns
// chunk y of that line. Element i of line l lies at l * line_stride +
// i * elem_stride.
template <bool REGION, int LX, int TY>
__global__ void __launch_bounds__(LX * TY)
seg_scan_kernel(const int* __restrict__ lab, const uint8_t* __restrict__ mask,
                int* __restrict__ out, int n_lines, int n,
                long long line_stride, long long elem_stride) {
  __shared__ int s_fv[TY][LX];
  __shared__ int s_fo[TY][LX];
  __shared__ int s_bv[TY][LX];
  __shared__ int s_bo[TY][LX];

  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int line = blockIdx.x * LX + x;
  const bool active = line < n_lines;
  const int chunk = (n + TY - 1) / TY;
  const int lo = min(y * chunk, n);
  const int hi = active ? min(lo + chunk, n) : lo;
  const long long base = static_cast<long long>(line) * line_stride;
  const long long step = elem_stride;

  // Phase A: the chunk's summary in both directions, in one pass.
  Seg f = {CELLSEG_INF, 1};
  Seg b = {CELLSEG_INF, 1};
  for (int i = lo; i < hi; ++i) {
    const int v = lab[base + i * step];
    const int of = open_f<REGION>(mask, base, step, i);
    const int ob = open_b<REGION>(mask, base, step, i, n);
    f.val = of ? min(f.val, v) : v;
    f.open &= of;
    // backward fold seen from the chunk's first element: the min over
    // [lo, j] where j is the first element that does not absorb its right
    if (b.open) b.val = min(b.val, v);
    b.open &= ob;
  }
  s_fv[y][x] = f.val;
  s_fo[y][x] = f.open;
  s_bv[y][x] = b.val;
  s_bo[y][x] = b.open;
  __syncthreads();

  // Phase B: inclusive scans of the chunk summaries, forward over y and
  // backward over y (Hillis-Steele in shared memory).
  for (int d = 1; d < TY; d <<= 1) {
    Seg fp = {CELLSEG_INF, 1};
    Seg bn = {CELLSEG_INF, 1};
    const bool hf = y >= d;
    const bool hb = y + d < TY;
    if (hf) fp = Seg{s_fv[y - d][x], s_fo[y - d][x]};
    if (hb) bn = Seg{s_bv[y + d][x], s_bo[y + d][x]};
    const Seg fc = {s_fv[y][x], s_fo[y][x]};
    const Seg bc = {s_bv[y][x], s_bo[y][x]};
    __syncthreads();
    if (hf) {
      const Seg r = join(fp, fc);
      s_fv[y][x] = r.val;
      s_fo[y][x] = r.open;
    }
    if (hb) {
      const Seg r = join(bn, bc);
      s_bv[y][x] = r.val;
      s_bo[y][x] = r.open;
    }
    __syncthreads();
  }
  const int carry_f = y > 0 ? s_fv[y - 1][x] : CELLSEG_INF;
  const int carry_b = y + 1 < TY ? s_bv[y + 1][x] : CELLSEG_INF;

  // Phase C: rescan the chunk with its carries; the forward pass parks
  // its values in `out`, the backward pass combines and masks them.
  int cv = carry_f;
  for (int i = lo; i < hi; ++i) {
    const int v = lab[base + i * step];
    cv = open_f<REGION>(mask, base, step, i) ? min(cv, v) : v;
    out[base + i * step] = cv;
  }
  cv = carry_b;
  for (int i = hi - 1; i >= lo; --i) {
    const long long at = base + i * step;
    const int v = lab[at];
    cv = open_b<REGION>(mask, base, step, i, n) ? min(cv, v) : v;
    int r = min(out[at], cv);
    if (!REGION && mask[at] == 0) r = CELLSEG_INF;
    out[at] = r;
  }
}

template <int LX, int TY>
void launch(const void* lab, const void* mask, void* out, int n_lines, int n,
            long long line_stride, long long elem_stride, int region,
            cudaStream_t stream) {
  const dim3 block(LX, TY);
  const dim3 grid((n_lines + LX - 1) / LX);
  const int* l = static_cast<const int*>(lab);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* o = static_cast<int*>(out);
  if (region) {
    seg_scan_kernel<true, LX, TY><<<grid, block, 0, stream>>>(
        l, m, o, n_lines, n, line_stride, elem_stride);
  } else {
    seg_scan_kernel<false, LX, TY><<<grid, block, 0, stream>>>(
        l, m, o, n_lines, n, line_stride, elem_stride);
  }
}

}  // namespace

// lab: int32 (h, w); mask: uint8 (h, w), 0/1; out: int32 (h, w). All
// row-major and contiguous, on the device.
extern "C" int cellseg_row_segmented_min_scan(const void* lab,
                                              const void* mask, void* out,
                                              int h, int w, int region,
                                              void* stream) {
  launch<1, 256>(lab, mask, out, h, w, w, 1, region,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cellseg_col_segmented_min_scan(const void* lab,
                                              const void* mask, void* out,
                                              int h, int w, int region,
                                              void* stream) {
  launch<32, 32>(lab, mask, out, w, h, 1, w, region,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
