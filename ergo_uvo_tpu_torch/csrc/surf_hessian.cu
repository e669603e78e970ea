// SURF fast-Hessian detector on Hopper (sm_90a): the padded integral table,
// the box-filter responses, the 3x3x3 peak test and the sub-pixel refinement
// with the cross-octave merge of ergo_uvo_tpu_torch/features/detector.py.
//
// Replaces no TPU kernel: the JAX package runs
// ergo_uvo_tpu/features/detector.py::detect_surf as one program under
// jax.jit, and XLA fuses its slices and elementwise ops.  Eager PyTorch runs
// the same chain as ~2,700 launches an image (the blocked scans, 4 corner
// slices and 4 ops a box, 10 boxes a filter, 20 filters, the peak masks and
// the refinement's gathers), each a few microseconds of device work behind
// ~30 us of host time: the launches bound it, not the card.
//
// Five kernels, each one launch for the whole batch and every octave:
//   1. integral_columns: a thread a column, the blocked prefix sum down it;
//   2. integral_rows: a block a row of the padded table, the blocked prefix
//      sum along the row, then the zero row and column and the replicate
//      edge, as pad_integral(integral_image(img), margin) lays them out;
//   3. responses: a thread a point of every octave's stride-2^o grid and
//      layer, the Dxx, Dyy and Dxy box filters, det and trace;
//   4. peaks: a thread a point, the 3x3x3 peak test, the threshold and the
//      validity masks, the flat masked score in (layer, y, x) order;
//   5. refine_merge: after torch.sort's stable top-K of each octave's flat
//      scores, a thread a candidate slot: its rank in the cross-octave merge
//      and, for the slots that make the top K, the quadratic sub-pixel /
//      sub-scale refinement, written straight to the slot it lands in.
//
// Bit for bit against the plain version on the card, keypoints included.
// That version runs each step as its own elementwise kernel, so every sum,
// difference and product is rounded on its own.  Here each is spelled out
// with the _rn intrinsics, so that nvcc contracts nothing into an FMA, in
// the plain version's order:
//   * a prefix sum along a line follows XLA's blocked scan, which the plain
//     version's _blocked_cumsum copies: sums left to right inside blocks of
//     16, the block totals scanned the same way (recursively), then each
//     block's carried total added to its sums (0 to the first block's);
//     columns first, then rows;
//   * a box sum is ((a - b) - c) + d of its four corners, times the weight
//     w / area rounded to float32; a filter adds its boxes in pattern order;
//     det = dx dy - (0.81 dxy) dxy, trace = dx + dy;
//   * the refinement's differences and _solve33's adjugate as written there;
//     _solve33's `adj @ b` is cuBLAS's batched product, whose order is the
//     library's: dot3 below takes the order that gave its bits on the H100,
//     so xy and scale are bit for bit too (a cuBLAS that picks another
//     order would fail the card tests' and chip_smoke's bit checks of xy
//     and scale);
//   * a division by a Python scalar is a product with its float32
//     reciprocal, as PyTorch's CUDA division by a CPU scalar computes it.
//
// What bounds it on an H100 SXM: at 640x480 the work is ~2.0 M grid points
// (4 octaves x 5 layers) at 52 fp32 operations each, ~0.1 GFLOP or 1.6 us at
// 67 TFLOP/s, and the image is read once (1.2 MB, 0.4 us at 3.35 TB/s).  The
// five kernels took ~0.24 ms of device time a frame and the four sorts ~0.23
// (PERF.md, section 6): the scans are serial along a line (480 or 640
// dependent adds a thread, a few hundred threads a frame) and kernel 3 reads
// 40 table entries a point from L1/L2.  Nothing here is near the card's
// limits; the design's aim is one launch for what was hundreds, where the
// host's launches bounded the chain.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanBlock = 16;   // XLA's scan block
constexpr int kMaxLevels = 6;    // a line of up to 16^6 values
constexpr int kMaxOctaves = 8;
constexpr int kBoxes = 10;       // Dxx 3, Dyy 3, Dxy 4
constexpr int kThreads = 256;
constexpr int kRowThreads = 128;
constexpr int kRefineThreads = 128;
constexpr int kSmemDefault = 48 * 1024;

// The SURF 9x9 base patterns (x0, y0, x1, y1), half-open boxes relative to
// the filter's top-left corner, and their weights: Dxx, Dyy, Dxy.
__constant__ int kPattern[kBoxes][4] = {
    {0, 2, 3, 7}, {3, 2, 6, 7}, {6, 2, 9, 7},
    {2, 0, 7, 3}, {2, 3, 7, 6}, {2, 6, 7, 9},
    {1, 1, 4, 4}, {5, 1, 8, 4}, {1, 5, 4, 8}, {5, 5, 8, 8}};
__constant__ float kPatternWeight[kBoxes] = {1.0f, -2.0f, 1.0f, 1.0f, -2.0f, 1.0f,
                                             1.0f, -1.0f, -1.0f, 1.0f};

// The batch's shapes: the image, the padded table, each octave's grid and
// where its (batch, layer, y, x) stack starts in the flat buffers.
struct Geometry {
  int batch, h, w, n_octaves, layers, margin, hp, wp;
  int h_o[kMaxOctaves], w_o[kMaxOctaves];
  long long start[kMaxOctaves + 1];
};

Geometry make_geometry(const int batch, const int h, const int w, const int n_octaves,
                       const int layers, const int margin) {
  Geometry g{};
  g.batch = batch;
  g.h = h;
  g.w = w;
  g.n_octaves = n_octaves;
  g.layers = layers;
  g.margin = margin;
  g.hp = h + 1 + 2 * margin;
  g.wp = w + 1 + 2 * margin;
  g.start[0] = 0;
  for (int o = 0; o < n_octaves; ++o) {
    const int step = 1 << o;
    g.h_o[o] = (h + step - 1) / step;
    g.w_o[o] = (w + step - 1) / step;
    g.start[o + 1] = g.start[o] + static_cast<long long>(batch) * layers * g.h_o[o] * g.w_o[o];
  }
  return g;
}

// Filter size of (octave, layer): (9 + 6 layer) << octave, filter_sizes().
__host__ __device__ __forceinline__ int filter_size(const int octave, const int layer) {
  return (9 + 6 * layer) << octave;
}

// An inclusive prefix sum fed one value at a time, in XLA's blocked order.
// Level 0 takes the line's n values; a level with more than 16 values sums
// each block of 16 left to right, hands each finished block's total up to
// the next level (the last block's is never needed), and adds to each of
// its sums the next level's output for the block before (0 for the first
// block).  The first level with 16 values or fewer is a plain left-to-right
// sum.  Unrolled over the levels, so the state stays in registers.
struct BlockedScan {
  int top;  // the plain level
  int len[kMaxLevels];
  int pos[kMaxLevels];
  float acc[kMaxLevels];
  float carried[kMaxLevels];

  __device__ explicit BlockedScan(const int n) {
    top = 0;
    int m = n;
#pragma unroll
    for (int level = 0; level < kMaxLevels; ++level) {
      len[level] = m;
      pos[level] = 0;
      acc[level] = 0.0f;
      carried[level] = 0.0f;
      if (m > kScanBlock) {
        top = level + 1;
        m = (m + kScanBlock - 1) / kScanBlock;
      }
    }
  }

  __device__ __forceinline__ float push(float v) {
    float out = 0.0f;
    bool up = true;
#pragma unroll
    for (int level = 0; level < kMaxLevels; ++level) {
      if (up && level <= top) {
        const int j = pos[level]++;
        acc[level] = j % kScanBlock == 0 ? v : __fadd_rn(acc[level], v);
        const float res = level == top ? acc[level] : __fadd_rn(acc[level], carried[level]);
        if (level == 0) {
          out = res;
        } else {
          carried[level - 1] = res;
        }
        up = level < top && j % kScanBlock == kScanBlock - 1 && j != len[level] - 1;
        v = acc[level];
      }
    }
    return out;
  }
};

__global__ void __launch_bounds__(kRowThreads)
    integral_columns_kernel(const float* __restrict__ img, float* __restrict__ cols,
                            const int batch, const int h, const int w) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(batch) * w) return;
  const long long b = t / w;
  const int x = static_cast<int>(t % w);
  const float* src = img + b * h * w + x;
  float* dst = cols + b * h * w + x;
  BlockedScan scan(h);
  // A block of rows' loads is issued before its adds: one row at a time,
  // each add waited for its load, and a frame's few hundred threads left the
  // card idle (0.18 ms a 640x480 frame on the H100; PERF.md, section 6).
  for (int y0 = 0; y0 < h; y0 += kScanBlock) {
    float v[kScanBlock];
#pragma unroll
    for (int k = 0; k < kScanBlock; ++k) {
      v[k] = y0 + k < h ? __ldg(src + static_cast<long long>(y0 + k) * w) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kScanBlock; ++k) {
      if (y0 + k < h) dst[static_cast<long long>(y0 + k) * w] = scan.push(v[k]);
    }
  }
}

// Row r of frame b's padded table is row clamp(r - margin, 0, h) of the
// (h + 1) x (w + 1) table, whose row and column 0 are zeros; its column c is
// that row's column clamp(c - margin, 0, w).
__global__ void __launch_bounds__(kRowThreads)
    integral_rows_kernel(const float* __restrict__ cols, float* __restrict__ table, const Geometry g) {
  extern __shared__ float row[];
  const int r = blockIdx.x;
  const long long b = blockIdx.y;
  const int yy = min(max(r - g.margin, 0), g.h);
  float* out = table + (b * g.hp + r) * g.wp;
  if (yy == 0) {
    for (int c = threadIdx.x; c < g.wp; c += blockDim.x) out[c] = 0.0f;
    return;
  }
  const float* src = cols + (b * g.h + (yy - 1)) * g.w;
  for (int c = threadIdx.x; c < g.w; c += blockDim.x) row[c] = src[c];
  __syncthreads();
  if (threadIdx.x == 0) {
    BlockedScan scan(g.w);
    for (int c = 0; c < g.w; ++c) row[c] = scan.push(row[c]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < g.wp; c += blockDim.x) {
    const int xx = min(max(c - g.margin, 0), g.w);
    out[c] = xx == 0 ? 0.0f : row[xx - 1];
  }
}

// A point of the flat (octave, batch, layer, y, x) buffers.
struct Point {
  int o, l, y, x;
  long long b;
};

__device__ __forceinline__ bool decode(const Geometry& g, const long long t, Point& p) {
  if (t >= g.start[g.n_octaves]) return false;
  int o = 0;
  while (t >= g.start[o + 1]) ++o;
  long long rem = t - g.start[o];
  p.o = o;
  p.x = static_cast<int>(rem % g.w_o[o]);
  rem /= g.w_o[o];
  p.y = static_cast<int>(rem % g.h_o[o]);
  rem /= g.h_o[o];
  p.l = static_cast<int>(rem % g.layers);
  p.b = rem / g.layers;
  return true;
}

// A box of a scaled pattern: corner offsets from the pixel (rows y0, y1,
// columns x0, x1, half-open) and its float32 weight.
struct Box {
  int y0, x0, y1, x1;
  float w;
};

// _scaled_pattern: corners round(k * size / 9) (never a tie: 2 k size is
// even and 9 odd, and double arithmetic cannot move k * size / 9 across a
// half, whose distance from it is at least 1/18), offsets from floor(size /
// 2), weight w / max(area, 1) in double, then rounded to float32.
__device__ __forceinline__ Box scaled_box(const int size, const int k) {
  const int c = size / 2;
  const int sx0 = (2 * kPattern[k][0] * size + 9) / 18;
  const int sy0 = (2 * kPattern[k][1] * size + 9) / 18;
  const int sx1 = (2 * kPattern[k][2] * size + 9) / 18;
  const int sy1 = (2 * kPattern[k][3] * size + 9) / 18;
  const int area = max((sx1 - sx0) * (sy1 - sy0), 1);
  Box box;
  box.y0 = sy0 - c;
  box.x0 = sx0 - c;
  box.y1 = sy1 - c;
  box.x1 = sx1 - c;
  box.w = __double2float_rn(__ddiv_rn(static_cast<double>(kPatternWeight[k]), static_cast<double>(area)));
  return box;
}

// ((a - b) - c) + d of the box's corners, times its weight.
__device__ __forceinline__ float box_response(const float* __restrict__ at, const int wp, const Box& box) {
  const float a = __ldg(at + box.y1 * wp + box.x1);
  const float b = __ldg(at + box.y0 * wp + box.x1);
  const float c = __ldg(at + box.y1 * wp + box.x0);
  const float d = __ldg(at + box.y0 * wp + box.x0);
  return __fmul_rn(__fadd_rn(__fsub_rn(__fsub_rn(a, b), c), d), box.w);
}

__device__ __forceinline__ float haar(const float* __restrict__ at, const int wp, const Box* boxes,
                                      const int first, const int n) {
  float acc = box_response(at, wp, boxes[first]);
  for (int k = first + 1; k < first + n; ++k) acc = __fadd_rn(acc, box_response(at, wp, boxes[k]));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    responses_kernel(const float* __restrict__ table, float* __restrict__ dets,
                     float* __restrict__ traces, const Geometry g) {
  extern __shared__ Box boxes[];  // (octave, layer, box)
  const int n_boxes = g.n_octaves * g.layers * kBoxes;
  for (int i = threadIdx.x; i < n_boxes; i += blockDim.x) {
    const int filter = i / kBoxes;
    boxes[i] = scaled_box(filter_size(filter / g.layers, filter % g.layers), i % kBoxes);
  }
  __syncthreads();
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  Point p;
  if (!decode(g, t, p)) return;
  const int step = 1 << p.o;
  const float* at = table + (p.b * g.hp + g.margin + p.y * step) * g.wp + g.margin + p.x * step;
  const Box* fb = boxes + (p.o * g.layers + p.l) * kBoxes;
  const float dx = haar(at, g.wp, fb, 0, 3);
  const float dy = haar(at, g.wp, fb, 3, 3);
  const float dxy = haar(at, g.wp, fb, 6, 4);
  const float k081 = static_cast<float>(0.81);  // the Python scalar as PyTorch rounds it
  dets[t] = __fsub_rn(__fmul_rn(dx, dy), __fmul_rn(__fmul_rn(dxy, k081), dxy));
  traces[t] = __fadd_rn(dx, dy);
}

__global__ void __launch_bounds__(kThreads)
    peaks_kernel(const float* __restrict__ dets, float* __restrict__ scores, const Geometry g,
                 const float min_hessian) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  Point p;
  if (!decode(g, t, p)) return;
  const float v = dets[t];
  const int h_o = g.h_o[p.o], w_o = g.w_o[p.o];
  float out = -INFINITY;
  // Middle layers, the interior of the grid, above the threshold; then the
  // filter-fit margin of the layer above (NMS compares against it).
  if (p.l >= 1 && p.l <= g.layers - 2 && p.y >= 1 && p.y < h_o - 1 && p.x >= 1 &&
      p.x < w_o - 1 && v > min_hessian) {
    const int m = filter_size(p.o, p.l + 1) / 2 + 1;
    const int py = p.y << p.o, px = p.x << p.o;
    if (py >= m && py < g.h - m && px >= m && px < g.w - m) {
      // The 3x3x3 neighbourhood lies inside the stack; a NaN there fails
      // v >= it, as it makes max_pool3d's maximum NaN.
      bool peak = true;
      const long long plane = static_cast<long long>(h_o) * w_o;
#pragma unroll
      for (int dl = -1; dl <= 1; ++dl) {
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) peak &= v >= __ldg(dets + t + dl * plane + dy * w_o + dx);
        }
      }
      if (peak) out = v;
    }
  }
  scores[t] = out;
}

// Each octave's stable top-K of its flat scores, as torch.sort left them:
// (batch, n) rows, of which the first min(K, n) are read.
struct Sorted {
  const float* values[kMaxOctaves];
  const long long* index[kMaxOctaves];
};

// sum_k r_k b_k as cuBLAS's batched product computes it on the H100: of the
// 24 orders of three products, fused or rounded apart, this one alone gave
// its bits on every random 3x3 batch of 512-4096 tried (PERF.md, section 6).
__device__ __forceinline__ float dot3(const float r0, const float r1, const float r2, const float b0,
                                      const float b1, const float b2) {
  return __fadd_rn(__fmaf_rn(r1, b1, __fmul_rn(r0, b0)), __fmul_rn(r2, b2));
}

__device__ __forceinline__ float clamp_unit(const float v) {
  return isnan(v) ? v : fminf(fmaxf(v, -1.0f), 1.0f);  // torch.clamp keeps NaN
}

__device__ __forceinline__ float torch_sign(const float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}

struct Refined {
  float x, y, sigma, lap;
};

// _octave_candidates' refinement of the candidate at (l, y, x) of octave o.
__device__ Refined refine(const float* __restrict__ det, const float* __restrict__ trace,
                          const Geometry& g, const int o, const int l, const int y, const int x) {
  const int h_o = g.h_o[o], w_o = g.w_o[o];
  auto nb = [&](const int dl, const int dy, const int dx) {
    const int ll = min(max(l + dl, 0), g.layers - 1);
    const int yy = min(max(y + dy, 1), h_o - 2);
    const int xx = min(max(x + dx, 1), w_o - 2);
    return __ldg(det + (static_cast<long long>(ll) * h_o + yy) * w_o + xx);
  };
  const float c = nb(0, 0, 0);
  const float lp = nb(1, 0, 0), lm = nb(-1, 0, 0);
  const float yp = nb(0, 1, 0), ym = nb(0, -1, 0);
  const float xp = nb(0, 0, 1), xm = nb(0, 0, -1);
  const float d_l = __fmul_rn(0.5f, __fsub_rn(lp, lm));
  const float d_y = __fmul_rn(0.5f, __fsub_rn(yp, ym));
  const float d_x = __fmul_rn(0.5f, __fsub_rn(xp, xm));
  const float c2 = __fmul_rn(2.0f, c);
  const float d_ll = __fsub_rn(__fadd_rn(lp, lm), c2);
  const float d_yy = __fsub_rn(__fadd_rn(yp, ym), c2);
  const float d_xx = __fsub_rn(__fadd_rn(xp, xm), c2);
  auto cross = [&](const float pp, const float pm, const float mp, const float mm) {
    return __fmul_rn(0.25f, __fadd_rn(__fsub_rn(__fsub_rn(pp, pm), mp), mm));
  };
  const float d_ly = cross(nb(1, 1, 0), nb(1, -1, 0), nb(-1, 1, 0), nb(-1, -1, 0));
  const float d_lx = cross(nb(1, 0, 1), nb(1, 0, -1), nb(-1, 0, 1), nb(-1, 0, -1));
  const float d_yx = cross(nb(0, 1, 1), nb(0, 1, -1), nb(0, -1, 1), nb(0, -1, -1));

  // _solve33(H3, g): H3 = [[d_ll, d_ly, d_lx], [d_ly, d_yy, d_yx],
  // [d_lx, d_yx, d_xx]], g = (d_l, d_y, d_x).
  const float a00 = d_ll, a01 = d_ly, a02 = d_lx;
  const float a10 = d_ly, a11 = d_yy, a12 = d_yx;
  const float a20 = d_lx, a21 = d_yx, a22 = d_xx;
  auto minor = [](const float p, const float q, const float r, const float s) {
    return __fsub_rn(__fmul_rn(p, q), __fmul_rn(r, s));
  };
  const float c00 = minor(a11, a22, a12, a21);
  const float c01 = minor(a12, a20, a10, a22);
  const float c02 = minor(a10, a21, a11, a20);
  const float det3 = __fadd_rn(__fadd_rn(__fmul_rn(a00, c00), __fmul_rn(a01, c01)), __fmul_rn(a02, c02));
  const float c10 = minor(a02, a21, a01, a22);
  const float c11 = minor(a00, a22, a02, a20);
  const float c12 = minor(a01, a20, a00, a21);
  const float c20 = minor(a01, a12, a02, a11);
  const float c21 = minor(a02, a10, a00, a12);
  const float c22 = minor(a00, a11, a01, a10);
  const float eps = static_cast<float>(1e-12);
  const float safe = fabsf(det3) < eps ? (det3 < 0.0f ? -eps : eps) : det3;
  const float s0 = __fdiv_rn(dot3(c00, c10, c20, d_l, d_y, d_x), safe);
  const float s1 = __fdiv_rn(dot3(c01, c11, c21, d_l, d_y, d_x), safe);
  const float s2 = __fdiv_rn(dot3(c02, c12, c22, d_l, d_y, d_x), safe);
  const float off_l = clamp_unit(-s0), off_y = clamp_unit(-s1), off_x = clamp_unit(-s2);

  const float step = static_cast<float>(1 << o);
  const float base_size = static_cast<float>(filter_size(o, l));
  const float size_step = static_cast<float>(6 << o);
  Refined r;
  // 1.2 * (base + off * size_step) / 9.0, the division as PyTorch's product
  // with the float32 reciprocal of a CPU scalar.
  r.sigma = __fmul_rn(__fmul_rn(static_cast<float>(1.2), __fadd_rn(base_size, __fmul_rn(off_l, size_step))),
                      1.0f / 9.0f);
  r.x = __fmul_rn(__fadd_rn(static_cast<float>(x), off_x), step);
  r.y = __fmul_rn(__fadd_rn(static_cast<float>(y), off_y), step);
  r.lap = torch_sign(__ldg(trace + (static_cast<long long>(l) * h_o + y) * w_o + x));
  return r;
}

// Grid (slot blocks, batch).  Every block builds frame b's merged scores
// (the octaves' top-K values where finite and above the threshold, else
// -inf) in shared memory; a thread takes a slot s = o K + j, and if its
// score is finite, counts its rank in the stable descending order (greater
// scores, and equal ones at lower slots, go first).  The finite slots' ranks
// are 0..F-1; those below K are refined and written there, and block 0 fills
// the slots F..K-1 with the plain version's zeros.
__global__ void __launch_bounds__(kRefineThreads)
    refine_merge_kernel(const float* __restrict__ dets, const float* __restrict__ traces,
                        const Sorted sorted, const Geometry g, const int k_max, const float min_hessian,
                        float* __restrict__ xy, float* __restrict__ scale, float* __restrict__ score,
                        float* __restrict__ lap, uint8_t* __restrict__ mask) {
  extern __shared__ float merged[];
  const long long b = blockIdx.y;
  const int slots = g.n_octaves * k_max;
  int finite = 0;
  for (int base = 0; base < slots; base += blockDim.x) {
    const int s = base + threadIdx.x;
    bool ok = false;
    if (s < slots) {
      const int o = s / k_max, j = s % k_max;
      const long long n = static_cast<long long>(g.layers) * g.h_o[o] * g.w_o[o];
      float v = -INFINITY;
      if (j < n) v = __ldg(sorted.values[o] + b * n + j);
      ok = isfinite(v) && v > min_hessian;
      merged[s] = ok ? v : -INFINITY;
    }
    finite += __syncthreads_count(ok);  // also the barrier before merged is read
  }

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < slots && merged[s] != -INFINITY) {
    const float v = merged[s];
    int rank = 0;
    for (int q = 0; q < slots; ++q) {
      const float u = merged[q];
      rank += (u > v) || (u == v && q < s);
    }
    if (rank < k_max) {
      const int o = s / k_max, j = s % k_max;
      const int h_o = g.h_o[o], w_o = g.w_o[o];
      const long long plane = static_cast<long long>(h_o) * w_o;
      const long long n = g.layers * plane;
      const long long idx = __ldg(sorted.index[o] + b * n + j);
      const int l = static_cast<int>(idx / plane);
      const int y = static_cast<int>(idx % plane / w_o);
      const int x = static_cast<int>(idx % w_o);
      const long long frame = g.start[o] + b * n;
      const Refined r = refine(dets + frame, traces + frame, g, o, l, y, x);
      const long long at = b * k_max + rank;
      xy[2 * at] = r.x;
      xy[2 * at + 1] = r.y;
      scale[at] = r.sigma;
      score[at] = v;
      lap[at] = r.lap;
      mask[at] = 1;
    }
  }
  if (blockIdx.x == 0) {
    for (int p = finite + threadIdx.x; p < k_max; p += blockDim.x) {
      const long long at = b * k_max + p;
      xy[2 * at] = 0.0f;
      xy[2 * at + 1] = 0.0f;
      scale[at] = 0.0f;
      score[at] = 0.0f;
      lap[at] = 0.0f;
      mask[at] = 0;
    }
  }
}

// The shapes every entry point takes; `layers` is the octave's stack of
// filter sizes (n_layers + 2), `margin` the padded table's.
bool valid_shape(const int batch, const int h, const int w, const int n_octaves, const int layers,
                 const int margin) {
  return batch > 0 && batch <= 65535 && h > 0 && h <= (1 << 20) && w > 0 && w <= (1 << 20) &&
         n_octaves >= 1 && n_octaves <= kMaxOctaves && layers >= 1 && layers <= 64 &&
         margin >= filter_size(n_octaves - 1, layers - 1) / 2 + 2 && margin <= (1 << 20);
}

// Dynamic shared memory above the default 48 KB needs the kernel's consent.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, const size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

int blocks_for(const long long n, const int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the launch's
// cudaError_t (0 on success), or cudaErrorInvalidValue for shapes it cannot
// take.  Every buffer is contiguous float32 unless said otherwise:
//   img (batch, h, w); cols (batch, h, w);
//   table (batch, h + 1 + 2 margin, w + 1 + 2 margin);
//   dets, traces, scores: every octave's (batch, layers, ceil(h / 2^o),
//   ceil(w / 2^o)) stack, octave after octave.

extern "C" int surf_integral_columns(const float* img, float* cols, int batch, int h, int w,
                                     int n_octaves, int layers, int margin, void* stream) {
  if (!valid_shape(batch, h, w, n_octaves, layers, margin)) return static_cast<int>(cudaErrorInvalidValue);
  const long long lines = static_cast<long long>(batch) * w;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  integral_columns_kernel<<<blocks_for(lines, kRowThreads), kRowThreads, 0, s>>>(img, cols, batch, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int surf_integral_rows(const float* cols, float* table, int batch, int h, int w, int n_octaves,
                                  int layers, int margin, void* stream) {
  if (!valid_shape(batch, h, w, n_octaves, layers, margin)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(batch, h, w, n_octaves, layers, margin);
  const size_t smem = sizeof(float) * w;
  const cudaError_t err = allow_smem(integral_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  integral_rows_kernel<<<dim3(g.hp, batch), kRowThreads, smem, s>>>(cols, table, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int surf_responses(const float* table, float* dets, float* traces, int batch, int h, int w,
                              int n_octaves, int layers, int margin, void* stream) {
  if (!valid_shape(batch, h, w, n_octaves, layers, margin)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(batch, h, w, n_octaves, layers, margin);
  const size_t smem = sizeof(Box) * n_octaves * layers * kBoxes;
  const cudaError_t err = allow_smem(responses_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  responses_kernel<<<blocks_for(g.start[n_octaves], kThreads), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(table, dets, traces, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int surf_peaks(const float* dets, float* scores, int batch, int h, int w, int n_octaves,
                          int layers, int margin, float min_hessian, void* stream) {
  if (!valid_shape(batch, h, w, n_octaves, layers, margin)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(batch, h, w, n_octaves, layers, margin);
  peaks_kernel<<<blocks_for(g.start[n_octaves], kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dets, scores, g, min_hessian);
  return static_cast<int>(cudaGetLastError());
}

// values[o], indices[o]: octave o's torch.sort output, (batch, n_o) float32
// and int64; xy (batch, k_max, 2), scale, score, lap (batch, k_max) float32;
// mask (batch, k_max) bool.
extern "C" int surf_refine_merge(const float* dets, const float* traces, const void* const* values,
                                 const void* const* indices, int batch, int h, int w, int n_octaves,
                                 int layers, int margin, int k_max, float min_hessian, float* xy,
                                 float* scale, float* score, float* lap, uint8_t* mask, void* stream) {
  if (!valid_shape(batch, h, w, n_octaves, layers, margin) || k_max < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = make_geometry(batch, h, w, n_octaves, layers, margin);
  Sorted sorted{};
  for (int o = 0; o < n_octaves; ++o) {
    sorted.values[o] = static_cast<const float*>(values[o]);
    sorted.index[o] = static_cast<const long long*>(indices[o]);
  }
  const long long slots = static_cast<long long>(n_octaves) * k_max;
  const size_t smem = sizeof(float) * slots;
  const cudaError_t err = allow_smem(refine_merge_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  refine_merge_kernel<<<dim3(blocks_for(slots, kRefineThreads), batch), kRefineThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(dets, traces, sorted, g, k_max, min_hessian, xy,
                                                             scale, score, lap, mask);
  return static_cast<int>(cudaGetLastError());
}
