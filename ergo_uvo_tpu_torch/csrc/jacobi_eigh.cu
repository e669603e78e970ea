// Batched cyclic Jacobi eigensolver for small symmetric matrices, Hopper (sm_90a).
//
// Replaces the eager form of ergo_uvo_tpu/geometry/linalg.py::jacobi_eigh,
// which the JAX package hand-unrolled for the TPU so that one solve is one
// fused program under jax.jit.  For each of B float32 n x n matrices A it runs
// `sweeps` cyclic sweeps of two-sided Jacobi rotations in the fixed order
// (p, q) = (0, 1), (0, 2), ..., (n - 2, n - 1), then returns the diagonal
// sorted ascending (stable, NaN last) and the accumulated rotations V with
// their columns gathered in that order.  n is 3 (P3P's pencils), 9 (the
// 8-point solve and the essential / homography refits) or 12 (the PnP DLT).
//
// Bit for bit against the plain PyTorch version on the card.  That version
// runs every step as its own elementwise kernel, so every product, sum and
// quotient is rounded on its own.  This kernel spells each one out with the
// _rn intrinsics, so that nvcc cannot contract `c * ap - s * aq` into an FMA
// (the flags keep -fmad on for the other kernels):
//   small = |apq| < 1e-30f                      (torch compares in float32)
//   tau   = (aqq - app) / (small ? 1 : 2 apq)
//   t     = sign(tau) / (|tau| + sqrt(1 + tau tau)),  0 where small
//           sign is torch's (0 < x) - (x < 0): +0 for -0 and for NaN
//   c     = 1 / sqrt(1 + t t)   (`1.0 / x` is x.reciprocal() * 1.0 in torch)
//   s     = t c
// then rows p, q of A, columns p, q of A, columns p, q of V, each as
// (c x_p - s x_q, s x_p + c x_q) from the values before that update.  Every
// product is taken, 0 * inf included, so NaN spreads as it does there.  The
// sort gives element i the rank #{j : d_j < d_i} + #{j < i : d_j ~ d_i}
// under torch's CUDA comparator (a NaN is greater than any number, two NaNs
// and -0 / +0 are equivalent), the stable order that torch.argsort(stable=
// True) gives.
//
// What bounds it on an H100 SXM: a rotation is 18 n + 15 fp32 operations
// (n = 9: 177), a sweep n (n - 1) / 2 rotations; each matrix is read once
// and n + n^2 outputs written once.  At 512 x 9 x 9 that is 22.8 MFLOP on
// 350 KB: 0.34 us at 67 TFLOP/s against 0.10 us at 3.35 TB/s, so operations
// bound it.  The kernel is far above that: a matrix's 252 rotations form one
// serial chain (each rotation reads what the last one wrote, and two square
// roots and three divisions are on it in every rotation), and a batch of 512
// is 16 warps on a card with 528 warp schedulers.  The design takes that as
// given and removes what the eager version paid: about 50 launches a
// rotation, whatever the batch.
//
// Design: one thread a matrix, 32 threads a block, so that a batch spreads
// over as many SMs as it has warps.  A and V live in float[n][n] arrays whose
// every index is a compile-time constant (the (p, q) loops are unrolled for
// each n), so at n = 3 and n = 9 (162 floats) they stay in registers; at
// n = 12 (288 floats) part of them spills to local memory, which ptxas's
// report shows.  The sweeps loop stays rolled.  The input is only read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;

template <int N>
__device__ __forceinline__ void rotate(float (&a)[N][N], float (&v)[N][N], const int p,
                                       const int q) {
  const float app = a[p][p];
  const float aqq = a[q][q];
  const float apq = a[p][q];
  const bool small = fabsf(apq) < 1e-30f;
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), small ? 1.0f : __fmul_rn(2.0f, apq));
  const float sgn = static_cast<float>((0.0f < tau) - (tau < 0.0f));
  float t = __fdiv_rn(sgn, __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(__fmul_rn(tau, tau), 1.0f))));
  t = small ? 0.0f : t;
  const float c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fmul_rn(t, t), 1.0f)));
  const float s = __fmul_rn(t, c);

#pragma unroll
  for (int j = 0; j < N; ++j) {  // rows p, q of A
    const float xp = a[p][j];
    const float xq = a[q][j];
    a[p][j] = __fsub_rn(__fmul_rn(c, xp), __fmul_rn(s, xq));
    a[q][j] = __fadd_rn(__fmul_rn(s, xp), __fmul_rn(c, xq));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {  // columns p, q of A
    const float xp = a[i][p];
    const float xq = a[i][q];
    a[i][p] = __fsub_rn(__fmul_rn(c, xp), __fmul_rn(s, xq));
    a[i][q] = __fadd_rn(__fmul_rn(s, xp), __fmul_rn(c, xq));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {  // columns p, q of V
    const float xp = v[i][p];
    const float xq = v[i][q];
    v[i][p] = __fsub_rn(__fmul_rn(c, xp), __fmul_rn(s, xq));
    v[i][q] = __fadd_rn(__fmul_rn(s, xp), __fmul_rn(c, xq));
  }
}

// torch's CUDA sort comparator with NaN handling: x before y.
__device__ __forceinline__ bool before(const float x, const float y) {
  return (isnan(y) && !isnan(x)) || x < y;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    jacobi_eigh_kernel(const float* __restrict__ in, float* __restrict__ evals,
                       float* __restrict__ evecs, const int batch, const int sweeps) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* src = in + static_cast<int64_t>(b) * N * N;
  float a[N][N];
  float v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = __ldg(src + i * N + j);
      v[i][j] = i == j ? 1.0f : 0.0f;
    }
  }

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        rotate<N>(a, v, p, q);
      }
    }
  }

  float* w_out = evals + static_cast<int64_t>(b) * N;
  float* v_out = evecs + static_cast<int64_t>(b) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float di = a[i][i];
    int rank = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float dj = a[j][j];
      // j goes before i if it is less, or equivalent and earlier.
      rank += before(dj, di) || (j < i && !before(di, dj));
    }
    w_out[rank] = di;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      v_out[r * N + rank] = v[r][i];
    }
  }
}

}  // namespace

// a: (batch, n, n) row-major float32; evals: (batch, n); evecs: (batch, n, n).
// n must be 3, 9 or 12.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); a batch of 0 launches nothing.
extern "C" int jacobi_eigh_launch(const float* a, float* evals, float* evecs, int batch, int n,
                                  int sweeps, void* stream) {
  if (batch < 0 || sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const dim3 grid((batch + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 3:
      jacobi_eigh_kernel<3><<<grid, kThreads, 0, s>>>(a, evals, evecs, batch, sweeps);
      break;
    case 9:
      jacobi_eigh_kernel<9><<<grid, kThreads, 0, s>>>(a, evals, evecs, batch, sweeps);
      break;
    case 12:
      jacobi_eigh_kernel<12><<<grid, kThreads, 0, s>>>(a, evals, evecs, batch, sweeps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
