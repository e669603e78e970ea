// Batched cyclic Jacobi eigensolver for small symmetric matrices, Hopper (sm_90a).
//
// Replaces the eager form of ergo_uvo_tpu/geometry/linalg.py::jacobi_eigh
// (:21), which the JAX package hand-unrolled for the TPU so that one solve is
// one fused program under jax.jit.  For each of B float32 n x n matrices A it
// runs `sweeps` cyclic sweeps of two-sided Jacobi rotations in the fixed order
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
// then rows p, q of A from the values before the rotation, columns p, q of A
// from the row-updated matrix, and columns p, q of V, each element as
// (c x_p - s x_q, s x_p + c x_q).  A is not exactly symmetric after a
// rotation, so no element is taken from its mirror.  Every product is taken,
// 0 * inf included, so NaN spreads as it does there.  The sort gives element
// i the rank #{j : d_j < d_i} + #{j < i : d_j ~ d_i} under torch's CUDA
// comparator (a NaN is greater than any number, two NaNs and -0 / +0 are
// equivalent), the stable order that torch.argsort(stable=True) gives.
//
// What bounds it on an H100 SXM (chip_smoke.py::_jacobi_bound): a rotation
// is 18 n + 15 fp32 operations, a sweep n (n - 1) / 2 rotations; each matrix
// is read once and n + n^2 outputs written once.  At 512 x 9 x 9 that is 22.8
// MFLOP on 350 KB: 0.34 us at 67 TFLOP/s against 0.10 us at 3.35 TB/s, so
// operations bound it.  No design in this order gets near that: a matrix's
// rotations form one serial chain (each reads what the last one wrote: 252 at
// n = 9, 462 at n = 12), and on that chain every rotation has 3 IEEE
// divisions, 2 IEEE square roots and ~10 dependent operations, whatever the
// batch.  The serial chain sets the pace: ~310 cycles a rotation alone on an
// H100 (PERF.md, section 6).  The design keeps the rest off it.
//
// Design.  At n = 9 and 12 a group of 16 lanes takes a matrix, lane k its
// index k, two matrices a warp, 128 threads a block (groups of 8 and 32
// measured slower or no faster).  A lives in shared memory, rows padded to
// n + 1 floats, plus a row and a column n where the lanes past n read and
// write, so that no lane branches on its index.  The (p, q) loop stays
// rolled: ~1,400 SASS instructions at n = 9 and ~2,200 at n = 12, where a
// thread a matrix with unrolled sweeps took 10k and 22k.  In each rotation:
//   * every lane of the group computes tau, t, c and s itself: the same
//     intrinsics give the same bits on every lane;
//   * lane k, from its A[p][k], A[q][k], A[k][p], A[k][q] loaded before the
//     chain, computes the row phase's A[p][k], A[q][k] and the column phase's
//     A[k][p], A[k][q].  The column phase reads the row-updated matrix only in
//     rows p and q, the 2x2 block, which each lane recomputes from the four
//     scalars with the row phase's own products; every other row of columns
//     p, q is untouched by the row phase.  So each element is written once,
//     by one lane, between two __syncwarp (every read of the matrix before
//     any write, every write before the next reads);
//   * the next rotation's scalars do not go through shared memory, a round
//     trip of ~190 cycles on the chain: along a row, (p, q + 1), they are the
//     new A[p][p], A[q + 1][p] and A[p][q + 1], which lanes p and q + 1 hold
//     in registers and __shfl_sync hands to the group, and A[q + 1][q + 1],
//     loaded before; at (p + 1, p + 2) the rotation leaves them as they were,
//     loaded before too; only (n - 2, n - 1) and the next sweep's (0, 1) read
//     them back after the writes;
//   * __syncwarp() spans the whole warp: a lane that left (a batch's last
//     groups) is not waited for, and a per-group mask compiles to MATCH.ANY
//     and REDUX, ~120 cycles a rotation more.
// That leaves ~190 cycles a rotation beside the chain, ~500 in all: the
// second __syncwarp waits for the stores to drain (~60), and ~70
// instructions follow the chain in each rotation.
//
// V does not feed back into A: lane 0 keeps each rotation's (c, s) in shared
// memory, and after each sweep lane k applies the sweep's rotations in order
// to row k of V, which lives in its registers under compile-time indices
// (that loop alone is unrolled: ~7 instructions a rotation).  At n = 3 one
// thread takes a matrix, A and V in registers and the sweep unrolled (3
// rotations): groups of 2 and 4 measured slower.  The input is only read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockThreads = 128;
constexpr int kGroup = 16;  // lanes a 9x9 or 12x12 matrix

__device__ __forceinline__ float rot_minus(const float c, const float s, const float xp,
                                           const float xq) {
  return __fsub_rn(__fmul_rn(c, xp), __fmul_rn(s, xq));
}

__device__ __forceinline__ float rot_plus(const float c, const float s, const float xp,
                                          const float xq) {
  return __fadd_rn(__fmul_rn(s, xp), __fmul_rn(c, xq));
}

// The rotation zeroing A[p][q], as the plain version computes it.  Where
// tau * tau overflows (a converged off-diagonal), sqrt(1 + tau tau) and
// |tau| + sqrt(...) are +inf and t is sign(tau) / inf, a zero of tau's sign:
// that t is written out, and the square root gets a finite operand whose
// result is not used, so that neither IEEE routine leaves its fast path.
__device__ __forceinline__ void rotation(const float app, const float aqq, const float apq,
                                         float& c, float& s) {
  const bool small = fabsf(apq) < 1e-30f;
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), small ? 1.0f : __fmul_rn(2.0f, apq));
  const float sgn = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : 0.0f);  // torch.sign
  const float tt1 = __fadd_rn(__fmul_rn(tau, tau), 1.0f);
  float t = __fdiv_rn(sgn, __fadd_rn(fabsf(tau), __fsqrt_rn(fminf(tt1, 3.40282347e38f))));
  t = isinf(tt1) ? __fmul_rn(sgn, 0.0f) : t;
  t = small ? 0.0f : t;
  c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fmul_rn(t, t), 1.0f)));
  s = __fmul_rn(t, c);
}

// torch's CUDA sort comparator with NaN handling: x before y.
__device__ __forceinline__ bool before(const float x, const float y) {
  return (isnan(y) && !isnan(x)) || x < y;
}

// rank[i]: where d[i] goes when d is sorted ascending, stable, NaN last.
template <int N>
__device__ __forceinline__ void sorted_ranks(const float (&d)[N], int (&rank)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    rank[i] = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // j goes before i if it is less, or equivalent and earlier.
      rank[i] += before(d[j], d[i]) || (j < i && !before(d[i], d[j]));
    }
  }
}

// Row k of V, its columns in the sorted order, into v_out, and the
// eigenvalue d[k] into its place in w_out.
template <int N>
__device__ __forceinline__ void write_row(const float (&d)[N], const int (&rank)[N],
                                          const float (&vk)[N], const int k, float* w_out,
                                          float* v_out) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j == k) w_out[rank[j]] = d[j];
    v_out[k * N + rank[j]] = vk[j];
  }
}

// The rotation (p, q) on rows p, q of A, then its columns p, q, then V's.
template <int N>
__device__ __forceinline__ void rotate_registers(float (&a)[N][N], float (&v)[N][N], const int p,
                                                 const int q) {
  float c, s;
  rotation(a[p][p], a[q][q], a[p][q], c, s);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float xp = a[p][j];
    const float xq = a[q][j];
    a[p][j] = rot_minus(c, s, xp, xq);
    a[q][j] = rot_plus(c, s, xp, xq);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float xp = a[i][p];
    const float xq = a[i][q];
    a[i][p] = rot_minus(c, s, xp, xq);
    a[i][q] = rot_plus(c, s, xp, xq);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float xp = v[i][p];
    const float xq = v[i][q];
    v[i][p] = rot_minus(c, s, xp, xq);
    v[i][q] = rot_plus(c, s, xp, xq);
  }
}

// One thread a matrix, A and V in registers under compile-time indices.
template <int N>
__global__ void __launch_bounds__(kBlockThreads)
    jacobi_eigh_thread_kernel(const float* __restrict__ in, float* __restrict__ evals,
                              float* __restrict__ evecs, const int batch, const int sweeps) {
  const int b = blockIdx.x * kBlockThreads + threadIdx.x;
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
      for (int q = p + 1; q < N; ++q) rotate_registers<N>(a, v, p, q);
    }
  }
  float d[N];
#pragma unroll
  for (int j = 0; j < N; ++j) d[j] = a[j][j];
  int rank[N];
  sorted_ranks<N>(d, rank);
  const int64_t at = b;
#pragma unroll
  for (int k = 0; k < N; ++k) write_row<N>(d, rank, v[k], k, evals + at * N, evecs + at * N * N);
}

// The sweep's rotations, in order, on a row of V.
template <int N>
__device__ __forceinline__ void rotate_row(float (&v)[N], const float2* cs) {
  int r = 0;
#pragma unroll
  for (int p = 0; p < N - 1; ++p) {
#pragma unroll
    for (int q = p + 1; q < N; ++q, ++r) {
      const float2 t = cs[r];
      const float xp = v[p];
      const float xq = v[q];
      v[p] = rot_minus(t.x, t.y, xp, xq);
      v[q] = rot_plus(t.x, t.y, xp, xq);
    }
  }
}

// A group of kGroup lanes a matrix, A in shared memory, lane k its index k.
template <int N>
__global__ void __launch_bounds__(kBlockThreads)
    jacobi_eigh_group_kernel(const float* __restrict__ in, float* __restrict__ evals,
                             float* __restrict__ evecs, const int batch, const int sweeps) {
  constexpr int kMats = kBlockThreads / kGroup;  // matrices a block
  constexpr int kLd = N + 1;                     // a padded row of A
  constexpr int kPairs = N * (N - 1) / 2;        // rotations a sweep
  static_assert(N < kGroup && 32 % kGroup == 0, "a group lies in a warp, an index a lane");
  // A, plus row n and column n: a lane's index past n is taken as n, so that
  // its loads and stores go there and no lane branches on its index.
  __shared__ float a_all[kMats][(N + 1) * kLd];
  __shared__ float2 cs_all[kMats][kPairs];  // (c, s) of the sweep's rotations

  const int group = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const int b = blockIdx.x * kMats + group;
  if (b >= batch) return;  // __syncwarp() and __shfl_sync() wait for no lane that left
  float* a = a_all[group];
  float2* cs = cs_all[group];

  const float* src = in + static_cast<int64_t>(b) * N * N;
#pragma unroll
  for (int j = 0; j < (N * N + kGroup - 1) / kGroup; ++j) {
    const int i = lane + j * kGroup;
    if (i < N * N) a[i / N * kLd + i % N] = __ldg(src + i);
  }
  const int k = lane < N ? lane : N;  // this lane's index, or n past the matrix
  float* const row_k = a + k * kLd;
  float v[N];  // row k of V
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = lane == j ? 1.0f : 0.0f;
  __syncwarp();

  // The rotation's pair and scalars, in registers on every lane.
  int p = 0, q = 1;
  float app = a[0], aqq = a[kLd + 1], apq = a[1], aqp = a[kLd];
#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll 1
    for (int i = 0; i < kPairs; ++i) {
      // This rotation's indices and the next one's, ahead of the chain.
      const int q1 = q + 1, p1 = p + 1, p2 = p + 2;
      const bool along = q1 < N;  // the next rotation is (p, q + 1)
      const int np = along ? p : (p2 < N ? p1 : 0);
      const int nq = along ? q1 : np + 1;
      const bool reload = !along && p + 3 >= N;  // (n - 2, n - 1), or (0, 1) of the next sweep
      float* const row_p = a + p * kLd;
      float* const row_q = a + q * kLd;
      // The matrix before the rotation: this lane's A[p][k], A[q][k],
      // A[k][p], A[k][q], and the scalars of (p + 1, p + 2), which the
      // rotation leaves as they are (an index n reads row or column n).
      const float rp = row_p[k], rq = row_q[k], cp = row_k[p], cq = row_k[q];
      const float a_q1q1 = a[q1 * kLd + q1];
      const float a_p1p1 = a[p1 * kLd + p1], a_p2p2 = a[p2 * kLd + p2];
      const float a_p1p2 = a[p1 * kLd + p2], a_p2p1 = a[p2 * kLd + p1];

      float c, s;
      rotation(app, aqq, apq, c, s);

      // The row phase's A[p][k], A[q][k]; the column phase's A[k][p],
      // A[k][q], whose inputs in rows p and q are the row phase's values
      // (the partner element recomputed from the scalars) and elsewhere the
      // values before.
      const float pq_row = rot_minus(c, s, apq, aqq);  // A[p][q] after the row phase
      const float qp_row = rot_plus(c, s, app, aqp);   // A[q][p] after the row phase
      const float wp = rot_minus(c, s, rp, rq);
      const float wq = rot_plus(c, s, rp, rq);
      const float yp = k == p ? wp : (k == q ? qp_row : cp);
      const float yq = k == p ? pq_row : (k == q ? wq : cq);
      const float xp = rot_minus(c, s, yp, yq);
      const float xq = rot_plus(c, s, yp, yq);
      // When the next rotation is (p, q + 1), its scalars are new values of
      // lanes p and q + 1: A[p][p] and A[q + 1][p] from the column phase,
      // A[p][q + 1] from the row phase; A[q + 1][q + 1] is as it was.
      const float s_pp = __shfl_sync(0xffffffffu, xp, p, kGroup);
      const float s_q1p = __shfl_sync(0xffffffffu, xp, q1, kGroup);
      const float s_pq1 = __shfl_sync(0xffffffffu, wp, q1, kGroup);
      __syncwarp();  // every read of the matrix before the rotation is done
      if (k != p && k != q) {  // the 2x2 block is the column phase's
        row_p[k] = wp;
        row_q[k] = wq;
      }
      row_k[p] = xp;
      row_k[q] = xq;
      if (lane == 0) cs[i] = make_float2(c, s);
      __syncwarp();  // every write before the reads of the matrix after it

      app = along ? s_pp : a_p1p1;
      aqq = along ? a_q1q1 : a_p2p2;
      apq = along ? s_pq1 : a_p1p2;
      aqp = along ? s_q1p : a_p2p1;
      if (reload) {
        app = a[np * kLd + np];
        aqq = a[nq * kLd + nq];
        apq = a[np * kLd + nq];
        aqp = a[nq * kLd + np];
      }
      p = np;
      q = nq;
    }
    rotate_row<N>(v, cs);  // the sweep's rotations on V
  }

  float d[N];
#pragma unroll
  for (int j = 0; j < N; ++j) d[j] = a[j * kLd + j];
  int rank[N];
  sorted_ranks<N>(d, rank);
  const int64_t at = b;
  if (lane < N) write_row<N>(d, rank, v, lane, evals + at * N, evecs + at * N * N);
}

template <int N>
int launch(const float* a, float* evals, float* evecs, const int batch, const int sweeps,
           const cudaStream_t stream) {
  if constexpr (N == 3) {
    const dim3 grid((batch + kBlockThreads - 1) / kBlockThreads);
    jacobi_eigh_thread_kernel<N><<<grid, kBlockThreads, 0, stream>>>(a, evals, evecs, batch, sweeps);
  } else {
    constexpr int kMats = kBlockThreads / kGroup;
    const dim3 grid((batch + kMats - 1) / kMats);
    jacobi_eigh_group_kernel<N><<<grid, kBlockThreads, 0, stream>>>(a, evals, evecs, batch, sweeps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (batch, n, n) row-major float32; evals: (batch, n); evecs: (batch, n, n).
// n must be 3, 9 or 12.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); a batch of 0 launches nothing.
extern "C" int jacobi_eigh_launch(const float* a, float* evals, float* evecs, int batch, int n,
                                  int sweeps, void* stream) {
  if (batch < 0 || sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 3:
      return launch<3>(a, evals, evecs, batch, sweeps, s);
    case 9:
      return launch<9>(a, evals, evecs, batch, sweeps, s);
    case 12:
      return launch<12>(a, evals, evecs, batch, sweeps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
