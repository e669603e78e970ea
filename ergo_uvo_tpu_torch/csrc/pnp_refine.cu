// PnP refinement on Hopper (sm_90a): the robust Gauss-Newton polish of the
// RANSAC winner in ergo_uvo_tpu_torch/estimation/pnp.py, in one launch.
//
// Replaces no TPU kernel: the JAX package's gauss_newton_pnp
// (ergo_uvo_tpu/estimation/pnp.py:99) is jnp code that XLA fuses under
// jax.jit.  Eager PyTorch runs the same refinement (8 rounds of Cauchy
// reweighting, 4 Gauss-Newton steps a round, the final divergence check) as
// ~3,460 launches a stereo pair, 72% of the pair's launches: each a few
// microseconds of device work behind ~30 us of host time, so the host's
// launches bound it, not the card.
//
// What bounds it on an H100 SXM: not bytes (N = 512 slots are ~12 KB, read
// from L1 every step) nor operations (~150 fp32 operations a slot and step,
// 2.5 MFLOP in all, ~0.04 us at 67 TFLOP/s), but latency: 32 dependent steps,
// each a reduction over the slots into 27 numbers and a 6x6 solve on them,
// then the pose update that the next step reads.  The design keeps that
// chain inside one block of 512 threads: a thread a slot (a stride over the
// slots when N is larger), the 27 sums by warp shuffles and then across the
// warps through shared memory, the solve and the pose update by one thread,
// the new pose handed to all through shared memory; two block barriers a
// step, no launch, no host round trip.
//
// The arithmetic is the plain chain's, in float32, step for step:
//   * masked-out slots take X = (0, 0, 1), xy = (0, 0);
//   * a round's weights from _reproj_error_sq (|z| < 1e-9 guarded, +inf
//     behind the camera): r = sqrt(max(r2, 1e-12)), w = 1 / (1 + (r/delta)^2),
//     0 unless mask & isfinite(r2) & r < support;
//   * a step: pc = R X + t, z clamped at 1e-6, the 2x6 Jacobian
//     d(pixel)/d(pc) [I | -[pc]x], J^T W J (upper triangle) and J^T W r; the
//     damped system J^T W J + 1e-6 I solved by LU with partial pivoting (the
//     first largest |pivot| of a column, as getrf; no singularity check, so
//     a singular system spreads non-finite numbers as solve_ex's does);
//     xi = -solution, dR = so3_exp(xi[3:]) with its theta2 < 1e-12 Taylor
//     branch, R <- dR R, t <- dR t + xi[:3];
//   * the final check: inliers of the refined pose under thr2, its count
//     against the RANSAC winner's, better = finite(R, t) & 2 n_ref >= n_in.
// Every clamp keeps NaN, as torch.clamp does.  The sums run in another order
// than cuBLAS's and cuSOLVER's, so the pose agrees with the plain chain to
// rounding, not bit for bit; the order is fixed, so a launch repeats its
// bits.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // J^T W J's upper triangle (21), then J^T W r (6)
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSmemDefault = 48 * 1024;

struct Args {
  const float* Rs;         // (m, 3, 3) RANSAC candidates
  const float* ts;         // (m, 3)
  const long long* best;   // () the winner's index
  const float* K;          // (3, 3)
  const float* X;          // (n, 3)
  const float* xy;         // (n, 2)
  const uint8_t* mask;     // (n,)
  const uint8_t* inliers;  // (n,) the winner's inliers
  int n, m, rounds, steps, min_inliers;
  float thr2, delta, support;
  float* R_out;            // (3, 3)
  float* t_out;            // (3,)
  uint8_t* inl_out;        // (n,)
  uint8_t* success;        // ()
  uint8_t* better;         // ()
};

struct Camera {
  float fx, fy, cx, cy;
};

struct Pose {
  float R[9];
  float t[3];
};

// A slot as the plain chain sees it after X_safe / xy_safe.
struct Slot {
  float X[3];
  float u, v;
  bool on;
};

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(const float x, const float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ Slot load_slot(const Args& a, const int i) {
  Slot s;
  s.on = a.mask[i] != 0;
  s.X[0] = s.on ? a.X[3 * i] : 0.0f;
  s.X[1] = s.on ? a.X[3 * i + 1] : 0.0f;
  s.X[2] = s.on ? a.X[3 * i + 2] : 1.0f;
  s.u = s.on ? a.xy[2 * i] : 0.0f;
  s.v = s.on ? a.xy[2 * i + 1] : 0.0f;
  return s;
}

__device__ __forceinline__ void camera_point(const Pose& p, const float X[3], float pc[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    pc[r] = p.R[3 * r] * X[0] + p.R[3 * r + 1] * X[1] + p.R[3 * r + 2] * X[2] + p.t[r];
  }
}

// _reproj_error_sq: the squared pixel error, +inf behind the camera.
__device__ __forceinline__ float reproj_error_sq(const Pose& p, const Camera& c, const Slot& s) {
  float pc[3];
  camera_point(p, s.X, pc);
  const float z = pc[2];
  const float safe_z = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float du = (pc[0] / safe_z) * c.fx + c.cx - s.u;
  const float dv = (pc[1] / safe_z) * c.fy + c.cy - s.v;
  return z > 0.0f ? du * du + dv * dv : INFINITY;
}

__device__ __forceinline__ float cauchy_weight(const Pose& p, const Camera& c, const Slot& s,
                                               const float inv_delta, const float support) {
  const float r2 = reproj_error_sq(p, c, s);
  const float r = sqrtf(clamp_min(r2, 1e-12f));
  const float q = r * inv_delta;
  const float w = 1.0f / (1.0f + q * q);
  return (s.on && isfinite(r2) && r < support) ? w : 0.0f;
}

// One slot's share of J^T W J (upper triangle, row by row) and J^T W r.
__device__ __forceinline__ void accumulate(const Pose& p, const Camera& c, const Slot& s, const float w,
                                           float acc[kSums]) {
  float pc[3];
  camera_point(p, s.X, pc);
  const float inv_z = 1.0f / clamp_min(pc[2], 1e-6f);
  const float xn = pc[0] * inv_z;
  const float yn = pc[1] * inv_z;
  const float ru = c.fx * xn + c.cx - s.u;
  const float rv = c.fy * yn + c.cy - s.v;
  // d(pixel)/d(pc) = [[a, 0, cu], [0, b, cv]] times [I | -[pc]x].
  const float a = c.fx * inv_z, cu = -c.fx * xn * inv_z;
  const float b = c.fy * inv_z, cv = -c.fy * yn * inv_z;
  const float J0[6] = {a, 0.0f, cu, cu * pc[1], a * pc[2] - cu * pc[0], -a * pc[1]};
  const float J1[6] = {0.0f, b, cv, cv * pc[1] - b * pc[2], -cv * pc[0], b * pc[0]};
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = J0[i] * w, w1 = J1[i] * w;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += w0 * J0[j] + w1 * J1[j];
    acc[21 + i] += w0 * ru + w1 * rv;
  }
}

// (J^T W J + 1e-6 I) x = J^T W r by LU with partial pivoting on the augmented
// system; returns xi = -x.  Fully unrolled, so the matrix stays in registers.
__device__ __forceinline__ void solve_step(const float* sums, float xi[6]) {
  float a[6][7];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      a[i][j] = sums[k];
      a[j][i] = sums[k];
      ++k;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a[i][i] += 1e-6f;
    a[i][6] = sums[21 + i];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float largest = fabsf(a[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabsf(a[r][c]) > largest) {
        largest = fabsf(a[r][c]);
        p = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int j = c; j < 7; ++j) {
          const float tmp = a[c][j];
          a[c][j] = a[r][j];
          a[r][j] = tmp;
        }
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float l = a[r][c] / a[c][c];
#pragma unroll
      for (int j = c + 1; j < 7; ++j) a[r][j] -= l * a[c][j];
    }
  }
  float x[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = a[i][6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= a[i][j] * x[j];
    x[i] = s / a[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = -x[i];
}

// R <- so3_exp(xi[3:]) R, t <- so3_exp(xi[3:]) t + xi[:3].
__device__ __forceinline__ void update_pose(Pose& p, const float xi[6]) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(clamp_min(theta2, 1e-24f));
  const bool small = theta2 < 1e-12f;
  const float sa = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float sb = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float dR[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float ww = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
      dR[3 * i + j] = ((i == j ? 1.0f : 0.0f) + sa * W[3 * i + j]) + sb * ww;
    }
  }
  Pose q;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q.R[3 * i + j] = dR[3 * i] * p.R[j] + dR[3 * i + 1] * p.R[3 + j] + dR[3 * i + 2] * p.R[6 + j];
    }
    q.t[i] = (dR[3 * i] * p.t[0] + dR[3 * i + 1] * p.t[1] + dR[3 * i + 2] * p.t[2]) + xi[i];
  }
  p = q;
}

__device__ __forceinline__ void load_pose(Pose& p, const float* src) {
#pragma unroll
  for (int i = 0; i < 9; ++i) p.R[i] = src[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) p.t[i] = src[9 + i];
}

__global__ void __launch_bounds__(kThreads, 1) pnp_refine_kernel(const Args a) {
  extern __shared__ float weight[];  // (n,): each slot's weight in the current round
  __shared__ float partial[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ float shared_pose[12];
  __shared__ int counts[2];  // inliers of the refined pose, of the RANSAC winner

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Camera cam{a.K[0], a.K[4], a.K[2], a.K[5]};
  const float inv_delta = 1.0f / a.delta;

  const long long best = *a.best;
  if (best < 0 || best >= a.m) __trap();  // as an index out of range in Rs[best]
  Pose start;
#pragma unroll
  for (int i = 0; i < 9; ++i) start.R[i] = a.Rs[9 * best + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) start.t[i] = a.ts[3 * best + i];
  Pose pose = start;

  for (int round = 0; round < a.rounds; ++round) {
    // Each thread weighs and later reads only its own slots: no barrier.
    for (int i = tid; i < a.n; i += kThreads) {
      weight[i] = cauchy_weight(pose, cam, load_slot(a, i), inv_delta, a.support);
    }
    for (int step = 0; step < a.steps; ++step) {
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
      for (int i = tid; i < a.n; i += kThreads) accumulate(pose, cam, load_slot(a, i), weight[i], acc);
      // A fixed order: the warp's lanes by shuffles, then the warps in turn.
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFullMask, acc[k], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) partial[warp][k] = acc[k];
      }
      __syncthreads();
      if (tid < kSums) {
        float s = partial[0][tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += partial[w][tid];
        sums[tid] = s;
      }
      __syncwarp();
      if (tid == 0) {
        float xi[6];
        solve_step(sums, xi);
        update_pose(pose, xi);
#pragma unroll
        for (int i = 0; i < 9; ++i) shared_pose[i] = pose.R[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) shared_pose[9 + i] = pose.t[i];
      }
      __syncthreads();
      load_pose(pose, shared_pose);
    }
  }

  // The final check: keep the refinement unless it diverged.
  if (tid == 0) counts[0] = counts[1] = 0;
  __syncthreads();
  int n_ref = 0, n_in = 0;
  for (int i = tid; i < a.n; i += kThreads) {
    const Slot s = load_slot(a, i);
    n_ref += (s.on && reproj_error_sq(pose, cam, s) <= a.thr2) ? 1 : 0;
    n_in += a.inliers[i] != 0 ? 1 : 0;
  }
  if (n_ref) atomicAdd(&counts[0], n_ref);
  if (n_in) atomicAdd(&counts[1], n_in);
  __syncthreads();
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) finite = finite && isfinite(pose.R[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) finite = finite && isfinite(pose.t[i]);
  const bool better = finite && 2LL * counts[0] >= counts[1];
  for (int i = tid; i < a.n; i += kThreads) {
    const Slot s = load_slot(a, i);
    const bool refined = s.on && reproj_error_sq(pose, cam, s) <= a.thr2;
    a.inl_out[i] = better ? refined : a.inliers[i] != 0;
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) a.R_out[i] = better ? pose.R[i] : start.R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) a.t_out[i] = better ? pose.t[i] : start.t[i];
    *a.success = (better ? counts[0] : counts[1]) >= a.min_inliers;
    *a.better = better;
  }
}

}  // namespace

// One launch on `stream`; returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for sizes it cannot take.  Float buffers are
// contiguous float32, masks one byte a slot (torch.bool), `best` int64.
extern "C" int pnp_refine(const float* Rs, const float* ts, const long long* best, const float* K,
                          const float* X, const float* xy, const uint8_t* mask, const uint8_t* inliers,
                          int n, int m, int rounds, int steps, float thr2, float delta, float support,
                          int min_inliers, float* R_out, float* t_out, uint8_t* inl_out, uint8_t* success,
                          uint8_t* better, void* stream) {
  if (n < 0 || m < 1 || rounds < 0 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (n > 0 ? n : 1);
  if (smem > kSmemDefault) {
    const cudaError_t err =
        cudaFuncSetAttribute(pnp_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{Rs,    ts,    best,  K,       X,       xy,    mask,    inliers, n,      m,     rounds,
               steps, min_inliers, thr2, delta, support, R_out, t_out, inl_out, success, better};
  pnp_refine_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
