// Fused descriptor distance + row top-2 for Hopper (sm_90a).
//
// Replaces ergo_uvo_tpu/features/pallas_matcher.py::top2_distances_pallas.
// For each query row q_i it returns, over the valid train rows t_j:
//   min1[i] = min_j d(i, j),  idx1[i] = its j (ties -> lowest j),
//   min2[i] = min over j != idx1[i],
// with d(i, j) = max(|q_i|^2 + |t_j|^2 - 2 q_i.t_j, 0).  Masked train rows are
// skipped; a row with no valid column gets (+inf, 0, +inf).  The Q x T
// distance matrix never reaches device memory.
//
// What bounds it: on the main path Q = T = 512 and D = 64, i.e. 33.5 MFLOP on
// 256 KB of inputs.  That is microseconds of work for the card's FP32 pipes
// and its memory alike, so the kernel is bound by launch latency and by how
// little parallelism the problem has, not by FLOPs or bytes.  The design is
// therefore the simplest correct one:
//   * one block of 256 threads per tile of TQ = 16 query rows;
//   * the block walks the train set in tiles of TT = 64 rows and the depth in
//     chunks of DC = 32, staging both operands in shared memory, so any D
//     works with fixed shared memory (10,560 bytes);
//   * each row is served by 16 lanes; a lane owns train columns
//     j0 + lane + 16c (c = 0..3) of every tile, visited in rising j, and
//     accumulates the dot products and the train norms in fp32 FMA on the
//     CUDA cores (no TF32, no wgmma);
//   * each lane keeps a running (min1, idx1, min2) in registers and the 16
//     lanes of a row merge with warp shuffles: the winner is the lower
//     (d, j) pair and min2 = min(loser.min1, winner.min2).
// Tensor cores (wgmma / mma.sync on the QT^T tile), TMA staging and a wider
// grid for small Q are later work.
//
// Built by ergo_uvo_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C entry point below).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TQ = 16;            // query rows per block
constexpr int LANES = 16;         // threads per query row
constexpr int CPT = 4;            // train columns per lane per tile
constexpr int TT = LANES * CPT;   // train rows per tile
constexpr int DC = 32;            // depth chunk staged in shared memory
constexpr int THREADS = TQ * LANES;
constexpr int NO_INDEX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

struct Top2 {
  float m1;
  int i1;
  float m2;
};

__device__ __forceinline__ void push(Top2& a, float d, int j) {
  // j rises across calls, so a tie with m1 keeps the lower index in i1.
  if (d < a.m1) {
    a.m2 = a.m1;
    a.m1 = d;
    a.i1 = j;
  } else if (d < a.m2) {
    a.m2 = d;
  }
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_wins = (a.m1 < b.m1) || (a.m1 == b.m1 && a.i1 < b.i1);
  const Top2& w = a_wins ? a : b;
  const Top2& l = a_wins ? b : a;
  Top2 r;
  r.m1 = w.m1;
  r.i1 = w.i1;
  r.m2 = fminf(w.m2, l.m1);
  return r;
}

__global__ void __launch_bounds__(THREADS)
top2_kernel(const float* __restrict__ q, const float* __restrict__ t,
            const uint8_t* __restrict__ mask, float* __restrict__ min1,
            int* __restrict__ idx1, float* __restrict__ min2, int Q, int T,
            int D) {
  __shared__ float sq[TQ][DC + 1];
  __shared__ float st[TT][DC + 1];

  const int tid = threadIdx.x;
  const int r = tid / LANES;
  const int lane = tid % LANES;
  const int row0 = blockIdx.x * TQ;
  const int row = row0 + r;

  // |q|^2: the 16 lanes of a row split the depth, then reduce by shuffles
  // (xor offsets below 16 stay inside the row's half-warp).
  float qn = 0.f;
  if (row < Q) {
    for (int d = lane; d < D; d += LANES) {
      const float v = q[(size_t)row * D + d];
      qn = fmaf(v, v, qn);
    }
  }
  for (int off = LANES / 2; off > 0; off >>= 1) {
    qn += __shfl_xor_sync(FULL, qn, off);
  }

  Top2 best = {CUDART_INF_F, NO_INDEX, CUDART_INF_F};

  for (int j0 = 0; j0 < T; j0 += TT) {
    float acc[CPT];
    float tn[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[c] = 0.f;
      tn[c] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += DC) {
      for (int e = tid; e < TQ * DC; e += THREADS) {
        const int rr = e / DC, dd = e % DC;
        const int gr = row0 + rr, gd = d0 + dd;
        sq[rr][dd] = (gr < Q && gd < D) ? q[(size_t)gr * D + gd] : 0.f;
      }
      for (int e = tid; e < TT * DC; e += THREADS) {
        const int cc = e / DC, dd = e % DC;
        const int gc = j0 + cc, gd = d0 + dd;
        st[cc][dd] = (gc < T && gd < D) ? t[(size_t)gc * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float qv = sq[r][dd];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float tv = st[lane + c * LANES][dd];
          acc[c] = fmaf(qv, tv, acc[c]);
          tn[c] = fmaf(tv, tv, tn[c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + lane + c * LANES;
      if (j < T && mask[j]) {
        push(best, fmaxf(qn + tn[c] - 2.f * acc[c], 0.f), j);
      }
    }
  }

  for (int off = LANES / 2; off > 0; off >>= 1) {
    Top2 o;
    o.m1 = __shfl_xor_sync(FULL, best.m1, off);
    o.i1 = __shfl_xor_sync(FULL, best.i1, off);
    o.m2 = __shfl_xor_sync(FULL, best.m2, off);
    best = merge(best, o);
  }

  if (lane == 0 && row < Q) {
    const bool empty = best.i1 == NO_INDEX;
    min1[row] = empty ? CUDART_INF_F : best.m1;
    idx1[row] = empty ? 0 : best.i1;
    min2[row] = best.m2;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` (PyTorch's current
// stream), does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller sees a refused launch.  Q must be > 0.
extern "C" int top2_distances_launch(const float* q, const float* t,
                                     const uint8_t* mask, float* min1,
                                     int* idx1, float* min2, int Q, int T,
                                     int D, void* stream) {
  const dim3 grid((Q + TQ - 1) / TQ);
  top2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, t, mask, min1, idx1, min2, Q, T, D);
  return static_cast<int>(cudaGetLastError());
}
