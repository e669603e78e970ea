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
// What bounds it on an H100 SXM (fp32 FMA on the CUDA cores at 67 TFLOP/s,
// device memory at 3.35 TB/s; 2 Q T D operations on 4 (Q + T) D + T + 12 Q
// bytes, each input read once and each output written once; every train row
// valid here, and a masked row needs neither its operations nor its bytes,
// though this kernel spends both on it):
//   Q x T x D          operations   bytes       compute    memory
//   512 x 512 x 64     33.6 MFLOP   268,800     0.50 us    0.08 us
//   2048 x 2048 x 64   537 MFLOP    1,075,200   8.0 us     0.32 us
//   4096 x 4096 x 128  4.29 GFLOP   4,247,552   64 us      1.3 us
// Operations bound it at every shape, by 6x to 50x over the bytes.  The
// arithmetic stays fp32 FMA (no TF32, no tensor cores): d cancels for near
// matches and the ratio test compares two such values.  At 512 x 512 x 64
// the bound is below the time of an empty launch, so there the design is
// about filling the card and exposing one memory round trip, not more.
//
// Design:
//   * Fill the card.  A block of 128 threads scores TQ = 32 query rows
//     against a slice of the train set.  The S blocks of a query tile form
//     one thread-block cluster (grid (Q / 32, S), cluster (1, S, 1), S in
//     {1, 2, 4, 8}); rank s takes the columns [s * cols_per_rank,
//     (s + 1) * cols_per_rank).  The host doubles S while the grid does not
//     cover the SMs (512 x 512: 16 x 8 = 128 blocks; 4096 x 4096: 128 x 2).
//     Every rank writes its rows' partial (min1, idx1, min2) into rank 0's
//     shared memory over distributed shared memory, and after the cluster's
//     barrier rank 0 merges them and writes the result.  The merge takes the
//     lower (d, j) pair and min2 = min(winner.min2, loser.min1); it is
//     associative and commutative, so the result depends neither on S nor on
//     the order of the ranks.  An empty slice contributes
//     (+inf, NO_INDEX, +inf).
//   * Register tiles.  A thread owns 4 x 4 distances (query rows rg + 8 i,
//     train columns cg + 16 k).  Tiles lie row-major in shared memory with a
//     row stride of 4 (mod 32) floats, so a thread fetches four depths of a
//     row with one 16-byte load, and the rows a warp touches (4 query, 8
//     train) fall on distinct banks: 8 loads for 64 FMAs.  The scoring of a
//     finished tile is free of branches, since the lanes of a warp disagree
//     on most columns.
//   * Norms once a thread, not once a distance.  |t_j|^2 of a thread's four
//     columns is summed from the operands it has in registers anyway, 16 FMAs
//     beside the 64 of its tile; the mask is folded in when the tile is
//     scored (a masked or out-of-slice column is skipped).  |q_i|^2 is summed
//     once a block from the staged tile.  Summing the train norms from shared
//     memory once a block and tile took the same time on the card (the inner
//     loop is bound by shared-memory loads, not by the FMA pipes) and cost a
//     barrier a tile, so the registers keep them.
//   * Operands resident, copies asynchronous.  The query tile stays resident
//     at full depth; the train slice streams through a two-stage ring of
//     64-column x 64-depth chunks filled with 16-byte cp.async, so the next
//     chunk arrives while this one is scored, and at 512 x 512 x 64 a block
//     makes a single load round.  A query tile too deep to stay resident
//     rides the ring with the train chunks.  When D is not a multiple of 4 or
//     a base pointer is not 16-byte aligned, the chunks are staged with
//     4-byte loads instead; the scoring is the same.
// What is left on the table: with 4 x 4 tiles fetched four depths at a time
// the inner loop moves 2 bytes of shared memory per FMA, which caps it near
// half of the FMA rate; an 8 x 8 tile in this layout needs 64 operand
// registers, was tried and was no faster.  A depth-major layout (operands of
// one depth in 16 registers, double-buffered) is the known way past that.
//
// Built by ergo_uvo_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TQ = 32;       // query rows per block
constexpr int RQ = 4;        // query rows per thread: rg + NRG * i
constexpr int RC = 4;        // train columns per thread: cg + CG * k
constexpr int CG = 16;       // column groups
constexpr int NRG = TQ / RQ; // row groups
constexpr int TT = CG * RC;  // train columns per tile
constexpr int THREADS = NRG * CG;
constexpr int DC = 64;       // depths per staged chunk
constexpr int TS = DC + 4;   // row stride of a staged chunk, in floats
constexpr int LQ = THREADS / TQ;  // lanes that share a query row's norm
constexpr int MAX_SPLITS = 8;  // largest portable cluster
constexpr int MAX_DEVICES = 64;  // devices whose set-up is remembered
constexpr int RESIDENT_LIMIT = 100 * 1024;  // dynamic bytes that leave room for two blocks an SM
constexpr int NO_INDEX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

struct Top2 {
  float m1;
  int i1;
  float m2;
};

__device__ __forceinline__ void push(Top2& a, float d, int j) {
  // Without branches, since the lanes of a warp disagree on most columns.
  // j rises across calls, so a tie with m1 keeps the lower index in i1.
  // d < m1: m2 takes the old m1; otherwise m2 = min(m2, d).
  a.m2 = fminf(a.m2, fmaxf(d, a.m1));
  a.i1 = d < a.m1 ? j : a.i1;
  a.m1 = fminf(a.m1, d);
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

// 16 bytes global -> shared without passing through registers; `valid`
// false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [row0, row0 + ROWS) x depths [d0, d0 + DC) of the row-major
// (row_end, D) matrix `src` at dst[r * stride + d]; rows past row_end and
// depths past D become zeros.
template <int ROWS>
__device__ __forceinline__ void stage_chunk(float* dst, int stride, const float* __restrict__ src,
                                            int row0, int row_end, int d0, int D, bool vec16,
                                            int tid) {
  if (vec16) {
    // A thread copies the same 16 bytes of every RSTEP-th row.
    constexpr int RSTEP = THREADS / (DC / 4);
    const int v = tid % (DC / 4), r0 = tid / (DC / 4);
    const int gd = d0 + 4 * v;
    const bool depth_ok = gd < D;
    const float* from = src + (size_t)(row0 + r0) * D + gd;
    float* to = dst + r0 * stride + 4 * v;
    const size_t step = (size_t)RSTEP * D;
#pragma unroll
    for (int k = 0; k < ROWS / RSTEP; ++k) {
      const bool ok = depth_ok && row0 + r0 + k * RSTEP < row_end;
      cp_async16(to + k * RSTEP * stride, ok ? from : src, ok);
      from += step;
    }
  } else {
    for (int e = tid; e < ROWS * DC; e += THREADS) {
      const int r = e / DC, d = e % DC;
      const int gr = row0 + r, gd = d0 + d;
      dst[r * stride + d] = (gr < row_end && gd < D) ? src[(size_t)gr * D + gd] : 0.f;
    }
  }
}

// Sum of squares of depths [0, 4 * n4) of row tid / LANES, split over LANES
// neighbouring lanes; the caller reduces across them.  Lane p takes the
// 16-byte groups p * W + i + 8 m (i < W = 8 / LANES): rows lie 4 banks apart,
// so the 8 lanes that a 16-byte shared load serves at a time then fall on
// 8 distinct bank groups.
template <int LANES>
__device__ __forceinline__ float partial_norm(const float* tile, int stride, int n4, int tid) {
  constexpr int W = 8 / LANES;
  const float* row = tile + (tid / LANES) * stride;
  const int first = (tid % LANES) * W;
  float s = 0.f;
  for (int base = first; base < n4; base += 8) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (base + i < n4) {
        const float4 x = *reinterpret_cast<const float4*>(row + 4 * (base + i));
        s = fmaf(x.x, x.x, s);
        s = fmaf(x.y, x.y, s);
        s = fmaf(x.z, x.z, s);
        s = fmaf(x.w, x.w, s);
      }
    }
  }
  return s;
}

template <int LANES>
__device__ __forceinline__ float lanes_sum(float s) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(FULL, s, off);
  }
  return s;
}

__global__ void __launch_bounds__(THREADS, 4)
top2_kernel(const float* __restrict__ q, const float* __restrict__ t,
            const uint8_t* __restrict__ mask, float* __restrict__ min1,
            int* __restrict__ idx1, float* __restrict__ min2, int Q, int T, int D,
            int cols_per_rank, int q_resident, int vec16) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_qn[TQ];
  __shared__ Top2 s_half[TQ];               // the upper 8 column groups' partial result
  __shared__ Top2 s_ranks[MAX_SPLITS][TQ];  // in rank 0: every rank's partial result

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // A warp covers 4 row groups x 8 column groups.
  const int cgp = (warp & 1) * 8 + (lane & 7);
  const int rg = (warp >> 1) * 4 + (lane >> 3);
  const int row0 = blockIdx.x * TQ;
  const int jb = min(T, rank * cols_per_rank);
  const int je = min(T, jb + cols_per_rank);
  // Shared memory of another block may be written only once that block runs:
  // arrive now, wait just before the partial results go to rank 0.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  const int NC = max(1, (D + DC - 1) / DC);
  const int nit = ((je - jb + TT - 1) / TT) * NC;
  const int qs = q_resident ? NC * DC + 4 : TS;
  float* sq = smem;  // resident: [TQ][qs]; riding the ring: 2 x [TQ][TS]
  float* st = smem + (q_resident ? TQ * qs : 2 * TQ * TS);  // 2 x [TT][TS]

  // Copies of iteration `it` = (tile jt, depth chunk c) into stage it & 1.
  auto copy_in = [&](int it, int jt, int c) {
    const int s = it & 1;
    if (q_resident) {
      if (it == 0) {
        for (int cc = 0; cc < NC; ++cc) {
          stage_chunk<TQ>(sq + cc * DC, qs, q, row0, Q, cc * DC, D, vec16, tid);
        }
      }
    } else {
      stage_chunk<TQ>(sq + s * TQ * TS, TS, q, row0, Q, c * DC, D, vec16, tid);
    }
    stage_chunk<TT>(st + s * TT * TS, TS, t, jb + jt * TT, je, c * DC, D, vec16, tid);
    cp_async_commit();
  };

  Top2 best[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    best[i] = {CUDART_INF_F, NO_INDEX, CUDART_INF_F};
  }
  float acc[RQ][RC];
  float tn[RC];         // |t_j|^2 of the thread's columns
  bool col_valid[RC];
  float qn_part = 0.f;

  if (nit > 0) copy_in(0, 0, 0);
  for (int it = 0, jt = 0, c = 0; it < nit; ++it) {
    const int s = it & 1;
    const bool last_chunk = c == NC - 1;
    const int jt_next = last_chunk ? jt + 1 : jt, c_next = last_chunk ? 0 : c + 1;
    // Chunk `it` has landed and every thread is done with chunk it - 1, whose
    // stage the next copies overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < nit) copy_in(it + 1, jt_next, c_next);

    const float* cq = q_resident ? sq + c * DC : sq + s * TQ * TS;
    const float* ct = st + s * TT * TS;
    const int n4 = (min(DC, D - c * DC) + 3) / 4;
    if (c == 0) {
#pragma unroll
      for (int k = 0; k < RC; ++k) {
        // The mask is asked for now and needed when the tile's depth is complete.
        const int j = jb + jt * TT + cgp + CG * k;
        col_valid[k] = j < je && mask[j] != 0;
        tn[k] = 0.f;
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][k] = 0.f;
      }
    }
    if (jt == 0) qn_part += partial_norm<LQ>(cq, qs, n4, tid);

#pragma unroll 2
    for (int v = 0; v < n4; ++v) {
      float4 b[RC];
#pragma unroll
      for (int k = 0; k < RC; ++k) {
        b[k] = *reinterpret_cast<const float4*>(ct + (cgp + CG * k) * TS + 4 * v);
        tn[k] = fmaf(b[k].x, b[k].x, tn[k]);
        tn[k] = fmaf(b[k].y, b[k].y, tn[k]);
        tn[k] = fmaf(b[k].z, b[k].z, tn[k]);
        tn[k] = fmaf(b[k].w, b[k].w, tn[k]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(cq + (rg + NRG * i) * qs + 4 * v);
#pragma unroll
        for (int k = 0; k < RC; ++k) {
          acc[i][k] = fmaf(a.x, b[k].x, acc[i][k]);
          acc[i][k] = fmaf(a.y, b[k].y, acc[i][k]);
          acc[i][k] = fmaf(a.z, b[k].z, acc[i][k]);
          acc[i][k] = fmaf(a.w, b[k].w, acc[i][k]);
        }
      }
    }

    if (last_chunk) {
      // The tile's depth is complete: score its columns.
      if (jt == 0) {
        const float qn_row = lanes_sum<LQ>(qn_part);
        if (tid % LQ == 0) s_qn[tid / LQ] = qn_row;
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < RC; ++k) {
        const int j = jb + jt * TT + cgp + CG * k;
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float d = fmaxf(s_qn[rg + NRG * i] + tn[k] - 2.f * acc[i][k], 0.f);
          push(best[i], col_valid[k] ? d : CUDART_INF_F, j);
        }
      }
    }
    jt = jt_next;
    c = c_next;
  }

  // Merge: the 8 lanes of a row group in this warp by shuffles, the two
  // warps that share the row group through s_half, and the cluster's ranks
  // through rank 0's s_ranks, which every rank writes over distributed
  // shared memory before the cluster's barrier.
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      Top2 o;
      o.m1 = __shfl_xor_sync(FULL, best[i].m1, off);
      o.i1 = __shfl_xor_sync(FULL, best[i].i1, off);
      o.m2 = __shfl_xor_sync(FULL, best[i].m2, off);
      best[i] = merge(best[i], o);
    }
    if ((lane & 7) == 0 && (warp & 1) == 1) s_half[rg + NRG * i] = best[i];
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if ((lane & 7) == 0 && (warp & 1) == 0) {
    Top2* to_rank0 = cluster.map_shared_rank(&s_ranks[rank][0], 0);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      to_rank0[rg + NRG * i] = merge(best[i], s_half[rg + NRG * i]);
    }
  }
  // Rank 0 outlives the writes into its shared memory; the others may leave.
  cluster.sync();
  if (rank == 0 && tid < TQ && row0 + tid < Q) {
    Top2 r = s_ranks[0][tid];
    for (int k = 1; k < nranks; ++k) r = merge(r, s_ranks[k][tid]);
    const bool empty = r.i1 == NO_INDEX;
    min1[row0 + tid] = empty ? CUDART_INF_F : r.m1;
    idx1[row0 + tid] = empty ? 0 : r.i1;
    min2[row0 + tid] = r.m2;
  }
}

struct Plan {
  int splits;         // cluster size S
  int query_tiles;    // grid.x
  int cols_per_rank;
  int q_resident;
  int smem_bytes;     // dynamic shared memory
};

// The SM count of each device, asked for once.
int sm_count(int device) {
  static int cached[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return 132;
  if (cached[device] == 0) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached[device] = sms;
  }
  return cached[device];
}

// splits 0: chosen here from the shape.
Plan make_plan(int Q, int T, int D, int splits, int sms) {
  const int train_tiles = (T + TT - 1) / TT;
  Plan p;
  p.query_tiles = (Q + TQ - 1) / TQ;
  if (splits == 0) {
    // Double S while the grid does not cover the SMs and every rank still
    // gets a whole tile.
    splits = 1;
    while (2 * splits <= MAX_SPLITS && 2 * splits <= train_tiles &&
           p.query_tiles * splits < sms) {
      splits *= 2;
    }
  }
  p.splits = splits;
  const int per_rank = (T + splits - 1) / splits;
  p.cols_per_rank = (per_rank + TT - 1) / TT * TT;
  const int chunks = D > DC ? (D + DC - 1) / DC : 1;
  const int ring_t = 2 * TT * TS;
  const int resident = (TQ * (chunks * DC + 4) + ring_t) * static_cast<int>(sizeof(float));
  p.q_resident = resident <= RESIDENT_LIMIT ? 1 : 0;
  p.smem_bytes = p.q_resident ? resident
                              : (2 * TQ * TS + ring_t) * static_cast<int>(sizeof(float));
  return p;
}

// Launches on `stream`, does not synchronise, allocates nothing, and returns
// the first CUDA error of the set-up or the launch.  Q must be > 0.
int launch(const float* q, const float* t, const uint8_t* mask, float* min1, int* idx1,
           float* min2, int Q, int T, int D, int splits, void* stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(Q, T, D, splits, sm_count(device));
  const int vec16 = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(t) % 16 == 0;
  if (p.smem_bytes > 44 * 1024) {
    // Above 48 KB together with the static arrays, shared memory is opt-in:
    // once a device, for the most that the resident plan can ask for.
    static bool opted_in[MAX_DEVICES] = {};
    const bool known = device >= 0 && device < MAX_DEVICES;
    if (!known || !opted_in[device]) {
      err = cudaFuncSetAttribute(top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 RESIDENT_LIMIT);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (known) opted_in[device] = true;
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.query_tiles, p.splits, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, top2_kernel, q, t, mask, min1, idx1, min2, Q, T, D,
                           p.cols_per_rank, p.q_resident, vec16);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points for ctypes.
//
// top2_distances_launch is the one the matcher calls: the cluster size comes
// from the shape.  It launches on `stream` (PyTorch's current stream), does
// not synchronise, allocates nothing, and returns the first CUDA error of the
// set-up or the launch, so the caller sees a refused launch.  Q must be > 0.
extern "C" int top2_distances_launch(const float* q, const float* t, const uint8_t* mask,
                                     float* min1, int* idx1, float* min2, int Q, int T, int D,
                                     void* stream) {
  return launch(q, t, mask, min1, idx1, min2, Q, T, D, 0, stream);
}

// The same launch under a given cluster size (1, 2, 4 or 8), for the checks
// that the merge across ranks gives the same bits whatever the size, and for
// timing the sizes against each other.
extern "C" int top2_distances_launch_forced(const float* q, const float* t, const uint8_t* mask,
                                            float* min1, int* idx1, float* min2, int Q, int T,
                                            int D, int splits, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(q, t, mask, min1, idx1, min2, Q, T, D, splits, stream);
}

// What top2_distances_launch would use at this shape on the current device:
// out[0..4] = cluster size S, query tiles (grid.x), columns per rank, whether
// the query tile stays resident, dynamic shared memory in bytes.
extern "C" void top2_distances_plan(int Q, int T, int D, int* out) {
  int device = 0;
  cudaGetDevice(&device);
  const Plan p = make_plan(Q, T, D, 0, sm_count(device));
  out[0] = p.splits;
  out[1] = p.query_tiles;
  out[2] = p.cols_per_rank;
  out[3] = p.q_resident;
  out[4] = p.smem_bytes;
}
