// Fused contrastive objectives of a batch of Q mini-batches (one per
// proxy lane), forward only.
//
// Replaces the Pallas kernel _contrastive_kernel
// (src/repro/kernels/contrastive/contrastive.py, contrastive_losses).
// For each lane: normalize z_q and z_d; qsim = query-anchored InfoNCE
// (mean over positives); the (n, n) similarities; supcon = masked-LSE
// supervised contrastive over anchors with a non-empty U(i); polar =
// bellwether rows (the weakest positive and the hardest negative w.r.t.
// the query, first index on a tie) -> out[q] = [qsim, supcon, polar,
// lam * supcon + (1 - lam) * polar].
//
// What bounds it: ~2 MFLOP per lane at n=128, p=64 (0.00013 ms at the
// FP32 peak for Q=4), so a launch is bound by launch latency and by the
// serial depth of its reductions, never by bytes or arithmetic. The
// design therefore spreads each lane over many blocks and keeps every
// chain of dependent steps short.
//
// Design. Two kernels behind one entry point, on one stream.
//  rows:   grid (Q, ceil(n / R)), R = 8 anchor rows a block (64 blocks at
//          the training path's Q=4, n=128; 64 at Q=1, n=512). Every block
//          of a lane
//          1. issues at once every load that waits on nothing: the first
//             tile of rows, the labels, its R anchor rows (warp w: anchor
//             w) and z_q; normalizes z_q (every warp alike) and the
//             anchors into shared memory;
//          2. streams all n rows of the lane through shared memory in
//             tiles of 256 rows x 32 columns (row stride 33, so threads
//             reading different rows hit different banks; the next tile
//             is fetched into registers while this one is used), and
//             each thread, one row j, accumulates in registers |z_j|^2,
//             z_j . zqn and the R dot products z_j . zan_r against the
//             normalized anchors: sims_q[j] = (z_j . zqn / |z_j|) / tau
//             and sims[r][j] = (z_j . zan_r / |z_j|) / tau. No pair
//             needs a warp reduction;
//          3. picks the bellwethers i_pos / i_neg from sims_q (warp 0,
//             first index on a tie). sims_q comes from the same code in
//             every block, independent of blockIdx.y, with the same
//             summation order, so every block holds the same bits and
//             agrees on the bellwethers. Block 0 of the lane also folds
//             qsim (warp 1);
//          4. warp w folds anchor i0 + w's row of sims (from shared
//             memory, lane-strided over j) into online log-sum-exp
//             states: U (same label, j != i), A (j != i) and, where the
//             anchor is a bellwether, the polar states with the diagonal
//             included (as the Pallas kernel's `ones` mask does); then one
//             warp merge per state, and lane 0 writes (per_anchor, valid)
//             and, for a bellwether, its polar term.
//  finish: grid Q. Sums where(valid, per_anchor, 0) over the anchors in
//          index order (one thread, a fixed order, no atomics: two calls
//          on the same inputs give the same bits) and writes out[q].
// Partials, float32 (Q, 2n + 4) a call: [per_anchor (n) | valid as 0/1
// (n) | qsim, n_pos, loss_p, loss_n]. Every slot is written by exactly one
// block of the rows kernel.
//
// Shared memory of a rows block (static, the same at every shape):
// tile 256 x 33 floats (33.8 KB; reused as the (R, 512) sims after the
// row pass), normalized anchors 256 x 8 (8 KB), zqn 1 KB, sims_q 2 KB,
// labels 0.5 KB: 45.6 KB at n=128, p=64 and at n=512, p=256 alike; a
// lane of n=512, p=256 (512 KB) never has to fit, since it streams.
//
// The arithmetic is the Pallas kernel's; only the order of f32 sums and
// where the norms divide differ (dot products of raw rows with normalized
// anchors, divided by |z_j|), so the plain PyTorch version
// (kernels/contrastive/ref.py, ref_losses) is the kernel's plain version.
// Empty masks give an LSE of -inf, as the Pallas kernel's _lse does, and
// every degenerate case (no positives, no negatives, an anchor with
// empty U(i)) is masked with a select, never a multiply by a 0/1 mask, so
// an inf never meets a 0. Takes every shape the Pallas kernel takes:
// n <= 512, p <= 256, any Q.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = WARPS;               // anchor rows a block: one warp each
constexpr int TJ = THREADS;            // rows a tile: one thread each
constexpr int PK = 32;                 // columns a tile
constexpr int ITEMS = TJ * PK / THREADS;
constexpr int MAX_N = 512;
constexpr int MAX_P = 256;
constexpr int FINISH_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_N <= 2 * TJ, "a thread holds at most two rows");
static_assert(R * MAX_N <= TJ * (PK + 1), "the sims reuse the tile");
static_assert(MAX_P / 32 == WARPS, "warp w writes zqn's w-th 32 columns");

struct Lse {
  float m, s;   // running max and sum of exp(v - m); empty = (-inf, 0)
};

__device__ __forceinline__ Lse lse_empty() { return {-INFINITY, 0.0f}; }

__device__ __forceinline__ void lse_add(Lse& a, float v) {
  if (v > a.m) {
    a.s = a.s * expf(a.m - v) + 1.0f;
    a.m = v;
  } else {
    a.s += expf(v - a.m);
  }
}

__device__ __forceinline__ float lse_value(const Lse& a) {
  return a.m == -INFINITY ? -INFINITY : a.m + logf(a.s);
}

__device__ __forceinline__ Lse lse_merge(const Lse& a, const Lse& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return lse_empty();
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// Butterfly sums leave each lane with the same terms added in another
// order; broadcasting lane 0's result keeps the whole warp consistent.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0);
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ Lse warp_lse(Lse a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Lse b{__shfl_xor_sync(FULL, a.m, o), __shfl_xor_sync(FULL, a.s, o)};
    a = lse_merge(a, b);
  }
  return {__shfl_sync(FULL, a.m, 0), __shfl_sync(FULL, a.s, 0)};
}

// (value, index) reductions that keep the FIRST index on a tie, as
// jnp.argmin / jnp.argmax do.
__device__ __forceinline__ bool better_min(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}
__device__ __forceinline__ bool better_max(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Columns [k0, k0 + PK) of the tile's rows into registers: warp w takes
// rows w, w + 8, ..., lane c column k0 + c (one coalesced row a load).
__device__ __forceinline__ void fetch(float (&v)[ITEMS],
                                      const float* __restrict__ zd, int j0,
                                      int rows, int p, int k0) {
  const int warp = threadIdx.x / 32, c = k0 + threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int r = u * WARPS + warp;
    v[u] = (r < rows && c < p) ? __ldg(zd + (size_t)(j0 + r) * p + c)
                               : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
contrastive_rows_kernel(const float* __restrict__ zq,
                        const float* __restrict__ zd,
                        const float* __restrict__ y, float* __restrict__ part,
                        int n, int p, float tau) {
  __shared__ __align__(16) float tile_s[TJ * (PK + 1)];
  __shared__ __align__(16) float anc_s[MAX_P * R];   // [k][r]
  __shared__ float zqn_s[MAX_P];
  __shared__ float simq_s[MAX_N];
  __shared__ bool pos_s[MAX_N];
  __shared__ int bell_s[2];          // i_pos, i_neg

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = blockIdx.y * R;
  zq += (size_t)blockIdx.x * p;
  zd += (size_t)blockIdx.x * n * p;
  y += (size_t)blockIdx.x * n;
  part += (size_t)blockIdx.x * (2 * n + 4);

  // 1. every load that needs nothing before it is issued at once: the
  //    first tile of rows, the labels, the block's anchor row (warp w:
  //    anchor i0 + w) and z_q (every warp, which also computes |z_q|)
  const int kch = (p + PK - 1) / PK, chunks = (n + TJ - 1) / TJ * kch;
  float v[ITEMS];
  fetch(v, zd, 0, min(n, TJ), p, 0);
  const int i = i0 + warp;
  float a[MAX_P / 32], zv[MAX_P / 32];
#pragma unroll
  for (int u = 0; u < MAX_P / 32; ++u) {
    const int k = lane + 32 * u;
    a[u] = (i < n && k < p) ? zd[(size_t)i * p + k] : 0.0f;
    zv[u] = k < p ? zq[k] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < MAX_N / THREADS; ++u) {
    const int j = tid + THREADS * u;
    if (j < n) pos_s[j] = y[j] > 0.5f;
  }
  float sa = 0.0f, sq = 0.0f;
#pragma unroll
  for (int u = 0; u < MAX_P / 32; ++u) {
    sa = fmaf(a[u], a[u], sa);
    sq = fmaf(zv[u], zv[u], sq);
  }
  const float na = sqrtf(fmaxf(warp_sum(sa), 1e-16f));
  const float nq = sqrtf(fmaxf(warp_sum(sq), 1e-16f));
#pragma unroll
  for (int u = 0; u < MAX_P / 32; ++u) {
    const int k = lane + 32 * u;
    if (k < p) {
      anc_s[k * R + warp] = a[u] / na;
      if (u == warp) zqn_s[k] = zv[u] / nq;
    }
  }

  // 2. the row pass over chunks of (TJ rows, PK columns), each fetched
  //    into registers while the one before it is used; thread t holds row
  //    t of the tile: sims_q for all n rows, the block's (R, n) sims
  float s0[R] = {}, s1[R] = {};
  float ss = 0.0f, dq = 0.0f, d[R] = {};
  for (int ci = 0; ci < chunks; ++ci) {
    const int j0 = ci / kch * TJ, k0 = ci % kch * PK;
    const int rows = min(TJ, n - j0);
    if (k0 == 0) {
      ss = 0.0f;
      dq = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = 0.0f;
    }
    __syncthreads();        // the chunk before has been read (and, at the
                            // first, step 1's shared writes are published)
#pragma unroll
    for (int u = 0; u < ITEMS; ++u)
      tile_s[(u * WARPS + warp) * (PK + 1) + lane] = v[u];
    __syncthreads();
    if (ci + 1 < chunks) {
      const int jn = (ci + 1) / kch * TJ;
      fetch(v, zd, jn, min(TJ, n - jn), p, (ci + 1) % kch * PK);
    }
    if (tid < rows) {
      const float* row = tile_s + tid * (PK + 1);
      const int kw = min(PK, p - k0);
#pragma unroll 4
      for (int c = 0; c < kw; ++c) {
        const float x = row[c];
        const int k = k0 + c;
        ss = fmaf(x, x, ss);
        dq = fmaf(x, zqn_s[k], dq);
        const float4 a0 = *reinterpret_cast<const float4*>(anc_s + k * R);
        const float4 a1 = *reinterpret_cast<const float4*>(anc_s + k * R + 4);
        d[0] = fmaf(x, a0.x, d[0]);
        d[1] = fmaf(x, a0.y, d[1]);
        d[2] = fmaf(x, a0.z, d[2]);
        d[3] = fmaf(x, a0.w, d[3]);
        d[4] = fmaf(x, a1.x, d[4]);
        d[5] = fmaf(x, a1.y, d[5]);
        d[6] = fmaf(x, a1.z, d[6]);
        d[7] = fmaf(x, a1.w, d[7]);
      }
      if (k0 + PK >= p) {           // the row is complete
        const float nrm = sqrtf(fmaxf(ss, 1e-16f));
        simq_s[j0 + tid] = (dq / nrm) / tau;
        if (j0 == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) s0[r] = (d[r] / nrm) / tau;
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) s1[r] = (d[r] / nrm) / tau;
        }
      }
    }
  }
  __syncthreads();                   // sims_q complete; the tile is free
  float* sims_s = tile_s;            // [r][j], row stride MAX_N
  if (tid < n) {
#pragma unroll
    for (int r = 0; r < R; ++r) sims_s[r * MAX_N + tid] = s0[r];
  }
  if (TJ + tid < n) {
#pragma unroll
    for (int r = 0; r < R; ++r) sims_s[r * MAX_N + TJ + tid] = s1[r];
  }

  // 3. bellwethers (warp 0, every block); qsim and n_pos (warp 1, block 0)
  if (warp == 0) {
    int ipos = MAX_N, ineg = MAX_N;
    float vpos = INFINITY, vneg = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = simq_s[j];
      const float ps = pos_s[j] ? s : INFINITY;
      const float ns = pos_s[j] ? -INFINITY : s;
      if (better_min(ps, j, vpos, ipos)) { vpos = ps; ipos = j; }
      if (better_max(ns, j, vneg, ineg)) { vneg = ns; ineg = j; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v1 = __shfl_xor_sync(FULL, vpos, o);
      const int i1 = __shfl_xor_sync(FULL, ipos, o);
      if (better_min(v1, i1, vpos, ipos)) { vpos = v1; ipos = i1; }
      const float v2 = __shfl_xor_sync(FULL, vneg, o);
      const int i2 = __shfl_xor_sync(FULL, ineg, o);
      if (better_max(v2, i2, vneg, ineg)) { vneg = v2; ineg = i2; }
    }
    if (lane == 0) {
      bell_s[0] = ipos;
      bell_s[1] = ineg;
    }
  } else if (warp == 1 && blockIdx.y == 0) {
    Lse all = lse_empty();
    int npos = 0;
    for (int j = lane; j < n; j += 32) {
      lse_add(all, simq_s[j]);
      npos += pos_s[j];
    }
    all = warp_lse(all);
    npos = warp_sum_int(npos);
    const float lse_all = lse_value(all);
    float qsum = 0.0f;
    for (int j = lane; j < n; j += 32)
      if (pos_s[j]) qsum += -(simq_s[j] - lse_all);
    qsum = warp_sum(qsum);
    if (lane == 0) {
      part[2 * n] = npos > 0 ? qsum / (float)max(npos, 1) : 0.0f;
      part[2 * n + 1] = (float)npos;
    }
  }
  __syncthreads();

  // 4. anchor i0 + w folded by warp w: supcon's U and A, and the polar
  //    states where the anchor is a bellwether (diagonal included)
  if (i >= n) return;
  const bool pi = pos_s[i], bp = i == bell_s[0], bn = i == bell_s[1];
  const float* srow = sims_s + warp * MAX_N;
  Lse lu = lse_empty(), la = lse_empty();
  Lse lpp = lse_empty(), lpa = lse_empty(), lnn = lse_empty(),
      lna = lse_empty();
  int ucount = 0;
  for (int j = lane; j < n; j += 32) {
    const float s = srow[j];
    const bool pj = pos_s[j];
    if (j != i) {
      lse_add(la, s);
      if (pj == pi) {
        lse_add(lu, s);
        ++ucount;
      }
    }
    if (bp) {
      lse_add(lpa, s);
      if (pj) lse_add(lpp, s);
    }
    if (bn) {
      lse_add(lna, s);
      if (!pj) lse_add(lnn, s);
    }
  }
  lu = warp_lse(lu);
  la = warp_lse(la);
  ucount = warp_sum_int(ucount);
  float loss_p = 0.0f, loss_n = 0.0f;
  if (bp) loss_p = -(lse_value(warp_lse(lpp)) - lse_value(warp_lse(lpa)));
  if (bn) loss_n = -(lse_value(warp_lse(lnn)) - lse_value(warp_lse(lna)));
  if (lane == 0) {
    part[i] = -(lse_value(lu) - lse_value(la)) / (float)max(ucount, 1);
    part[n + i] = ucount > 0 ? 1.0f : 0.0f;
    if (bp) part[2 * n + 2] = loss_p;
    if (bn) part[2 * n + 3] = loss_n;
  }
}

__global__ void __launch_bounds__(FINISH_THREADS)
contrastive_finish_kernel(const float* __restrict__ part,
                          float* __restrict__ out, int n, float lam) {
  __shared__ float per_s[MAX_N];
  __shared__ float valid_s[MAX_N];
  part += (size_t)blockIdx.x * (2 * n + 4);
  out += (size_t)blockIdx.x * 4;
  for (int j = threadIdx.x; j < n; j += FINISH_THREADS) {
    per_s[j] = part[j];
    valid_s[j] = part[n + j];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float total = 0.0f;
  int valid = 0;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const bool ok = valid_s[i] != 0.0f;
    total += ok ? per_s[i] : 0.0f;
    valid += ok;
  }
  const int npos = (int)part[2 * n + 1];
  const float supcon = total / (float)max(valid, 1);
  const float polar = (npos > 0 ? part[2 * n + 2] : 0.0f) +
                      (npos < n ? part[2 * n + 3] : 0.0f);
  out[0] = part[2 * n];
  out[1] = supcon;
  out[2] = polar;
  out[3] = lam * supcon + (1.0f - lam) * polar;
}

}  // namespace

extern "C" {

int contrastive_max_n() { return MAX_N; }
int contrastive_max_p() { return MAX_P; }

// zq (Q, p), zd (Q, n, p), y (Q, n) -> out (Q, 4); part (Q, 2n + 4) is
// the partials buffer the two kernels pass through (see the header). All
// float32, contiguous. Returns the CUDA error code of the launches.
int contrastive_launch(const float* zq, const float* zd, const float* y,
                       float* part, float* out, int q, int n, int p,
                       float tau, float lam, void* stream) {
  if (q <= 0 || n <= 0 || n > MAX_N || p <= 0 || p > MAX_P)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  contrastive_rows_kernel<<<dim3(q, (n + R - 1) / R), THREADS, 0, s>>>(
      zq, zd, y, part, n, p, tau);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  contrastive_finish_kernel<<<q, FINISH_THREADS, 0, s>>>(part, out, n, lam);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
