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
// What bounds it: ~2 MFLOP per lane at n=128, p=64, so a launch is bound
// by launch latency and by the serial depth of its reductions, never by
// bytes or arithmetic.
//
// Design. One block per lane (grid = Q). The Pallas kernel holds the
// whole (n, n) similarity matrix in VMEM; at n=512 it does not fit a
// block's shared memory, so no row of it is ever stored: each warp owns
// anchor rows and folds every similarity into online log-sum-exp states
// as it is computed (the bellwether rows ride along when the warp's
// anchor is a bellwether). Normalized rows go to a scratch buffer in
// global memory (L1/L2-resident at these sizes). Empty masks give an LSE
// of -inf, as the Pallas kernel's _lse does, and every degenerate case
// (no positives, no negatives, an anchor with empty U(i)) is masked with
// a select, never a multiply by a 0/1 mask, so an inf never meets a 0.
// Takes every shape the Pallas kernel takes: n <= 512, p <= 256.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 512;
constexpr int MAX_P = 256;
constexpr unsigned FULL = 0xffffffffu;

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

__global__ void __launch_bounds__(THREADS)
contrastive_kernel(const float* __restrict__ zq, const float* __restrict__ zd,
                   const float* __restrict__ y, float* zdn,
                   float* __restrict__ out, int n, int p, float tau,
                   float lam) {
  __shared__ float zqn_s[MAX_P];
  __shared__ float simq_s[MAX_N];
  __shared__ float row_s[WARPS][MAX_P];
  __shared__ float sup_sum_s[WARPS];
  __shared__ int sup_valid_s[WARPS];
  __shared__ float scal_s[4];   // |z_q|, qsim, loss_p, loss_n
  __shared__ int int_s[4];      // i_pos, i_neg, n_pos

  const int lane_id = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  zq += (size_t)lane_id * p;
  zd += (size_t)lane_id * n * p;
  y += (size_t)lane_id * n;
  zdn += (size_t)lane_id * n * p;
  out += (size_t)lane_id * 4;

  // 1. zqn = zq / sqrt(max(|zq|^2, 1e-16))
  if (warp == 0) {
    float ss = 0.0f;
    for (int k = lane; k < p; k += 32) ss = fmaf(zq[k], zq[k], ss);
    ss = warp_sum(ss);
    if (lane == 0) scal_s[0] = sqrtf(fmaxf(ss, 1e-16f));
  }
  __syncthreads();
  for (int k = tid; k < p; k += THREADS) zqn_s[k] = zq[k] / scal_s[0];
  __syncthreads();

  // 2. normalized rows (one warp per row) and sims_q = (zdn . zqn) / tau
  for (int j = warp; j < n; j += WARPS) {
    const float* row = zd + (size_t)j * p;
    float ss = 0.0f;
    for (int k = lane; k < p; k += 32) ss = fmaf(row[k], row[k], ss);
    const float nrm = sqrtf(fmaxf(warp_sum(ss), 1e-16f));
    float dot = 0.0f;
    for (int k = lane; k < p; k += 32) {
      const float v = row[k] / nrm;
      zdn[(size_t)j * p + k] = v;
      dot = fmaf(v, zqn_s[k], dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) simq_s[j] = dot / tau;
  }
  __syncthreads();   // also publishes the zdn rows to the whole block

  // 3. qsim, positive count and the two bellwethers (warp 0)
  if (warp == 0) {
    Lse all = lse_empty();
    int npos = 0, ipos = MAX_N, ineg = MAX_N;
    float vpos = INFINITY, vneg = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = simq_s[j];
      const bool pos = y[j] > 0.5f;
      lse_add(all, s);
      npos += pos;
      const float ps = pos ? s : INFINITY;
      const float ns = pos ? -INFINITY : s;
      if (better_min(ps, j, vpos, ipos)) { vpos = ps; ipos = j; }
      if (better_max(ns, j, vneg, ineg)) { vneg = ns; ineg = j; }
    }
    all = warp_lse(all);
    npos = warp_sum_int(npos);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v1 = __shfl_xor_sync(FULL, vpos, o);
      const int i1 = __shfl_xor_sync(FULL, ipos, o);
      if (better_min(v1, i1, vpos, ipos)) { vpos = v1; ipos = i1; }
      const float v2 = __shfl_xor_sync(FULL, vneg, o);
      const int i2 = __shfl_xor_sync(FULL, ineg, o);
      if (better_max(v2, i2, vneg, ineg)) { vneg = v2; ineg = i2; }
    }
    const float lse_all = lse_value(all);
    float qsum = 0.0f;
    for (int j = lane; j < n; j += 32)
      if (y[j] > 0.5f) qsum += -(simq_s[j] - lse_all);
    qsum = warp_sum(qsum);
    if (lane == 0) {
      scal_s[1] = npos > 0 ? qsum / (float)max(npos, 1) : 0.0f;
      int_s[0] = ipos;
      int_s[1] = ineg;
      int_s[2] = npos;
    }
  }
  __syncthreads();
  const int ipos = int_s[0], ineg = int_s[1];

  // 4. supcon over anchor rows (one warp per anchor); the bellwether
  //    rows also fold their polar LSEs (diagonal included, as in Pallas)
  float sup_sum = 0.0f;
  int sup_valid = 0;
  for (int i = warp; i < n; i += WARPS) {
    for (int k = lane; k < p; k += 32) row_s[warp][k] = zdn[(size_t)i * p + k];
    __syncwarp();
    const bool pi = y[i] > 0.5f;
    Lse lu = lse_empty(), la = lse_empty();
    Lse lpp = lse_empty(), lpa = lse_empty(), lnn = lse_empty(),
        lna = lse_empty();
    int ucount = 0;
    for (int j = 0; j < n; ++j) {
      const float* rj = zdn + (size_t)j * p;
      float dot = 0.0f;
      for (int k = lane; k < p; k += 32) dot = fmaf(row_s[warp][k], rj[k], dot);
      const float s = warp_sum(dot) / tau;
      const bool pj = y[j] > 0.5f;
      if (j != i) {
        lse_add(la, s);
        if (pj == pi) {
          lse_add(lu, s);
          ++ucount;
        }
      }
      if (i == ipos) {
        lse_add(lpa, s);
        if (pj) lse_add(lpp, s);
      }
      if (i == ineg) {
        lse_add(lna, s);
        if (!pj) lse_add(lnn, s);
      }
    }
    if (lane == 0) {
      const float per_anchor =
          -(lse_value(lu) - lse_value(la)) / (float)max(ucount, 1);
      if (ucount > 0) {
        sup_sum += per_anchor;
        ++sup_valid;
      }
      if (i == ipos) scal_s[2] = -(lse_value(lpp) - lse_value(lpa));
      if (i == ineg) scal_s[3] = -(lse_value(lnn) - lse_value(lna));
    }
    __syncwarp();
  }
  if (lane == 0) {
    sup_sum_s[warp] = sup_sum;
    sup_valid_s[warp] = sup_valid;
  }
  __syncthreads();

  if (tid == 0) {
    float total = 0.0f;
    int valid = 0;
    for (int w = 0; w < WARPS; ++w) {
      total += sup_sum_s[w];
      valid += sup_valid_s[w];
    }
    const int npos = int_s[2];
    const float supcon = total / (float)max(valid, 1);
    const float polar = (npos > 0 ? scal_s[2] : 0.0f) +
                        (npos < n ? scal_s[3] : 0.0f);
    out[0] = scal_s[1];
    out[1] = supcon;
    out[2] = polar;
    out[3] = lam * supcon + (1.0f - lam) * polar;
  }
}

}  // namespace

extern "C" {

int contrastive_max_n() { return MAX_N; }
int contrastive_max_p() { return MAX_P; }

// zq (Q, p), zd (Q, n, p), y (Q, n) -> out (Q, 4); zdn_scratch (Q, n, p)
// holds the normalized rows. All float32, contiguous. Returns the CUDA
// error code of the launch.
int contrastive_launch(const float* zq, const float* zd, const float* y,
                       float* zdn_scratch, float* out, int q, int n, int p,
                       float tau, float lam, void* stream) {
  if (q <= 0 || n <= 0 || n > MAX_N || p <= 0 || p > MAX_P)
    return (int)cudaErrorInvalidValue;
  contrastive_kernel<<<q, THREADS, 0, (cudaStream_t)stream>>>(
      zq, zd, y, zdn_scratch, out, n, p, tau, lam);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
