// WKV6 (RWKV6 "Finch") intra-chunk recurrence.
//
// Replaces the Pallas kernel _wkv6_kernel / wkv6_intra_chunk
// (src/repro/kernels/wkv6/wkv6.py:38-126). For each batch b, chunk c and
// head h, over the chunk's Q rows and the head's K channels, all float32:
//     A[t,j]  = sum_k r[t,k] exp(cum_{t-1}[t,k] - cum[j,k]) k[j,k], j < t
//     y_intra = A v + (r.u.k) v                          (Q, K)
//     s_inj   = (k * exp(cum[Q-1] - cum))^T v            (K, K)
//     a_end   = exp(cum[Q-1])                            (K,)
//     r_dec   = r * exp(cum_{t-1})                       (Q, K)
// where cum is the within-chunk cumsum of the log-decay lw and cum_{t-1}
// is cum - lw, computed exactly as the Pallas kernel computes it (not as
// an exclusive scan: under lw = -200 one ulp of |cum| moves exp by 0.2%).
// Every exponent is of a difference, which is <= 0 on the lower
// triangle, so nothing overflows under strong decay; the product is
// never factored into exp(cum_{t-1}) exp(-cum_j). The upper triangle,
// whose exponents can overflow, is dropped by a select, never by a
// multiply with a 0/1 mask. expf, not __expf: the kernel is held to its
// plain version to 1e-5 of max |y|.
//
// What bounds it: at the rwkv6-7b embedding path's shape (b=8, s=512 ->
// nc=4 chunks of Q=128, H=64 heads of K=64; 2,048 blocks) one launch
// reads and writes 0.50 GB, 0.15 ms at 3.35 TB/s, and that is its
// bound; its exponentials (below) take 0.06 ms at the H100's 16 MUFU
// results per clock per SM (132 SMs, 1.98 GHz) and its ~7.0 GFLOP of
// FP32 0.10 ms at 67 TFLOP/s (chip_smoke.py's wkv6_times counts all
// three from the shapes).
//
// The sub-chunk form. The rows are cut into sub-chunks of SUB = 16; e_s
// is the last row of sub-chunk s. A pair (t, j) inside one sub-chunk
// takes one exponential per term, as above. A pair with j in an earlier
// sub-chunk s factors through e_s:
//     A[t,j] = sum_k rd[t,s,k] kd[j,k]
//     rd[t,s,k] = r[t,k] exp(cum_{t-1}[t,k] - cum[e_s,k])
//     kd[j,k]   = k[j,k] exp(cum[e_s(j),k] - cum[j,k])
// Both exponents are <= 0 (cum falls with the row), so nothing
// overflows under lw = -200, and where the product is a normal float
// neither factor underflows. At the path's shape a launch takes 2.35e8
// exponentials, against 1.10e9 for one per (t, j, k) term
// (b*nc*H*K*(Q(Q-1)/2 + 2Q + 1)), the kernel's previous design.
//
// Design. The Pallas kernel builds the (Q, Q, 16) pairwise-decay slab in
// VMEM (1 MiB at Q=128), which does not fit a block's shared memory, so
// A is never stored here. One block per (b, c, h); four threads per row
// t, thread `lane` owning the channels lane + 4i (i < K/4). cum, k, v
// and kd of the chunk sit in shared memory (4 x 32 KB at Q=128, K=64),
// zero-padded to KP = 16, 32 or 64 columns; kd is computed as the chunk
// is loaded, from cum in device memory. Each thread keeps its slice of
// r[t] and cum_{t-1}[t] and of the output row in registers. A warp's
// eight rows lie in one sub-chunk (16 is a multiple of 8), so its loop
// bounds are uniform and its shuffles convergent. For each earlier
// sub-chunk s a thread forms its slice of rd[t, s] (PER exponentials),
// then for each j of s its part of A[t, j] = rd . kd[j] (PER FMAs), sums
// the four parts with two shuffles and accumulates A[t, j] v[j]; every
// such j is below t, so no select. Then the rows of its own sub-chunk,
// up to the warp's last row, take one expf per term, j >= t giving A = 0
// by the select. The rows do triangular work, so the warps of a block
// are unevenly loaded. Then k is scaled in place by exp(cum[Q-1] - cum)
// and each thread computes s_inj entries as dot products over the Q
// rows.
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int LANES = 4;                  // threads per row
constexpr int ROWS_PER_WARP = 32 / LANES;  // 8
constexpr int MAX_Q = 128;
constexpr int MAX_K = 64;
constexpr int SUB = 16;                   // rows of a sub-chunk
static_assert(SUB % ROWS_PER_WARP == 0, "a warp's rows in one sub-chunk");

template <int KP>
constexpr int smem_bytes(int q) { return 4 * q * KP * 4; }

template <int KP>
__global__ void __launch_bounds__(MAX_Q * LANES)
wkv6_intra_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ cum,
                  const float* __restrict__ lw, const float* __restrict__ u,
                  float* __restrict__ y, float* __restrict__ s_inj,
                  float* __restrict__ a_end, float* __restrict__ r_dec,
                  int Q, int H, int K) {
  constexpr int PER = KP / LANES;         // channels per thread
  extern __shared__ __align__(16) float smem[];
  float* cum_s = smem;                    // (Q, KP)
  float* k_s = cum_s + Q * KP;            // (Q, KP)
  float* v_s = k_s + Q * KP;              // (Q, KP)
  float* kd_s = v_s + Q * KP;             // (Q, KP): k exp(cum[e] - cum)

  const int g = blockIdx.x;               // (b * nc + c) * H + h
  const int h = g % H;
  const size_t row_stride = (size_t)H * K;
  // element (b, c, t=0, h, 0) of a (b, nc, Q, H, K) input
  const size_t base = (size_t)(g / H) * Q * row_stride + (size_t)h * K;

  for (int idx = threadIdx.x; idx < Q * KP; idx += blockDim.x) {
    const int t = idx / KP, ch = idx % KP;
    const bool in = ch < K;
    const int e = min(t / SUB * SUB + SUB - 1, Q - 1);  // its sub-chunk's
    const size_t off = base + (size_t)t * row_stride + ch;
    const float cv = in ? cum[off] : 0.f;
    const float kv = in ? k[off] : 0.f;
    cum_s[idx] = cv;
    k_s[idx] = kv;
    v_s[idx] = in ? v[off] : 0.f;
    kd_s[idx] = in ? kv * expf(cum[base + (size_t)e * row_stride + ch] - cv)
                   : 0.f;
  }
  __syncthreads();

  const int t = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const bool row_ok = t < Q;
  const size_t roff = base + (size_t)t * row_stride;
  float rr[PER], ct[PER], acc[PER];
  float diag = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int ch = lane + LANES * i;
    const bool in = row_ok && ch < K;
    const float rv = in ? r[roff + ch] : 0.f;
    const float lv = in ? lw[roff + ch] : 0.f;
    const float cv = in ? cum_s[t * KP + ch] : 0.f;
    rr[i] = rv;
    ct[i] = cv - lv;                      // cum_{t-1} = cum - lw
    acc[i] = 0.f;
    if (in) {
      diag += rv * u[h * K + ch] * k_s[t * KP + ch];
      r_dec[roff + ch] = rv * expf(ct[i]);
    }
  }
  diag += __shfl_xor_sync(0xffffffffu, diag, 1);
  diag += __shfl_xor_sync(0xffffffffu, diag, 2);

  // the warp's rows are warp_first .. warp_first + 7, all in sub-chunk
  // s_w: first the earlier sub-chunks, through rd . kd
  const int warp_first = (threadIdx.x / 32) * ROWS_PER_WARP;
  const int s_w = warp_first / SUB;
  for (int sc = 0; sc < s_w; ++sc) {
    const float* ce = cum_s + (sc * SUB + SUB - 1) * KP;
    float rd[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      rd[i] = rr[i] * expf(ct[i] - ce[lane + LANES * i]);
    for (int j = sc * SUB; j < sc * SUB + SUB; ++j) {
      const float* kj = kd_s + j * KP;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) a += rd[i] * kj[lane + LANES * i];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      const float* vj = v_s + j * KP;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] += a * vj[lane + LANES * i];
    }
  }
  // then the own sub-chunk, one exponential per term, below the last of
  // the warp's rows that exists
  const int j_end = min(warp_first + ROWS_PER_WARP, Q) - 1;
  for (int j = s_w * SUB; j < j_end; ++j) {
    const float* cj = cum_s + j * KP;
    const float* kj = k_s + j * KP;
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int ch = lane + LANES * i;
      a += rr[i] * expf(ct[i] - cj[ch]) * kj[ch];
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    a = (j < t) ? a : 0.f;                // strictly lower: a select
    const float* vj = v_s + j * KP;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] += a * vj[lane + LANES * i];
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int ch = lane + LANES * i;
      if (ch < K) y[roff + ch] = acc[i] + diag * v_s[t * KP + ch];
    }
  }
  __syncthreads();                        // every row is done with k_s

  const float* c_last = cum_s + (Q - 1) * KP;
  for (int idx = threadIdx.x; idx < Q * KP; idx += blockDim.x)
    k_s[idx] *= expf(c_last[idx % KP] - cum_s[idx]);
  __syncthreads();
  float* s_out = s_inj + (size_t)g * K * K;
  for (int idx = threadIdx.x; idx < K * K; idx += blockDim.x) {
    const int kk = idx / K, vv = idx % K;
    float s = 0.f;
    for (int q = 0; q < Q; ++q) s += k_s[q * KP + kk] * v_s[q * KP + vv];
    s_out[idx] = s;
  }
  // a block of Q < 16 rows has fewer threads than K channels
  for (int ch = threadIdx.x; ch < K; ch += blockDim.x)
    a_end[(size_t)g * K + ch] = expf(c_last[ch]);
}

template <int KP>
int launch(const float* r, const float* k, const float* v, const float* cum,
           const float* lw, const float* u, float* y, float* s_inj,
           float* a_end, float* r_dec, int blocks, int Q, int H, int K,
           cudaStream_t stream) {
  // the shared memory limit once per instantiation and device, a bit a
  // device (0-63; past them at every launch): the attribute is per
  // device, and the current device is the launch's (the wrapper makes
  // the tensors' device current)
  static std::atomic<unsigned long long> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(configured.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        wkv6_intra_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<KP>(MAX_Q));
    if (err != cudaSuccess) return (int)err;
    configured.fetch_or(bit, std::memory_order_release);
  }
  const int rows = (Q + ROWS_PER_WARP - 1) / ROWS_PER_WARP * ROWS_PER_WARP;
  wkv6_intra_kernel<KP><<<blocks, rows * LANES, smem_bytes<KP>(Q), stream>>>(
      r, k, v, cum, lw, u, y, s_inj, a_end, r_dec, Q, H, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, cum, lw, y and r_dec (b, nc, Q, H, K); u (H, K); s_inj
// (b, nc, H, K, K); a_end (b, nc, H, K): all float32, contiguous, on the
// device of `stream`. Q at most 128, K at most 64. Returns the CUDA error
// code of the launch.
int wkv6_intra_chunk_launch(const void* r, const void* k, const void* v,
                            const void* cum, const void* lw, const void* u,
                            void* y, void* s_inj, void* a_end, void* r_dec,
                            int b, int nc, int Q, int H, int K,
                            void* stream) {
  if (b <= 0 || nc <= 0 || Q <= 0 || H <= 0 || K <= 0 || Q > MAX_Q ||
      K > MAX_K || (long long)b * nc * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int blocks = b * nc * H;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fr = (const float*)r, *fk = (const float*)k,
              *fv = (const float*)v, *fc = (const float*)cum,
              *fl = (const float*)lw, *fu = (const float*)u;
  float *fy = (float*)y, *fs = (float*)s_inj, *fa = (float*)a_end,
        *fd = (float*)r_dec;
  if (K <= 16)
    return launch<16>(fr, fk, fv, fc, fl, fu, fy, fs, fa, fd, blocks, Q, H,
                      K, s);
  if (K <= 32)
    return launch<32>(fr, fk, fv, fc, fl, fu, fy, fs, fa, fd, blocks, Q, H,
                      K, s);
  return launch<64>(fr, fk, fv, fc, fl, fu, fy, fs, fa, fd, blocks, Q, H, K,
                    s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
