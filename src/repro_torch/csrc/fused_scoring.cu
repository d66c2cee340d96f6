// Fused proxy scoring over a tile of documents, for Q query latents.
//
// Replaces the Pallas kernels _scoring_kernel_multi and _scoring_kernel
// (src/repro/kernels/fused_scoring/scoring.py, fused_scores_multi and
// fused_scores). Per document row:
//     h1 = gelu(x W1 + b1), h2 = gelu(h1 W2 + b2), z = h2 W3 + b3,
//     s[q] = 0.5 * (1 + (z / |z|) . zq[q])
// with gelu in its tanh form (jax.nn.gelu's default) and every product
// in FP32 FMA (no TF32), so the kernel meets the reference's 1e-5.
//
// What bounds it: at the main path's shapes (8192 docs x D=4096, H=512,
// L=128) a launch does ~4.0e10 FLOP against ~134 MB of reads, so it is
// bound by FP32 arithmetic (67 TFLOP/s outside the tensor cores on an
// H100 SXM), not by memory.
//
// Design. The Pallas kernel keeps all weights in VMEM; W1 alone is 8 MiB,
// far more than a block's 227 KB of shared memory. So one block owns a
// tile of BM=32 document rows and streams the weights through shared
// memory in K-tiles of BK=32 rows, accumulating each layer's outputs in
// registers (256 threads: 4 row groups of 8 rows x 64 column groups, up
// to 8 columns each, strided by 64 so that a warp reads 32 neighbouring
// columns of the weight tile). h1 and h2 stay in shared memory
// (32 x 512 x 4 B = 64 KB each); z reuses h1's buffer. The weights
// (9.3 MB) stay resident in the 50 MB L2 across blocks. The final step
// normalizes z and writes (rows, Q) for any Q, with no padding of Q.
// No tensor cores, TMA or pipelining yet: simple and right first.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 32;            // document rows per block
constexpr int BK = 32;            // depth of a streamed weight tile
constexpr int THREADS = 256;
constexpr int COL_GROUPS = 64;    // threads across a layer's columns
constexpr int ROWS = BM / (THREADS / COL_GROUPS);   // rows per thread: 8

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;   // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return x * (0.5f * (1.0f + tanhf(k0 * (x + k1 * (x * x * x)))));
}

// acc[r][c] = sum_k A[row r][k] * W[k][col c] over K, where A is either
// the document tile read from global memory (layer 1, zero-padded past
// n_rows) or an activation matrix already in shared memory (BM x K).
// W (K x NC*64, row-major) is streamed through `ws` in BK-row tiles.
template <bool A_GLOBAL, int NC>
__device__ __forceinline__ void mlp_layer(
    const float* __restrict__ a_glob, int n_rows, int row0,
    const float* a_smem, int K, const float* __restrict__ w,
    float* xs, float* ws, float (&acc)[ROWS][NC]) {
  constexpr int W = NC * COL_GROUPS;
  const int tid = threadIdx.x;
  const int ty = tid / COL_GROUPS, tx = tid % COL_GROUPS;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (A_GLOBAL) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        const int row = row0 + r, k = k0 + kk;
        xs[i] = (row < n_rows && k < K) ? a_glob[(size_t)row * K + k] : 0.0f;
      }
    }
    for (int i = tid; i < BK * W; i += THREADS) {
      const int kk = i / W, k = k0 + kk;
      ws[i] = (k < K) ? w[(size_t)k * W + (i - kk * W)] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[ROWS], b[NC];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        a[r] = A_GLOBAL ? xs[(ty * ROWS + r) * BK + kk]
                        : a_smem[(ty * ROWS + r) * K + k0 + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) b[c] = ws[kk * W + tx + c * COL_GROUPS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// dst[row][col] = act(acc + bias[col]) for this thread's rows/columns.
template <int NC, bool GELU>
__device__ __forceinline__ void store_layer(const float (&acc)[ROWS][NC],
                                            const float* __restrict__ bias,
                                            float* dst) {
  constexpr int W = NC * COL_GROUPS;
  const int ty = threadIdx.x / COL_GROUPS, tx = threadIdx.x % COL_GROUPS;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = tx + c * COL_GROUPS;
    const float bc = bias[col];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = acc[r][c] + bc;
      dst[(ty * ROWS + r) * W + col] = GELU ? gelu_tanh(v) : v;
    }
  }
}

template <int NC_H, int NC_L>
__global__ void __launch_bounds__(THREADS)
fused_scores_kernel(const float* __restrict__ docs,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ zq, float* __restrict__ out,
                    int n, int d, int q) {
  constexpr int H = NC_H * COL_GROUPS, L = NC_L * COL_GROUPS;
  extern __shared__ float smem[];
  float* h1 = smem;                 // BM x H; later z (BM x L)
  float* h2 = h1 + BM * H;          // BM x H
  float* ws = h2 + BM * H;          // BK x H weight tile
  float* xs = ws + BK * H;          // BM x BK document tile
  float* nrm = xs + BM * BK;        // BM row norms of z
  const int row0 = blockIdx.x * BM;

  {
    float acc[ROWS][NC_H];
    mlp_layer<true, NC_H>(docs, n, row0, nullptr, d, w1, xs, ws, acc);
    store_layer<NC_H, true>(acc, b1, h1);
    __syncthreads();
    mlp_layer<false, NC_H>(nullptr, 0, 0, h1, H, w2, xs, ws, acc);
    store_layer<NC_H, true>(acc, b2, h2);
    __syncthreads();
  }
  float* z = h1;
  {
    float acc[ROWS][NC_L];
    mlp_layer<false, NC_L>(nullptr, 0, 0, h2, H, w3, xs, ws, acc);
    store_layer<NC_L, false>(acc, b3, z);
    __syncthreads();
  }

  // |z| per row: sqrt(max(sum z^2, 1e-16)), one warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += THREADS / 32) {
    float ss = 0.0f;
    for (int l = lane; l < L; l += 32) ss = fmaf(z[r * L + l], z[r * L + l], ss);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) nrm[r] = sqrtf(fmaxf(ss, 1e-16f));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BM * q; i += THREADS) {
    const int r = i / q, qi = i % q, row = row0 + r;
    if (row >= n) continue;
    const float norm = nrm[r];
    float dot = 0.0f;
    for (int l = 0; l < L; ++l)
      dot = fmaf(z[r * L + l] / norm, zq[(size_t)qi * L + l], dot);
    out[(size_t)row * q + qi] = 0.5f * (1.0f + dot);
  }
}

template <int NC_H, int NC_L>
int launch(const float* docs, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* w3,
           const float* b3, const float* zq, float* out, int n, int d,
           int q, cudaStream_t stream) {
  constexpr int H = NC_H * COL_GROUPS;
  const size_t smem = sizeof(float) * (2 * BM * H + BK * H + BM * BK + BM);
  cudaError_t err = cudaFuncSetAttribute(
      fused_scores_kernel<NC_H, NC_L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BM - 1) / BM);
  fused_scores_kernel<NC_H, NC_L><<<grid, THREADS, smem, stream>>>(
      docs, w1, b1, w2, b2, w3, b3, zq, out, n, d, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widths the kernel is built for: H and L each one of 64, 128, 256 or
// 512, with L <= H (z reuses h1's buffer). D is free.
int fused_scores_supported(int h, int l) {
  const bool h_ok = h == 64 || h == 128 || h == 256 || h == 512;
  const bool l_ok = l == 64 || l == 128 || l == 256 || l == 512;
  return h_ok && l_ok && l <= h;
}

// docs (n, d), w1 (d, h), b1 (h), w2 (h, h), b2 (h), w3 (h, l), b3 (l),
// zq (q, l) unit rows -> out (n, q). All float32, contiguous, on the
// device of `stream`. Returns the CUDA error code of the launch.
int fused_scores_launch(const float* docs, const float* w1, const float* b1,
                        const float* w2, const float* b2, const float* w3,
                        const float* b3, const float* zq, float* out, int n,
                        int d, int h, int l, int q, void* stream) {
  if (!fused_scores_supported(h, l) || n <= 0 || q <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FS_CASE(HH, LL)                                                      \
  if (h == HH && l == LL)                                                    \
    return launch<HH / COL_GROUPS, LL / COL_GROUPS>(docs, w1, b1, w2, b2,    \
                                                    w3, b3, zq, out, n, d,   \
                                                    q, s);
  FS_CASE(64, 64)
  FS_CASE(128, 64) FS_CASE(128, 128)
  FS_CASE(256, 64) FS_CASE(256, 128) FS_CASE(256, 256)
  FS_CASE(512, 64) FS_CASE(512, 128) FS_CASE(512, 256) FS_CASE(512, 512)
#undef FS_CASE
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
