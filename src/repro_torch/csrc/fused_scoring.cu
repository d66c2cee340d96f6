// Fused proxy scoring over a tile of documents, for Q query latents.
//
// Replaces the Pallas kernels _scoring_kernel_multi and _scoring_kernel
// (src/repro/kernels/fused_scoring/scoring.py: fused_scores_multi, whose
// pallas_call is at :138, and fused_scores, :76; the Q=1 form is the Q=1
// launch of this kernel). Per document row:
//     h1 = gelu(x W1 + b1), h2 = gelu(h1 W2 + b2), z = h2 W3 + b3,
//     s[q] = 0.5 * (1 + (z . zq[q]) / |z|),  |z| = sqrt(max(z . z, 1e-16))
// with gelu in its tanh form (jax.nn.gelu's default) and every product
// in FP32 FMA (no TF32), so the kernel meets the reference's 1e-5. Q is
// not padded.
//
// What bounds it: at the main path's shapes (8192 docs x D=4096, H=512,
// L=128, Q=1) a launch does 3.97e10 FLOP against 134 MB of reads: 0.593
// ms at the H100's 67 TFLOP/s FP32 peak, against 0.040 ms for the bytes
// at 3.35 TB/s. So it is bound by FP32 arithmetic, and the design is a
// register-blocked FP32 GEMM whose job is to keep the FMA pipes fed.
//
// Design. A block owns BM = 64 documents and all H hidden units, so that
// layers 2 and 3 and the cosine run in the block on rows it already
// holds. 512 threads, each with a ROWS x COLS register micro-tile of the
// layer's output: 8 x 8 at H=512 (rows ty, ty+8, ..., ty+56 and columns
// 4tx..4tx+3, 4tx+256..4tx+259, tx < 64); a warp is 32 column groups of
// one row group. Each layer is one loop over K in deep slices:
//  - Layer 1 streams the document slice (64 x 32) and W1's slice
//    (32 x H) through a 3-stage ring by cp.async.cg (16-byte copies, one
//    commit group a slice): after the one barrier of a step, slice k+2
//    is copied into the stage that slice k-1 left, so two slices are in
//    flight while slice k is computed. The ring lies over the space that
//    h1 takes later (h1 is written only after the loop), which is what
//    makes room for 32-deep slices and three stages. Both slices are
//    copied as they lie in global memory (row-major); no transposition
//    is needed, because the 32 threads of a warp read the same document
//    rows: a thread takes 4 consecutive k of one row as one 16-byte load
//    that the warp broadcasts, so 4 k-steps cost 8 loads of A and 8 of W
//    (2 column groups of 4), 8 16-byte shared loads per 128 FMA against
//    16 scalar loads per 64 FMA before. A warp's W loads cover 512
//    contiguous bytes: no bank conflict.
//  - Epilogue: bias and gelu in registers; h1 (64 x H, 129 KB at H=512,
//    rows padded by 16 bytes) goes to shared memory.
//  - Layers 2 and 3 run the same loop with A read from h1 (then h2) in
//    shared memory and only W2, then W3, streamed through a 2-stage ring
//    of 16-deep slices beside the activations. After a barrier h2
//    overwrites h1 in place.
//  - z never leaves registers: at L=128 a warp holds all L columns of its
//    4 rows, so |z|^2 and each z . zq[q] are the thread's partial sums
//    reduced by shuffles over its row's lanes in a fixed order (at L of
//    256 or 512 a row spans two warps, whose sums meet in shared memory),
//    with one division per output and none per term.
// Shared memory at H=512: layer 1's ring of 3 x (64 x 36 + 32 x 512)
// floats, 224,256 bytes, against 64 x 516 activations + 2 x (64 x 20 +
// 16 x 512) later, one block an SM. At n = 8192 the grid is 128 blocks:
// one wave on 132 SMs. Each W1 element fetched from L2 feeds 64 rows, so
// a launch moves ~1.07 GB of W1 from L2 to the SMs.
//
// Against the first version of this kernel (3.5 ms at the path's shape,
// 5.9x its bound), the design answers: low reuse of W1 (32 -> 64 rows a
// block); no overlap of loads and compute (scalar loads, then compute ->
// a cp.async ring); one block of 8 warps an SM (-> 16 warps, 128
// registers a thread); scalar shared loads (16 per 64 FMA -> 8 per 128);
// two waves of blocks (256 -> 128). The tile sizes were chosen by
// timing variants of this file against each other on the card
// (tools/fused_variants.py; PERF.md): 512 threads of 8 x 8 ran ahead of
// 256 threads of 8 x 16 (255 registers, 8 warps an SM), though those
// take only 6 shared loads per 128 FMA, and 32-deep slices in 3 stages
// ahead of 16-deep ones in 2 or 4. What still holds it from its bound is
// the inner loop itself: a variant that copies nothing after its first
// slices is not much faster.
//
// Ragged edges are masked in the copies: rows past n and k past D are
// zero-filled by cp.async itself (src-size 0), and rows past n are never
// stored. When D is not a multiple of 4, or docs or a weight matrix is
// not 16-byte aligned, the entry point launches the same kernel
// instantiated with 4-byte copies (cp.async.ca) instead. Every sum runs
// in a fixed order and nothing is atomic, so two launches on the same
// inputs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int BM = 64;            // document rows per block
constexpr int BK1 = 32;           // layer 1: depth of a ring stage
constexpr int STAGES1 = 3;        //          ring stages
constexpr int BK = 16;            // layers 2, 3: depth of a ring stage
constexpr int STAGES = 2;         //              ring stages
constexpr int THREADS = 512;

// How the threads cover a BM x W output: TX column groups of 4 columns
// (NC of them a thread, 4*TX apart) by RG row groups; row group ty owns
// rows ty, ty + RG, ... (ROWS of them). A warp spans WC column groups
// of one row group (of two at W = 64, where TX = 16).
template <int W>
struct Tile {
  static constexpr int TX = W / 4 < THREADS / 8 ? W / 4 : THREADS / 8;
  static constexpr int RG = THREADS / TX;
  static constexpr int ROWS = BM / RG;
  static constexpr int NC = W / (4 * TX);
  static constexpr int COLS = 4 * NC;
  static constexpr int WC = TX < 32 ? TX : 32;
  __device__ static int tx() {
    return threadIdx.x / 32 % (TX / WC) * WC + threadIdx.x % WC;
  }
  __device__ static int ty() {
    return threadIdx.x / 32 / (TX / WC) * (32 / WC) + threadIdx.x % 32 / WC;
  }
};

// A ring of S stages, each a BM x K_ document slice (rows padded by 16
// bytes; only layer 1 fills it) and a K_ x H weight slice.
template <int K_, int S>
struct Ring {
  static constexpr int BK = K_, STAGES = S, XS_LD = K_ + 4;
  template <int H>
  __host__ __device__ static constexpr int floats() {
    return S * (BM * XS_LD + K_ * H);
  }
};
using Ring1 = Ring<BK1, STAGES1>;   // over the activations' space too
using Ring2 = Ring<BK, STAGES>;     // beside the activations

// The end of layer 1's ring, or of the activations and the ring of
// layers 2 and 3, whichever lies further; row_sum's floats follow.
template <int H>
__host__ __device__ constexpr int ring_end() {
  return Ring1::floats<H>() > BM * (H + 4) + Ring2::floats<H>()
             ? Ring1::floats<H>() : BM * (H + 4) + Ring2::floats<H>();
}

template <int H>
__host__ __device__ constexpr int smem_bytes() {
  return (ring_end<H>() + THREADS / 8) * 4;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;   // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return x * (0.5f * (1.0f + tanhf(k0 * (x + k1 * (x * x * x)))));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one copy global -> shared: 16 bytes (cp.async.cg, bypassing L1) or 4
// (cp.async.ca, the unaligned path); ok = false writes zeros
template <bool VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  if (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>   // at most N of this thread's copy groups in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows k0 .. k0+BK-1 of w (K x W, row-major) into ws (BK x W); rows
// past K are zeros. A thread's copies lie at constant offsets from one
// address; a whole slice (every slice but a ragged last one) takes no
// predicate.
template <class R, int W, bool VEC>
__device__ __forceinline__ void load_w(float* ws, const float* __restrict__ w,
                                       int k0, int K) {
  constexpr int E = VEC ? 4 : 1;
  constexpr int ACROSS = W / E < THREADS ? W / E : THREADS;  // along a row
  constexpr int DOWN = THREADS / ACROSS;                      // rows a pass
  constexpr int BK = R::BK;
  const int c0 = threadIdx.x % ACROSS * E, kk0 = threadIdx.x / ACROSS;
  const bool whole = k0 + BK <= K;
  const float* src = w + (size_t)(whole ? k0 + kk0 : 0) * W + c0;
  float* dst = ws + kk0 * W + c0;
#pragma unroll(VEC ? R::BK : 1)   // 4-byte copies: 4x as many, whose
                                  // unrolled addresses would spill
  for (int i = 0; i < (BK + DOWN - 1) / DOWN; ++i) {
    const int kk = kk0 + i * DOWN, k = min(k0 + kk, K - 1);
#pragma unroll
    for (int j = 0; j < W / (ACROSS * E); ++j) {
      const int off = i * DOWN * W + j * ACROSS * E;
      if (DOWN > BK && kk >= BK) continue;   // kk0 < DOWN: else kk < BK
      if (whole)
        cp_async<VEC>(dst + off, src + off, true);
      else
        cp_async<VEC>(dst + off, w + (size_t)k * W + c0 + j * ACROSS * E,
                      k0 + kk < K);
    }
  }
}

// docs[row0 .. row0+BM-1][k0 .. k0+BK-1] into xs (BM x XS_LD); rows past
// n and columns past d are zeros
template <class R, bool VEC>
__device__ __forceinline__ void load_x(float* xs,
                                       const float* __restrict__ docs, int n,
                                       int d, int row0, int k0) {
  constexpr int E = VEC ? 4 : 1, BK = R::BK, XS_LD = R::XS_LD;
  constexpr int ACROSS = BK / E;
  constexpr int DOWN = THREADS / ACROSS;
  const int c = threadIdx.x % ACROSS * E, r0 = threadIdx.x / ACROSS;
  const bool whole = row0 + BM <= n && k0 + BK <= d;
#pragma unroll
  for (int i = 0; i < (BM + DOWN - 1) / DOWN; ++i) {
    const int r = r0 + i * DOWN;
    if (DOWN > BM && r >= BM) continue;      // r0 < DOWN: else r < BM
    const bool ok = whole || (row0 + r < n && k0 + c < d);
    cp_async<VEC>(xs + r * XS_LD + c,
                  docs + (ok ? (size_t)(row0 + r) * d + k0 + c : 0), ok);
  }
}

// acc[r][j] = sum_k A[row r][k] W[k][col j] over this thread's rows and
// columns. A is the document tile (A_DOCS: streamed with W through the
// ring) or the activations in shared memory (act, row stride ALD).
template <class R, int W, int H, bool A_DOCS, bool VEC>
__device__ __forceinline__ void gemm(
    float (&acc)[Tile<W>::ROWS][Tile<W>::COLS],
    const float* __restrict__ docs, int n, int d, int row0,
    const float* act, int K, const float* __restrict__ w, float* ring) {
  using T = Tile<W>;
  constexpr int ALD = H + 4, BK = R::BK, STAGES = R::STAGES;
  constexpr int XS_LD = R::XS_LD, STAGE = R::template floats<H>() / STAGES;
  const int tx = T::tx(), ty = T::ty();
#pragma unroll
  for (int r = 0; r < T::ROWS; ++r)
#pragma unroll
    for (int j = 0; j < T::COLS; ++j) acc[r][j] = 0.0f;

  const int nt = (K + BK - 1) / BK;
  auto fetch = [&](int t) {       // slice t into stage t % STAGES
    if (t < nt) {
      float* st = ring + t % STAGES * STAGE;
      if (A_DOCS) load_x<R, VEC>(st, docs, n, d, row0, t * BK);
      load_w<R, W, VEC>(st + BM * XS_LD, w, t * BK, K);
    }
    cp_async_commit();            // one group a slice, empty past nt
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice t
    __syncthreads();              // everyone's; and slice t-1 is done
    fetch(t + STAGES - 1);        // into the stage slice t-1 left
    const float* st = ring + t % STAGES * STAGE;
    const float* ws = st + BM * XS_LD;
    const float* a = A_DOCS ? st + ty * XS_LD : act + ty * ALD + t * BK;
    constexpr int LDA = (A_DOCS ? XS_LD : ALD) * T::RG;   // row r to r+1
#pragma unroll
    for (int kg = 0; kg < BK; kg += 4) {
      float av[T::ROWS][4];         // 4 k-steps of each row: one load
#pragma unroll
      for (int r = 0; r < T::ROWS; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(a + r * LDA + kg);
        av[r][0] = v.x; av[r][1] = v.y; av[r][2] = v.z; av[r][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[T::COLS];
#pragma unroll
        for (int c = 0; c < T::NC; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (kg + kk) * W + 4 * (tx + c * T::TX));
          bv[4 * c] = v.x; bv[4 * c + 1] = v.y;
          bv[4 * c + 2] = v.z; bv[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < T::ROWS; ++r)
#pragma unroll
          for (int j = 0; j < T::COLS; ++j)
            acc[r][j] = fmaf(av[r][kk], bv[j], acc[r][j]);
      }
    }
  }
}

// act[row][col] = gelu(acc + bias[col]) for this thread's rows, columns
template <int H>
__device__ __forceinline__ void store_gelu(
    const float (&acc)[Tile<H>::ROWS][Tile<H>::COLS],
    const float* __restrict__ bias, float* act) {
  using T = Tile<H>;
  const int tx = T::tx(), ty = T::ty();
#pragma unroll
  for (int c = 0; c < T::NC; ++c) {
    const int col = 4 * (tx + c * T::TX);
    const float b0 = bias[col], b1 = bias[col + 1], b2 = bias[col + 2],
                b3 = bias[col + 3];
#pragma unroll
    for (int r = 0; r < T::ROWS; ++r) {
      *reinterpret_cast<float4*>(act + (ty + r * T::RG) * (H + 4) + col) =
          make_float4(gelu_tanh(acc[r][4 * c] + b0),
                      gelu_tanh(acc[r][4 * c + 1] + b1),
                      gelu_tanh(acc[r][4 * c + 2] + b2),
                      gelu_tanh(acc[r][4 * c + 3] + b3));
    }
  }
}

// sum over the TX threads that share row group ty, in a fixed order:
// shuffles over a warp's WC lanes, then (TX > WC) the TX / WC warps'
// sums in order through red
template <class T>
__device__ __forceinline__ float row_sum(float v, float* red, int ty) {
#pragma unroll
  for (int o = T::WC / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (T::TX > T::WC) {
    constexpr int N = T::TX / T::WC;
    if (threadIdx.x % T::WC == 0) red[ty * N + threadIdx.x / 32 % N] = v;
    __syncthreads();
    v = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) v += red[ty * N + i];
    __syncthreads();
  }
  return v;
}

// z = acc + b3 in registers -> out[row][qi] = 0.5 (1 + z.zq[qi] / |z|)
template <int L>
__device__ __forceinline__ void cosine(
    float (&acc)[Tile<L>::ROWS][Tile<L>::COLS], const float* __restrict__ b3,
    const float* __restrict__ zq, float* __restrict__ out, int n, int q,
    int row0, float* red) {
  using T = Tile<L>;
  const int tx = T::tx(), ty = T::ty();
#pragma unroll
  for (int j = 0; j < T::COLS; ++j) {
    const float b = b3[4 * (tx + (j / 4) * T::TX) + j % 4];
#pragma unroll
    for (int r = 0; r < T::ROWS; ++r) acc[r][j] += b;
  }
#pragma unroll
  for (int r = 0; r < T::ROWS; ++r) {
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < T::COLS; ++j) ss = fmaf(acc[r][j], acc[r][j], ss);
    const float norm = sqrtf(fmaxf(row_sum<T>(ss, red, ty), 1e-16f));
    const int row = row0 + ty + r * T::RG;
    for (int qi = 0; qi < q; ++qi) {
      const float* zr = zq + (size_t)qi * L;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < T::COLS; ++j)
        dot = fmaf(acc[r][j], zr[4 * (tx + (j / 4) * T::TX) + j % 4], dot);
      dot = row_sum<T>(dot, red, ty);
      if (tx == 0 && row < n) out[(size_t)row * q + qi] =
          0.5f * (1.0f + dot / norm);
    }
  }
}

template <int H, int L, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_scores_kernel(const float* __restrict__ docs,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ zq, float* __restrict__ out,
                    int n, int d, int q) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                      // BM x (H + 4): h1, then h2
  float* ring = act + BM * (H + 4);       // layers 2 and 3
  float* red = smem + ring_end<H>();
  const int row0 = blockIdx.x * BM;
  {
    float acc[Tile<H>::ROWS][Tile<H>::COLS];
    gemm<Ring1, H, H, true, VEC>(acc, docs, n, d, row0, nullptr, d, w1,
                                 smem);
    __syncthreads();                      // layer 1's ring is done
    store_gelu<H>(acc, b1, act);
    __syncthreads();                      // h1 whole; the ring is free
    gemm<Ring2, H, H, false, VEC>(acc, nullptr, 0, 0, 0, act, H, w2, ring);
    __syncthreads();                      // every read of h1 is done
    store_gelu<H>(acc, b2, act);
    __syncthreads();
  }
  float acc[Tile<L>::ROWS][Tile<L>::COLS];
  gemm<Ring2, L, H, false, VEC>(acc, nullptr, 0, 0, 0, act, H, w3, ring);
  cosine<L>(acc, b3, zq, out, n, q, row0, red);
}

template <int H, int L, bool VEC>
int launch(const float* docs, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* w3,
           const float* b3, const float* zq, float* out, int n, int d,
           int q, cudaStream_t stream) {
  constexpr int smem = smem_bytes<H>();
  static_assert(smem <= 232448, "more shared memory than a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      fused_scores_kernel<H, L, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BM - 1) / BM);
  fused_scores_kernel<H, L, VEC><<<grid, THREADS, smem, stream>>>(
      docs, w1, b1, w2, b2, w3, b3, zq, out, n, d, q);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Widths the kernel is built for: H and L each one of 64, 128, 256 or
// 512, with L <= H. D, n and Q are free.
int fused_scores_supported(int h, int l) {
  const bool h_ok = h == 64 || h == 128 || h == 256 || h == 512;
  const bool l_ok = l == 64 || l == 128 || l == 256 || l == 512;
  return h_ok && l_ok && l <= h;
}

// Dynamic shared memory of one block at hidden width h, in bytes.
int fused_scores_smem_bytes(int h) {
  switch (h) {
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 256: return smem_bytes<256>();
    case 512: return smem_bytes<512>();
  }
  return 0;
}

// docs (n, d), w1 (d, h), b1 (h), w2 (h, h), b2 (h), w3 (h, l), b3 (l),
// zq (q, l) unit rows -> out (n, q). All float32, contiguous, on the
// device of `stream`. 16-byte copies when d % 4 == 0 and docs, w1, w2
// and w3 are 16-byte aligned, 4-byte copies otherwise. Returns the CUDA
// error code of the launch.
int fused_scores_launch(const float* docs, const float* w1, const float* b1,
                        const float* w2, const float* b2, const float* w3,
                        const float* b3, const float* zq, float* out, int n,
                        int d, int h, int l, int q, void* stream) {
  if (!fused_scores_supported(h, l) || n <= 0 || q <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && aligned16(docs) && aligned16(w1) &&
                   aligned16(w2) && aligned16(w3);
#define FS_CASE(HH, LL)                                                      \
  if (h == HH && l == LL)                                                    \
    return vec ? launch<HH, LL, true>(docs, w1, b1, w2, b2, w3, b3, zq, out, \
                                      n, d, q, s)                            \
               : launch<HH, LL, false>(docs, w1, b1, w2, b2, w3, b3, zq,     \
                                       out, n, d, q, s);
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
