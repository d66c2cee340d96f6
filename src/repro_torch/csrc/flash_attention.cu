// Flash attention forward: masked online softmax over streamed KV tiles.
//
// Replaces the Pallas kernel _flash_kernel / flash_attention_fwd
// (src/repro/kernels/flash_attention/flash.py:33-114). For each batch b,
// query head j and query row i at absolute position p = q_offset + i:
//     out[b, i, j] = sum_t softmax_t(scale * q[b,i,j] . k[b,t,g]) v[b,t,g]
// over the keys t < skv with t <= p (causal) and t > p - window
// (window > 0), where g = j / (h / kv_heads) is the shared KV head (GQA:
// read in place, never copied out). Inputs are float32 or bfloat16; every
// product, the running max m, the running sum l and the output
// accumulator are float32; the output is written in the input's type.
// The arithmetic follows flash.py: q is scaled before the dot, masked
// scores take the finite sentinel -1e30 (never -inf, which would make
// exp(-inf - -inf) NaN), alpha = exp(m_old - m_new) rescales l and the
// accumulator, and the result is acc / max(l, 1e-30).
//
// What bounds it: at the embedding path's shape (b=8, s=512, 32 query
// heads over 8 KV heads, head_dim 128, causal, bf16) one launch needs
// 4*b*h*hd*s(s+1)/2 = 1.7e10 FLOP and 84 MB of reads and writes (q, k, v
// once, out once): on an H100 that is 17 us at the 989 TFLOP/s bf16
// tensor-core peak against 25 us at 3.35 TB/s, so the ideal kernel is
// bound by bytes, narrowly. This kernel runs its products on the FP32
// pipes (67 TFLOP/s), 15x below the tensor cores, so in practice it is
// bound by arithmetic: the FLOP count at the FP32 peak is 0.26 ms.
//
// Design. One block of 256 threads per (64-row Q tile, batch x head).
// The Q tile is loaded once, scaled, into shared memory as float32; K and
// V tiles of 64 keys stream through one shared buffer (K for S = Q K^T,
// then V for O += P V), so 85 KB of shared memory per block lets two
// blocks share an SM. Each thread owns 4 query rows (strided by 16) and
// 4 key columns of S, and the same 4 rows by head_dim/16 columns of the
// output accumulator, all in registers; a row's max and sum are reduced
// over the 16 lanes that share it with warp shuffles. Tiles wholly above
// the causal diagonal or wholly before the window of every row of the Q
// tile are skipped: for such a tile every p would be 0 (or wiped by the
// next tile's alpha = 0), so skipping is exact. The products are plain
// FP32 FMA with float4 shared-memory reads; mma.sync/wgmma tensor cores,
// TMA and pipelining are left to a later change (see PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per streamed tile
constexpr int THREADS = 256;    // 16 row groups x 16 column groups
constexpr int RPT = BQ / 16;    // query rows per thread: 4
constexpr int KPT = BK / 16;    // key columns per thread: 4
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "load_tile fills tiles of one height");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr int smem_bytes() {
  return (BQ * (HD + 4) + BK * (HD + 4) + BQ * (BK + 4)) * 4;
}

// A (BK, hd) slice with row stride `stride` (in elements) into a
// (BK, HD) float tile with row stride HD + 4, times `mul`; rows past
// `valid` and columns past `hd` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          size_t stride, int valid, int hd,
                                          float mul, float* dst) {
  constexpr int LD = HD + 4;
  for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    float x = 0.0f;
    if (r < valid && d < hd) x = to_float(src[(size_t)r * stride + d]) * mul;
    dst[r * LD + d] = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int h, int hkv, int hd, int causal, int window,
                 int q_offset, float scale) {
  constexpr int LD = HD + 4;      // padded rows keep float4 reads aligned
  constexpr int LDP = BK + 4;     // and spread them over the banks
  constexpr int CPT = HD / 16;    // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // BQ x LD, scaled Q
  float* kvs = qs + BQ * LD;      // BK x LD, K then V
  float* ps = kvs + BK * LD;      // BQ x LDP, probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, bi = bh / h, hi = bh - bi * h;
  const int kvh = hi / (h / hkv);
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, sq - q0);
  const size_t q_stride = (size_t)h * hd, kv_stride = (size_t)hkv * hd;
  const T* qb = q + ((size_t)bi * sq * h + hi) * hd + q0 * q_stride;
  const T* kb = k + ((size_t)bi * skv * hkv + kvh) * hd;
  const T* vb = v + ((size_t)bi * skv * hkv + kvh) * hd;
  T* ob = out + ((size_t)bi * sq * h + hi) * hd + q0 * q_stride;

  load_tile<T, HD>(qb, q_stride, nq, hd, scale, qs);

  // keys [kv_lo, kv_hi) are visible to at least one row of the tile
  const int p_lo = q_offset + q0, p_hi = q_offset + q0 + nq - 1;
  const int kv_hi = causal ? min(skv, p_hi + 1) : skv;
  const int kv_lo = window > 0 ? max(0, p_lo - window + 1) : 0;

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (kv_lo / BK) * BK; k0 < kv_hi; k0 += BK) {
    const int nk = min(BK, skv - k0);
    __syncthreads();              // the last tile's P V is done with kvs
    load_tile<T, HD>(kb + k0 * kv_stride, kv_stride, nk, hd, 1.0f, kvs);
    __syncthreads();

    // S = (scale Q) K^T for rows ty + 16 i, keys tx + 16 j
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[RPT], b[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        b[j] = *reinterpret_cast<const float4*>(&kvs[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
      const int p = q_offset + q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int t = k0 + tx + 16 * j;
        bool ok = t < skv;
        if (causal) ok = ok && t <= p;
        if (window > 0) ok = ok && t > p - window;
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float e = expf(s[i][j] - m_new);
        ps[r * LDP + tx + 16 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();              // every thread is done reading K
    load_tile<T, HD>(vb + k0 * kv_stride, kv_stride, nk, hd, 1.0f, kvs);
    __syncthreads();

    // O += P V for rows ty + 16 i, columns tx + 16 c
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = kvs[(kk + u) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pu = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                         : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[(size_t)r * q_stride + d] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int hkv, int hd, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, h, hkv, hd,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int sq, int skv, int h, int hkv, int hd, int causal,
              int window, int q_offset, float scale, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, b, sq, skv, h, hkv, hd, causal,
                         window, q_offset, scale, s);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, b, sq, skv, h, hkv, hd, causal,
                         window, q_offset, scale, s);
  return launch<T, 128>(q, k, v, out, b, sq, skv, h, hkv, hd, causal,
                        window, q_offset, scale, s);
}

}  // namespace

extern "C" {

// q (b, sq, h, hd), k and v (b, skv, hkv, hd), out (b, sq, h, hd): all
// contiguous, of one type (bf16 != 0: bfloat16, else float32), on the
// device of `stream`. h must be a multiple of hkv, hd at most 128,
// window >= 0 (0: none), q_offset >= 0. Returns the CUDA error code of
// the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int b, int sq, int skv, int h, int hkv,
                           int hd, int causal, int window, int q_offset,
                           int bf16, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || hkv <= 0 || h % hkv ||
      hd <= 0 || hd > 128 || b * h > 65535 || window < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, b, sq, skv, h, hkv, hd,
                                    causal, window, q_offset, scale, s);
  return launch_hd<float>(q, k, v, out, b, sq, skv, h, hkv, hd, causal,
                          window, q_offset, scale, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
