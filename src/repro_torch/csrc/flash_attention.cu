// Flash attention forward: masked online softmax over streamed KV tiles.
//
// Replaces the Pallas kernel _flash_kernel / flash_attention_fwd
// (src/repro/kernels/flash_attention/flash.py:33-114). For each batch b,
// query head j and query row i at absolute position p = q_offset + i:
//     out[b, i, j] = sum_t softmax_t(scale * q[b,i,j] . k[b,t,g]) v[b,t,g]
// over the keys t < skv with t <= p (causal) and t > p - window
// (window > 0), where g = j / (h / kv_heads) is the shared KV head (GQA:
// read in place, never copied out). As in flash.py, masked scores take
// the finite sentinel -1e30 (never -inf, which would make exp(-inf -
// -inf) NaN), alpha = exp(m_old - m_new) rescales l and the accumulator,
// and the result is acc / max(l, 1e-30), written in the input's type.
// One C entry point holds two kernels and picks one by the input type:
// bfloat16 runs on the tensor cores, float32 on the FP32 pipes. Neither
// ever falls back to the other.
//
// Each kernel has a second form that also writes every row's
// log-sum-exp, lse = m + log(max(l, 1e-30)) as (b, h, sq) float32: the
// residual that the JAX package's custom VJP keeps beside out for its
// backward (_flash_fwd, src/repro/models/attention.py:179-281). The
// attention layer's autograd Function (models/attention.py) asks for it
// when a gradient is wanted. A template flag on each kernel gates the
// write, and lse is a last parameter that the forms without it never
// read, so those keep the code they had before the flag existed
// (tools/flash_variants.py --against matches them to an older source's
// kernels by name, flag and lse taken off, and compares their SASS), and
// out is the same in both forms.
//
// What bounds it: at the embedding path's shape (b=8, s=512, 32 query
// heads over 8 KV heads, head_dim 128, causal, bf16) one launch needs
// 4*b*h*hd*s(s+1)/2 = 1.7e10 FLOP and 84 MB of reads and writes (q, k, v
// once, out once): on an H100 that is 17 us at the 989 TFLOP/s bf16
// tensor-core peak against 25 us at 3.35 TB/s, so the ideal kernel is
// bound by bytes, narrowly.
//
// bfloat16 (flash_fwd_bf16_kernel): FlashAttention-2's shape in inline
// PTX. One block of 4 warps per (64-row Q tile, batch x head); each warp
// owns 16 query rows. The Q tile arrives once by cp.async and stays in
// registers for the whole loop as mma A fragments (ldmatrix). K and V
// tiles of 64 keys stream through a 2-stage shared-memory ring filled by
// 16-byte cp.async.cg copies (commit_group / wait_group): after the one
// barrier of each step, tile t+1's copies go into the stage that tile
// t-1 left and are in flight while tile t's products run. Rows are
// padded by 16 bytes, which keeps every ldmatrix free of bank conflicts;
// rows past skv or sq and columns past hd are zero-filled by the copy
// itself (src-size 0). Both products are mma.sync.m16n8k16 bf16 x bf16
// -> f32: S = Q K^T with K's B fragments from ldmatrix, O += P V with V's
// from ldmatrix.trans. The rounding points follow flash.py in all but
// one place: each bf16 x bf16 product is exact in f32 and sums in f32;
// the scale is applied to S in f32, never to Q before the product, and is
// folded with log2(e) so that each exponential is one ex2.approx (MUFU)
// of s * scale * log2(e) - m (m, the sentinel and alpha live in that
// base-2 domain; ex2.approx errs by ~2 f32 ulps, far below P's bf16
// rounding); m and l are f32 and l sums the f32 probabilities; O
// accumulates in f32. The one difference: P is rounded to bf16 as the A
// operand of P V, repacked from S's accumulator in registers (it never
// touches shared memory), where flash.py and the JAX package's blocked
// path keep P in f32 for P V (flash.py:44 upcasts V, 59-61 multiply in
// f32). Its plain version is ref.attention_blocked(..., round_p=True);
// chip_smoke.py also logs the kernel against round_p=False. Row max and
// row sum reduce over the 4 lanes that share a row with two
// __shfl_xor_sync.
// Tiles wholly outside every row's causal/window range are skipped
// (exact, as below), and only tiles that cross the diagonal, the window
// edge or the ragged end skv take the per-element select. The grid runs
// batch x head along x (the query heads of one KV head adjacent, so their
// K/V stay in L2) and the Q tiles along y in reverse order, heaviest
// causal tiles first. The head width is templated on hd rounded up to
// 16, 32, 64, 128, 240 or 256, and hd must be a multiple of 8 (whole
// 16-byte chunks). At hd 128 a block holds 85 KB of shared memory and 250
// registers a thread, so two blocks share an SM.
//
// Wide heads (hd 129-256; gemma3-12b's is 240) take the same kernel with
// two changes, both compile-time, that leave the narrow instantiations'
// code as it was. At hd 240 a warp's O accumulator alone is 30 n-tiles x
// 4 = 120 f32 registers a thread, and Q's fragments held over the loop
// would add 60 (15 k-steps x 4): (1) Q's A fragments are read from the
// Q tile in shared memory by one ldmatrix at each k-step of every K/V
// tile instead of being held in registers (a quarter more ldmatrix work
// for S = Q K^T); (2) K/V tiles are 32 keys, not 64, so S is 16
// registers and a block's shared memory is (64 + 2 x 2 x 32) rows x
// (hd + 8) x 2 B = 95 KB at HD 240 (101 KB at 256): two blocks an SM, as
// at hd 128, where 64-key tiles would allow one. The arithmetic is the
// same; only the tile on which the online softmax updates m is shorter.
// HD 240 is instantiated on its own, so gemma3's heads compute on no
// zero columns; 256 takes the widths from 241. ptxas gives both 255
// registers and spills a little (68 bytes stored, 100 loaded a thread at
// HD 240); the variants that take either change back, or unroll the
// k-steps less, spill as much or more and run no faster
// (tools/flash_variants.py, PERF.md).
//
// At the path's shape this design runs at about the time of
// FlashAttention-2's mma.sync kernel, some 4.7x the byte bound (PERF.md).
// What holds it there is the steady state, not the causal loops: a
// non-causal call, with 1.8x the tile steps, takes ~1.5x the time. With
// 16 rows a warp and 251 registers, each warp's ldmatrix -> mma chains
// and its softmax between the two products are exposed, and 8 warps an
// SM hide too little of them. Left for a later version: wgmma
// on 64-row warpgroup tiles (the only way to Hopper's full tensor-core
// rate; mma.sync stops short of it), TMA copies completing on mbarriers,
// warp specialisation (a producer warp feeding consumer warpgroups), the
// softmax of one tile overlapped with the products of the next, and a
// persistent grid.
//
// float32 (flash_fwd_kernel): every product on the FP32 pipes (67
// TFLOP/s), since the tolerance of the f32 path (2e-5) is below what a
// TF32 or bf16 product gives, so it is bound by arithmetic: the FLOP
// count at the FP32 peak is 0.26 ms. q is scaled before the dot, as in
// flash.py. One block of 256 threads per (64-row Q tile, batch x head).
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
// FP32 FMA with float4 shared-memory reads. The head width is templated
// on hd rounded up to 32, 64, 128, 240 or 256; at 240 a block holds
// 139 KB of shared memory (one block an SM) and each thread 4 x 15
// accumulator columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per streamed tile
constexpr int THREADS = 256;    // 16 row groups x 16 column groups
constexpr int RPT = BQ / 16;    // query rows per thread: 4
constexpr int KPT = BK / 16;    // key columns per thread: 4
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "load_tile fills tiles of one height");

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// The FP32 kernel; with LSE it also writes each row's log-sum-exp
// m + log(max(l, 1e-30)) to lse (b, h, sq), else lse is never read.
template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int h, int hkv, int hd, int causal, int window,
                 int q_offset, float scale, float* __restrict__ lse) {
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
    // m and l are whole-row values in each of the row's 16 lanes
    if constexpr (LSE) {
      if (tx == 0) lse[((size_t)bi * h + hi) * sq + q0 + r] = m[i] + logf(denom);
    }
  }
}

// The devices on which a kernel's dynamic shared memory limit is set, a
// bit each (devices 0-63; a device past them sets it at every launch).
struct DeviceFlags {
  std::atomic<unsigned long long> bits{0};
};

// cudaFuncSetAttribute once per kernel and device: the dynamic shared
// memory a block asks for beyond the default 48 KB. The attribute is
// per device, so a launch on a device not yet configured sets it there;
// the current device is the launch's (the wrapper makes the tensors'
// device current).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, DeviceFlags& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (configured.bits.load(std::memory_order_acquire) & bit)
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    configured.bits.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int sq, int skv, int h, int hkv, int hd,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static DeviceFlags configured, configured_lse;
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaError_t err;
  if (lse == nullptr) {
    if ((err = allow_smem(flash_fwd_kernel<T, HD, false>, bytes, configured)))
      return (int)err;
    flash_fwd_kernel<T, HD, false><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, ot, sq, skv, h, hkv, hd, causal, window, q_offset,
        scale, nullptr);
  } else {
    if ((err = allow_smem(flash_fwd_kernel<T, HD, true>, bytes,
                          configured_lse)))
      return (int)err;
    flash_fwd_kernel<T, HD, true><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, ot, sq, skv, h, hkv, hd, causal, window, q_offset,
        scale, lse);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              float* lse, int b, int sq, int skv, int h, int hkv, int hd,
              int causal, int window, int q_offset, float scale,
              cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, lse, b, sq, skv, h, hkv, hd, causal,
                         window, q_offset, scale, s);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, lse, b, sq, skv, h, hkv, hd, causal,
                         window, q_offset, scale, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, lse, b, sq, skv, h, hkv, hd,
                          causal, window, q_offset, scale, s);
  if (hd <= 240)
    return launch<T, 240>(q, k, v, out, lse, b, sq, skv, h, hkv, hd,
                          causal, window, q_offset, scale, s);
  return launch<T, 256>(q, k, v, out, lse, b, sq, skv, h, hkv, hd, causal,
                        window, q_offset, scale, s);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;                 // 16 query rows each
constexpr int BF_THREADS = 32 * WARPS;
constexpr int STAGES = 2;                // depth of the K/V ring
static_assert(BQ == 16 * WARPS, "one 16-row mma tile per warp");

// keys a K/V tile holds: 64, or 32 for heads wider than 128
template <int HD>
__host__ __device__ constexpr int bf16_tile_keys() {
  return HD <= 128 ? BK : 32;
}

template <int HD>
constexpr int bf16_smem_bytes() {        // Q, then the K ring, the V ring
  return (BQ + 2 * STAGES * bf16_tile_keys<HD>()) * (HD + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// 2^x on the MUFU unit (ex2(0) = 1 and ex2(-1e30) = 0 exactly;
// subnormal results flush to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A (ROWS, hd) slice with row stride `stride` (in elements) into a
// (ROWS, HD) bf16 tile with row stride HD + 8 by 16-byte cp.async copies;
// rows past `valid` and columns past `hd` (a multiple of 8) are
// zero-filled. Where the copies do not split evenly over the threads
// (32 rows at HD 240), the last round's surplus threads copy nothing.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                size_t stride, int valid,
                                                int hd) {
  constexpr int LDS = HD + 8, CHUNKS = HD / 8;
  constexpr bool EVEN = ROWS * CHUNKS % BF_THREADS == 0;
#pragma unroll
  for (int it = 0; it < (ROWS * CHUNKS + BF_THREADS - 1) / BF_THREADS;
       ++it) {
    const int i = threadIdx.x + it * BF_THREADS;
    if (!EVEN && i >= ROWS * CHUNKS) break;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = r < valid && c * 8 < hd;
    cp_async16(smem_addr(dst + r * LDS + c * 8),
               ok ? src + (size_t)r * stride + c * 8 : src, ok ? 16 : 0);
  }
}

// S += Q K^T for one k-step of 16 columns: the warp's 16 rows (A
// fragments `a`) against the TK keys of the K tile `ks`
template <int HD, int TK>
__device__ __forceinline__ void qk_step(float (&s)[TK / 8][4],
                                        const uint32_t (&a)[4],
                                        const bf16* ks, int kk, int lane) {
  constexpr int LDS = HD + 8;
#pragma unroll
  for (int jp = 0; jp < TK / 16; ++jp) {   // two n-tiles per ldmatrix
    uint32_t b[4];
    ldmatrix_x4(b, smem_addr(ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8)
                             * LDS + kk * 16 + ((lane >> 3) & 1) * 8));
    mma_bf16(s[2 * jp], a, b[0], b[1]);
    mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
  }
}

// The bf16 kernel; with LSE it also writes each row's log-sum-exp to
// lse (b, h, sq): m lives in the base-2 domain, so the natural-log value
// is m ln 2 + log(max(l, 1e-30)). Without LSE, lse is never read.
template <int HD, bool LSE>
__global__ void __launch_bounds__(BF_THREADS, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int sq, int skv, int h, int hkv, int hd, int causal,
                      int window, int q_offset, float scale_log2,
                      float* __restrict__ lse) {
  constexpr int LDS = HD + 8;       // padded rows: ldmatrix without conflicts
  constexpr int KSTEPS = HD / 16;   // k-steps of S = Q K^T
  constexpr int TK = bf16_tile_keys<HD>();   // keys of a K/V tile
  constexpr int NT_S = TK / 8;      // 8-key n-tiles of S
  constexpr int NT_O = HD / 8;      // 8-column n-tiles of O
  constexpr bool Q_IN_REGS = HD <= 128;   // else read at each k-step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq_tile = reinterpret_cast<bf16*>(smem_raw);   // BQ x LDS
  bf16* sk_ring = sq_tile + BQ * LDS;                  // STAGES x TK x LDS
  bf16* sv_ring = sk_ring + STAGES * TK * LDS;         // STAGES x TK x LDS

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;   // row group, lane in the group
  const int bh = blockIdx.x, bi = bh / h, hi = bh - bi * h;
  const int kvh = hi / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int nq = min(BQ, sq - q0);
  const size_t q_stride = (size_t)h * hd, kv_stride = (size_t)hkv * hd;
  const bf16* qb = q + ((size_t)bi * sq * h + hi) * hd + q0 * q_stride;
  const bf16* kb = k + ((size_t)bi * skv * hkv + kvh) * hd;
  const bf16* vb = v + ((size_t)bi * skv * hkv + kvh) * hd;
  bf16* ob = out + ((size_t)bi * sq * h + hi) * hd + q0 * q_stride;

  // keys [kv_lo, kv_hi) are visible to at least one row of the tile
  const int p_lo = q_offset + q0, p_hi = q_offset + q0 + nq - 1;
  const int kv_hi = causal ? min(skv, p_hi + 1) : skv;
  const int kv_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_lo = kv_lo / TK, t_hi = (kv_hi + TK - 1) / TK;

  load_tile_async<HD, BQ>(sq_tile, qb, q_stride, nq, hd);
  if (t_lo < t_hi) {
    load_tile_async<HD, TK>(sk_ring, kb + (size_t)t_lo * TK * kv_stride,
                            kv_stride, skv - t_lo * TK, hd);
    load_tile_async<HD, TK>(sv_ring, vb + (size_t)t_lo * TK * kv_stride,
                            kv_stride, skv - t_lo * TK, hd);
  }
  cp_async_commit();

  // this thread's rows of the warp's 16: g and g + 8
  const int row = warp * 16 + g;
  const int pos[2] = {q_offset + q0 + row, q_offset + q0 + row + 8};
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  float o[NT_O][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) % STAGES;
    cp_async_wait<0>();             // this thread's copies of tile t
    __syncthreads();                // everyone's; and tile t - 1 is done
    if (t + 1 < t_hi) {             // tile t + 1 into the stage of t - 1
      const int next = (t + 1 - t_lo) % STAGES;
      const size_t off = (size_t)(t + 1) * TK * kv_stride;
      load_tile_async<HD, TK>(sk_ring + next * TK * LDS, kb + off, kv_stride,
                              skv - (t + 1) * TK, hd);
      load_tile_async<HD, TK>(sv_ring + next * TK * LDS, vb + off, kv_stride,
                              skv - (t + 1) * TK, hd);
      cp_async_commit();
    }
    if constexpr (Q_IN_REGS) {
      if (t == t_lo) {              // the warp's Q rows, once
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldmatrix_x4(qf[kk], smem_addr(sq_tile + (warp * 16 + (lane & 15))
                                        * LDS + kk * 16 + (lane >> 4) * 8));
      }
    }
    const bf16* ks = sk_ring + stage * TK * LDS;
    const bf16* vs = sv_ring + stage * TK * LDS;

    // S = Q K^T: 16 rows x TK keys per warp
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if constexpr (Q_IN_REGS) {
        qk_step<HD, TK>(s, qf[kk], ks, kk, lane);
      } else {                      // the warp's Q rows, this k-step
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(sq_tile + (warp * 16 + (lane & 15)) * LDS
                                 + kk * 16 + (lane >> 4) * 8));
        qk_step<HD, TK>(s, a, ks, kk, lane);
      }
    }

    // scale in f32 (base 2), then mask where the tile crosses an edge
    const int k0 = t * TK;
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    const bool edge = k0 + TK > skv || (causal && k0 + TK - 1 > p_lo) ||
                      (window > 0 && k0 < p_hi - window + 1);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + tg * 2 + (e & 1);
          const int p = pos[e >> 1];
          bool ok = key < skv;
          if (causal) ok = ok && key <= p;
          if (window > 0) ok = ok && key > p - window;
          s[j][e] = ok ? s[j][e] : NEG_INF;
        }
    }

    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = fast_exp2(s[j][e] - m_new);
          sum += s[j][e];
        }
      l[r] = l[r] * alpha + sum;    // this lane's share; summed at the end
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V: S's accumulator repacked as bf16 A fragments, 16 keys each
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {   // two n-tiles per ldmatrix
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vs + (kk * 16 + (lane & 15)) * LDS
                                       + np * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // acc / max(l, 1e-30) in bf16, staged through the warp's own Q rows so
  // that the global stores are whole 16-byte chunks (a block that ran no
  // tile may still have Q's copies in flight: wait for them first)
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* dst = sq_tile + (row + 8 * r) * LDS + tg * 2;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    // m is the row's in all 4 lanes of its group, l now summed over them
    if constexpr (LSE) {
      if (tg == 0 && row + 8 * r < nq)
        lse[((size_t)bi * h + hi) * sq + q0 + row + 8 * r] =
            m[r] * 0.6931471805599453f + logf(denom);
    }
  }
  __syncwarp();
  constexpr int CHUNKS = HD / 8;
#pragma unroll
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = warp * 16 + i / CHUNKS, c = i % CHUNKS;
    if (r < nq && c * 8 < hd)
      *reinterpret_cast<uint4*>(ob + (size_t)r * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(sq_tile + r * LDS + c * 8);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int sq, int skv, int h, int hkv, int hd,
                int causal, int window, int q_offset, float scale,
                cudaStream_t stream) {
  constexpr int bytes = bf16_smem_bytes<HD>();
  static DeviceFlags configured, configured_lse;
  const dim3 grid(b * h, (sq + BQ - 1) / BQ);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(out);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaError_t err;
  if (lse == nullptr) {
    if ((err = allow_smem(flash_fwd_bf16_kernel<HD, false>, bytes, configured)))
      return (int)err;
    flash_fwd_bf16_kernel<HD, false><<<grid, BF_THREADS, bytes, stream>>>(
        qt, kt, vt, ot, sq, skv, h, hkv, hd, causal, window, q_offset,
        scale_log2, nullptr);
  } else {
    if ((err = allow_smem(flash_fwd_bf16_kernel<HD, true>, bytes,
                          configured_lse)))
      return (int)err;
    flash_fwd_bf16_kernel<HD, true><<<grid, BF_THREADS, bytes, stream>>>(
        qt, kt, vt, ot, sq, skv, h, hkv, hd, causal, window, q_offset,
        scale_log2, lse);
  }
  return (int)cudaGetLastError();
}

int launch_bf16_hd(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int sq, int skv, int h, int hkv,
                   int hd, int causal, int window, int q_offset, float scale,
                   cudaStream_t s) {
  if (hd <= 16)
    return launch_bf16<16>(q, k, v, out, lse, b, sq, skv, h, hkv, hd,
                           causal, window, q_offset, scale, s);
  if (hd <= 32)
    return launch_bf16<32>(q, k, v, out, lse, b, sq, skv, h, hkv, hd,
                           causal, window, q_offset, scale, s);
  if (hd <= 64)
    return launch_bf16<64>(q, k, v, out, lse, b, sq, skv, h, hkv, hd,
                           causal, window, q_offset, scale, s);
  if (hd <= 128)
    return launch_bf16<128>(q, k, v, out, lse, b, sq, skv, h, hkv, hd,
                            causal, window, q_offset, scale, s);
  if (hd <= 240)
    return launch_bf16<240>(q, k, v, out, lse, b, sq, skv, h, hkv, hd,
                            causal, window, q_offset, scale, s);
  return launch_bf16<256>(q, k, v, out, lse, b, sq, skv, h, hkv, hd,
                          causal, window, q_offset, scale, s);
}

}  // namespace

extern "C" {

// q (b, sq, h, hd), k and v (b, skv, hkv, hd), out (b, sq, h, hd): all
// contiguous, of one type (bf16 != 0: bfloat16, else float32), on the
// device of `stream`, bfloat16 ones 16-byte aligned. lse: null, or a
// contiguous float32 (b, h, sq) that receives each row's log-sum-exp
// (the kernels' LSE instantiations; without it the others run). h must be
// a multiple of hkv, hd at most 256 (for bfloat16 a multiple of 8),
// window >= 0 (0: none), q_offset >= 0. Returns the CUDA error code of the
// launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int b, int sq, int skv,
                           int h, int hkv, int hd, int causal, int window,
                           int q_offset, int bf16, float scale,
                           void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || hkv <= 0 || h % hkv ||
      hd <= 0 || hd > 256 || window < 0 || q_offset < 0 ||
      (long long)b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // grid y: the Q tiles for bfloat16, batch x head for float32
  if (!bf16 && b * h > 65535) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (hd % 8 || (sq + BQ - 1) / BQ > 65535 ||
        ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
      return (int)cudaErrorInvalidValue;
    return launch_bf16_hd(q, k, v, out, static_cast<float*>(lse), b, sq,
                          skv, h, hkv, hd, causal, window, q_offset, scale,
                          s);
  }
  return launch_hd<float>(q, k, v, out, static_cast<float*>(lse), b, sq,
                          skv, h, hkv, hd, causal, window, q_offset, scale,
                          s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
