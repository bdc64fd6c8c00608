// int8 direct convolution and int8 GEMM, each with an int32 accumulator and
// one folded f32 scale per output channel (column) applied at the store.
//
// Replaces: src/repro/kernels/quant.py, _conv_q_kernel (entry conv2d_q) and
// _matmul_q_kernel (entry matmul_q), the Pallas TPU kernels.
//
//   out[n, co, h, w] = float(sum over c_I and taps of x_q * w_q) * scale[co]
//   out[i, j]        = float(sum over k of a_q * b_q) * scale[j]
//
// then cast to out_dtype (float32 or bfloat16).
//
// What bounds them on an H100: the integer pipe and shared-memory reads.
// This first version multiplies with __dp4a (four int8 products summed into
// an int32 per instruction, on the CUDA cores), not the int8 tensor cores
// (1,979 TOP/s dense): at the ResNet-50 shapes it is bound by operations,
// far above the card's memory bound.
//
// Numerics: the int32 sum is exact (the largest |sum| at the ResNet-50
// shapes is 512 * 9 * 127^2 ~ 7.4e7 < 2^31); it is converted to f32 once, at
// the store, multiplied by the f32 scale and cast to out_dtype, each step
// rounding to nearest even. The reference instead adds each (tap, c_I block)
// int32 partial into an f32 accumulator, which rounds once a sum passes
// 2^24; below that the two agree bit for bit.
//
// Design (the structure of conv2d.cu and matmul.cu):
//  * One CTA per output tile, the tile index flattened into blockIdx.x;
//    the loop over the reduction blocks (c_I blocks, k blocks) runs inside
//    the CTA, the int32 accumulator stays in registers across it.
//  * Accumulator budget: the H100 int8 plans hold up to 32,768 accumulators
//    per tile (the reference's LP prices the accumulator at the output's
//    stored width, half a word for bf16), twice what the bf16 kernels hold.
//    So a CTA has up to 512 threads, each owning a micro-tile of 64 int32
//    registers (__launch_bounds__(512, 1): at most 128 registers a thread).
//    The micro-tile shape is a template argument; the wrapper picks it.
//  * Shared memory holds int32 words of four int8 values along the
//    reduction axis (four input channels of one pixel; four k of one row or
//    column), so one __dp4a takes one x word and one w word. The words are
//    packed from byte loads masked to the array and the tile (zero-filled
//    beyond), so the bytes issued are the windows and blocks that
//    conv2d_q_hbm_words / matmul_q_hbm_words count. One stage.
//  * Scale: after the reduction each CTA stages its b_cO (bn) slice of the
//    scale vector in shared memory and applies it at the store. The counter
//    keeps the reference's convention (c_O words once per launch), so the
//    words issued exceed it by (CTAs - c_O tiles) * b_cO: 0.31% on conv1,
//    0.19% on conv2_x, less on the other layers of the H100 plans.
//  * All global offsets are 64-bit; tile-local ones are 32-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int pack4(int word, int q, int8_t v) {
  return word | ((int)(uint8_t)v << (8 * q));
}

// ---------------------------------------------------------------------------
// conv2d_q
// ---------------------------------------------------------------------------

struct ConvQParams {
  long long N;
  int c_I, H, W, c_O, h_F, w_F, sh, sw;
  int bN, b_cI, b_cO, bh, bw, h_in, w_in;
  int cI4;                    // channel quads per c_I block: ceil(b_cI / 4)
  int cOp, hOp, wOp;          // padded output extents (Np is implied)
  int nCO, nH, nW, nCI;       // tile counts
  int nPG, ldW;               // pixel groups per CTA, filter row stride (words)
  int x_bytes, w_bytes;       // shared-memory offsets of the filter, scale
};

template <typename Tout, int CO_T, int P_T>
__global__ void __launch_bounds__(512, 1)
conv2d_q_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, Tout* __restrict__ out,
                const ConvQParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* xs = reinterpret_cast<int*>(smem);                  // [n][c4][h_in][w_in]
  int* ws = reinterpret_cast<int*>(smem + p.x_bytes);      // [c4][tap][ldW]
  float* sc = reinterpret_cast<float*>(smem + p.x_bytes + p.w_bytes);

  long long t = blockIdx.x;
  const int co_t = (int)(t % p.nCO); t /= p.nCO;
  const int wb = (int)(t % p.nW); t /= p.nW;
  const int hb = (int)(t % p.nH); t /= p.nH;
  const long long n0 = t * p.bN;
  const int co0 = co_t * p.b_cO;
  const int row0 = hb * p.bh * p.sh, col0 = wb * p.bw * p.sw;

  const int P = p.bN * p.bh * p.bw;           // output pixels per tile
  const int win = p.h_in * p.w_in;
  const int xwin = p.cI4 * win;               // one image's window, in words
  const int x_words = p.bN * xwin;
  const int taps = p.h_F * p.w_F;
  const int w_words = p.b_cO * p.cI4 * taps;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid / p.nPG, pg = tid % p.nPG;

  int xoff[P_T];
#pragma unroll
  for (int k = 0; k < P_T; ++k) {
    const int pp = pg + k * p.nPG;
    xoff[k] = 0;
    if (pp < P) {
      const int wo = pp % p.bw, r = pp / p.bw;
      const int ho = r % p.bh, n = r / p.bh;
      xoff[k] = n * xwin + ho * p.sh * p.w_in + wo * p.sw;
    }
  }
  int acc[CO_T][P_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j)
#pragma unroll
    for (int k = 0; k < P_T; ++k) acc[j][k] = 0;

  // Filter columns [b_cO, ldW) are never loaded: zero them once.
  for (int i = tid; i < p.cI4 * taps * p.ldW; i += nthr)
    if (i % p.ldW >= p.b_cO) ws[i] = 0;

  for (int cb = 0; cb < p.nCI; ++cb) {
    const int ci0 = cb * p.b_cI;
    __syncthreads();  // every thread is done reading the previous step
    for (int i = tid; i < x_words; i += nthr) {
      const int col = i % p.w_in;
      int r = i / p.w_in;
      const int row = r % p.h_in; r /= p.h_in;
      const int c4 = r % p.cI4, n = r / p.cI4;
      const long long gn = n0 + n;
      const int gr = row0 + row, gcol = col0 + col;
      int word = 0;
      if (gn < p.N && gr < p.H && gcol < p.W) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * c4 + q, gc = ci0 + c;
          if (c < p.b_cI && gc < p.c_I)
            word = pack4(word, q,
                         x[((gn * p.c_I + gc) * p.H + gr) * (long long)p.W + gcol]);
        }
      }
      xs[i] = word;
    }
    for (int i = tid; i < w_words; i += nthr) {  // global order: co, c, tap
      const int tap = i % taps;
      const int r = i / taps;
      const int c4 = r % p.cI4, co = r / p.cI4;
      const int gco = co0 + co;
      int word = 0;
      if (gco < p.c_O) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * c4 + q, gc = ci0 + c;
          if (c < p.b_cI && gc < p.c_I)
            word = pack4(word, q, w[((long long)gco * p.c_I + gc) * taps + tap]);
        }
      }
      ws[(c4 * taps + tap) * p.ldW + co] = word;
    }
    __syncthreads();

    for (int c4 = 0; c4 < p.cI4; ++c4) {
      for (int hf = 0; hf < p.h_F; ++hf) {
        for (int wf = 0; wf < p.w_F; ++wf) {
          const int* xr = xs + c4 * win + hf * p.w_in + wf;
          const int* wr = ws + (c4 * taps + hf * p.w_F + wf) * p.ldW + cg * CO_T;
          int wv[CO_T];
#pragma unroll
          for (int j = 0; j < CO_T; ++j) wv[j] = wr[j];
#pragma unroll
          for (int k = 0; k < P_T; ++k) {
            const int xv = xr[xoff[k]];
#pragma unroll
            for (int j = 0; j < CO_T; ++j) acc[j][k] = __dp4a(wv[j], xv, acc[j][k]);
          }
        }
      }
    }
  }

  // The CTA's slice of the folded scale (0 past c_O: padded channels).
  for (int i = tid; i < p.b_cO; i += nthr)
    sc[i] = (co0 + i < p.c_O) ? scale[co0 + i] : 0.f;
  __syncthreads();

#pragma unroll
  for (int k = 0; k < P_T; ++k) {
    const int pp = pg + k * p.nPG;
    if (pp >= P) continue;
    const int wo = pp % p.bw, r = pp / p.bw;
    const int ho = r % p.bh, n = r / p.bh;
    const long long plane = (long long)p.hOp * p.wOp;
    const long long pix = (long long)(hb * p.bh + ho) * p.wOp + wb * p.bw + wo;
#pragma unroll
    for (int j = 0; j < CO_T; ++j) {
      const int co = cg * CO_T + j;
      if (co < p.b_cO)
        out[((n0 + n) * p.cOp + co0 + co) * plane + pix] =
            from_f<Tout>((float)acc[j][k] * sc[co]);
    }
  }
}

template <typename Tout, int CO_T, int P_T>
cudaError_t conv_launch_t(const void* x, const void* w, const void* scale,
                          void* out, const ConvQParams& p, long long blocks,
                          int threads, int smem, cudaStream_t s) {
  auto kern = conv2d_q_kernel<Tout, CO_T, P_T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t conv_launch_v(int variant, const void* x, const void* w,
                          const void* scale, void* out, const ConvQParams& p,
                          long long blocks, int threads, int smem,
                          cudaStream_t s) {
  switch (variant) {  // micro-tile CO_T x P_T, as repro_torch.kernels.quant
    case 0: return conv_launch_t<Tout, 8, 8>(x, w, scale, out, p, blocks, threads, smem, s);
    case 1: return conv_launch_t<Tout, 4, 16>(x, w, scale, out, p, blocks, threads, smem, s);
    case 2: return conv_launch_t<Tout, 16, 4>(x, w, scale, out, p, blocks, threads, smem, s);
    case 3: return conv_launch_t<Tout, 2, 32>(x, w, scale, out, p, blocks, threads, smem, s);
    case 4: return conv_launch_t<Tout, 1, 64>(x, w, scale, out, p, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// matmul_q
// ---------------------------------------------------------------------------

struct MMQParams {
  long long m;
  int n, k;
  int bm, bn, bk, bk4;  // bk4 = ceil(bk / 4): packed k words per step
  int nNT, nKT;         // n tiles, k tiles
  long long ldo;        // padded output row length (np)
  int nRG, ldA, ldB;    // row groups, shared-memory row strides (words)
  int a_bytes, b_bytes; // shared-memory offsets of the B tile, scale
};

template <typename Tout, int TM, int TN>
__global__ void __launch_bounds__(512, 1)
matmul_q_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                const float* __restrict__ scale, Tout* __restrict__ out,
                const MMQParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* as = reinterpret_cast<int*>(smem);               // [bk4][ldA]
  int* bs = reinterpret_cast<int*>(smem + p.a_bytes);   // [bk4][ldB]
  float* sc = reinterpret_cast<float*>(smem + p.a_bytes + p.b_bytes);

  const long long t = blockIdx.x;
  const int jt = (int)(t % p.nNT);
  const long long row0 = (t / p.nNT) * p.bm;
  const int col0 = jt * p.bn;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid / p.nRG, rg = tid % p.nRG;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  // B columns [bn, ldB) are never loaded: zero them once.
  for (int i = tid; i < p.bk4 * p.ldB; i += nthr)
    if (i % p.ldB >= p.bn) bs[i] = 0;

  for (int kt = 0; kt < p.nKT; ++kt) {
    const int k0 = kt * p.bk;
    __syncthreads();  // every thread is done reading the previous step
    for (int i = tid; i < p.bm * p.bk4; i += nthr) {  // global order: row, k
      const int k4 = i % p.bk4, r = i / p.bk4;
      const long long gr = row0 + r;
      int word = 0;
      if (gr < p.m) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * k4 + q, gk = k0 + kk;
          if (kk < p.bk && gk < p.k) word = pack4(word, q, a[gr * p.k + gk]);
        }
      }
      as[k4 * p.ldA + r] = word;
    }
    for (int i = tid; i < p.bk4 * p.bn; i += nthr) {  // global order: k, col
      const int c = i % p.bn, k4 = i / p.bn;
      const int gc = col0 + c;
      int word = 0;
      if (gc < p.n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * k4 + q, gk = k0 + kk;
          if (kk < p.bk && gk < p.k)
            word = pack4(word, q, b[(long long)gk * p.n + gc]);
        }
      }
      bs[k4 * p.ldB + c] = word;
    }
    __syncthreads();

    for (int k4 = 0; k4 < p.bk4; ++k4) {
      const int* ar = as + k4 * p.ldA;
      const int* br = bs + k4 * p.ldB + cg * TN;
      int bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = br[j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = min(rg + i * p.nRG, p.bm - 1);
        const int av = ar[r];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av, bv[j], acc[i][j]);
      }
    }
  }

  // The CTA's slice of the folded scale (0 past n: padded columns).
  for (int i = tid; i < p.bn; i += nthr)
    sc[i] = (col0 + i < p.n) ? scale[col0 + i] : 0.f;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rg + i * p.nRG;
    if (r >= p.bm) continue;
    Tout* orow = out + (row0 + r) * p.ldo + col0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = cg * TN + j;
      if (c < p.bn) orow[c] = from_f<Tout>((float)acc[i][j] * sc[c]);
    }
  }
}

template <typename Tout, int TM, int TN>
cudaError_t mm_launch_t(const void* a, const void* b, const void* scale,
                        void* out, const MMQParams& p, long long blocks,
                        int threads, int smem, cudaStream_t s) {
  auto kern = matmul_q_kernel<Tout, TM, TN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(scale), static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t mm_launch_v(int variant, const void* a, const void* b,
                        const void* scale, void* out, const MMQParams& p,
                        long long blocks, int threads, int smem,
                        cudaStream_t s) {
  switch (variant) {  // micro-tile TM x TN, as repro_torch.kernels.quant
    case 0: return mm_launch_t<Tout, 8, 8>(a, b, scale, out, p, blocks, threads, smem, s);
    case 1: return mm_launch_t<Tout, 16, 4>(a, b, scale, out, p, blocks, threads, smem, s);
    case 2: return mm_launch_t<Tout, 4, 16>(a, b, scale, out, p, blocks, threads, smem, s);
    case 3: return mm_launch_t<Tout, 32, 2>(a, b, scale, out, p, blocks, threads, smem, s);
    case 4: return mm_launch_t<Tout, 64, 1>(a, b, scale, out, p, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out_dtype codes: 0 = float32, 1 = bfloat16. Return the launch's cudaError_t.
extern "C" int repro_conv2d_q(
    const void* x, const void* w, const void* scale, void* out, int out_dtype,
    int variant, long long N, int c_I, int H, int W, int c_O, int h_F, int w_F,
    int sh, int sw, int bN, int b_cI, int b_cO, int bh, int bw, int h_in,
    int w_in, int cOp, int hOp, int wOp, int nN, int nCO, int nH, int nW,
    int nCI, int nPG, int ldW, int x_bytes, int w_bytes, int threads, int smem,
    void* stream) {
  ConvQParams p{N, c_I, H, W, c_O, h_F, w_F, sh, sw, bN, b_cI, b_cO, bh, bw,
                h_in, w_in, (b_cI + 3) / 4, cOp, hOp, wOp, nCO, nH, nW, nCI,
                nPG, ldW, x_bytes, w_bytes};
  const long long blocks = (long long)nN * nCO * nH * nW;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return (int)conv_launch_v<float>(variant, x, w, scale, out, p, blocks, threads, smem, s);
  if (out_dtype == 1)
    return (int)conv_launch_v<__nv_bfloat16>(variant, x, w, scale, out, p, blocks, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_matmul_q(
    const void* a, const void* b, const void* scale, void* out, int out_dtype,
    int variant, long long m, int n, int k, int bm, int bn, int bk,
    long long nMT, int nNT, int nKT, long long ldo, int nRG, int ldA, int ldB,
    int a_bytes, int b_bytes, int threads, int smem, void* stream) {
  MMQParams p{m, n, k, bm, bn, bk, (bk + 3) / 4, nNT, nKT, ldo, nRG, ldA, ldB,
              a_bytes, b_bytes};
  const long long blocks = nMT * nNT;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return (int)mm_launch_v<float>(variant, a, b, scale, out, p, blocks, threads, smem, s);
  if (out_dtype == 1)
    return (int)mm_launch_v<__nv_bfloat16>(variant, a, b, scale, out, p, blocks, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}
