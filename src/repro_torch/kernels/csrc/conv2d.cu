// Direct VALID convolution, NCHW input x OIHW filter, any stride, tiled by
// the blocking LP's (bN, b_cI, b_cO, b_hO, b_wO) plan.
//
// Replaces: src/repro/kernels/conv2d.py, _conv_kernel (the Pallas TPU kernel).
//
// What bounds it on an H100: the FMA pipe and shared-memory reads. This
// first version multiplies with plain f32 FMAs (67 TFLOP/s peak), not the
// tensor cores (989 TFLOP/s bf16), so at the ResNet-50 shapes it is bound by
// operations, far above the card's memory bound; each FMA's operands come
// from shared memory.
//
// Design:
//  * One CTA per output tile (n, co, h, w); the tile index is flattened into
//    blockIdx.x (c_O tiles fastest, so CTAs that share an input window run
//    together and meet it in L2). A loop over the c_I blocks inside the CTA
//    takes the place of the TPU grid's sequential innermost c_I axis.
//  * The f32 accumulator stays in registers across that loop: each thread
//    owns a CO_T x P_T micro-tile (output channels x output pixels) of at
//    most 64 values, and a CTA has at most 256 threads, so a tile holds at
//    most 16,384 accumulators, the H100 preset's M_acc_eff. The micro-tile
//    shape is a template argument; the wrapper picks it from the plan.
//  * Per c_I step the CTA stages in dynamic shared memory exactly what the
//    reference DMAs: the halo input window (bN, b_cI, h_in, w_in) with
//    h_in = (b_hO - 1) * sh + h_F, and the (b_cO, b_cI, h_F, w_F) filter
//    block, zero-filled beyond the array edges (the reference pads in HBM;
//    here the loads are masked, so the words issued are the same windows
//    that conv2d_hbm_words counts). One stage: the loads are plain loads
//    (2-byte bf16 rows at any column offset do not meet cp.async's 4/8/16
//    byte granularity), so the step waits for its loads; other resident CTAs
//    hide part of that latency. The double-buffered ring the preset's
//    double_buffer=True assumes is later work.
//  * Then the h_F * w_F strided taps: each thread reads CO_T filter values
//    and P_T window values per (ci, hf, wf) and does CO_T * P_T FMAs.
//  * The padded output tile is stored once, after the last c_I step, into
//    the (Np, cOp, hOp, wOp) tensor the wrapper allocated.
//  * All global offsets are 64-bit; tile-local ones are 32-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ConvParams {
  long long N;
  int c_I, H, W, c_O, h_F, w_F, sh, sw;
  int bN, b_cI, b_cO, bh, bw, h_in, w_in;
  int cOp, hOp, wOp;          // padded output extents (Np is implied)
  int nCO, nH, nW, nCI;       // tile counts
  int nPG, ldW;               // pixel groups per CTA, filter row stride
  long long x_bytes;          // shared-memory offset of the filter block
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename Tin, typename Tout, int CO_T, int P_T>
__global__ void __launch_bounds__(256)
conv2d_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
              Tout* __restrict__ out, const ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tin* xs = reinterpret_cast<Tin*>(smem);
  Tin* ws = reinterpret_cast<Tin*>(smem + p.x_bytes);

  long long t = blockIdx.x;
  const int co_t = (int)(t % p.nCO); t /= p.nCO;
  const int wb = (int)(t % p.nW); t /= p.nW;
  const int hb = (int)(t % p.nH); t /= p.nH;
  const long long n0 = t * p.bN;
  const int co0 = co_t * p.b_cO;
  const int row0 = hb * p.bh * p.sh, col0 = wb * p.bw * p.sw;

  const int P = p.bN * p.bh * p.bw;           // output pixels per tile
  const int win = p.h_in * p.w_in;
  const int xwin = p.b_cI * win;              // one image's window
  const int x_elems = p.bN * xwin;
  const int taps = p.h_F * p.w_F;
  const int w_elems = p.b_cO * p.b_cI * taps;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid / p.nPG, pg = tid % p.nPG;

  // Window offset of each owned pixel (pixel pg + k * nPG of the tile).
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
  float acc[CO_T][P_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j)
#pragma unroll
    for (int k = 0; k < P_T; ++k) acc[j][k] = 0.f;

  // Filter columns [b_cO, ldW) are never loaded: zero them once.
  for (int i = tid; i < p.b_cI * taps * p.ldW; i += nthr)
    if (i % p.ldW >= p.b_cO) ws[i] = zero_of<Tin>();

  for (int cb = 0; cb < p.nCI; ++cb) {
    const int ci0 = cb * p.b_cI;
    __syncthreads();  // every thread is done reading the previous step
    for (int i = tid; i < x_elems; i += nthr) {
      const int col = i % p.w_in;
      int r = i / p.w_in;
      const int row = r % p.h_in; r /= p.h_in;
      const int c = r % p.b_cI, n = r / p.b_cI;
      const long long gn = n0 + n;
      const int gc = ci0 + c, gr = row0 + row, gcol = col0 + col;
      Tin v = zero_of<Tin>();
      if (gn < p.N && gc < p.c_I && gr < p.H && gcol < p.W)
        v = x[((gn * p.c_I + gc) * p.H + gr) * (long long)p.W + gcol];
      xs[i] = v;
    }
    for (int i = tid; i < w_elems; i += nthr) {  // global order: co, ci, tap
      const int tap = i % taps;
      const int r = i / taps;
      const int c = r % p.b_cI, co = r / p.b_cI;
      const int gco = co0 + co, gc = ci0 + c;
      Tin v = zero_of<Tin>();
      if (gco < p.c_O && gc < p.c_I)
        v = w[((long long)gco * p.c_I + gc) * taps + tap];
      ws[(c * taps + tap) * p.ldW + co] = v;
    }
    __syncthreads();

    for (int c = 0; c < p.b_cI; ++c) {
      for (int hf = 0; hf < p.h_F; ++hf) {
        for (int wf = 0; wf < p.w_F; ++wf) {
          const Tin* xr = xs + c * win + hf * p.w_in + wf;
          const Tin* wr = ws + (c * taps + hf * p.w_F + wf) * p.ldW + cg * CO_T;
          float wv[CO_T];
#pragma unroll
          for (int j = 0; j < CO_T; ++j) wv[j] = to_f(wr[j]);
#pragma unroll
          for (int k = 0; k < P_T; ++k) {
            const float xv = to_f(xr[xoff[k]]);
#pragma unroll
            for (int j = 0; j < CO_T; ++j) acc[j][k] = fmaf(wv[j], xv, acc[j][k]);
          }
        }
      }
    }
  }

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
        out[((n0 + n) * p.cOp + co0 + co) * plane + pix] = from_f<Tout>(acc[j][k]);
    }
  }
}

template <typename Tin, typename Tout, int CO_T, int P_T>
cudaError_t launch_t(const void* x, const void* w, void* out, const ConvParams& p,
                     long long blocks, int threads, int smem, cudaStream_t s) {
  auto kern = conv2d_kernel<Tin, Tout, CO_T, P_T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_v(int variant, const void* x, const void* w, void* out,
                     const ConvParams& p, long long blocks, int threads, int smem,
                     cudaStream_t s) {
  switch (variant) {  // micro-tile CO_T x P_T, as repro_torch.kernels.conv2d
    case 0: return launch_t<Tin, Tout, 8, 8>(x, w, out, p, blocks, threads, smem, s);
    case 1: return launch_t<Tin, Tout, 4, 16>(x, w, out, p, blocks, threads, smem, s);
    case 2: return launch_t<Tin, Tout, 16, 4>(x, w, out, p, blocks, threads, smem, s);
    case 3: return launch_t<Tin, Tout, 2, 32>(x, w, out, p, blocks, threads, smem, s);
    case 4: return launch_t<Tin, Tout, 1, 64>(x, w, out, p, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_conv2d(
    const void* x, const void* w, void* out, int in_dtype, int out_dtype,
    int variant, long long N, int c_I, int H, int W, int c_O, int h_F, int w_F,
    int sh, int sw, int bN, int b_cI, int b_cO, int bh, int bw, int h_in,
    int w_in, int cOp, int hOp, int wOp, int nN, int nCO, int nH, int nW,
    int nCI, int nPG, int ldW, long long x_bytes, int threads, int smem,
    void* stream) {
  ConvParams p{N, c_I, H, W, c_O, h_F, w_F, sh, sw, bN, b_cI, b_cO, bh, bw,
               h_in, w_in, cOp, hOp, wOp, nCO, nH, nW, nCI, nPG, ldW, x_bytes};
  const long long blocks = (long long)nN * nCO * nH * nW;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_dtype == 0 && out_dtype == 0)
    e = launch_v<float, float>(variant, x, w, out, p, blocks, threads, smem, s);
  else if (in_dtype == 0 && out_dtype == 1)
    e = launch_v<float, __nv_bfloat16>(variant, x, w, out, p, blocks, threads, smem, s);
  else if (in_dtype == 1 && out_dtype == 0)
    e = launch_v<__nv_bfloat16, float>(variant, x, w, out, p, blocks, threads, smem, s);
  else if (in_dtype == 1 && out_dtype == 1)
    e = launch_v<__nv_bfloat16, __nv_bfloat16>(variant, x, w, out, p, blocks, threads, smem, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
