// Causal depthwise conv1d (the mamba short convolution), K <= 8 taps:
//
//   y[b, t, d] = sum over k < K of w[k, d] * x[b, t - (K-1) + k, d]
//
// with zero left padding, f32 accumulation and y in x's dtype.
//
// Replaces: src/repro/kernels/conv1d.py, _conv1d_kernel (the Pallas TPU
// kernel, entry conv1d_causal), which holds the whole sequence of a
// (bB, L, bD) tile in VMEM.
//
// What bounds it on an H100: bytes. It does 2K flops per output and reads
// and writes one element each, far below the card's ~295 flops a byte, so
// the least time is (2 B L D + K D) elements over 3.35 TB/s.
//
// Design:
//  * One CTA per (bB, bD) tile of the (nB, nD) grid, the TPU grid's tiles
//    (gridDim = (nD, nB)). A (bB, L, bD) tile does not fit 227 KB of
//    shared memory at long L, so nothing is staged but the filter: each
//    thread owns one (b, d) of the tile (threads stride over the tile when
//    it holds more than the CTA's threads), keeps the last K-1 inputs in
//    registers and walks t from 0 to L-1, reading each x[b, t, d] once and
//    writing each y[b, t, d] once. Neighbouring threads take neighbouring d,
//    so each load and store is coalesced along the contiguous channel axis.
//  * Each CTA reads its (K, bD) filter block into shared memory once; the
//    threads take their K taps from there into registers. The words issued
//    equal conv1d_hbm_words, except when nD == 1 and nB > 1: every CTA then
//    reads the filter block where the counter (the Pallas pipeline, which
//    skips the re-fetch of an unchanged block) charges one fetch.
//  * Ragged B and D edges are masked, not padded in device memory.
//  * x may be a row-strided view (the x half of the in-projection): its
//    channel axis must be contiguous; batch and time strides are arguments.
//  * Order of the sum: tap K-1 first, then k = 0 .. K-2, as the Pallas
//    kernel adds them, with __fmul_rn/__fadd_rn so that nvcc contracts
//    nothing into an FMA; the plain PyTorch version adds in the same order,
//    so the two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct C1Params {
  int B, L, D;
  int bB, bD;
  long long sxb, sxt;  // x strides (elements) of the batch and time axes
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int K>
__global__ void __launch_bounds__(256)
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ y, const C1Params p) {
  extern __shared__ float wsm[];  // [K][bD]
  const int d0 = blockIdx.x * p.bD;
  const int b0 = blockIdx.y * p.bB;
  for (int i = threadIdx.x; i < K * p.bD; i += blockDim.x) {
    const int d = d0 + i % p.bD;
    wsm[i] = d < p.D ? to_f(w[(long long)(i / p.bD) * p.D + d]) : 0.f;
  }
  __syncthreads();

  const int tile = p.bB * p.bD;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int dd = i % p.bD;
    const int b = b0 + i / p.bD, d = d0 + dd;
    if (b >= p.B || d >= p.D) continue;
    float wk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k] = wsm[k * p.bD + dd];
    float win[K > 1 ? K - 1 : 1];  // win[k] = x[t - (K-1) + k]
#pragma unroll
    for (int k = 0; k < (K > 1 ? K - 1 : 1); ++k) win[k] = 0.f;
    const T* xp = x + (long long)b * p.sxb + d;
    T* yp = y + (long long)b * p.L * p.D + d;
#pragma unroll 4
    for (int t = 0; t < p.L; ++t) {
      const float xt = to_f(xp[(long long)t * p.sxt]);
      float acc = __fmul_rn(xt, wk[K - 1]);
#pragma unroll
      for (int k = 0; k < K - 1; ++k) acc = __fadd_rn(acc, __fmul_rn(win[k], wk[k]));
      yp[(long long)t * p.D] = from_f<T>(acc);
      if constexpr (K > 1) {
#pragma unroll
        for (int k = 0; k < K - 2; ++k) win[k] = win[k + 1];
        win[K - 2] = xt;
      }
    }
  }
}

template <typename T, int K>
cudaError_t launch_k(const void* x, const void* w, void* y, const C1Params& p,
                     int nB, int nD, int threads, int smem, cudaStream_t s) {
  auto kern = conv1d_kernel<T, K>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)nD, (unsigned)nB), threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int K, const void* x, const void* w, void* y,
                     const C1Params& p, int nB, int nD, int threads, int smem,
                     cudaStream_t s) {
  switch (K) {
    case 1: return launch_k<T, 1>(x, w, y, p, nB, nD, threads, smem, s);
    case 2: return launch_k<T, 2>(x, w, y, p, nB, nD, threads, smem, s);
    case 3: return launch_k<T, 3>(x, w, y, p, nB, nD, threads, smem, s);
    case 4: return launch_k<T, 4>(x, w, y, p, nB, nD, threads, smem, s);
    case 5: return launch_k<T, 5>(x, w, y, p, nB, nD, threads, smem, s);
    case 6: return launch_k<T, 6>(x, w, y, p, nB, nD, threads, smem, s);
    case 7: return launch_k<T, 7>(x, w, y, p, nB, nD, threads, smem, s);
    case 8: return launch_k<T, 8>(x, w, y, p, nB, nD, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, w and y share it). Returns the
// launch's cudaError_t.
extern "C" int repro_conv1d_causal(
    const void* x, const void* w, void* y, int dtype, int K, int B, int L,
    int D, long long sxb, long long sxt, int bB, int bD, int nB, int nD,
    int threads, int smem, void* stream) {
  if (nB <= 0 || nD <= 0 || nB > 65535 || L <= 0) return (int)cudaErrorInvalidConfiguration;
  C1Params p{B, L, D, bB, bD, sxb, sxt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_t<float>(K, x, w, y, p, nB, nD, threads, smem, s);
  else if (dtype == 1)
    e = launch_t<__nv_bfloat16>(K, x, w, y, p, nB, nD, threads, smem, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
