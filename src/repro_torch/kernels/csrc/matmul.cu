// C = A @ B, A (m, k) and B (k, n) row-major, f32 accumulation, tiled by
// the blocking LP's (bm, bn, bk) plan.
//
// Replaces: src/repro/kernels/matmul.py, _matmul_kernel (the Pallas TPU
// kernel), which the Im2Col baseline (kernels/im2col.py, conv2d_im2col) runs
// on the expanded patch matrix.
//
// What bounds it on an H100: the FMA pipe. This first version multiplies
// with plain f32 FMAs (67 TFLOP/s peak), not the tensor cores (989 TFLOP/s
// bf16), so at the Im2Col shapes (k = 147 .. 4,608) it is bound by
// operations; each FMA's operands come from shared memory.
//
// Design:
//  * One CTA per (bm, bn) output tile, the tile index flattened into
//    blockIdx.x (n tiles fastest): conv1's GEMM has 98,000 row tiles, beyond
//    gridDim.y's 65,535.
//  * A loop over the k blocks inside the CTA takes the place of the TPU
//    grid's sequential innermost k axis; the f32 accumulator stays in
//    registers across it. Each thread owns a TM x TN micro-tile of at most 64
//    values (rows rg + a * nRG, columns cg * TN + b), and a CTA has at most
//    256 threads: a tile holds at most 16,384 accumulators, the H100
//    preset's M_acc_eff. The micro-tile shape is a template argument; the
//    wrapper picks it from the plan.
//  * Per k step the CTA stages the (bm, bk) A tile (transposed, k-major, so
//    a thread's rows are consecutive words) and the (bk, bn) B tile in
//    dynamic shared memory, zero-filled past the ragged edges instead of the
//    reference's padded copies: the words issued are the full tiles that
//    matmul_hbm_words counts. One stage: plain loads, waited for before the
//    step's FMAs; other resident CTAs hide part of that latency.
//  * The padded (mp, np) output tile is stored once, after the last k step.
//  * All global offsets are 64-bit (conv1's patch matrix has 1.8e9
//    elements, its padded extent 3.6e9).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct MMParams {
  long long m;
  int n, k;
  int bm, bn, bk;
  int nNT, nKT;        // n tiles, k tiles
  long long ldo;       // padded output row length (np)
  int nRG, ldA, ldB;   // row groups, shared-memory row strides
  long long a_bytes;   // shared-memory offset of the B tile
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

template <typename Tin, typename Tout, int TM, int TN>
__global__ void __launch_bounds__(256)
matmul_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
              Tout* __restrict__ out, const MMParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tin* as = reinterpret_cast<Tin*>(smem);              // [bk][ldA]
  Tin* bs = reinterpret_cast<Tin*>(smem + p.a_bytes);  // [bk][ldB]

  const long long t = blockIdx.x;
  const int jt = (int)(t % p.nNT);
  const long long row0 = (t / p.nNT) * p.bm;
  const int col0 = jt * p.bn;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid / p.nRG, rg = tid % p.nRG;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // B columns [bn, ldB) are never loaded: zero them once.
  for (int i = tid; i < p.bk * p.ldB; i += nthr)
    if (i % p.ldB >= p.bn) bs[i] = zero_of<Tin>();

  for (int kt = 0; kt < p.nKT; ++kt) {
    const int k0 = kt * p.bk;
    __syncthreads();  // every thread is done reading the previous step
    for (int i = tid; i < p.bm * p.bk; i += nthr) {  // global order: row, k
      const int kk = i % p.bk, r = i / p.bk;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      Tin v = zero_of<Tin>();
      if (gr < p.m && gk < p.k) v = a[gr * p.k + gk];
      as[kk * p.ldA + r] = v;
    }
    for (int i = tid; i < p.bk * p.bn; i += nthr) {  // global order: k, col
      const int c = i % p.bn, kk = i / p.bn;
      const int gk = k0 + kk, gc = col0 + c;
      Tin v = zero_of<Tin>();
      if (gk < p.k && gc < p.n) v = b[(long long)gk * p.n + gc];
      bs[kk * p.ldB + c] = v;
    }
    __syncthreads();

    for (int kk = 0; kk < p.bk; ++kk) {
      const Tin* ar = as + kk * p.ldA;
      const Tin* br = bs + kk * p.ldB + cg * TN;
      float bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = to_f(br[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = min(rg + i * p.nRG, p.bm - 1);
        const float av = to_f(ar[r]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rg + i * p.nRG;
    if (r >= p.bm) continue;
    Tout* orow = out + (row0 + r) * p.ldo + col0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = cg * TN + j;
      if (c < p.bn) orow[c] = from_f<Tout>(acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout, int TM, int TN>
cudaError_t launch_t(const void* a, const void* b, void* out, const MMParams& p,
                     long long blocks, int threads, int smem, cudaStream_t s) {
  auto kern = matmul_kernel<Tin, Tout, TM, TN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_v(int variant, const void* a, const void* b, void* out,
                     const MMParams& p, long long blocks, int threads, int smem,
                     cudaStream_t s) {
  switch (variant) {  // micro-tile TM x TN, as repro_torch.kernels.matmul
    case 0: return launch_t<Tin, Tout, 8, 8>(a, b, out, p, blocks, threads, smem, s);
    case 1: return launch_t<Tin, Tout, 16, 4>(a, b, out, p, blocks, threads, smem, s);
    case 2: return launch_t<Tin, Tout, 4, 16>(a, b, out, p, blocks, threads, smem, s);
    case 3: return launch_t<Tin, Tout, 32, 2>(a, b, out, p, blocks, threads, smem, s);
    case 4: return launch_t<Tin, Tout, 64, 1>(a, b, out, p, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_matmul(
    const void* a, const void* b, void* out, int in_dtype, int out_dtype,
    int variant, long long m, int n, int k, int bm, int bn, int bk,
    long long nMT, int nNT, int nKT, long long ldo, int nRG, int ldA, int ldB,
    long long a_bytes, int threads, int smem, void* stream) {
  MMParams p{m, n, k, bm, bn, bk, nNT, nKT, ldo, nRG, ldA, ldB, a_bytes};
  const long long blocks = nMT * nNT;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_dtype == 0 && out_dtype == 0)
    e = launch_v<float, float>(variant, a, b, out, p, blocks, threads, smem, s);
  else if (in_dtype == 0 && out_dtype == 1)
    e = launch_v<float, __nv_bfloat16>(variant, a, b, out, p, blocks, threads, smem, s);
  else if (in_dtype == 1 && out_dtype == 0)
    e = launch_v<__nv_bfloat16, float>(variant, a, b, out, p, blocks, threads, smem, s);
  else if (in_dtype == 1 && out_dtype == 1)
    e = launch_v<__nv_bfloat16, __nv_bfloat16>(variant, a, b, out, p, blocks, threads, smem, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
