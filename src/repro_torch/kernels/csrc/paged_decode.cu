// One decode step of GQA attention read straight out of the paged KV pool
// through per-row block tables, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, _paged_decode_kernel
// (:257), whose grid (B, KV, w) fetches physical block tables[b, j] at step
// j through its index map.
//
// What bounds it on an H100: the K/V stream from HBM (Lq = 1: about one FMA
// per byte read). This first version walks a row's blocks one after the
// other in a single CTA per (b, kv head), so B * KV CTAs are in flight and
// each waits on one block's load at a time: it is latency bound far below
// the HBM rate at serving batch sizes. Splitting over blocks
// (flash-decoding) would fill the card, but changes the words
// paged_decode_hbm_words charges; that is a later PR's work.
//
// Design:
//  * One CTA of 128 threads per (batch row b, kv head h). It loads the (g,
//    hd) query group of the g query heads that share kv head h (h * g + i,
//    the registry's GQA fold) once, converted to f32 in shared memory.
//  * A loop over the row's table slots j < w takes the place of the TPU
//    grid's sequential block axis: it reads physical block tables[b, j]
//    straight from the (num_blocks, KV, bs, hd) pools, with no gathered
//    copy, so each step moves exactly its own w * bs keys and values once.
//    Dead rows and padding point at block 0, whose keys the length masks.
//  * Positions at or past lengths[b] get the reference's finite NEG_INF =
//    -1e30, so a row of length 0 averages V (neither zeros nor NaN).
//  * Online softmax in f32 (running max, sum, rescale), one warp per query
//    head; each thread owns fixed (head, dim) accumulators in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int G_MAX = 16;  // query heads per kv head this kernel takes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int KV, int g, int bs, int w, float scale) {
  constexpr int QS = HD + 1;
  constexpr int NACC = (G_MAX * HD + THREADS - 1) / THREADS;
  extern __shared__ float smem[];
  float* sq = smem;          // g x QS
  float* sk = sq + g * QS;   // bs x QS
  float* sv = sk + bs * QS;  // bs x HD
  float* ss = sv + bs * HD;  // g x bs: scores, then probabilities
  float* sm = ss + g * bs;
  float* sl = sm + g;
  float* sa = sl + g;

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = lengths[b];
  const long long head0 = ((long long)b * KV + h) * g;  // first of g heads
  const T* qg = q + head0 * HD;
  const int* tab = tables + (long long)b * w;
  const long long blk_stride = (long long)KV * bs * HD;

  for (int e = tid; e < g * HD; e += THREADS) sq[(e / HD) * QS + e % HD] = to_f(qg[e]);
  for (int r = tid; r < g; r += THREADS) {
    sm[r] = NEG_INF;
    sl[r] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int j = 0; j < w; ++j) {
    const long long base = (long long)tab[j] * blk_stride + (long long)h * bs * HD;
    for (int e = tid; e < bs * HD; e += THREADS) {
      const int t = e / HD, d = e % HD;
      sk[t * QS + d] = to_f(kp[base + e]);
      sv[e] = to_f(vp[base + e]);
    }
    __syncthreads();
    for (int e = tid; e < g * bs; e += THREADS) {
      const int r = e / bs, t = e % bs;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(sq[r * QS + d], sk[t * QS + d], dot);
      ss[e] = (j * bs + t < len) ? dot * scale : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < g; r += THREADS / 32) {
      const float m_prev = sm[r];
      float mx = m_prev;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, ss[r * bs + t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float pr = expf(ss[r * bs + t] - mx);
        ss[r * bs + t] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        sa[r] = alpha;
        sl[r] = alpha * sl[r] + sum;
        sm[r] = mx;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + THREADS * i;
      if (e >= g * HD) continue;
      const int r = e / HD, d = e % HD;
      float a = acc[i] * sa[r];
      for (int t = 0; t < bs; ++t) a = fmaf(ss[r * bs + t], sv[t * HD + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + THREADS * i;
    if (e >= g * HD) continue;
    float l = sl[e / HD];
    l = (l == 0.f) ? 1.f : l;
    out[head0 * HD + e] = from_f<T>(acc[i] / l);
  }
}

int smem_bytes(int hd, int g, int bs) {
  return (int)sizeof(float) * (g * (hd + 1) + bs * (hd + 1) + bs * hd + g * bs + 3 * g);
}

template <typename T, int HD>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const void* tables, const void* lengths, void* out,
                     int B, int KV, int g, int bs, int w, float scale,
                     cudaStream_t s) {
  auto kern = paged_decode_kernel<T, HD>;
  const int smem = smem_bytes(HD, g, bs);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((unsigned)B, (unsigned)KV), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), KV, g, bs, w,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kp, const void* vp,
                      const void* tables, const void* lengths, void* out,
                      int B, int KV, int g, int bs, int w, float scale,
                      cudaStream_t s) {
  switch (hd) {
    case 16: return launch_t<T, 16>(q, kp, vp, tables, lengths, out, B, KV, g, bs, w, scale, s);
    case 32: return launch_t<T, 32>(q, kp, vp, tables, lengths, out, B, KV, g, bs, w, scale, s);
    case 64: return launch_t<T, 64>(q, kp, vp, tables, lengths, out, B, KV, g, bs, w, scale, s);
    case 128: return launch_t<T, 128>(q, kp, vp, tables, lengths, out, B, KV, g, bs, w, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, KV, g, hd), pools (num_blocks, KV, bs, hd), out like q, one dtype
// (0 = float32, 1 = bfloat16), contiguous; tables int32 (B, w), lengths int32
// (B,). Returns the launch's cudaError_t.
extern "C" int repro_paged_decode(
    const void* q, const void* kp, const void* vp, const void* tables,
    const void* lengths, void* out, int dtype, int hd, int B, int KV, int g,
    int bs, int w, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || KV > 65535 || g <= 0 || g > G_MAX || bs <= 0 || w <= 0)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_hd<float>(hd, q, kp, vp, tables, lengths, out, B, KV, g, bs, w, scale, s);
  else if (dtype == 1)
    e = launch_hd<__nv_bfloat16>(hd, q, kp, vp, tables, lengths, out, B, KV, g, bs, w,
                                 scale, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
