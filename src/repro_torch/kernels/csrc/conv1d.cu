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
// the least time is (2 B L D + K D) elements over 3.35 TB/s. At the hybrid
// serve's shapes (B 1, D 16384, L <= 300) that is 6 us or less, so the
// kernel has to keep megabytes of loads in flight to hide the memory's
// latency, and the four short shapes cost a launch whatever it does.
//
// Design (kernels/conv1d.py, launch_config, picks the geometry;
// conv1d_ring_emulate replays it on the CPU):
//  * Wide channel groups. One CTA covers one plan batch tile (bB rows) and
//    `span` consecutive channels: G consecutive plan channel tiles (G * bD
//    channels, 128 bytes of a time row), or, for a plan tile wider than
//    that, an equal part of one tile (`parts` CTAs a tile). Grid:
//    (ceil(nD / G) * parts, nB). Threads move VW-element vectors along the
//    contiguous channel axis: `cols` = span / VW vectors a row, `rows` rows
//    a pass, threads = rows * cols.
//  * A cp.async ring over time. The CTA walks its bB rows one after the
//    other, and each row's L steps in chunks of CHUNK time rows; a chunk is
//    one (CHUNK, span) stage of a ring of STAGES slots, loaded straight
//    from the row-strided x view (batch and time strides sxb, sxt). At
//    chunk i the CTA waits for chunk i, issues chunk i + STAGES - 2 into
//    the slot of chunk i - 2, and sums chunk i's outputs from shared memory
//    while the later chunks land: STAGES - 2 chunks in flight. The K - 1
//    rows before a chunk are the previous chunk's last rows, read from its
//    slot, which is reused only after chunk i has read them; rows before
//    t = 0 are zeros. Each x element is read from device memory once; no
//    CTA re-reads another's halo.
//    Bytes in flight at the serve's L = 300 (bf16, span 64, CHUNK 32,
//    STAGES 8): 256 CTAs x 6 chunks x 4 KB = 6 MB, against the 3.35 TB/s x
//    ~1 us = ~3.4 MB that cover the memory's latency; a CTA's 300 rows are
//    10 chunks, so most of its input is in flight from the start.
//  * The filter. Each CTA reads its (K, span) filter block into shared
//    memory once (as f32), and each thread keeps the K x VW taps of its
//    vector column in registers. The words issued equal conv1d_hbm_words
//    when nD > 1 and the tiles divide B and D (the counter charges padded
//    tiles; the kernel masks the ragged edges and reads nothing there);
//    when nD == 1 and nB > 1 every CTA reads the filter block where the
//    counter (the Pallas pipeline, which skips the re-fetch of an unchanged
//    block) charges one fetch.
//  * Copy width, per launch: 16-byte cp.async (cg) when the base pointer,
//    the batch and time strides, D and the CTA's channel group are 16-byte
//    aligned (the serve's operand); else 8- or 4-byte cp.async (ca); else
//    (bf16 at an odd element) 2-byte loads and shared-memory stores into
//    the same ring. VW is a template parameter; the wrapper names the
//    choice in its launch configuration.
//  * Ragged B, D and L are masked: no copy or store past them.
//  * Order of the sum: tap K-1 first, then k = 0 .. K-2, as the Pallas
//    kernel adds them, with __fmul_rn/__fadd_rn so that nvcc contracts
//    nothing into an FMA; the zero rows before t = 0 enter as products like
//    any other. The plain PyTorch version adds in the same order, so the
//    two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;   // time rows of a ring stage
constexpr int STAGES = 8;   // ring slots: STAGES - 2 chunks in flight
constexpr int MAX_THREADS = 256;
static_assert(STAGES >= 3, "the ring keeps the previous chunk's slot");

struct C1Params {
  int B, L, D;
  int bB;     // plan batch tile: the rows a CTA walks
  int gw;     // channels of a CTA group: G plan channel tiles
  int span;   // channels a CTA covers: gw, or a part of it
  int parts;  // CTAs a group is split into
  int cols;   // vectors a row of the span
  long long sxb, sxt;  // x strides (elements) of the batch and time axes
};

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Vec { T v[VW]; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__host__ __device__ constexpr int ring_bytes(int span, int itemsize) {
  return (STAGES * CHUNK * span * itemsize + 15) / 16 * 16;
}

template <typename T, int K, int VW>
__global__ void __launch_bounds__(MAX_THREADS)
conv1d_ring_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, const C1Params p) {
  typedef Vec<T, VW> V;
  constexpr int BYTES = VW * (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [STAGES][CHUNK][span]
  float* wsm = reinterpret_cast<float*>(smem + ring_bytes(p.span, sizeof(T)));  // [K][span]

  const int grp = blockIdx.x / p.parts, part = blockIdx.x - grp * p.parts;
  const int g0 = grp * p.gw, c0 = g0 + part * p.span;
  const int cw = min(min(c0 + p.span, g0 + p.gw), p.D) - c0;  // channels here
  if (cw <= 0) return;  // a part past D: the whole CTA, before any barrier
  const int b0 = blockIdx.y * p.bB;
  const int nch = (p.L + CHUNK - 1) / CHUNK;
  const int items = min(p.bB, p.B - b0) * nch;  // (row, chunk) in walk order
  const int tid = threadIdx.x;
  const int c = (tid % p.cols) * VW, row0 = tid / p.cols;
  const int rstep = blockDim.x / p.cols;
  const bool cok = c < cw;
  const int slot_elems = CHUNK * p.span;

  for (int i = tid; i < K * cw; i += blockDim.x) {
    const int k = i / cw, cc = i - k * cw;
    wsm[k * p.span + cc] = to_f(w[(long long)k * p.D + c0 + cc]);
  }

  // Chunk `it`: rows [t0, t0 + CHUNK) of batch row b0 + it / nch, masked at
  // L and at the CTA's last channel, into slot it % STAGES.
  auto issue = [&](int it) {
    if (!cok) return;
    const int t0 = (it % nch) * CHUNK, rows = min(CHUNK, p.L - t0);
    const T* src = x + (long long)(b0 + it / nch) * p.sxb + (long long)t0 * p.sxt + c0 + c;
    T* dst = ring + (it % STAGES) * slot_elems + c;
    for (int r = row0; r < rows; r += rstep) {
      if constexpr (BYTES >= 4)
        cp_async<BYTES>(dst + r * p.span, src + r * p.sxt);
      else
        *reinterpret_cast<V*>(dst + r * p.span) =
            *reinterpret_cast<const V*>(src + r * p.sxt);
    }
  };

  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < items) issue(s);
    cp_async_commit();
  }
  __syncthreads();  // the filter block
  float wk[K][VW];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < VW; ++j) wk[k][j] = cok ? wsm[k * p.span + c + j] : 0.f;

  for (int it = 0; it < items; ++it) {
    cp_async_wait<STAGES - 3>();  // this thread's copies of chunk it
    __syncthreads();  // everyone's; and every read of chunk it - 2's slot done
    if (it + STAGES - 2 < items) issue(it + STAGES - 2);
    cp_async_commit();
    if (!cok) continue;
    const int ch = it % nch, t0 = ch * CHUNK, rows = min(CHUNK, p.L - t0);
    const T* cur = ring + (it % STAGES) * slot_elems + c;
    const T* prev = ring + ((it + STAGES - 1) % STAGES) * slot_elems + c;
    T* yp = y + ((long long)(b0 + it / nch) * p.L + t0) * p.D + c0 + c;
    for (int r = row0; r < rows; r += rstep) {
      float acc[VW];
      const V xc = *reinterpret_cast<const V*>(cur + r * p.span);
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = __fmul_rn(to_f(xc.v[j]), wk[K - 1][j]);
#pragma unroll
      for (int k = 0; k < K - 1; ++k) {
        const int rr = r - (K - 1) + k;  // row of x[t - (K-1) + k] in the chunk
        float xv[VW];
        if (rr >= 0 || ch > 0) {
          const V v = *reinterpret_cast<const V*>(
              rr >= 0 ? cur + rr * p.span : prev + (CHUNK + rr) * p.span);
#pragma unroll
          for (int j = 0; j < VW; ++j) xv[j] = to_f(v.v[j]);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) xv[j] = 0.f;  // before t = 0
        }
#pragma unroll
        for (int j = 0; j < VW; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(xv[j], wk[k][j]));
      }
      V o;
#pragma unroll
      for (int j = 0; j < VW; ++j) o.v[j] = from_f<T>(acc[j]);
      *reinterpret_cast<V*>(yp + (long long)r * p.D) = o;
    }
  }
  cp_async_wait<0>();
}

template <typename T, int K, int VW>
cudaError_t launch_kv(const void* x, const void* w, void* y, const C1Params& p,
                      dim3 grid, int threads, int smem, cudaStream_t s) {
  auto kern = conv1d_ring_kernel<T, K, VW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(static_cast<const T*>(x),
                                   static_cast<const T*>(w),
                                   static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_k(int vec, const void* x, const void* w, void* y,
                     const C1Params& p, dim3 grid, int threads, int smem,
                     cudaStream_t s) {
  switch (vec * (int)sizeof(T)) {  // the copy's bytes
    case 16: return launch_kv<T, K, 16 / sizeof(T)>(x, w, y, p, grid, threads, smem, s);
    case 8: return launch_kv<T, K, 8 / sizeof(T)>(x, w, y, p, grid, threads, smem, s);
    case 4: return launch_kv<T, K, 4 / sizeof(T)>(x, w, y, p, grid, threads, smem, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_kv<T, K, 1>(x, w, y, p, grid, threads, smem, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int K, int vec, const void* x, const void* w, void* y,
                     const C1Params& p, dim3 grid, int threads, int smem,
                     cudaStream_t s) {
  switch (K) {
    case 1: return launch_k<T, 1>(vec, x, w, y, p, grid, threads, smem, s);
    case 2: return launch_k<T, 2>(vec, x, w, y, p, grid, threads, smem, s);
    case 3: return launch_k<T, 3>(vec, x, w, y, p, grid, threads, smem, s);
    case 4: return launch_k<T, 4>(vec, x, w, y, p, grid, threads, smem, s);
    case 5: return launch_k<T, 5>(vec, x, w, y, p, grid, threads, smem, s);
    case 6: return launch_k<T, 6>(vec, x, w, y, p, grid, threads, smem, s);
    case 7: return launch_k<T, 7>(vec, x, w, y, p, grid, threads, smem, s);
    case 8: return launch_k<T, 8>(vec, x, w, y, p, grid, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, w and y share it). vec is the
// copy's width in elements (16, 8 or 4 bytes, or one bf16); the geometry is
// kernels/conv1d.py's launch_config. Returns the launch's cudaError_t.
extern "C" int repro_conv1d_causal(
    const void* x, const void* w, void* y, int dtype, int K, int vec, int B,
    int L, int D, long long sxb, long long sxt, int bB, int gw, int span,
    int parts, int cols, int grid_x, int grid_y, int threads, int smem,
    void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (grid_x <= 0 || grid_y <= 0 || grid_y > 65535 || L <= 0 || vec <= 0 ||
      cols <= 0 || span != cols * vec || gw % vec || threads % cols ||
      threads > MAX_THREADS || threads / cols > CHUNK ||
      smem < ring_bytes(span, itemsize) + K * span * 4)
    return (int)cudaErrorInvalidConfiguration;
  C1Params p{B, L, D, bB, gw, span, parts, cols, sxb, sxt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaError_t e;
  if (dtype == 0)
    e = launch_t<float>(K, vec, x, w, y, p, grid, threads, smem, s);
  else if (dtype == 1)
    e = launch_t<__nv_bfloat16>(K, vec, x, w, y, p, grid, threads, smem, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
