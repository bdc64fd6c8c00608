// Flash attention forward with an online softmax, GQA query groups folded
// into the query axis, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel (:48, static
// q_offset and kv_len) and _flash_kernel_dyn (:96, per-row q_offset and
// kv_lens as scalar-prefetch operands). One kernel serves both: offsets and
// lengths are int32 device arrays of one value per folded row, so a static
// offset is a constant array and nothing recompiles per decode step. It also
// takes the optional (B, Lk) key mask of padded prefill, which the TPU
// kernel declined (the reference serves that call with XLA).
//
// What bounds it on an H100: at prefill shapes, the FMA pipe. This first
// version computes both GEMMs (S = Q K^T and O += P V) with plain f32 FMAs
// (67 TFLOP/s peak), not the tensor cores (989 TFLOP/s bf16), every operand
// from shared memory. At decode shapes (Lq = 1) it is bound by the K/V
// stream from HBM, and a few CTAs in flight leave most of that bandwidth
// idle.
//
// Design:
//  * One CTA per (folded row b * Hkv + kv, q tile of bq folded query rows).
//    Row j of the folded query axis is query j % q_seq_len of its group, so
//    its absolute position is (j % q_seq_len) + q_offset[row] (q_seq_len = 0:
//    plain positions).
//  * A loop over the K/V tiles of bk keys inside the CTA takes the place of
//    the TPU grid's sequential key axis. Every key tile is streamed (no
//    causal block skipping), once per q tile, as attention_hbm_words
//    charges. When the keys fit one tile (n_k == 1) the CTA walks every q
//    tile of its row with that tile resident: the reference's index map
//    fetches it once per row then, and so does this kernel.
//  * The Q tile and each K/V tile are converted to f32 in dynamic shared
//    memory (row pitch hd + 1: conflict-free column reads), zero-filled past
//    the ragged edges instead of padded copies in HBM.
//  * 256 threads as a 16 x 16 grid: thread (ty, tx) computes S at rows
//    ty + 16 i and keys tx + 16 j, and owns O at rows ty + 16 i and head
//    dims tx + 16 j in registers (at most 64 f32 accumulators a thread).
//  * Masks: keys past Lk (the tile's ragged edge) get exactly zero weight;
//    keys at or past kv_lens[row], causally future keys and keys the key
//    mask rejects get the reference's finite NEG_INF = -1e30. A row whose
//    keys are all rejected therefore averages V over its Lk keys: neither
//    zeros nor NaN.
//  * Online softmax in f32, one warp per row: running max m, sum l, and the
//    rescale factor of the accumulator; the store divides by l (l == 0 -> 1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

struct FAParams {
  int Lq, Lk;           // folded query rows, keys (per folded row)
  int bq, bk;           // runtime tiles (<= BLOCK)
  int n_q, n_k;         // tiles along each axis
  int q_seq_len;        // queries per GQA group (0 = plain positions)
  int rows_per_batch;   // folded rows per key-mask row (Hkv)
  int causal, kv_resident;
  float scale;
};

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

template <int HD, int BLOCK>
constexpr int smem_floats() {
  return 2 * BLOCK * (HD + 1) + BLOCK * HD + BLOCK * (BLOCK + 1) + 3 * BLOCK;
}

template <typename T, int HD, int BLOCK>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
             const uint8_t* __restrict__ key_mask, FAParams p) {
  constexpr int QS = HD + 1;     // q/k row pitch in shared memory
  constexpr int SS = BLOCK + 1;  // score row pitch
  constexpr int RI = BLOCK / 16; // rows a thread owns
  constexpr int CJ = BLOCK / 16; // score columns a thread computes
  constexpr int DJ = HD / 16;    // head dims a thread owns
  extern __shared__ float smem[];
  float* sq = smem;              // BLOCK x QS
  float* sk = sq + BLOCK * QS;   // BLOCK x QS
  float* sv = sk + BLOCK * QS;   // BLOCK x HD
  float* ss = sv + BLOCK * HD;   // BLOCK x SS: scores, then probabilities
  float* sm = ss + BLOCK * SS;   // running max per row
  float* sl = sm + BLOCK;        // running sum per row
  float* sa = sl + BLOCK;        // this step's rescale factor per row

  const long long row = blockIdx.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int off = q_offset[row];
  const int len = kv_lens[row];
  const uint8_t* km =
      key_mask ? key_mask + (row / p.rows_per_batch) * (long long)p.Lk : nullptr;
  const T* qr = q + row * p.Lq * (long long)HD;
  const T* kr = k + row * p.Lk * (long long)HD;
  const T* vr = v + row * p.Lk * (long long)HD;
  T* orow = out + row * p.Lq * (long long)HD;

  for (int qt = blockIdx.y; qt < p.n_q; qt += gridDim.y) {
    const int q0 = qt * p.bq;
    for (int e = tid; e < BLOCK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD, qi = q0 + r;
      sq[r * QS + d] = (r < p.bq && qi < p.Lq) ? to_f(qr[(long long)qi * HD + d]) : 0.f;
    }
    for (int r = tid; r < BLOCK; r += THREADS) {
      sm[r] = NEG_INF;
      sl[r] = 0.f;
    }
    float acc[RI][DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    int qpos[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + 16 * i;
      qpos[i] = (p.q_seq_len > 0 ? qi % p.q_seq_len : qi) + off;
    }

    for (int kt = 0; kt < p.n_k; ++kt) {
      const int k0 = kt * p.bk;
      if (!p.kv_resident || qt == (int)blockIdx.y) {
        for (int e = tid; e < BLOCK * HD; e += THREADS) {
          const int r = e / HD, d = e % HD, kj = k0 + r;
          const bool ok = r < p.bk && kj < p.Lk;
          sk[r * QS + d] = ok ? to_f(kr[(long long)kj * HD + d]) : 0.f;
          sv[r * HD + d] = ok ? to_f(vr[(long long)kj * HD + d]) : 0.f;
        }
      }
      __syncthreads();

      // S = Q K^T for this thread's (row, key) pairs
      float s[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[RI], b[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = sq[(ty + 16 * i) * QS + d];
#pragma unroll
        for (int j = 0; j < CJ; ++j) b[j] = sk[(tx + 16 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool in_range = c < p.bk && kpos < p.Lk;
        const bool key_ok = in_range && kpos < len && (km == nullptr || km[kpos]);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          float val = -INFINITY;  // past the keys: zero weight
          if (in_range) {
            const bool keep = key_ok && (!p.causal || kpos <= qpos[i]);
            val = keep ? s[i][j] * p.scale : NEG_INF;
          }
          ss[(ty + 16 * i) * SS + c] = val;
        }
      }
      __syncthreads();

      // online softmax, one warp per row
      for (int r = warp; r < BLOCK; r += THREADS / 32) {
        const float m_prev = sm[r];
        float mx = m_prev;
        for (int c = lane; c < BLOCK; c += 32) mx = fmaxf(mx, ss[r * SS + c]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int c = lane; c < BLOCK; c += 32) {
          const float pr = expf(ss[r * SS + c] - mx);
          ss[r * SS + c] = pr;
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

      // O = alpha * O + P V
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float al = sa[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] *= al;
      }
      for (int c = 0; c < p.bk; ++c) {
        float pr[RI], vv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) pr[i] = ss[(ty + 16 * i) * SS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = sv[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
      if (r >= p.bq || qi >= p.Lq) continue;
      float l = sl[r];
      l = (l == 0.f) ? 1.f : l;
      const float inv = 1.f / l;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        orow[(long long)qi * HD + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    }
    __syncthreads();
  }
}

template <typename T, int HD, int BLOCK>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     const void* offs, const void* lens, const void* km,
                     long long rows, const FAParams& p, cudaStream_t s) {
  auto kern = flash_kernel<T, HD, BLOCK>;
  const int smem = smem_floats<HD, BLOCK>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)rows, p.kv_resident ? 1u : (unsigned)p.n_q);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int*>(offs), static_cast<const int*>(lens),
      static_cast<const uint8_t*>(km), p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_b(int block, const void* q, const void* k, const void* v,
                     void* out, const void* offs, const void* lens,
                     const void* km, long long rows, const FAParams& p,
                     cudaStream_t s) {
  switch (block) {  // the instances repro_torch.kernels.flash_attention names
    case 32: return launch_t<T, HD, 32>(q, k, v, out, offs, lens, km, rows, p, s);
    case 64: return launch_t<T, HD, 64>(q, k, v, out, offs, lens, km, rows, p, s);
    case 128:
      if constexpr (HD <= 32)
        return launch_t<T, HD, 128>(q, k, v, out, offs, lens, km, rows, p, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_hd(int hd, int block, const void* q, const void* k,
                      const void* v, void* out, const void* offs,
                      const void* lens, const void* km, long long rows,
                      const FAParams& p, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_b<T, 16>(block, q, k, v, out, offs, lens, km, rows, p, s);
    case 32: return launch_b<T, 32>(block, q, k, v, out, offs, lens, km, rows, p, s);
    case 64: return launch_b<T, 64>(block, q, k, v, out, offs, lens, km, rows, p, s);
    case 128: return launch_b<T, 128>(block, q, k, v, out, offs, lens, km, rows, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (rows, Lq, hd), k/v (rows, Lk, hd), out like q, all one dtype (0 =
// float32, 1 = bfloat16), contiguous; q_offset and kv_lens int32 (rows,);
// key_mask bool (rows / rows_per_batch, Lk) or null. ``block`` selects the
// compiled tile (the plan's), bq/bk <= block the clamped runtime tiles.
// Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* q_offset, const void* kv_lens, const void* key_mask,
    int dtype, int hd, int block, long long rows, int Lq, int Lk, int bq,
    int bk, int q_seq_len, int rows_per_batch, int causal, float scale,
    void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || bq <= 0 || bk <= 0 || bq > block ||
      bk > block)
    return (int)cudaErrorInvalidConfiguration;
  FAParams p;
  p.Lq = Lq;
  p.Lk = Lk;
  p.bq = bq;
  p.bk = bk;
  p.n_q = (Lq + bq - 1) / bq;
  p.n_k = (Lk + bk - 1) / bk;
  p.q_seq_len = q_seq_len;
  p.rows_per_batch = rows_per_batch;
  p.causal = causal;
  p.kv_resident = p.n_k == 1;
  p.scale = scale;
  if (p.n_q > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_hd<float>(hd, block, q, k, v, out, q_offset, kv_lens, key_mask, rows, p, s);
  else if (dtype == 1)
    e = launch_hd<__nv_bfloat16>(hd, block, q, k, v, out, q_offset, kv_lens, key_mask,
                                 rows, p, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
