// C = A @ B, A (m, k) and B (k, n) row-major, f32 accumulation, tiled by
// the blocking LP's (bm, bn, bk) plan.
//
// Replaces: src/repro/kernels/matmul.py, _matmul_kernel (the Pallas TPU
// kernel), which the Im2Col baseline (kernels/im2col.py, conv2d_im2col) runs
// on the expanded patch matrix.
//
// Two kernels, chosen by the input dtype before the launch (never after a
// failure):
//
// matmul_tc_kernel, bf16 in (the conv path): tensor cores.
//  What bounds it on an H100: at the five ResNet-50 Im2Col GEMMs (batch
//  1000, bf16 A and B, f32 out) the compulsory bytes, for conv1 through
//  conv4_x (34-209 flop a byte against the card's 295 in bf16), and the
//  tensor cores' 989 TFLOP/s for conv5_x (416 flop a byte). So the design
//  keeps the bytes streaming and puts the products on the tensor cores:
//  * mma.sync.m16n8k16 bf16 x bf16 -> f32 in registers. A is row-major
//    (k contiguous): ldmatrix.x4; B is row-major (n contiguous): ldmatrix
//    .x4.trans / .x2.trans, no transposed copy of B in HBM. The fragments
//    of the next 16-deep slice load while the current one multiplies.
//  * One CTA per plan (bm, bn) tile (n tiles fastest in blockIdx.x, as
//    conv1 has 98,000 row tiles). Its warps each own a block of MI x NI
//    m16n8 tiles (at most 64 f32 accumulators a thread, 256 threads);
//    the wrapper picks the compiled (MI, NI) from the plan and the warp
//    grid at run time. A tile no rectangular block fits is covered by the
//    LINEAR variant: warp w owns m16n8 tiles 16w .. 16w + 15 of the
//    covered tile in row-major order. 128 registers a thread, so two CTAs
//    share an SM: one computes while the other waits on its ring.
//  * A ring of `slots` (2 or 3) shared-memory stages, each a k-span of `ks`
//    (a multiple of 16; 64 = four 16-deep plan k-steps on the main path):
//    cp.async.cg 16-byte copies, zero-filled past m, n and k with the
//    src-size-0 form, one commit group a stage, cp.async.wait_group before a
//    stage is read and a __syncthreads before its slot is refilled. Rows
//    are padded to an odd multiple of 16 bytes, so ldmatrix's eight row
//    addresses hit eight distinct bank groups.
//  * A pitch that 16-byte copies cannot take (conv1's 147 bf16 = 294-byte
//    rows; k = 77 or 129) is planned as one span of whole rows: a tile's A
//    rows are then one contiguous run, loaded 16 bytes at a time into
//    registers and scattered into the padded rows. Where that does not
//    hold (a long odd k, an unaligned base) the rows are loaded with the
//    widest aligned loads the pitch allows (2, 4 or 8 bytes), a batch in
//    flight a thread, then stored.
//  * k16 slices wholly past k skip their MMAs (conv1's span of 160 holds
//    147 real columns: 10 slices, not 18 plan-step slices).
//  * The epilogue stores the padded (mp, np) output straight from the
//    fragments, as paired float2 / __nv_bfloat162 stores (each quad of a
//    warp writes one 32-byte sector).
//
// matmul_kernel, f32 in: the first version, on the FMA pipe (67 TFLOP/s).
//  bf16 x bf16 products are exact in f32, but TF32 products would not meet
//  the f32 checks' 1e-4; so f32 inputs keep plain FMAs: each thread owns a
//  TM x TN micro-tile of at most 64 accumulators, one shared-memory stage
//  per plan k step ((bm, bk) A tile stored k-major, (bk, bn) B tile).
//
// Both: a loop over k inside the CTA takes the place of the TPU grid's
// sequential k axis; words issued are the plan's tiles, zero-filled past the
// ragged edges instead of the reference's padded copies, so they stay what
// matmul_hbm_words counts; all global offsets are 64-bit (conv1's patch
// matrix has 1.8e9 elements).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

struct MMParams {
  long long m;
  int n, k;
  int bm, bn, bk;
  int nNT, nKT;        // n tiles, k steps (FMA) or k spans holding real k (TC)
  long long ldo;       // padded output row length (np)
  int nRG, ldA, ldB;   // FMA: row groups; both: shared-memory row strides
  long long a_bytes;   // bytes of one A stage; the B stage follows it
  int wn, cm, cn;      // TC: warps along n; m16 and n8 tiles of the covered tile
  int ks, slots;       // TC: k-span of a ring stage, ring depth
  int vwa, vwb;        // TC: elements per global load of A and B (8: cp.async)
};

__device__ __forceinline__ float to_f(float v) { return v; }

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
    if (i % p.ldB >= p.bn) bs[i] = Tin(0);

  for (int kt = 0; kt < p.nKT; ++kt) {
    const int k0 = kt * p.bk;
    __syncthreads();  // every thread is done reading the previous step
    for (int i = tid; i < p.bm * p.bk; i += nthr) {  // global order: row, k
      const int kk = i % p.bk, r = i / p.bk;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      Tin v = Tin(0);
      if (gr < p.m && gk < p.k) v = a[gr * p.k + gk];
      as[kk * p.ldA + r] = v;
    }
    for (int i = tid; i < p.bk * p.bn; i += nthr) {  // global order: k, col
      const int c = i % p.bn, kk = i / p.bn;
      const int gk = k0 + kk, gc = col0 + c;
      Tin v = Tin(0);
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

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 in).
// ---------------------------------------------------------------------------

// MI x NI m16n8 tiles a warp (LINEAR: MI = 1, NI = 16 tiles in row-major
// order of the covered tile's cm x cn grid).
constexpr int MAX_SLICES = 4;  // k16 slices of one unrolled fragment loop

template <typename Tout, int MI, int NI, bool LINEAR>
__global__ void __launch_bounds__(256, 2)
matmul_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 Tout* __restrict__ out, const MMParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // slot i: A [rows][ldA] then B [ks][ldB]; only slots that a span uses
  // are allocated (a single span needs one)
  const int a_slot = (int)(p.a_bytes / 2);
  const int slot = a_slot + p.ks * p.ldB;
  bf16* const ring = reinterpret_cast<bf16*>(smem);

  const long long t = blockIdx.x;
  const int jt = (int)(t % p.nNT);
  const long long row0 = (t / p.nNT) * p.bm;
  const int col0 = jt * p.bn;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / p.wn, wn = warp % p.wn;
  const int rv = (int)min((long long)p.bm, p.m - row0);  // rows of A to read
  const int nv = min(p.bn, p.n - col0);                  // columns of B

  // register-staged loads in flight a thread: fewer beside more
  // accumulators (no spills at 128 registers)
  constexpr int STAGED = MI * NI >= 16 ? 8 : MI * NI >= 8 ? 16 : 32;
  constexpr int RUN_CHUNKS = MI * NI >= 16 ? 2 : MI * NI >= 8 ? 4 : 8;
  constexpr int NBUF = MI * NI >= 16 ? 1 : 2;  // fragment buffers
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // issue the copies of k-span s into ring slot s % slots: A (bm, ks) and
  // B (ks, bn), zero past m, n and k
  const CopyPlan pa = copy_plan(p.ks / p.vwa, tid, nthr);
  const CopyPlan pb = copy_plan(p.bn / p.vwb, tid, nthr);
  auto load = [&](int s) {
    const int k0 = s * p.ks;
    const int kv = min(p.ks, p.k - k0);          // real columns of the span
    const int kc = min(p.ks, (kv + 15) & ~15);   // columns its slices read
    bf16* ad = ring + (s % p.slots) * slot;
    bf16* bd = ad + a_slot;
    // one span of whole rows with a pitch 16-byte copies cannot take: the
    // tile is one contiguous run (conv1)
    if (p.vwa == 8 || p.nKT > 1 || kv < p.k ||
        !copy_rows_run<RUN_CHUNKS>(ad, p.ldA, a + row0 * p.k, p.k, p.bm, rv,
                                   kc, tid, nthr))
      copy_any<STAGED>(p.vwa, ad, p.ldA, a + row0 * p.k + k0, p.k, p.bm, rv,
                       p.ks, kv, pa, tid, nthr);
    copy_any<STAGED>(p.vwb, bd, p.ldB, b + (long long)k0 * p.n + col0, p.n,
                     p.ks, kv, p.bn, nv, pb, tid, nthr);
  };

  for (int s = 0; s < p.slots - 1; ++s) {
    if (s < p.nKT) load(s);
    cp_async_commit();
  }

  for (int s = 0; s < p.nKT; ++s) {
    // span s has landed (slots - 2 younger groups may be in flight) ...
    if (p.slots == 3) cp_async_wait<1>(); else cp_async_wait<0>();
    // ... for every thread, and every warp is done with span s - 1's slot
    __syncthreads();
    if (s + p.slots - 1 < p.nKT) load(s + p.slots - 1);
    cp_async_commit();

    const bf16* at = ring + (s % p.slots) * slot;
    const bf16* bt = at + a_slot;
    const int n16 = min(p.ks, p.k - s * p.ks + 15) >> 4;  // slices with real k
    if constexpr (LINEAR) {
      for (int kk = 0; kk < n16; ++kk) {
        const int kc = kk * 16;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int q = warp * NI + j;
          if (q >= p.cm * p.cn) break;
          const int mt = q / p.cn, nt = q - mt * p.cn;
          uint32_t af[4], bfr[2];
          ldsm_x4(af, at + (mt * 16 + (lane & 15)) * p.ldA + kc + (lane >> 4) * 8);
          ldsm_x2_t(bfr, bt + (kc + (lane & 15)) * p.ldB + nt * 8);
          mma_bf16(acc[0][j], af, bfr);
        }
      }
    }
    if constexpr (!LINEAR) {
      // the fragments of slice kk + 1 load while slice kk multiplies, in a
      // second buffer where 128 registers leave room for one
      uint32_t af[NBUF][MI][4], bfr[NBUF][NI][2];
      auto frags = [&](int kk, uint32_t (&fa)[MI][4], uint32_t (&fb)[NI][2]) {
        const int kc = kk * 16;
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldsm_x4(fa[i], at + ((wm * MI + i) * 16 + (lane & 15)) * p.ldA + kc +
                             (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j + 1 < NI; j += 2)
          ldsm_x4_t(fb[j], fb[j + 1], bt + (kc + (lane & 15)) * p.ldB +
                                          (wn * NI + j) * 8 + (lane >> 4) * 8);
        if constexpr (NI % 2 == 1)
          ldsm_x2_t(fb[NI - 1], bt + (kc + (lane & 15)) * p.ldB +
                                    (wn * NI + NI - 1) * 8);
      };
      for (int g = 0; g < n16; g += MAX_SLICES) {
        const int ng = min(MAX_SLICES, n16 - g);
        frags(g, af[0], bfr[0]);
#pragma unroll
        for (int kk = 0; kk < MAX_SLICES; ++kk) {
          if (kk >= ng) break;
          const int cur = kk % NBUF, nxt = (kk + 1) % NBUF;
          if (NBUF == 2 && kk + 1 < ng) frags(g + kk + 1, af[nxt], bfr[nxt]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
              mma_bf16(acc[i][j], af[cur][i], bfr[cur][j]);
          if (NBUF == 1 && kk + 1 < ng) frags(g + kk + 1, af[nxt], bfr[nxt]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the trailing groups are empty)

  // epilogue: fragment (i, j) holds rows g, g + 8 and columns 2t, 2t + 1 of
  // its m16n8 tile (g = lane / 4, t = lane % 4)
  const bool paired = (p.ldo % 2 == 0) && (p.bn % 2 == 0);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      int mt, nt;
      if constexpr (LINEAR) {
        const int q = warp * NI + j;
        if (q >= p.cm * p.cn) break;
        mt = q / p.cn;
        nt = q - mt * p.cn;
      } else {
        mt = wm * MI + i;
        nt = wn * NI + j;
      }
      const int c = nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + (lane >> 2) + h * 8;
        if (r >= p.bm || c >= p.bn) continue;
        Tout* o = out + (row0 + r) * p.ldo + col0 + c;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (paired) {
          *reinterpret_cast<typename Pair<Tout>::T*>(o) = Pair<Tout>::make(x, y);
        } else {
          o[0] = from_f<Tout>(x);
          if (c + 1 < p.bn) o[1] = from_f<Tout>(y);
        }
      }
    }
}

template <typename Tin, typename Tout>
cudaError_t launch_k(void (*kern)(const Tin*, const Tin*, Tout*, const MMParams),
                     const void* a, const void* b, void* out, const MMParams& p,
                     long long blocks, int threads, int smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)  // the most shared memory: two rings share an SM
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t launch_fma(int variant, const void* a, const void* b, void* out,
                       const MMParams& p, long long blocks, int threads,
                       int smem, cudaStream_t s) {
  switch (variant) {  // micro-tile TM x TN, as MICRO_TILES in kernels/matmul.py
    case 0: return launch_k(matmul_kernel<float, Tout, 8, 8>, a, b, out, p, blocks, threads, smem, s);
    case 1: return launch_k(matmul_kernel<float, Tout, 16, 4>, a, b, out, p, blocks, threads, smem, s);
    case 2: return launch_k(matmul_kernel<float, Tout, 4, 16>, a, b, out, p, blocks, threads, smem, s);
    case 3: return launch_k(matmul_kernel<float, Tout, 32, 2>, a, b, out, p, blocks, threads, smem, s);
    case 4: return launch_k(matmul_kernel<float, Tout, 64, 1>, a, b, out, p, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tout>
cudaError_t launch_tc(int variant, const void* a, const void* b, void* out,
                      const MMParams& p, long long blocks, int threads,
                      int smem, cudaStream_t s) {
  switch (variant) {  // (MI, NI) as TC_VARIANTS in kernels/matmul.py
    case 0: return launch_k(matmul_tc_kernel<Tout, 4, 4, false>, a, b, out, p, blocks, threads, smem, s);
    case 1: return launch_k(matmul_tc_kernel<Tout, 2, 4, false>, a, b, out, p, blocks, threads, smem, s);
    case 2: return launch_k(matmul_tc_kernel<Tout, 1, 16, true>, a, b, out, p, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. bf16 inputs run the tensor-core
// kernel (variant indexes TC_VARIANTS, nKT counts the k-spans holding real
// k), f32 inputs the FMA kernel (variant indexes MICRO_TILES). Returns the
// launch's cudaError_t.
extern "C" int repro_matmul(
    const void* a, const void* b, void* out, int in_dtype, int out_dtype,
    int variant, long long m, int n, int k, int bm, int bn, int bk,
    long long nMT, int nNT, int nKT, long long ldo, int nRG, int ldA, int ldB,
    long long a_bytes, int wn, int cm, int cn, int ks, int slots, int vwa,
    int vwb, int threads, int smem, void* stream) {
  MMParams p{m, n, k, bm, bn, bk, nNT, nKT, ldo, nRG, ldA, ldB, a_bytes,
             wn, cm, cn, ks, slots, vwa, vwb};
  const long long blocks = nMT * nNT;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && (slots < 2 || slots > 3)) return (int)cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0)
    return (int)launch_fma<float>(variant, a, b, out, p, blocks, threads, smem, s);
  if (in_dtype == 0 && out_dtype == 1)
    return (int)launch_fma<__nv_bfloat16>(variant, a, b, out, p, blocks, threads, smem, s);
  if (in_dtype == 1 && out_dtype == 0)
    return (int)launch_tc<float>(variant, a, b, out, p, blocks, threads, smem, s);
  if (in_dtype == 1 && out_dtype == 1)
    return (int)launch_tc<__nv_bfloat16>(variant, a, b, out, p, blocks, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}
