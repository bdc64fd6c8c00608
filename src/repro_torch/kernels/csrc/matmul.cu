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
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r0)[2], uint32_t (&r1)[2],
                                          const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0[0]), "=r"(r0[1]), "=r"(r1[0]), "=r"(r1[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int VW> struct Vec;  // VW bf16 elements as one aligned load
template <> struct Vec<1> { typedef unsigned short T; };
template <> struct Vec<8> { typedef uint4 T; };
template <> struct Vec<2> { typedef unsigned int T; };
template <> struct Vec<4> { typedef uint2 T; };

// A thread's share of a tile copy with C / VW chunks a row: when the threads
// divide evenly over a row's chunks (every tile of the main path), the
// thread keeps chunk column c and steps over rows r0, r0 + rs, ...; rs == 0
// means a per-chunk division. Planned once a kernel: the shapes of every
// span's copies are the same.
struct CopyPlan { int c, r0, rs; };

__device__ __forceinline__ CopyPlan copy_plan(int cpr, int tid, int nthr) {
  if (nthr % cpr) return CopyPlan{0, 0, 0};
  return CopyPlan{tid % cpr, tid / cpr, nthr / cpr};
}

// Copy rows [0, R) x columns [0, C) of a row-major global tile (row pitch
// lds) into shared memory (row pitch ldd), VW elements at a time; entries at
// or past (rv, cv) are zero-filled, never read. VW == 8: cp.async 16-byte
// copies (the caller commits and waits); else loads into registers, ELEMS
// elements in flight a thread, then stores.
template <int VW, int ELEMS>
__device__ __forceinline__ void copy_tile(bf16* dst, int ldd,
                                          const bf16* __restrict__ src,
                                          long long lds, int R, int rv, int C,
                                          int cv, CopyPlan pl, int tid,
                                          int nthr) {
  typedef typename Vec<VW>::T V;
  constexpr int BATCH = ELEMS / VW > 0 ? ELEMS / VW : 1;
  if (pl.rs) {
    const int c = pl.c * VW, rs = pl.rs;
    const bool cok = c < cv;
    if constexpr (VW == 8) {
      for (int r = pl.r0; r < R; r += rs) {
        const bool ok = cok && r < rv;
        cp_async16(dst + r * ldd + c, ok ? src + r * lds + c : src, ok ? 16 : 0);
      }
    } else {
      for (int r0 = pl.r0; r0 < R; r0 += BATCH * rs) {
        V v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int r = r0 + u * rs;
          v[u] = V();
          if (cok && r < rv) v[u] = *reinterpret_cast<const V*>(src + r * lds + c);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int r = r0 + u * rs;
          if (r < R) *reinterpret_cast<V*>(dst + r * ldd + c) = v[u];
        }
      }
    }
    return;
  }
  const int cpr = C / VW, total = R * cpr;
  if constexpr (VW == 8) {
    for (int i = tid; i < total; i += nthr) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const bool ok = r < rv && c < cv;
      cp_async16(dst + r * ldd + c, ok ? src + r * lds + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i0 = tid; i0 < total; i0 += BATCH * nthr) {
      V v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * nthr;
        const int r = i / cpr, c = (i - r * cpr) * VW;
        v[u] = V();
        if (i < total && r < rv && c < cv)
          v[u] = *reinterpret_cast<const V*>(src + r * lds + c);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * nthr;
        const int r = i / cpr, c = (i - r * cpr) * VW;
        if (i < total) *reinterpret_cast<V*>(dst + r * ldd + c) = v[u];
      }
    }
  }
}

template <int ELEMS>
__device__ __forceinline__ void copy_any(int vw, bf16* dst, int ldd,
                                         const bf16* src, long long lds, int R,
                                         int rv, int C, int cv, CopyPlan pl,
                                         int tid, int nthr) {
  switch (vw) {
    case 8: copy_tile<8, ELEMS>(dst, ldd, src, lds, R, rv, C, cv, pl, tid, nthr); break;
    case 4: copy_tile<4, ELEMS>(dst, ldd, src, lds, R, rv, C, cv, pl, tid, nthr); break;
    case 2: copy_tile<2, ELEMS>(dst, ldd, src, lds, R, rv, C, cv, pl, tid, nthr); break;
    default: copy_tile<1, ELEMS>(dst, ldd, src, lds, R, rv, C, cv, pl, tid, nthr); break;
  }
}

// A (rv, k) block of whole rows is one contiguous run of rv * k elements.
// When it starts on 16 bytes (conv1: 128 rows of 147 bf16 = 37,632 bytes),
// a thread loads 16-byte chunks of the run, CHUNKS in flight, and scatters
// their elements into the padded rows; columns [k, kc) and rows [rv, R) are
// zero-filled. Returns false (nothing done) when the run is not aligned.
template <int CHUNKS>
__device__ __forceinline__ bool copy_rows_run(bf16* dst, int ldd,
                                              const bf16* __restrict__ src,
                                              int k, int R, int rv, int kc,
                                              int tid, int nthr) {
  if (reinterpret_cast<uintptr_t>(src) & 15) return false;
  const int total = rv * k, nchunk = (total + 7) / 8;
  for (int j0 = tid; j0 < nchunk; j0 += CHUNKS * nthr) {
    uint4 v[CHUNKS];
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int j = j0 + u * nthr;
      v[u] = make_uint4(0, 0, 0, 0);
      if (j * 8 + 8 <= total) {
        v[u] = *reinterpret_cast<const uint4*>(src + j * 8);
      } else if (j < nchunk) {  // the run's ragged end: element by element
        uint32_t w[4] = {0, 0, 0, 0};
        const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (j * 8 + i < total) w[i >> 1] |= uint32_t(h[j * 8 + i]) << (16 * (i & 1));
        v[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int j = j0 + u * nthr;
      if (j >= nchunk) break;
      int r = j * 8 / k, c = j * 8 - r * k;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t w = i < 2 ? v[u].x : i < 4 ? v[u].y : i < 6 ? v[u].z : v[u].w;
        if (r < rv)
          reinterpret_cast<unsigned short*>(dst)[r * ldd + c] =
              (unsigned short)(w >> (16 * (i & 1)));
        if (++c == k) { c = 0; ++r; }
      }
    }
  }
  const int pad = kc - k;  // zero columns [k, kc) of rows [0, rv), rows [rv, R)
  for (int i = tid; i < rv * pad; i += nthr)
    dst[(i / pad) * ldd + k + i % pad] = bf16();
  for (int i = tid; i < (R - rv) * kc; i += nthr)
    dst[(rv + i / kc) * ldd + i % kc] = bf16();
  return true;
}

template <typename Tout> struct Pair;
template <> struct Pair<float> {
  typedef float2 T;
  static __device__ __forceinline__ T make(float x, float y) { return make_float2(x, y); }
};
template <> struct Pair<__nv_bfloat16> {
  typedef __nv_bfloat162 T;
  static __device__ __forceinline__ T make(float x, float y) {
    return __floats2bfloat162_rn(x, y);
  }
};

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
