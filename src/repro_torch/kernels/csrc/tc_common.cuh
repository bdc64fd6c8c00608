// Device helpers shared by the tensor-core kernels of csrc/matmul.cu,
// csrc/conv2d.cu, csrc/flash_attention.cu, csrc/paged_decode.cu and
// csrc/quant.cu: cp.async 16-byte copies into shared memory, ldmatrix
// (bf16 tiles, and int8 tiles read as b16 pairs), the mma.sync m16n8k16
// bf16 and m16n8k32 s8 products, the tile copies that feed a shared-memory
// ring, a kernel's launch attributes set once, and what the two direct
// convs (bf16 and int8) share: the halo window's copy into a slot, the
// output tile of a CTA and 4-pixel stores. Included once by each source
// (the build hashes the headers of csrc/ with the source).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// two f32 values as one register of a bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 tiles: ldmatrix reads 8 rows of 16 bytes as b16 pairs, and lane l
// receives bytes 4 (l % 4) .. 4 (l % 4) + 3 of row l / 4: the m16n8k32 s8
// fragment layout, A (row) from rows of m, B (col) from rows of n. So both
// operands sit in shared memory with k contiguous.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const int8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// D += A B over k32: int8 x int8 -> int32, exact (the IMMA pipe)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int VB> struct Bytes;  // VB bytes as one aligned load
template <> struct Bytes<1> { typedef uint8_t T; };
template <> struct Bytes<2> { typedef unsigned short T; };
template <> struct Bytes<4> { typedef unsigned int T; };
template <> struct Bytes<8> { typedef uint2 T; };
template <> struct Bytes<16> { typedef uint4 T; };

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

// Copy rows [0, R) x columns [0, C) of a row-major global tile of T (bf16
// or int8; row pitch lds) into shared memory (row pitch ldd), VW elements at
// a time; entries at or past (rv, cv) are zero-filled, never read. VW
// elements of 16 bytes: cp.async 16-byte copies (the caller commits and
// waits); else loads into registers, ELEMS elements in flight a thread,
// then stores.
template <int VW, int ELEMS, typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ldd,
                                          const T* __restrict__ src,
                                          long long lds, int R, int rv, int C,
                                          int cv, CopyPlan pl, int tid,
                                          int nthr) {
  typedef typename Bytes<VW * (int)sizeof(T)>::T V;
  constexpr bool ASYNC = VW * sizeof(T) == 16;
  constexpr int BATCH = ELEMS / VW > 0 ? ELEMS / VW : 1;
  if (pl.rs) {
    const int c = pl.c * VW, rs = pl.rs;
    const bool cok = c < cv;
    if constexpr (ASYNC) {
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
  if constexpr (ASYNC) {
    for (int i = tid; i < total; i += nthr) {
      const int r = i / cpr, c = (i - r * cpr) * VW;
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

// copy_tile with the run-time width vw (elements: 16 for int8 and 8 for
// bf16 are the 16-byte copies)
template <int ELEMS, typename T>
__device__ __forceinline__ void copy_any(int vw, T* dst, int ldd, const T* src,
                                         long long lds, int R, int rv, int C,
                                         int cv, CopyPlan pl, int tid, int nthr) {
  if constexpr (sizeof(T) == 1) {
    if (vw == 16) {
      copy_tile<16, ELEMS>(dst, ldd, src, lds, R, rv, C, cv, pl, tid, nthr);
      return;
    }
  }
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

// Set the dynamic shared memory (and the carveout) of one kernel instance
// once per device.
template <typename K>
cudaError_t configure_once(K kern, int smem, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
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

// ---------------------------------------------------------------------------
// The direct convs (csrc/conv2d.cu, csrc/quant.cu). P is the kernel's
// parameter struct: its fields of the same names (kernels/conv2d.py,
// window_layout, gives the pitches).
// ---------------------------------------------------------------------------

// x / d for 0 <= x < 2^31 by a multiply-high, an add and a shift (d >= 1;
// fast_div computes m and s on the host)
struct FastDiv {
  uint32_t m, s;
  __device__ __forceinline__ int operator()(int x) const {
    return (int)((__umulhi((uint32_t)x, m) + (uint32_t)x) >> s);
  }
};

inline FastDiv fast_div(int d) {
  uint32_t s = 0;
  while ((1ull << s) < (unsigned long long)d) ++s;
  return FastDiv{(uint32_t)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

// The window copy's view: images x ch channels x rows, each row copied as
// the 16-byte-aligned runs that cover it (a whole-plane window: one row an
// image, its ch * H * W elements). Row q of the view is entry q of a table
// each CTA builds once in shared memory: x = its source offset from a
// step's window origin in x, y = its destination offset from the origin in
// a slot (low 18 bits) and its channel (high bits; ROW_DEAD for a row past
// N or H, which is zero-filled). The slot's pitches are congruent to the
// input's modulo a run, so an aligned run lands on an aligned run.
constexpr int ROW_DEAD = 0x1fff;

template <typename P>
__device__ __forceinline__ void window_rows(int2* rowt, const P& p, int nv,
                                            int rv, int tid, int nthr) {
  const int ch = p.run ? 1 : p.b_cI, rows = p.run ? 1 : p.h_in;
  const int s_ch = p.H * p.W;
  for (int q = tid; q < p.bN * ch * rows; q += nthr) {
    const int t = p.f_rows(q), r = q - t * rows;
    const int n = p.f_ch(t), c = t - n * ch;
    const int live = n < nv && r < rv ? c : ROW_DEAD;
    rowt[q] = make_int2(n * p.c_I * s_ch + c * s_ch + r * p.W,
                        (live << 18) | (n * p.d_img + c * p.d_ch + r * p.d_row));
  }
}

// Copy one c_I step's window into shared memory with 16-byte cp.async (the
// caller commits and waits), G = 16 bytes of T a run: run j of row q's
// cover goes from src (the step's window origin in x, g0m = its element
// offset mod G) to dst (the window origin in the slot); elements at or past
// vend in a row, rows of channels at or past cv and dead rows are
// zero-filled, through a partial (src-size) copy; runs wholly past the row
// are not issued.
template <typename T, typename P>
__device__ __forceinline__ void copy_window(T* dst, const T* __restrict__ src,
                                            const T* __restrict__ x, int g0m,
                                            const int2* rowt, const P& p,
                                            int cv, int vend, int tid, int nthr) {
  constexpr int G = 16 / (int)sizeof(T);
  const int len = p.run ? p.b_cI * p.H * p.W : p.w_in;
  const int gpr = (len + 2 * G - 2) / G;
  const int total = p.bN * (p.run ? 1 : p.b_cI * p.h_in) * gpr;
  // elements of run i to copy (-1: no run), its offsets from the origins
  auto where = [&](int i, int& s, int& d) {
    const int q = p.f_gpr(i);
    const int2 e = rowt[q];
    const int start = (i - q * gpr) * G - ((g0m + e.x) & (G - 1));
    s = e.x + start;
    d = (e.y & 0x3ffff) + start;
    if (start >= len) return -1;
    return (e.y >> 18) < cv ? max(0, min(G, vend - start)) : 0;
  };
  for (int i = tid; i < total; i += nthr) {
    int s, d;
    const int n = where(i, s, d);
    if (n >= 0) cp_async16(dst + d, n ? src + s : x, (int)sizeof(T) * n);
  }
}

// Four consecutive output pixels of one channel, stored at once.
template <typename Tout> struct Quad;
template <> struct Quad<float> {
  static __device__ __forceinline__ void store(float* o, float4 q) {
    *reinterpret_cast<float4*>(o) = q;
  }
};
template <> struct Quad<bf16> {
  static __device__ __forceinline__ void store(bf16* o, float4 q) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(q.x, q.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(q.z, q.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(o) = u;
  }
};

// The output tile of CTA b: its first image, first output channel and its
// row and column blocks (c_O tiles fastest).
struct Tile {
  long long n0;
  int co0, hb, wb;
};

template <typename P>
__device__ __forceinline__ Tile tile_of(const P& p, unsigned b) {
  long long t = b;
  const int co_t = (int)(t % p.nCO); t /= p.nCO;
  const int wb = (int)(t % p.nW); t /= p.nW;
  const int hb = (int)(t % p.nH); t /= p.nH;
  return Tile{t * p.bN, co_t * p.b_cO, hb, wb};
}

// blockIdx.x, read afresh: the epilogue re-derives its tile rather than
// hold it in registers across the c_I loop
__device__ __forceinline__ unsigned ctaid() {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

}  // namespace
