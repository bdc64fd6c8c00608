// int8 direct convolution and int8 GEMM, each with an int32 accumulator and
// one folded f32 scale per output channel (column) applied at the store.
//
// Replaces: src/repro/kernels/quant.py, _conv_q_kernel (entry conv2d_q) and
// _matmul_q_kernel (:324, entry matmul_q), the Pallas TPU kernels.
//
//   out[n, co, h, w] = float(sum over c_I and taps of x_q * w_q) * scale[co]
//   out[i, j]        = float(sum over k of a_q * b_q) * scale[j]
//
// then cast to out_dtype (float32 or bfloat16).
//
// Numerics: the int32 sum is exact (the largest |sum| at the ResNet-50
// shapes is 512 * 9 * 127^2 ~ 7.4e7 < 2^31); it is converted to f32 once, at
// the store, multiplied by the f32 scale and cast to out_dtype, each step
// rounding to nearest even. The reference instead adds each (tap, c_I block)
// int32 partial into an f32 accumulator, which rounds once a sum passes
// 2^24; below that the two agree bit for bit.
//
// Both kernels: one CTA per output tile, the tile index flattened into
// blockIdx.x; the loop over the reduction (c_I blocks, k spans) runs inside
// the CTA, the int32 accumulator stays in registers across it. The H100
// int8 plans hold up to 32,768 accumulators a tile (the reference's LP
// prices the accumulator at the output's stored width, half a word for
// bf16), twice what the bf16 kernels hold: up to 512 threads a CTA, 64
// int32 registers each (__launch_bounds__(512, 1): at most 128 registers a
// thread). Scale: each CTA stages its b_cO (bn) slice of the scale vector in
// shared memory and applies it at the store. The counters keep the
// reference's convention (c_O words once per launch), so the words issued
// exceed them by (CTAs - c_O tiles) * b_cO: 0.31% on conv1, 0.19% on
// conv2_x, less on the other layers of the H100 plans. All global offsets
// are 64-bit; tile-local ones are 32-bit.
//
// conv2d_q_kernel: the first version, on the CUDA cores. Each thread owns a
// micro-tile of the accumulator (a template argument the wrapper picks) and
// multiplies with __dp4a (four int8 products summed into an int32 an
// instruction) from shared-memory words of four int8 values along c_I,
// packed from byte loads masked to the array and the tile (zero-filled
// beyond), so the bytes issued are the windows and blocks that
// conv2d_q_hbm_words counts. One stage. Bound on an H100 by the integer
// pipe and shared-memory reads, far above the card's memory bound.
//
// matmul_q_tc_kernel: the int8 tensor cores. At the reference's GEMMs and
// conv5_x's Im2Col GEMM (49000 x 4608 x 512) the work is bound by
// operations at the card's 1,979 TOP/s of dense int8 (2048^3: 0.0087 ms,
// conv5_x: 0.117), so the products go to the IMMA pipe:
//  * mma.sync m16n8k32 s8 x s8 -> s32, int32 accumulators in registers.
//    A is (m, k) with k contiguous, the MMA's row layout: ldmatrix.x4 on
//    the int8 stage read as b16 pairs gives the A fragment. Warps own MI x
//    NI m16n8 tiles ((2, 8): a 32 x 64 warp tile, 64 accumulators a
//    thread; a 4 x 4 grid of 16 warps on the (128, 256) plan, 8 x 2 on
//    (256, 128)); a tile that block does not cover within 16 warps takes
//    the LINEAR variant (warp w owns m16n8 tiles 16w .. 16w + 15 of the
//    covered tile in row-major order).
//  * B is (k, n) with n contiguous (the reference's signature), but the s8
//    MMA takes B k-major ("col": four consecutive k of one column a
//    register), and ldmatrix.trans moves 16-bit elements only. So each
//    ring stage of B lands by cp.async as [k][n] rows and is transposed
//    once per CTA in shared memory into a [n][k] buffer (B^T), from which
//    ldmatrix.x4 gives the B fragments exactly as for A. The transpose
//    moves 4 x 4 byte blocks: four 32-bit loads from four k rows, a byte
//    transpose by __byte_perm, four 32-bit stores into four n rows. A warp
//    takes 4 k-groups x 8 column words; lanes of the upper two k-groups load
//    their rows in the order 2, 3, 0, 1 and each lane rotates its stores by
//    (lane % 8) / 2 rows, so with both pitches an odd multiple of 16 bytes
//    the loads and the stores each hit 32 distinct banks. No transposed
//    copy of B is made in HBM: the bytes issued stay what
//    matmul_q_hbm_words counts.
//  * The plans have bk = 16, half the MMA's k32 (the H100 preset aligns
//    tiles to the bf16 depth, and the plans stay the reference's). A ring
//    stage spans ks = 128 k (64 or 32 where shared memory is short; never
//    less than bk rounded up to 32), several plan k-steps; k past the end
//    is zero-filled in shared memory, and k32 slices wholly past k skip
//    their MMAs. The words the counter charges do not depend on the span.
//  * The ring: three A stages and two B stages, one cp.async commit group
//    a span, and B^T double-buffered. Iteration s waits until span s + 1
//    has landed (cp.async.wait_group 0) and syncs once; then it issues span
//    s + 2 into the slots that spans s - 1 (A) and s (B) have freed,
//    transposes span s + 1 into B^T slot (s + 1) % 2, and multiplies span s
//    from A slot s % 3 and B^T slot s % 2. One __syncthreads a span.
//  * A CTA computes the plan's (bm, bn) tile where 16 warps and the ring
//    hold it (every main-path plan). A narrow tile, as the plans of GEMMs
//    with m or n of 16 or less give (1 x 4096, 16 x 2048, 2048 x 16), pads
//    to m16 / n8 tiles past what 16 warps or the ring's shared memory hold:
//    such a tile is cut along its longer side into sm x sn equal shares,
//    one CTA each, as few as fit. A share re-reads the tile's slice of the
//    narrow operand, beyond what the counter charges (1 x 4096 x 4096: A,
//    4 KiB, read three times against B's 16 MiB).
//  * Stage rows are padded to an odd multiple of 16 bytes, so ldmatrix's
//    eight row addresses hit eight distinct bank groups.
//  * A pitch or base that 16-byte copies cannot take (k = 77, n = 300, a
//    row slice of A at an odd offset) is copied with the widest aligned
//    loads it allows (8, 4, 2 or 1 bytes) through registers, in the same
//    kernel. Every main-path shape takes the cp.async path.
//  * The epilogue stores the padded (mp, np) output from the fragments,
//    paired float2 / __nv_bfloat162 stores where the pitch allows.
//  * The launch attributes are set once per instance and device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

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
// matmul_q: the int8 tensor cores
// ---------------------------------------------------------------------------

struct MMQParams {
  long long m;
  int n, k, bm, bn;     // the plan's tile
  int cbm, cbn, sm, sn; // a CTA's share of it; CTAs a tile along m and n
  long long nMT;        // CTAs along m (m tiles x sm)
  int nNT, nS;          // CTAs along n (n tiles x sn); ring spans
  long long ldo;        // padded output row length (np)
  int wn, cn;           // warps along n (blocks); n8 tiles of the covered tile
  int rows, bt;         // covered rows; columns of B staged and transposed
  int ks;               // k-span of a stage (a multiple of 32)
  int lda, ldbs, ldbt;  // shared-memory pitches in bytes: A, B, B^T stages
  int vwa, vwb;         // bytes a global load of A / B moves (16: cp.async)
  int off_bs, off_bt, off_sc;  // shared-memory offsets: B ring, B^T, scale
};

// The C entry's geometry array, in MMQParams order (kernels/quant.py,
// GEOMETRY).
constexpr int N_GEOMETRY = 26;

MMQParams unpack(const long long* g) {
  MMQParams p{};
  p.m = g[0];
  int* mid[] = {&p.n, &p.k, &p.bm, &p.bn, &p.cbm, &p.cbn, &p.sm, &p.sn};
  for (int i = 0; i < 8; ++i) *mid[i] = (int)g[1 + i];
  p.nMT = g[9];
  p.nNT = (int)g[10]; p.nS = (int)g[11];
  p.ldo = g[12];
  int* rest[] = {&p.wn, &p.cn, &p.rows, &p.bt, &p.ks, &p.lda, &p.ldbs,
                 &p.ldbt, &p.vwa, &p.vwb, &p.off_bs, &p.off_bt, &p.off_sc};
  for (int i = 0; i < 13; ++i) *rest[i] = (int)g[13 + i];
  return p;
}

// The ring: A_SLOTS stages of A, A_SLOTS - 1 of B, two of B^T.
constexpr int A_SLOTS = 3;

// B^T[n][k] = B[k][n] for one stage: the [ks][bt] stage (pitch ldbs) into
// [bt][ks] (pitch ldbt), as 4 x 4 byte blocks. Warp-block (gb, cb) holds
// k-groups 4 gb .. 4 gb + 3 (g: rows 4 g .. 4 g + 3) and column words
// 8 cb .. 8 cb + 7 (c: columns 4 c .. 4 c + 3); lane = 8 (g % 4) + c % 8.
// Lanes with g % 4 >= 2 load their four rows in the order 2, 3, 0, 1, and
// lane c % 8 = 2 r, 2 r + 1 writes its four n rows starting at the r-th:
// with both pitches 16 mod 32 bytes the 32 loads and the 32 stores of each
// step fall in 32 distinct banks (kernels/quant.py, transpose_stage, models
// this bit for bit).
__device__ __forceinline__ void transpose_stage(const int8_t* src, int8_t* dst,
                                                int ks, int bt, int ldbs,
                                                int ldbt, int warp, int nwarps,
                                                int lane) {
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(src);
  uint32_t* t32 = reinterpret_cast<uint32_t*>(dst);
  const int P = ldbs >> 2, Q = ldbt >> 2;  // pitches in words
  const int ncb = bt >> 5, nblk = (ks >> 4) * ncb;
  const int cl = lane & 7, gl = lane >> 3, sh = gl & 2, rot = cl >> 1;
  int gb = warp / ncb, cb = warp - gb * ncb;
  for (int blk = warp; blk < nblk; blk += nwarps) {
    const int g = 4 * gb + gl, c = 8 * cb + cl;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = w32[(4 * g + ((i + sh) & 3)) * P + c];
    if (sh) {  // back to rows 0, 1, 2, 3
      uint32_t x = w[0]; w[0] = w[2]; w[2] = x;
      x = w[1]; w[1] = w[3]; w[3] = x;
    }
    // byte b of row i becomes byte (b - rot) mod 4: the transposed word j
    // then holds column 4 c + (j + rot) mod 4
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __funnelshift_r(w[i], w[i], 8 * rot);
    const uint32_t u0 = __byte_perm(w[0], w[1], 0x5140);  // a0 b0 a1 b1
    const uint32_t u1 = __byte_perm(w[0], w[1], 0x7362);  // a2 b2 a3 b3
    const uint32_t u2 = __byte_perm(w[2], w[3], 0x5140);  // c0 d0 c1 d1
    const uint32_t u3 = __byte_perm(w[2], w[3], 0x7362);  // c2 d2 c3 d3
    const uint32_t t[4] = {__byte_perm(u0, u2, 0x5410), __byte_perm(u0, u2, 0x7632),
                           __byte_perm(u1, u3, 0x5410), __byte_perm(u1, u3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) t32[(4 * c + ((j + rot) & 3)) * Q + g] = t[j];
    cb += nwarps;
    while (cb >= ncb) { cb -= ncb; ++gb; }
  }
}

// MI x NI m16n8 tiles a warp (LINEAR: MI = 1, NI = 16 tiles in row-major
// order of the covered tile's (rows / 16) x cn grid).
template <typename Tout, int MI, int NI, bool LINEAR>
__global__ void __launch_bounds__(512, 1)
matmul_q_tc_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const float* __restrict__ scale, Tout* __restrict__ out,
                   const MMQParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const ar = reinterpret_cast<int8_t*>(smem);             // [3][rows][lda]
  int8_t* const bs = reinterpret_cast<int8_t*>(smem + p.off_bs);  // [2][ks][ldbs]
  int8_t* const btr = reinterpret_cast<int8_t*>(smem + p.off_bt); // [2][bt][ldbt]
  float* const sc = reinterpret_cast<float*>(smem + p.off_sc);    // [cbn]
  const int a_slot = p.rows * p.lda, b_slot = p.ks * p.ldbs, t_slot = p.bt * p.ldbt;

  // the CTA's share (si, sj) of tile (ti, tj): rows [row0, row0 + rl) and
  // columns [col0, col0 + cl) of the padded output
  const long long t = blockIdx.x, it = t / p.nNT;
  const int jt = (int)(t - it * p.nNT);
  const int si = (int)(it % p.sm) * p.cbm, sj = jt % p.sn * p.cbn;
  const long long row0 = it / p.sm * p.bm + si;
  const int col0 = jt / p.sn * p.bn + sj;
  const int rl = min(p.cbm, p.bm - si), cl = min(p.cbn, p.bn - sj);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const int wm = warp / p.wn, wn = warp % p.wn;
  const int rv = (int)max(0LL, min((long long)rl, p.m - row0));  // rows of A
  const int nv = max(0, min(cl, p.n - col0));                     // cols of B
  const int tiles = (p.rows >> 4) * p.cn;              // LINEAR: m16n8 tiles

  // the CTA's slice of the folded scale (0 past n: padded columns); the
  // prologue's __syncthreads publishes it
  for (int i = tid; i < cl; i += nthr)
    sc[i] = col0 + i < p.n ? scale[col0 + i] : 0.f;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // issue the copies of span s: A (rows, ks) into A slot s % 3, B (ks, bt)
  // into B slot s % 2, zero past m, n and k; a pitch 16-byte
  // copies cannot take moves through registers, STAGED bytes in flight a
  // thread (few: more spill the main-path instances at 128 registers)
  constexpr int STAGED = 4;
  const CopyPlan pa = copy_plan(p.ks / p.vwa, tid, nthr);
  const CopyPlan pb = copy_plan(p.bt / p.vwb, tid, nthr);
  const int8_t* const at0 = a + row0 * p.k;
  const int8_t* const bt0 = b + col0;
  auto load = [&](int s) {
    const int k0 = s * p.ks, kv = min(p.ks, p.k - k0);
    copy_any<STAGED>(p.vwa, ar + (s % A_SLOTS) * a_slot, p.lda, at0 + k0,
                     p.k, p.rows, rv, p.ks, kv, pa, tid, nthr);
    copy_any<STAGED>(p.vwb, bs + (s % (A_SLOTS - 1)) * b_slot, p.ldbs,
                     bt0 + (long long)k0 * p.n, p.n, p.ks, kv, p.bt, nv, pb,
                     tid, nthr);
  };
  auto transpose = [&](int s) {
    transpose_stage(bs + (s % (A_SLOTS - 1)) * b_slot, btr + (s & 1) * t_slot,
                    p.ks, p.bt, p.ldbs, p.ldbt, warp, nwarps, lane);
  };

  for (int s = 0; s < A_SLOTS - 1; ++s) {
    if (s < p.nS) load(s);
    cp_async_commit();
  }
  cp_async_wait<A_SLOTS - 2>();  // span 0 has landed (for this thread) ...
  __syncthreads();               // ... and for every thread
  transpose(0);

  for (int s = 0; s < p.nS; ++s) {
    // span s + 1 has landed; B^T of span s is written; every warp is done
    // with span s - 1's A slot and B^T slot and with span s's B slot
    cp_async_wait<A_SLOTS - 3>();
    __syncthreads();
    if (s + A_SLOTS - 1 < p.nS) load(s + A_SLOTS - 1);
    cp_async_commit();
    if (s + 1 < p.nS) transpose(s + 1);

    const int8_t* const as = ar + (s % A_SLOTS) * a_slot;
    const int8_t* const bq = btr + (s & 1) * t_slot;
    const int n32 = (min(p.ks, p.k - s * p.ks) + 31) >> 5;  // slices with real k
    for (int kk = 0; kk < n32; ++kk) {
      const int kc = kk * 32;
      if constexpr (LINEAR) {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int q = warp * NI + j;
          if (q >= tiles) break;
          const int mt = q / p.cn, nt = q - mt * p.cn;
          uint32_t af[4], bfr[2];
          ldsm_x4(af, as + (mt * 16 + (lane & 15)) * p.lda + kc + (lane >> 4) * 16);
          ldsm_x2(bfr, bq + (nt * 8 + (lane & 7)) * p.ldbt + kc + ((lane >> 3) & 1) * 16);
          mma_s8(acc[0][j], af, bfr);
        }
      } else {
        uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldsm_x4(af[i], as + ((wm * MI + i) * 16 + (lane & 15)) * p.lda + kc +
                             (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, bq + ((wn * NI + j) * 8 + (lane & 7) + ((lane >> 4) << 3)) * p.ldbt +
                         kc + ((lane >> 3) & 1) * 16);
          bfr[j][0] = r[0]; bfr[j][1] = r[1];
          bfr[j + 1][0] = r[2]; bfr[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the trailing groups are empty)

  // epilogue: fragment (i, j) holds rows g, g + 8 and columns 2t, 2t + 1 of
  // its m16n8 tile (g = lane / 4, t = lane % 4); int32 -> f32 (round to
  // nearest), times the f32 scale, cast to Tout
  const bool paired = (p.ldo % 2 == 0) && (col0 % 2 == 0) && (cl % 2 == 0);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      int mt, nt;
      if constexpr (LINEAR) {
        const int q = warp * NI + j;
        if (q >= tiles) break;
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
        if (r >= rl || c >= cl) continue;
        Tout* o = out + (row0 + r) * p.ldo + col0 + c;
        const float x = (float)acc[i][j][2 * h] * sc[c];
        if (paired) {
          const float y = (float)acc[i][j][2 * h + 1] * sc[c + 1];
          *reinterpret_cast<typename Pair<Tout>::T*>(o) = Pair<Tout>::make(x, y);
        } else {
          o[0] = from_f<Tout>(x);
          if (c + 1 < cl) o[1] = from_f<Tout>((float)acc[i][j][2 * h + 1] * sc[c + 1]);
        }
      }
    }
}

template <typename Tout, int MI, int NI, bool LINEAR>
cudaError_t mm_launch_t(const void* a, const void* b, const void* scale,
                        void* out, const MMQParams& p, int threads, int smem,
                        cudaStream_t s) {
  static unsigned done = 0;
  auto kern = matmul_q_tc_kernel<Tout, MI, NI, LINEAR>;
  // the attribute is the most any launch asks: set once, not per launch
  cudaError_t e = configure_once(kern, 232448, done);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)(p.nMT * p.nNT), threads, smem, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(scale), static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t mm_launch_v(int variant, const void* a, const void* b,
                        const void* scale, void* out, const MMQParams& p,
                        int threads, int smem, cudaStream_t s) {
  switch (variant) {  // (MI, NI), as TC_VARIANTS in repro_torch.kernels.quant
    case 0: return mm_launch_t<Tout, 2, 8, false>(a, b, scale, out, p, threads, smem, s);
    case 1: return mm_launch_t<Tout, 1, 16, true>(a, b, scale, out, p, threads, smem, s);
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

// g holds the launch geometry in MMQParams order; variant indexes
// TC_VARIANTS (the last: LINEAR). Returns the launch's cudaError_t.
extern "C" int repro_matmul_q(const void* a, const void* b, const void* scale,
                              void* out, int out_dtype, int variant,
                              const long long* g, int n_g, int threads,
                              int smem, void* stream) {
  if (n_g != N_GEOMETRY) return (int)cudaErrorInvalidValue;
  const MMQParams p = unpack(g);
  const long long blocks = p.nMT * p.nNT;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (p.ks % 32 || p.bt % 32 || p.nS < 1 || p.cbm < 1 || p.cbn < 1 ||
      p.sm < 1 || p.sn < 1 || (16 % p.vwa) || (16 % p.vwb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return (int)mm_launch_v<float>(variant, a, b, scale, out, p, threads, smem, s);
  if (out_dtype == 1)
    return (int)mm_launch_v<__nv_bfloat16>(variant, a, b, scale, out, p, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}
