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
// conv2d_q_tc_kernel: the int8 tensor cores, an implicit GEMM on the halo
// window as csrc/conv2d.cu's conv2d_tc_kernel runs it in bf16. What bounds
// it on an H100: each ResNet-50 layer at batch 1000 moves 0.03-0.53 ms of
// compulsory bytes (x and w read once, the bf16 output written once; conv1
// and conv2_x are bound by them) against 0.12 ms of products at 1,979
// TOP/s (conv3_x-conv5_x); the plan's words, windows and filters re-read,
// take 0.19-0.61 ms at 3.35 TB/s. mma.sync issue, and the shared-memory
// gather that feeds it, bind first. What the design does:
//  * Rows m are the tile's output pixels (n, ho, wo), columns its output
//    channels, k = (c * h_F + hf) * w_F + wf over a ring stage's channels
//    in OIHW order. So the filter block stays [co][k] as it lies in HBM,
//    which is the k-major ("col") B operand of mma.sync s8: B fragments
//    come by ldmatrix.x4 from rows padded to an odd multiple of 16 bytes,
//    with no transpose. A[m, k] = window[moff[m] + koff[k]]: koff, the same
//    for every CTA and stage, is built by the wrapper (kernels/conv2d.py,
//    gather_table, K padded to 32) and staged once a CTA; moff (row_offsets)
//    is computed once a thread for the rows it owns, 32 bits each (a window
//    slot holds up to 83 KB). The m16n8k32 A fragment holds 4 consecutive k
//    of one row a register: 4 byte loads at moff + koff[k .. k + 3], packed
//    by __byte_perm. Products: mma.sync m16n8k32 s8 x s8 -> s32, exact. K
//    pads to 32 with k that point at a zeroed plane of each image (conv1:
//    147 -> 160, 5 k32 slices).
//  * 16 warps of (2, 8) m16n8 tiles (a 32 x 64 warp tile, 64 int32
//    accumulators a thread) cover the main path's 448-512 x 64 tiles (14 or
//    16 warps); LINEAR (16 m16n8 tiles a warp, row-major over the covered
//    tile) takes a tile that no (2, 8) grid of 16 warps covers. Every
//    instance uses 128 registers a thread without spills (ptxas, nvcc
//    12.9): the copies re-derive the CTA's tile from blockIdx.x, since
//    holding its pointers across the c_I loop spilled 12 bytes.
//  * A two-slot cp.async ring over c_I: one commit group a stage,
//    cp.async.wait_group before a stage is read and a __syncthreads before
//    its slot is refilled. A stage holds two plan c_I blocks where shared
//    memory allows (32 channels of 3 x 3 taps: 288 k, 9 k32 slices, no
//    padding); the words issued do not depend on it. Window rows move as
//    the 16-byte runs of x that cover them, into a slot whose row, plane
//    and image pitches are congruent to x's modulo 16 bytes, with a run of
//    slack each (window_layout with run 16), so an aligned run of x lands
//    aligned whatever the row pitch (conv1's 229-byte rows); the wrapper
//    adds slack between channel planes where its bank model of the byte
//    gather finds fewer conflicts (kernels/quant.py, gather_conflicts;
//    conv3_x and conv4_x: 16 bytes, from 2-way on almost every load to
//    1.02 and 1.35 words a bank). Filter rows
//    take 16-byte copies where their pitch allows; conv1's 147-byte rows go
//    as the block's one aligned run, loaded 16 bytes at a time.
//  * The epilogue stages the tile through shared memory as [channel][pixel]
//    f32, float(acc) * scale[co] (the CTA's slice of the scale, staged
//    once), then stores runs of pixels of one channel: 4 at once where the
//    tile's output rows are whole groups of 4 (conv1, conv2_x), else one a
//    thread, consecutive threads on consecutive pixels. No two-byte value
//    goes to HBM one channel plane from its neighbour's.
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

// ---------------------------------------------------------------------------
// conv2d_q: the int8 tensor cores
// ---------------------------------------------------------------------------

struct ConvQParams {
  long long N;
  int c_I, H, W, c_O, h_F, w_F, sh, sw;
  int bN, b_cI, b_cO, bh, bw, h_in, w_in;  // b_cI: channels a ring stage
  int cOp, hOp, wOp;                       // padded output extents
  int nN, nCO, nH, nW, nCI;                // tile counts; nCI: ring stages
  // k32 slices a stage, filter row pitch (bytes), ring slots, warps along n,
  // n8 tiles and rows of the covered tile, a zero plane (K padded), shared
  // memory offsets of the gather table, the row table and the ring, bytes of
  // a slot's window and of a slot, whole-plane runs, bytes a filter copy
  // moves at once, the filter block as one run, pixels an epilogue store and
  // the staged tile's pixel pitch, the window's row, plane and image pitches
  // and the gather offset of its zero plane (kernels/conv2d.py,
  // window_layout)
  int n32, ldB, slots, wn, cn, rows, zc, off_koff, off_rows, off_ring,
      x_bytes, slot_bytes, run, vwb, b_run, vst, ldS, d_row, d_ch, d_img,
      zero;
  FastDiv f_gpr, f_rows, f_ch, f_bw, f_bhw, f_mv;  // set by the host
};

// The C entry's geometry array, in ConvQParams order (kernels/quant.py,
// CONV_GEOMETRY).
constexpr int N_CONV_GEOMETRY = 45;

// Elements (bytes) a window copy moves: 16, aligned in x (the wrapper's
// CONV_RUN).
constexpr int GQ = 16;

ConvQParams unpack_conv(const long long* g) {
  ConvQParams p{};
  int i = 0;
  p.N = g[i++];
  int* f[] = {&p.c_I, &p.H, &p.W, &p.c_O, &p.h_F, &p.w_F, &p.sh, &p.sw,
              &p.bN, &p.b_cI, &p.b_cO, &p.bh, &p.bw, &p.h_in, &p.w_in,
              &p.cOp, &p.hOp, &p.wOp, &p.nN, &p.nCO, &p.nH, &p.nW, &p.nCI,
              &p.n32, &p.ldB, &p.slots, &p.wn, &p.cn, &p.rows, &p.zc,
              &p.off_koff, &p.off_rows, &p.off_ring, &p.x_bytes,
              &p.slot_bytes, &p.run, &p.vwb, &p.b_run, &p.vst, &p.ldS,
              &p.d_row, &p.d_ch, &p.d_img, &p.zero};
  for (int* v : f) *v = (int)g[i++];
  // the window copy's view: images x channels x rows x runs a row's cover
  // (a whole-plane window: images x 1 x 1 x runs)
  p.f_gpr = fast_div(((p.run ? p.b_cI * p.H * p.W : p.w_in) + 2 * GQ - 2) / GQ);
  p.f_rows = fast_div(p.run ? 1 : p.h_in);
  p.f_ch = fast_div(p.run ? 1 : p.b_cI);
  p.f_bw = fast_div(p.bw);
  p.f_bhw = fast_div(p.bh * p.bw);
  p.f_mv = fast_div(p.vst > 0 ? p.bN * p.bh * p.bw / p.vst : 1);
  return p;
}

// The window offset of GEMM row r = (n, ho, wo) of the tile, n-major
// (kernels/conv2d.py, row_offsets); rows past the tile's M pixels read 0
// (computed, never stored).
__device__ __forceinline__ int row_off(const ConvQParams& p, int r, int M) {
  if (r >= M) return 0;
  const int n = p.f_bhw(r), rem = r - n * p.bh * p.bw;
  const int ho = p.f_bw(rem), wo = rem - ho * p.bw;
  return n * p.d_img + ho * p.sh * p.d_row + wo * p.sw;
}

// The m16n8k32 A register of one row: bytes r[k.x], r[k.y], r[k.z], r[k.w]
// (4 consecutive k, the lowest in the low byte).
__device__ __forceinline__ uint32_t gather4(const int8_t* r, int4 k) {
  const uint32_t lo = __byte_perm((uint8_t)r[k.x], (uint8_t)r[k.y], 0x0040);
  const uint32_t hi = __byte_perm((uint8_t)r[k.z], (uint8_t)r[k.w], 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// A block of rv whole rows of k bytes that is one contiguous run of x (a
// stage of all c_I channels: conv1's 64 rows of 147 taps, 9,408 bytes):
// 16-byte loads of the run, two in flight a thread, each chunk's bytes
// scattered into the rows of pitch ldd. Returns false (nothing done) when
// the run does not start on 16 bytes.
__device__ __forceinline__ bool copy_run_s8(int8_t* dst, int ldd,
                                            const int8_t* __restrict__ src,
                                            int k, int rv, int tid, int nthr) {
  if (reinterpret_cast<uintptr_t>(src) & 15) return false;
  const int total = rv * k, nchunk = (total + 15) / 16;
  for (int j0 = tid; j0 < nchunk; j0 += 2 * nthr) {
    uint4 v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u * nthr;
      v[u] = make_uint4(0, 0, 0, 0);
      if (j * 16 + 16 <= total) {
        v[u] = *reinterpret_cast<const uint4*>(src + j * 16);
      } else if (j < nchunk) {  // the run's ragged end: byte by byte
        uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (j * 16 + i < total)
            wd[i >> 2] |= uint32_t((uint8_t)src[j * 16 + i]) << (8 * (i & 3));
        v[u] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u * nthr;
      if (j >= nchunk) break;
      int r = j * 16 / k, c = j * 16 - r * k;
      const uint32_t wd[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (r < rv) dst[r * ldd + c] = (int8_t)(wd[i >> 2] >> (8 * (i & 3)));
        if (++c == k) { c = 0; ++r; }
      }
    }
  }
  return true;
}

// MI x NI m16n8 tiles a warp, the warps a (blockDim / 32 / wn) x wn grid
// over the covered tile (LINEAR: MI = 1, NI = 16 tiles in row-major order
// of the covered tile's (rows / 16) x cn grid).
template <typename Tout, int MI, int NI, bool LINEAR>
__global__ void __launch_bounds__(512, 1)
conv2d_q_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int* __restrict__ koff_g,
                   const float* __restrict__ scale, Tout* __restrict__ out,
                   const ConvQParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the scale slice, the gather table, the window's row table, then slot
  // i: the window (NCHW at window_layout's pitches), then the filter
  // [cols][ldB]; the epilogue's staged tile follows the scale slice
  float* const sc = reinterpret_cast<float*>(smem);
  int* const koff = reinterpret_cast<int*>(smem + p.off_koff);
  int2* const rowt = reinterpret_cast<int2*>(smem + p.off_rows);
  unsigned char* const ring = smem + p.off_ring;

  const Tile tile = tile_of(p, blockIdx.x);
  const long long n0 = tile.n0;
  const int co0 = tile.co0;
  const int row0 = tile.hb * p.bh * p.sh, col0 = tile.wb * p.bw * p.sw;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / p.wn, wn = warp % p.wn;
  const int cols = p.cn * 8;
  [[maybe_unused]] const int tiles = (p.rows >> 4) * p.cn;  // LINEAR's
  const int M = p.bN * p.bh * p.bw;
  const int taps = p.h_F * p.w_F, ks = p.b_cI * taps, kc = p.n32 * 32;
  const int HW = p.H * p.W;
  // stage s's window origin in x lies s * b_cI channels past stage 0's,
  // and in a slot GQ + (its input offset mod GQ) bytes in: congruent, so
  // aligned runs of the input land aligned
  const long long x0 = (n0 * p.c_I) * (long long)HW + (long long)row0 * p.W + col0;
  const int x0m = (int)(x0 & (GQ - 1));
  auto step_mod = [&](int s) { return (x0m + s * p.b_cI * HW) & (GQ - 1); };
  const int rvb = min(p.b_cO, p.c_O - co0);  // filter rows (channels) in c_O

  // Once: the scale slice (0 past c_O), the gather table, the row table;
  // each slot's zero planes (the padded k read them, from either origin) and
  // its filter entries no copy writes (k in [ks, kc), rows past c_O), which
  // ldmatrix reads.
  for (int i = tid; i < p.b_cO; i += nthr) sc[i] = i < rvb ? scale[co0 + i] : 0.f;
  for (int i = tid; i < kc; i += nthr) koff[i] = koff_g[i];
  const int nv = (int)min((long long)p.bN, p.N - n0);
  window_rows(rowt, p, nv, p.run ? 1 : p.H - row0, tid, nthr);
  for (int sl = 0; sl < p.slots; ++sl) {
    int8_t* xs = reinterpret_cast<int8_t*>(ring + sl * p.slot_bytes);
    int8_t* bs = xs + p.x_bytes;
    if (p.zc)
      for (int n = 0; n < p.bN; ++n)
        for (int i = tid; i < p.d_ch + GQ; i += nthr) xs[n * p.d_img + p.zero + GQ + i] = 0;
    const int pad = kc - ks;
    for (int i = tid; i < rvb * pad; i += nthr) bs[(i / pad) * p.ldB + ks + i % pad] = 0;
    for (int i = tid; i < (cols - rvb) * kc; i += nthr)
      bs[(rvb + i / kc) * p.ldB + i % kc] = 0;
  }

  // Window offsets of the rows this thread owns in each m16 tile: rows g
  // and g + 8 (LINEAR: computed per tile in the loop)
  int moff[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      moff[i][h] = LINEAR ? 0 : row_off(p, (wm * MI + i) * 16 + (lane >> 2) + 8 * h, M);

  // issue the copies of c_I stage s into slot s % 2: the window, zero past
  // N, c_I, H and W, and the filter block's rows in c_O, zero past c_I (the
  // tile re-derived from blockIdx.x rather than held in registers across
  // the loop)
  auto load = [&](int s) {
    const Tile t = tile_of(p, ctaid());
    const int ci0 = s * p.b_cI, c0 = t.wb * p.bw * p.sw;
    const long long xo = (t.n0 * p.c_I + ci0) * (long long)HW +
                         (long long)t.hb * p.bh * p.sh * p.W + c0;
    const int g0m = (int)(xo & (GQ - 1));
    int8_t* xd = reinterpret_cast<int8_t*>(ring + (s % 2) * p.slot_bytes) + GQ + g0m;
    int8_t* bd = reinterpret_cast<int8_t*>(ring + (s % 2) * p.slot_bytes + p.x_bytes);
    const int cv = p.run ? 1 : min(p.c_I - ci0, p.b_cI);
    const int vend = p.run ? (p.c_I - ci0) * HW : min(p.w_in, p.W - c0);
    copy_window(xd, x + xo, x, g0m, rowt, p, cv, vend, tid, nthr);
    // the filter block: rv rows of ks taps (pitch c_I * taps in w), zero
    // past c_I; 16-byte copies where rows allow (vwb 16), else the block as
    // one aligned run (conv1), else loads of vwb bytes through registers
    const int rv = min(p.b_cO, p.c_O - t.co0);
    const int8_t* wsrc = w + ((long long)t.co0 * p.c_I + ci0) * taps;
    const long long lw = (long long)p.c_I * taps;
    const int kv = min(ks, (p.c_I - ci0) * taps);
    if (p.vwb == 16 || !p.b_run || !copy_run_s8(bd, p.ldB, wsrc, ks, rv, tid, nthr))
      copy_any<4>(p.vwb, bd, p.ldB, wsrc, lw, rv, rv, ks, kv,
                  copy_plan(ks / p.vwb, tid, nthr), tid, nthr);
  };

  __syncthreads();  // the tables are written
  load(0);
  cp_async_commit();
  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int s = 0; s < p.nCI; ++s) {
    cp_async_wait<0>();  // stage s has landed, for this thread's copies ...
    __syncthreads();     // ... and every thread's; stage s - 1's slot is free
    if (s + 1 < p.nCI) load(s + 1);
    cp_async_commit();

    const unsigned char* sb = ring + (s % 2) * p.slot_bytes;
    const int8_t* xs = reinterpret_cast<const int8_t*>(sb) + GQ + step_mod(s);
    const int8_t* bs = reinterpret_cast<const int8_t*>(sb + p.x_bytes);
    // slices holding real k (a ragged last stage's channels past c_I are 0)
    const int n32 = min(p.n32, ((p.c_I - s * p.b_cI) * taps + 31) >> 5);
    for (int kk = 0; kk < n32; ++kk) {
      // this lane's k: 4 (lane % 4) .. + 3 and 16 more (the A registers'
      // columns), their window offsets from the gather table
      const int k0 = kk * 32 + 4 * (lane & 3);
      const int4 ka = *reinterpret_cast<const int4*>(koff + k0);
      const int4 kb = *reinterpret_cast<const int4*>(koff + k0 + 16);
      const int8_t* const bk = bs + kk * 32 + ((lane >> 3) & 1) * 16;
      if constexpr (LINEAR) {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int q = warp * NI + j;
          if (q >= tiles) break;
          const int mt = q / p.cn, nt = q - mt * p.cn;
          const int8_t* r0 = xs + row_off(p, mt * 16 + (lane >> 2), M);
          const int8_t* r1 = xs + row_off(p, mt * 16 + (lane >> 2) + 8, M);
          const uint32_t a[4] = {gather4(r0, ka), gather4(r1, ka),
                                 gather4(r0, kb), gather4(r1, kb)};
          uint32_t b[2];
          ldsm_x2(b, bk + (nt * 8 + (lane & 7)) * p.ldB);
          mma_s8(acc[0][j], a, b);
        }
      } else {
        uint32_t a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int8_t* r0 = xs + moff[i][0];
          const int8_t* r1 = xs + moff[i][1];
          a[i][0] = gather4(r0, ka);
          a[i][1] = gather4(r1, ka);
          a[i][2] = gather4(r0, kb);
          a[i][3] = gather4(r1, kb);
        }
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, bk + ((wn * NI + j) * 8 + (lane & 7) + ((lane >> 4) << 3)) * p.ldB);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_s8(acc[i][j], a[i], b0);
            mma_s8(acc[i][j + 1], a[i], b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the last group is empty)

  // the tile through shared memory as [channel][pixel] f32, float(acc)
  // times the channel's scale (ldS = 4 mod 16 words: the fragments' 32
  // lanes write 32 banks); fragment (i, j) holds rows g, g + 8 (pixels)
  // and columns 2t, 2t + 1 (channels) of its m16n8 tile (g = lane / 4, t =
  // lane % 4)
  __syncthreads();  // every warp is done with the ring
  float* const st = reinterpret_cast<float*>(smem + p.off_koff);
  auto stage = [&](int mt, int nt, const int (&c)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + (lane >> 2) + 8 * h, ch = nt * 8 + 2 * (lane & 3);
      if (ch < p.b_cO) st[ch * p.ldS + r] = (float)c[2 * h] * sc[ch];
      if (ch + 1 < p.b_cO) st[(ch + 1) * p.ldS + r] = (float)c[2 * h + 1] * sc[ch + 1];
    }
  };
  if constexpr (LINEAR) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int q = warp * NI + j;
      if (q >= tiles) break;
      stage(q / p.cn, q % p.cn, acc[0][j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) stage(wm * MI + i, wn * NI + j, acc[i][j]);
  }
  __syncthreads();
  // vst consecutive pixels of one channel a store (vst 4: b_wO and the
  // output pitches are multiples of 4), consecutive threads on consecutive
  // pixels
  const Tile te = tile_of(p, ctaid());
  const long long plane = (long long)p.hOp * p.wOp;
  const int mv = M / p.vst;
  for (int v = tid; v < p.b_cO * mv; v += nthr) {
    const int c = p.f_mv(v), r = p.vst * (v - c * mv);
    const int n = p.f_bhw(r), rem = r - n * p.bh * p.bw;
    const int ho = p.f_bw(rem), wo = rem - ho * p.bw;
    Tout* o = out + ((te.n0 + n) * p.cOp + te.co0 + c) * plane +
              (long long)(te.hb * p.bh + ho) * p.wOp + te.wb * p.bw + wo;
    if (p.vst == 4)
      Quad<Tout>::store(o, *reinterpret_cast<const float4*>(st + c * p.ldS + r));
    else
      *o = from_f<Tout>(st[c * p.ldS + r]);
  }
}

template <typename Tout, int MI, int NI, bool LINEAR>
cudaError_t conv_launch_t(const void* x, const void* w, const void* koff,
                          const void* scale, void* out, const ConvQParams& p,
                          long long blocks, int threads, int smem,
                          cudaStream_t s) {
  static unsigned done = 0;
  auto kern = conv2d_q_tc_kernel<Tout, MI, NI, LINEAR>;
  // the attribute is the most any launch asks: set once, not per launch
  cudaError_t e = configure_once(kern, 232448, done);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(koff), static_cast<const float*>(scale),
      static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t conv_launch_v(int variant, const void* x, const void* w,
                          const void* koff, const void* scale, void* out,
                          const ConvQParams& p, long long blocks, int threads,
                          int smem, cudaStream_t s) {
  switch (variant) {  // (MI, NI), as TC_VARIANTS in repro_torch.kernels.quant
    case 0: return conv_launch_t<Tout, 2, 8, false>(x, w, koff, scale, out, p, blocks, threads, smem, s);
    case 1: return conv_launch_t<Tout, 1, 16, true>(x, w, koff, scale, out, p, blocks, threads, smem, s);
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

// out_dtype codes: 0 = float32, 1 = bfloat16. g holds the launch geometry
// in ConvQParams order; variant indexes TC_VARIANTS (the last: LINEAR);
// koff is the gather table on the device; x must start on 16 bytes.
// Returns the launch's cudaError_t.
extern "C" int repro_conv2d_q(const void* x, const void* w, const void* koff,
                              const void* scale, void* out, int out_dtype,
                              int variant, const long long* g, int n_g,
                              int threads, int smem, void* stream) {
  if (n_g != N_CONV_GEOMETRY) return (int)cudaErrorInvalidValue;
  const ConvQParams p = unpack_conv(g);
  const long long blocks = (long long)p.nN * p.nCO * p.nH * p.nW;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (p.slots < 1 || p.slots > 2 || p.n32 < 1 || !koff || p.vwb < 1 || (16 % p.vwb) ||
      (p.vst != 1 && p.vst != 4) || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return (int)conv_launch_v<float>(variant, x, w, koff, scale, out, p, blocks, threads, smem, s);
  if (out_dtype == 1)
    return (int)conv_launch_v<__nv_bfloat16>(variant, x, w, koff, scale, out, p, blocks, threads, smem, s);
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
