// Direct VALID convolution, NCHW input x OIHW filter, any stride, tiled by
// the blocking LP's (bN, b_cI, b_cO, b_hO, b_wO) plan.
//
// Replaces: src/repro/kernels/conv2d.py, _conv_kernel (the Pallas TPU kernel).
//
// Two kernels, chosen by the input dtype before the launch (never after a
// failure). Both: one CTA per output tile (n, co, h, w), the tile index
// flattened into blockIdx.x (c_O tiles fastest, so CTAs that share an input
// window run together and meet it in L2); a loop over c_I inside the CTA
// takes the place of the TPU grid's sequential innermost c_I axis; the f32
// accumulator stays in registers across that loop (at most 64 a thread, 256
// threads: 16,384 a tile, the H100 preset's M_acc_eff); each step stages in
// shared memory what the reference DMAs, the halo input window (bN, c, h_in,
// w_in) with h_in = (b_hO - 1) * sh + h_F and the (b_cO, c, h_F, w_F) filter
// block, zero-filled beyond the array edges (the reference pads in HBM; here
// the loads are masked, so the words issued are the windows that
// conv2d_hbm_words counts); the padded output tile is stored once, into the
// (Np, cOp, hOp, wOp) tensor the wrapper allocated. Global offsets are
// 64-bit, tile-local ones 32-bit.
//
// conv2d_tc_kernel, bf16 in (the conv path): tensor cores.
//  What bounds it on an H100: counted in plan words (the tiles re-read
//  windows and filters; the L2 gets no credit), each ResNet-50 layer at
//  batch 1000 is bound by bytes, 0.51-1.34 ms, against 0.234 ms of products
//  at 989 TFLOP/s. mma.sync reaches 100-190 TFLOP/s, so at that rate the
//  product issue binds conv2_x-conv5_x instead (1.2-2.3 ms a layer), and
//  with it the shared-memory gather that feeds the products and the
//  instructions that issue the copies. What the design does:
//  * An implicit GEMM per c_I step: rows m are the tile's output pixels
//    (n, ho, wo), columns its output channels, k = (c * h_F + hf) * w_F + wf
//    in OIHW order over the step's channels. The window stays in shared
//    memory in its NCHW order and A[m, k] = window[moff[m] + koff[k]]:
//    moff[m] = n * d_img + ho * sh * d_row + wo * sw is computed once a
//    thread for the rows it owns and kept in registers (two 16-bit offsets
//    a register); koff, the same for every CTA and step, is built by the
//    wrapper (kernels/conv2d.py, gather_table) and read from shared memory
//    once a 16-deep k slice for all of a warp's m16 tiles. A fragments are
//    gathered with 2-byte loads and packed in pairs; the filter block stays
//    [co][k] as it lies in HBM, its rows padded to an odd multiple of 16
//    bytes, and B fragments come by ldmatrix (no transpose). Products are
//    mma.sync.m16n8k16 bf16 x bf16 -> f32. K is padded to 16 with k that
//    point at a zeroed channel plane of each image (conv1's 3 x 7 x 7 = 147
//    taps fold into 10 k16 slices).
//  * Warps own (MI, NI) blocks of m16n8 tiles (the wrapper picks the
//    compiled block and the warp grid from the plan; wide blocks gather
//    fewer A fragments a product). A narrow tile no rectangular block
//    covers within 8 warps (few output channels, many pixels: 784 x 16,
//    1800 x 8) takes the LINEAR variant, as the GEMMs do: warp w owns m16n8
//    tiles 16w .. 16w + 15 of the covered tile in row-major order, and
//    gathers a tile's A where its m16 row changes, computing the row
//    offsets there (16 tiles' offsets held across the loop spilled). 128
//    registers a thread, so two CTAs share an SM: one computes while the
//    other waits on its copies.
//  * A two-slot ring over c_I: step ci + 1's copies are issued before step
//    ci's products, one commit group a step, cp.async.wait_group before a
//    step is read and a __syncthreads before its slot is refilled. A stage
//    may hold part of the plan's c_I block (conv5_x: 16 of 32 channels), so
//    two slots fit two CTAs an SM; the words issued do not depend on it.
//  * Every window row (a whole-plane window: every image's run of planes)
//    is copied as the 16-byte-aligned runs of x that cover it, with
//    cp.async: the slot's row, plane and image pitches are congruent to
//    x's modulo 8 elements, with a run of slack each (window_layout), so an
//    aligned run of x lands on an aligned run of the slot, whatever the
//    input's row pitch (conv1's 229 bf16 rows are 2-byte aligned). The
//    slack is never gathered. Past N, c_I, H and W the runs zero-fill
//    (src-size 0, or a partial src-size at a row's end). A table of the
//    window's rows, built once a CTA in shared memory, gives each run its
//    offsets with one multiply-high division. Filter rows take 16-byte
//    copies where their pitch allows, conv1's whole block one aligned run.
//    (The wrapper realigns an input whose base is not 16-byte aligned, a
//    slice, with one copy before the launch.)
//  * The epilogue stages the tile through shared memory where its output
//    rows are whole groups of 4 pixels (conv1, conv2_x) and stores 4
//    pixels of one channel at once (16 bytes in f32): conv1's f32 output is
//    3.2 of its 4.5 GB of plan words. Else each C fragment goes straight
//    to the output, 8 consecutive pixels of one channel a warp store.
//
// conv2d_kernel, f32 in: the first version, on the FMA pipe (67 TFLOP/s).
//  bf16 x bf16 products are exact in f32, but TF32 products would not meet
//  the f32 checks' 1e-4; so f32 inputs keep plain FMAs: each thread owns a
//  CO_T x P_T micro-tile (output channels x output pixels); one stage a c_I
//  block, plain loads, every CTA waits for them; then the h_F * w_F strided
//  taps, CO_T * P_T FMAs a (ci, hf, wf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

struct ConvParams {
  long long N;
  int c_I, H, W, c_O, h_F, w_F, sh, sw;
  int bN, b_cI, b_cO, bh, bw, h_in, w_in;  // b_cI: channels a stage
  int cOp, hOp, wOp;                       // padded output extents
  int nN, nCO, nH, nW, nCI;                // tile counts; nCI: c_I stages
  int nPG, ldW;                            // FMA: pixel groups, filter stride
  long long x_bytes;                       // a stage's window; the filter follows
  // tensor cores: k16 slices a stage, filter row stride, ring slots, warps
  // along n, planes an image in shared memory (b_cI, + 1 zero plane when K
  // is padded), bytes of the gather table and of a slot, whole-plane runs,
  // elements a filter copy moves at once, filter block as one run, the
  // epilogue's 4-pixel stores staged through shared memory (vst, its pixel
  // pitch ldS; vst 0: fragment stores), bytes of the
  // window's row table, the window's row, plane and image pitches and the
  // gather offset of its zero plane (kernels/conv2d.py, window_layout)
  int n16, ldB, slots, wn, planes, koff_bytes, slot_bytes, run, vwb, b_run,
      vst, ldS, rows_bytes, d_row, d_ch, d_img, zero;
  int cn;  // n8 columns of the covered tile (LINEAR's tiles run row-major)
  FastDiv f_gpr, f_rows, f_ch, f_bw, f_bhw, f_m4, f_kc, f_ks;  // set by the host
};

// The C entry's geometry array, in ConvParams order (kernels/conv2d.py,
// GEOMETRY).
constexpr int N_GEOMETRY = 45;

// Elements a window copy moves: 16 bytes of bf16, aligned in x (the
// wrapper's WINDOW_RUN).
constexpr int G = 8;

ConvParams unpack(const long long* g) {
  ConvParams p{};
  int i = 0;
  p.N = g[i++];
  int* head[] = {&p.c_I, &p.H,   &p.W,   &p.c_O, &p.h_F, &p.w_F, &p.sh,
                 &p.sw,  &p.bN,  &p.b_cI, &p.b_cO, &p.bh, &p.bw, &p.h_in,
                 &p.w_in, &p.cOp, &p.hOp, &p.wOp, &p.nN, &p.nCO, &p.nH,
                 &p.nW,  &p.nCI, &p.nPG, &p.ldW};
  for (int* f : head) *f = (int)g[i++];
  p.x_bytes = g[i++];
  int* tail[] = {&p.n16, &p.ldB, &p.slots, &p.wn, &p.planes, &p.koff_bytes,
                 &p.slot_bytes, &p.run, &p.vwb, &p.b_run,
                 &p.vst, &p.ldS, &p.rows_bytes, &p.d_row, &p.d_ch, &p.d_img,
                 &p.zero, &p.cn};
  for (int* f : tail) *f = (int)g[i++];
  // the window copy's view: images x channels x rows x runs a row's cover
  // (a whole-plane window: images x 1 x 1 x runs)
  p.f_gpr = fast_div(((p.run ? p.b_cI * p.H * p.W : p.w_in) + 2 * G - 2) / G);
  p.f_rows = fast_div(p.run ? 1 : p.h_in);
  p.f_ch = fast_div(p.run ? 1 : p.b_cI);
  p.f_bw = fast_div(p.bw);
  const int ks = p.b_cI * p.h_F * p.w_F;  // filter row: 16-byte chunks, taps
  p.f_kc = fast_div(ks >= 8 ? ks / 8 : 1);
  p.f_ks = fast_div(ks);
  p.f_bhw = fast_div(p.bh * p.bw);
  p.f_m4 = fast_div(p.bN * p.bh * p.bw >= 4 ? p.bN * p.bh * p.bw / 4 : 1);
  return p;
}

// ---------------------------------------------------------------------------
// f32 in: the FMA kernel.
// ---------------------------------------------------------------------------

template <typename Tout, int CO_T, int P_T>
__global__ void __launch_bounds__(256)
conv2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              Tout* __restrict__ out, const ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + p.x_bytes);

  long long t = blockIdx.x;
  const int co_t = (int)(t % p.nCO); t /= p.nCO;
  const int wb = (int)(t % p.nW); t /= p.nW;
  const int hb = (int)(t % p.nH); t /= p.nH;
  const long long n0 = t * p.bN;
  const int co0 = co_t * p.b_cO;
  const int row0 = hb * p.bh * p.sh, col0 = wb * p.bw * p.sw;

  const int P = p.bN * p.bh * p.bw;           // output pixels per tile
  const int win = p.h_in * p.w_in;
  const int xwin = p.b_cI * win;              // one image's window
  const int x_elems = p.bN * xwin;
  const int taps = p.h_F * p.w_F;
  const int w_elems = p.b_cO * p.b_cI * taps;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid / p.nPG, pg = tid % p.nPG;

  // Window offset of each owned pixel (pixel pg + k * nPG of the tile).
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
  float acc[CO_T][P_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j)
#pragma unroll
    for (int k = 0; k < P_T; ++k) acc[j][k] = 0.f;

  // Filter columns [b_cO, ldW) are never loaded: zero them once.
  for (int i = tid; i < p.b_cI * taps * p.ldW; i += nthr)
    if (i % p.ldW >= p.b_cO) ws[i] = 0.f;

  for (int cb = 0; cb < p.nCI; ++cb) {
    const int ci0 = cb * p.b_cI;
    __syncthreads();  // every thread is done reading the previous step
    for (int i = tid; i < x_elems; i += nthr) {
      const int col = i % p.w_in;
      int r = i / p.w_in;
      const int row = r % p.h_in; r /= p.h_in;
      const int c = r % p.b_cI, n = r / p.b_cI;
      const long long gn = n0 + n;
      const int gc = ci0 + c, gr = row0 + row, gcol = col0 + col;
      float v = 0.f;
      if (gn < p.N && gc < p.c_I && gr < p.H && gcol < p.W)
        v = x[((gn * p.c_I + gc) * p.H + gr) * (long long)p.W + gcol];
      xs[i] = v;
    }
    for (int i = tid; i < w_elems; i += nthr) {  // global order: co, ci, tap
      const int tap = i % taps;
      const int r = i / taps;
      const int c = r % p.b_cI, co = r / p.b_cI;
      const int gco = co0 + co, gc = ci0 + c;
      float v = 0.f;
      if (gco < p.c_O && gc < p.c_I)
        v = w[((long long)gco * p.c_I + gc) * taps + tap];
      ws[(c * taps + tap) * p.ldW + co] = v;
    }
    __syncthreads();

    for (int c = 0; c < p.b_cI; ++c) {
      for (int hf = 0; hf < p.h_F; ++hf) {
        for (int wf = 0; wf < p.w_F; ++wf) {
          const float* xr = xs + c * win + hf * p.w_in + wf;
          const float* wr = ws + (c * taps + hf * p.w_F + wf) * p.ldW + cg * CO_T;
          float wv[CO_T];
#pragma unroll
          for (int j = 0; j < CO_T; ++j) wv[j] = wr[j];
#pragma unroll
          for (int k = 0; k < P_T; ++k) {
            const float xv = xr[xoff[k]];
#pragma unroll
            for (int j = 0; j < CO_T; ++j) acc[j][k] = fmaf(wv[j], xv, acc[j][k]);
          }
        }
      }
    }
  }

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
        out[((n0 + n) * p.cOp + co0 + co) * plane + pix] = from_f<Tout>(acc[j][k]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 in: the tensor-core kernel.
// ---------------------------------------------------------------------------

// MI x NI m16n8 tiles a warp; the warps form a (blockDim / 32 / wn) x wn
// grid over the covered tile (LINEAR: MI = 1, NI = 16 tiles in row-major
// order of the covered tile's (rows / 16) x cn grid, for a narrow tile no
// rectangular block covers within 8 warps).
template <typename Tout, int MI, int NI, bool LINEAR>
__global__ void __launch_bounds__(256, 2)
conv2d_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const int* __restrict__ koff_g, Tout* __restrict__ out,
                 const ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the gather table, the window's row table, then slot i: the window (NCHW
  // at window_layout's pitches), then the filter [cols][ldB]
  int* const koff = reinterpret_cast<int*>(smem);
  int2* const rowt = reinterpret_cast<int2*>(smem + p.koff_bytes);
  unsigned char* const ring = smem + p.koff_bytes + p.rows_bytes;

  const Tile tile = tile_of(p, blockIdx.x);
  const long long n0 = tile.n0;
  const int co0 = tile.co0;
  const int row0 = tile.hb * p.bh * p.sh, col0 = tile.wb * p.bw * p.sw;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / p.wn, wn = warp % p.wn;
  const int cols = LINEAR ? p.cn * 8 : p.wn * NI * 8;
  const int M = p.bN * p.bh * p.bw;
  [[maybe_unused]] const int tiles = ((M + 15) >> 4) * p.cn;  // LINEAR's
  const int taps = p.h_F * p.w_F, ks = p.b_cI * taps;
  const int HW = p.H * p.W;
  // step 0's window and filter origins in x and w; step s's lie s * b_cI
  // channels on, and its window origin in a slot G + (its input origin mod
  // G) elements in: congruent, so aligned runs of the input land aligned
  const long long x0 = (n0 * p.c_I) * (long long)HW + (long long)row0 * p.W + col0;
  const bf16* const xs0 = x + x0;
  const bf16* const ws0 = w + (long long)co0 * p.c_I * taps;
  const int x0m = (int)(x0 & 7);
  auto step_mod = [&](int s) { return (x0m + s * p.b_cI * HW) & (G - 1); };

  // Once: the gather table, the row table; each slot's zero planes (the
  // padded k read them, from either origin) and its filter entries no copy
  // writes (k in [ks, 16 * n16) and the covered columns past b_cO), which
  // ldmatrix reads.
  for (int i = tid; i < p.n16 * 16; i += nthr) koff[i] = koff_g[i];
  const int nv = (int)min((long long)p.bN, p.N - n0);
  window_rows(rowt, p, nv, p.run ? 1 : p.H - row0, tid, nthr);
  for (int sl = 0; sl < p.slots; ++sl) {
    bf16* xs = reinterpret_cast<bf16*>(ring + sl * p.slot_bytes);
    bf16* bs = reinterpret_cast<bf16*>(ring + sl * p.slot_bytes + p.x_bytes);
    if (p.planes > p.b_cI)
      for (int n = 0; n < p.bN; ++n)
        for (int i = tid; i < p.d_ch + G; i += nthr)
          xs[n * p.d_img + p.zero + G + i] = bf16();
    for (int r = tid; r < cols; r += nthr)
      for (int c = r < p.b_cO ? ks : 0; c < p.n16 * 16; ++c) bs[r * p.ldB + c] = bf16();
  }

  // Window offset (elements) of the rows this thread owns in each m16 tile,
  // rows g and g + 8 in the low and high halves (a window holds fewer than
  // 2^16 elements); rows past M read any valid offset and are never stored.
  // LINEAR computes a tile's offsets where it gathers (row_off): 16 tiles'
  // offsets held across the loop would spill.
  auto row_off = [&](int r) -> int {
    if (r >= M) return 0;
    const int n = p.f_bhw(r), rem = r - n * p.bh * p.bw;
    const int ho = p.f_bw(rem), wo = rem - ho * p.bw;
    return n * p.d_img + ho * p.sh * p.d_row + wo * p.sw;
  };
  uint32_t moff[LINEAR ? 1 : MI];
#pragma unroll
  for (int i = 0; i < (LINEAR ? 0 : MI); ++i) {
    moff[i] = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MI + i) * 16 + (lane >> 2) + 8 * h;
      if (r < M) {
        const int n = p.f_bhw(r), rem = r - n * p.bh * p.bw;
        const int ho = p.f_bw(rem), wo = rem - ho * p.bw;
        moff[i] |= uint32_t(n * p.d_img + ho * p.sh * p.d_row + wo * p.sw) << (16 * h);
      }
    }
  }
  // issue the copies of c_I step s into slot s % 2: the window, zero past
  // N, c_I, H and W, and the filter block, zero past c_O and c_I
  const int vend_row = min(p.w_in, p.W - col0), rvb = min(p.b_cO, p.c_O - co0);
  auto load = [&](int s) {
    const int ci0 = s * p.b_cI;
    const int g0m = step_mod(s);
    bf16* xd = reinterpret_cast<bf16*>(ring + (s % 2) * p.slot_bytes) + G + g0m;
    bf16* bd = reinterpret_cast<bf16*>(ring + (s % 2) * p.slot_bytes + p.x_bytes);
    const bf16* xsrc = xs0 + ci0 * HW;
    const int cv = p.run ? 1 : min(p.c_I - ci0, p.b_cI);
    const int vend = p.run ? (p.c_I - ci0) * HW : vend_row;
    copy_window(xd, xsrc, x, g0m, rowt, p, cv, vend, tid, nthr);
    // the filter block: b_cO rows of ks taps (pitch c_I * taps in w), zero
    // past c_O and c_I; 16-byte copies where rows allow (vwb 8), else the
    // block as one aligned run (conv1: 32 rows of 147 taps), else 2-byte
    // loads
    const bf16* wsrc = ws0 + ci0 * taps;
    const long long lw = (long long)p.c_I * taps;
    const int kv = min(ks, (p.c_I - ci0) * taps);
    if (p.vwb == 8) {
      const int cpr = ks / 8;
      for (int i = tid; i < p.b_cO * cpr; i += nthr) {
        const int r = p.f_kc(i), c = (i - r * cpr) * 8;
        const bool ok = r < rvb && c < kv;
        cp_async16(bd + r * p.ldB + c, ok ? wsrc + r * lw + c : w, ok ? 16 : 0);
      }
    } else if (!p.b_run ||
               !copy_rows_run<1>(bd, p.ldB, wsrc, ks, p.b_cO, rvb, p.n16 * 16, tid, nthr)) {
      for (int i = tid; i < p.b_cO * ks; i += nthr) {
        const int r = p.f_ks(i), c = i - r * ks;
        bd[r * p.ldB + c] = r < rvb && c < kv ? wsrc[r * lw + c] : bf16();
      }
    }
  };

  __syncthreads();  // the tables are written
  load(0);
  cp_async_commit();
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < p.nCI; ++s) {
    cp_async_wait<0>();  // step s has landed, for this thread's copies ...
    __syncthreads();     // ... and every thread's; step s - 1's slot is free
    if (s + 1 < p.nCI) load(s + 1);
    cp_async_commit();

    const unsigned char* sb = ring + (s % 2) * p.slot_bytes;
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(sb) + G + step_mod(s);
    const bf16* bs = reinterpret_cast<const bf16*>(sb + p.x_bytes);
    // slices holding real k (a ragged last step's channels past c_I are zero)
    const int n16 = min(p.n16, ((p.c_I - s * p.b_cI) * taps + 15) >> 4);
    for (int kk = 0; kk < n16; ++kk) {
      const int kc = kk * 16 + 2 * (lane & 3);
      const int2 k01 = *reinterpret_cast<const int2*>(koff + kc);
      const int2 k23 = *reinterpret_cast<const int2*>(koff + kc + 8);
      if constexpr (LINEAR) {
        // tile j of the warp: its m16 row's A (gathered again only where
        // the row changes) and its n8 column's B
        uint32_t a[4];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int q = warp * NI + j;
          if (q >= tiles) break;
          const int nt = q % p.cn;
          if (j == 0 || nt == 0) {
            const int r = (q / p.cn) * 16 + (lane >> 2);
            const unsigned short* r0 = xs + row_off(r);
            const unsigned short* r1 = xs + row_off(r + 8);
            a[0] = uint32_t(r0[k01.x]) | (uint32_t(r0[k01.y]) << 16);
            a[1] = uint32_t(r1[k01.x]) | (uint32_t(r1[k01.y]) << 16);
            a[2] = uint32_t(r0[k23.x]) | (uint32_t(r0[k23.y]) << 16);
            a[3] = uint32_t(r1[k23.x]) | (uint32_t(r1[k23.y]) << 16);
          }
          uint32_t b[2];
          ldsm_x2(b, bs + (nt * 8 + (lane & 7)) * p.ldB + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(acc[0][j], a, b);
        }
        continue;
      }
      uint32_t bfr[NI][2];
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, bs + ((wn * NI + j) * 8 + (lane & 7) + ((lane >> 4) << 3)) * p.ldB +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const unsigned short* r0 = xs + (moff[i] & 0xffff);
        const unsigned short* r1 = xs + (moff[i] >> 16);
        uint32_t a[4];
        a[0] = uint32_t(r0[k01.x]) | (uint32_t(r0[k01.y]) << 16);
        a[1] = uint32_t(r1[k01.x]) | (uint32_t(r1[k01.y]) << 16);
        a[2] = uint32_t(r0[k23.x]) | (uint32_t(r0[k23.y]) << 16);
        a[3] = uint32_t(r1[k23.x]) | (uint32_t(r1[k23.y]) << 16);
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a, bfr[j]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the last group is empty)

  const Tile te = tile_of(p, ctaid());
  const long long plane = (long long)p.hOp * p.wOp;
  if (p.vst) {
    // the tile through shared memory as [channel][pixel] f32 (ldS = 4 mod
    // 16: the fragments' 32 lanes write 32 banks), then 4 consecutive
    // pixels of one channel a store (b_wO and the output pitches are
    // multiples of 4)
    __syncthreads();  // every warp is done with the ring
    float* st = reinterpret_cast<float*>(smem);
    if constexpr (LINEAR) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int q = warp * NI + j;
        if (q >= tiles) break;
        const int mt = q / p.cn, c = (q - mt * p.cn) * 8 + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + (lane >> 2) + 8 * h;
          if (c < p.b_cO) st[c * p.ldS + r] = acc[0][j][2 * h];
          if (c + 1 < p.b_cO) st[(c + 1) * p.ldS + r] = acc[0][j][2 * h + 1];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < (LINEAR ? 0 : MI); ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MI + i) * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int c = (wn * NI + j) * 8 + 2 * (lane & 3);
          if (c < p.b_cO) st[c * p.ldS + r] = acc[i][j][2 * h];
          if (c + 1 < p.b_cO) st[(c + 1) * p.ldS + r] = acc[i][j][2 * h + 1];
        }
      }
    __syncthreads();
    const int m4 = M / 4;
    for (int v = tid; v < p.b_cO * m4; v += nthr) {
      const int c = p.f_m4(v), r = 4 * (v - c * m4);
      const int n = p.f_bhw(r), rem = r - n * p.bh * p.bw;
      const int ho = p.f_bw(rem), wo = rem - ho * p.bw;
      const float4 q = *reinterpret_cast<const float4*>(st + c * p.ldS + r);
      Tout* o = out + ((te.n0 + n) * p.cOp + te.co0 + c) * plane +
                (long long)(te.hb * p.bh + ho) * p.wOp + te.wb * p.bw + wo;
      Quad<Tout>::store(o, q);
    }
    return;
  }

  // fragment stores: fragment (i, j) holds rows g, g + 8 (pixels) and
  // columns 2t, 2t + 1 (channels) of its m16n8 tile (g = lane / 4, t =
  // lane % 4)
  if constexpr (LINEAR) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int q = warp * NI + j;
      if (q >= tiles) break;
      const int mt = q / p.cn, c = (q - mt * p.cn) * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + (lane >> 2) + 8 * h;
        if (r >= M) continue;
        const int n = p.f_bhw(r), rem = r - n * p.bh * p.bw;
        const int ho = p.f_bw(rem), wo = rem - ho * p.bw;
        Tout* o = out + ((te.n0 + n) * p.cOp + te.co0) * plane +
                  (long long)(te.hb * p.bh + ho) * p.wOp + te.wb * p.bw + wo;
        if (c < p.b_cO) o[c * plane] = from_f<Tout>(acc[0][j][2 * h]);
        if (c + 1 < p.b_cO) o[(c + 1) * plane] = from_f<Tout>(acc[0][j][2 * h + 1]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MI + i) * 16 + (lane >> 2) + 8 * h;
      if (r >= M) continue;
      const int n = p.f_bhw(r), rem = r - n * p.bh * p.bw;
      const int ho = p.f_bw(rem), wo = rem - ho * p.bw;
      Tout* o = out + ((te.n0 + n) * p.cOp + te.co0) * plane +
                (long long)(te.hb * p.bh + ho) * p.wOp + te.wb * p.bw + wo;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = (wn * NI + j) * 8 + 2 * (lane & 3);
        if (c < p.b_cO) o[c * plane] = from_f<Tout>(acc[i][j][2 * h]);
        if (c + 1 < p.b_cO) o[(c + 1) * plane] = from_f<Tout>(acc[i][j][2 * h + 1]);
      }
    }
}

template <typename Tin, typename Tout>
cudaError_t launch_k(void (*kern)(const Tin*, const Tin*, Tout*, const ConvParams),
                     const void* x, const void* w, const void*, void* out,
                     const ConvParams& p, long long blocks, int threads, int smem,
                     cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t launch_k(void (*kern)(const bf16*, const bf16*, const int*, Tout*,
                                  const ConvParams),
                     const void* x, const void* w, const void* koff, void* out,
                     const ConvParams& p, long long blocks, int threads, int smem,
                     cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)  // the most shared memory: two rings share an SM
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(koff), static_cast<Tout*>(out), p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t launch_fma(int variant, const void* x, const void* w, void* out,
                       const ConvParams& p, long long blocks, int threads,
                       int smem, cudaStream_t s) {
  switch (variant) {  // micro-tile CO_T x P_T, as MICRO_TILES in kernels/conv2d.py
    case 0: return launch_k(conv2d_kernel<Tout, 8, 8>, x, w, nullptr, out, p, blocks, threads, smem, s);
    case 1: return launch_k(conv2d_kernel<Tout, 4, 16>, x, w, nullptr, out, p, blocks, threads, smem, s);
    case 2: return launch_k(conv2d_kernel<Tout, 16, 4>, x, w, nullptr, out, p, blocks, threads, smem, s);
    case 3: return launch_k(conv2d_kernel<Tout, 2, 32>, x, w, nullptr, out, p, blocks, threads, smem, s);
    case 4: return launch_k(conv2d_kernel<Tout, 1, 64>, x, w, nullptr, out, p, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tout>
cudaError_t launch_tc(int variant, const void* x, const void* w, const void* koff,
                      void* out, const ConvParams& p, long long blocks,
                      int threads, int smem, cudaStream_t s) {
  switch (variant) {  // (MI, NI) as TC_VARIANTS in kernels/conv2d.py, then LINEAR
    case 0: return launch_k(conv2d_tc_kernel<Tout, 4, 4, false>, x, w, koff, out, p, blocks, threads, smem, s);
    case 1: return launch_k(conv2d_tc_kernel<Tout, 2, 8, false>, x, w, koff, out, p, blocks, threads, smem, s);
    case 2: return launch_k(conv2d_tc_kernel<Tout, 1, 16, true>, x, w, koff, out, p, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. bf16 inputs run the tensor-core
// kernel (variant indexes TC_VARIANTS; koff is the gather table on the
// device; x must start on 16 bytes), f32 inputs the FMA kernel (variant
// indexes MICRO_TILES; koff unused). g holds the launch geometry in ConvParams order. Returns the
// launch's cudaError_t.
extern "C" int repro_conv2d(const void* x, const void* w, const void* koff,
                            void* out, int in_dtype, int out_dtype, int variant,
                            const long long* g, int n_g, int threads, int smem,
                            void* stream) {
  if (n_g != N_GEOMETRY) return (int)cudaErrorInvalidValue;
  const ConvParams p = unpack(g);
  const long long blocks = (long long)p.nN * p.nCO * p.nH * p.nW;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && (p.slots < 1 || p.slots > 2 || !koff ||
                        reinterpret_cast<uintptr_t>(x) % 16))
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0)
    return (int)launch_fma<float>(variant, x, w, out, p, blocks, threads, smem, s);
  if (in_dtype == 0 && out_dtype == 1)
    return (int)launch_fma<bf16>(variant, x, w, out, p, blocks, threads, smem, s);
  if (in_dtype == 1 && out_dtype == 0)
    return (int)launch_tc<float>(variant, x, w, koff, out, p, blocks, threads, smem, s);
  if (in_dtype == 1 && out_dtype == 1)
    return (int)launch_tc<bf16>(variant, x, w, koff, out, p, blocks, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}
