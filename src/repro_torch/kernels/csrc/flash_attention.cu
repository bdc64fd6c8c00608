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
// Two kernels, chosen by the input dtype before the launch (never after a
// failure):
//
// flash_tc_kernel, bf16 in and out: tensor cores.
//  What bounds it on an H100: at prefill shapes the products (S = Q K^T and
//  O += P V, every key tile of every q tile, no causal block skipping); at
//  decode shapes (Lq = 1, g query heads folded into 8 rows) the K/V stream
//  from HBM. At 8 folded rows a key tile is about 2 FLOP a byte: half of
//  an m16 mma.sync tile is live, and wgmma's 64-row tiles would buy
//  nothing. What such a launch lacks is parallelism over the keys: one CTA
//  a (batch row, kv head) is 16 CTAs for Qwen2.5-3B's 8 rows, each with
//  one K/V tile in flight. So the design puts both products on the tensor
//  cores, overlaps each tile's loads with the previous tile's products,
//  and at decode shapes splits a row's keys over a thread-block cluster:
//  * The key split (the SPLIT instances, p.split = S > 1;
//    kernels/flash_attention.py, launch_config, takes S from the key tiles
//    alone: the largest power of two up to 8, the portable cluster size,
//    that leaves every CTA at least 8 tiles, and only when the folded
//    queries fit one q tile of one row slab, R = 1). The
//    grid is (rows x S, 1) in clusters of (S, 1, 1); rank r of a row's
//    cluster walks the key tiles [r n_k / S, (r + 1) n_k / S) through its
//    own ring, with its own running max. Rank 0 copies the Q tile from
//    HBM; after the first cluster.sync the other ranks copy it from rank
//    0's shared memory (distributed shared memory), so Q is read once a
//    row as before. After the walk (and the C-warp merge below) ranks 1 ..
//    S - 1 leave their (m, l, O) over their ring; after the second
//    cluster.sync rank 0 reads them with map_shared_rank and merges in
//    rank order as m* = max m_j, O = sum e^(m_j - m*) O_j, l = sum e^(m_j
//    - m*) l_j (a rank with no tile holds m = NEG_INF, l = 0, O = 0 and
//    weighs nothing); a third cluster.sync keeps every rank resident until
//    rank 0 has read it. Rank 0 then stores as the unsplit kernel does. No
//    partial goes to HBM: the launch moves the words attention_hbm_words
//    charges. At S = 1 (every prefill, every launch whose keys span fewer
//    than 16 tiles, or of more than one row slab) the launch takes the
//    instance without SPLIT, which compiles none of this: its grid, commit
//    groups and bits are the unsplit kernel's, and so are the main path's
//    registers. (As a runtime branch in every instance, the cluster code
//    raised the registers of the S = 1 instances by up to 63 and made the
//    serve's decode and prefill 11-25% slower in device time on an H100.)
//  * mma.sync m16n8k16 bf16 x bf16 -> f32. Q's A fragments come once a q
//    tile by ldmatrix.x4 and stay in registers; K's B fragments by
//    ldmatrix (non-transposed) from the row-major (key, d) tile; V's by
//    ldmatrix.trans. P never goes through shared memory: the C layout of
//    two adjacent m16n8 S tiles is the m16k16 A layout of P V, so P is
//    rounded to bf16 in registers (l sums the f32 probabilities).
//  * W warps (4 for blocks 32 and 64, 8 for 128) as an R x C grid: R row
//    slabs of 16 folded query rows (the smallest power of two with 16 R >=
//    the runtime bq) by C key slabs of BLOCK / C columns of every key
//    tile. Prefill (bq 64): R 4, C 1, each warp 16 rows x 64 keys. Decode
//    (bq 8): R 1, C 4, every warp on the 8 live rows, 16 of every 64 keys.
//    C > 1 ends with one merge through shared memory: the C warps of a row
//    slab combine (m, l, O) as m* = max m_j, O = sum e^(m_j - m*) O_j /
//    sum e^(m_j - m*) l_j. A slab of 8 keys (block 32, C 4) fills the upper
//    half of P's k16 fragment with zeros.
//  * Q, K and V tiles go to shared memory by 16-byte cp.async, zero-filled
//    past the ragged edges (no padded copies in HBM), rows padded to HD + 8
//    elements (an odd multiple of 16 bytes: ldmatrix's eight row addresses
//    hit eight distinct bank groups). K and V run through a two-slot ring:
//    tile t + 1 is issued after iteration t's cp.async.wait_group(0) and
//    __syncthreads, before its products; one commit group a tile.
//  * Head dims 16, 32, 64, 80 and 128 (the switch at the C entry). At hd
//    80 (HuBERT-xLarge: 1280 / 16) a row is 10 16-byte chunks, which divide
//    neither 128 nor 256 threads, so the tile copies take copy_plan's
//    per-chunk division (zero-filled past the ragged edges like the row
//    division); Q K^T takes 5 k16 steps, P V 5 ldmatrix.x4.trans pairs of
//    n8 tiles, and the pitch of 88 elements (176 bytes) is still an odd
//    multiple of 16 bytes.
//  * Masks and the online softmax stay in registers: lane (g, t) of a warp
//    holds rows g and g + 8 of its slab; the row max reduces over the quad
//    (shfl_xor 1, 2), the row sum once at the end. Logits are scaled by
//    log2(e) / sqrt(hd) and exponentiated with exp2.
//  * The output is staged as bf16 in the Q tile's rows of the slab and
//    stored as 16-byte rows.
//
// flash_kernel, f32 in and out: the first version, on the FMA pipe (67
//  TFLOP/s): bf16 MMAs would change f32 numerics. 256 threads as a 16 x 16
//  grid: thread (ty, tx) computes S at rows ty + 16 i and keys tx + 16 j and
//  owns O at rows ty + 16 i and head dims tx + 16 j in registers; tiles in
//  shared memory as f32 with row pitch hd + 1; online softmax one warp a
//  row.
//
// Both:
//  * One CTA per (folded row b * Hkv + kv, q tile of bq folded query rows;
//    under the tensor-core kernel's key split, S CTAs a row, above).
//    Row j of the folded query axis is query j % q_seq_len of its group, so
//    its absolute position is (j % q_seq_len) + q_offset[row] (q_seq_len = 0:
//    plain positions).
//  * A loop over the K/V tiles of bk keys inside the CTA takes the place of
//    the TPU grid's sequential key axis. Every key tile is streamed (no
//    causal block skipping), once per q tile, as attention_hbm_words
//    charges. When the keys fit one tile (n_k == 1) the CTA walks every q
//    tile of its row with that tile resident: the reference's index map
//    fetches it once per row then, and so does this kernel.
//  * Masks: keys past Lk (the tile's ragged edge) get exactly zero weight;
//    keys at or past kv_lens[row], causally future keys and keys the key
//    mask rejects get the reference's finite NEG_INF = -1e30. A row whose
//    keys are all rejected therefore averages V over its Lk keys: neither
//    zeros nor NaN. The store divides by l (l == 0 -> 1).
//  * The launch attributes (dynamic shared memory, carveout) are set once
//    per instance and device, not on every launch.
//  * Row statistics (``m``/``l`` set, the output f32): the flash-decode
//    partial of a key shard (repro_torch.dtensors.sequence_parallel_attention
//    merges the shards of a sequence-sharded cache). The store then writes
//    the unnormalised f32 accumulator, and per folded row the row max in
//    the logits' natural units (the tensor-core kernel's log2 max over
//    LOG2E; NEG_INF stays NEG_INF, so a shard with no valid key weighs 0 in
//    the merge) and the row sum. A runtime branch at the store, no new
//    template instance; with m/l null the store and its bits are as
//    before. The tensor-core kernel's f32 store (with or without the
//    statistics) writes 8-byte pairs from the C fragments, no staging.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // the FMA kernel's
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct FAParams {
  int Lq, Lk;           // folded query rows, keys (per folded row)
  int bq, bk;           // runtime tiles (<= BLOCK)
  int n_q, n_k;         // tiles along each axis
  int q_seq_len;        // queries per GQA group (0 = plain positions)
  int rows_per_batch;   // folded rows per key-mask row (Hkv)
  int causal, kv_resident;
  int out_f32;          // the output is f32 (the tensor-core kernel: else bf16)
  int split;            // CTAs of a row's cluster (the tensor-core kernel; 1: none)
  float scale;
};

// ---------------------------------------------------------------------------
// The FMA kernel (f32 in).
// ---------------------------------------------------------------------------

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

template <int HD, int BLOCK>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, void* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ l_out,
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
  const float* qr = q + row * p.Lq * (long long)HD;
  const float* kr = k + row * p.Lk * (long long)HD;
  const float* vr = v + row * p.Lk * (long long)HD;
  float* orow = static_cast<float*>(out) + row * p.Lq * (long long)HD;

  for (int qt = blockIdx.y; qt < p.n_q; qt += gridDim.y) {
    const int q0 = qt * p.bq;
    for (int e = tid; e < BLOCK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD, qi = q0 + r;
      sq[r * QS + d] = (r < p.bq && qi < p.Lq) ? qr[(long long)qi * HD + d] : 0.f;
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
          sk[r * QS + d] = ok ? kr[(long long)kj * HD + d] : 0.f;
          sv[r * HD + d] = ok ? vr[(long long)kj * HD + d] : 0.f;
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
      float inv;
      if (m_out) {  // the shard's partial: unnormalised, with (m, l)
        inv = 1.f;
        if (tx == 0) {
          m_out[row * p.Lq + qi] = sm[r];  // natural units already
          l_out[row * p.Lq + qi] = l;
        }
      } else {
        l = (l == 0.f) ? 1.f : l;
        inv = 1.f / l;
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        orow[(long long)qi * HD + tx + 16 * j] = acc[i][j] * inv;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 in).
// ---------------------------------------------------------------------------

template <int BLOCK>
__host__ __device__ constexpr int tc_warps() { return BLOCK == 128 ? 8 : 4; }

// Dynamic shared memory: the Q tile, two ring slots of K and V (rows of
// HD + 8 bf16), and, for C > 1, the (m, l, O) that key slabs 1 .. C - 1 of
// each row slab hand to key slab 0 (kernels/flash_attention.py,
// launch_config, computes the same). A rank's partial for the key split's
// merge lies over ring slot 0 after the walk.
template <int HD, int BLOCK, int C>
constexpr int tc_smem_bytes() {
  constexpr int R = tc_warps<BLOCK>() / C;
  return 5 * BLOCK * (HD + 8) * 2 + (C - 1) * R * 32 * (4 + HD / 2) * 4;
}

template <int HD, int BLOCK, int C, bool SPLIT>
__global__ void __launch_bounds__(32 * tc_warps<BLOCK>(), 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, void* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ l_out,
                const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
                const uint8_t* __restrict__ key_mask, FAParams p) {
  constexpr int W = tc_warps<BLOCK>(), R = W / C;  // row slabs x key slabs
  constexpr int NTHR = 32 * W;
  constexpr int P = HD + 8;            // shared-memory row pitch (elements)
  constexpr int NW = BLOCK / C;        // keys of a warp's slab
  constexpr int NT = NW / 8;           // its n8 tiles of S
  constexpr int KC = (NW + 15) / 16;   // its k16 chunks of P V
  constexpr int DK = HD / 16;          // k16 steps of Q K^T
  constexpr int DT = HD / 8;           // n8 tiles of O
  constexpr int SLOT = 2 * BLOCK * P;  // one ring slot: K, then V
  constexpr int PART = 4 + 4 * DT;     // floats a lane hands over to merge
  static_assert(R >= 1 && R * C == W && NW >= 8, "warp grid");
  static_assert(R * PART * 32 * 4 <= SLOT * 2, "a rank's partial fits a ring slot");
  static_assert(HD % 16 == 0, "k16 steps of Q K^T, n8 pairs of P V");
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* const sq = reinterpret_cast<bf16*>(smem_tc);
  bf16* const ring = sq + BLOCK * P;
  float* const merge = reinterpret_cast<float*>(ring + 2 * SLOT);

  // the key split: rank r of the row's cluster of S walks tiles [t0, t0 + nt)
  const int S = SPLIT ? p.split : 1;
  const long long row = SPLIT ? (long long)blockIdx.x / S : (long long)blockIdx.x;
  const int rank = SPLIT ? (int)cg::this_cluster().block_rank() : 0;
  const int t0 = SPLIT ? (int)((long long)rank * p.n_k / S) : 0;
  const int nt = SPLIT ? (int)((long long)(rank + 1) * p.n_k / S) - t0 : p.n_k;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slab = warp / C, kslab = warp % C;
  const int g = lane >> 2, t = lane & 3;
  const int off = q_offset[row], len = kv_lens[row];
  const uint8_t* km =
      key_mask ? key_mask + (row / p.rows_per_batch) * (long long)p.Lk : nullptr;
  const bf16* qr = q + row * p.Lq * (long long)HD;
  const bf16* kr = k + row * p.Lk * (long long)HD;
  const bf16* vr = v + row * p.Lk * (long long)HD;
  bf16* orow = static_cast<bf16*>(out) + row * p.Lq * (long long)HD;
  float* orow_f = static_cast<float*>(out) + row * p.Lq * (long long)HD;
  const CopyPlan pl = copy_plan(HD / 8, tid, NTHR);
  const float sl2 = p.scale * LOG2E;
  const int c0 = kslab * NW;  // the warp's first key column of a tile

  // issue the copies of K/V tile kt into ring slot (kt - t0) % 2, zero past Lk
  auto load_kv = [&](int kt) {
    const int k0 = kt * p.bk, kv = min(p.bk, p.Lk - k0);
    bf16* dst = ring + ((kt - t0) & 1) * SLOT;
    copy_tile<8, 8>(dst, P, kr + (long long)k0 * HD, HD, BLOCK, kv, HD, HD, pl,
                    tid, NTHR);
    copy_tile<8, 8>(dst + BLOCK * P, P, vr + (long long)k0 * HD, HD, BLOCK, kv,
                    HD, HD, pl, tid, NTHR);
  };

  for (int qt = blockIdx.y; qt < p.n_q; qt += gridDim.y) {
    const int q0 = qt * p.bq;
    __syncthreads();  // the previous q tile's output staging is read
    if (rank == 0)    // a split's other ranks copy rank 0's Q tile
      copy_tile<8, 8>(sq, P, qr + (long long)q0 * HD, HD, 16 * R,
                      min(p.bq, p.Lq - q0), HD, HD, pl, tid, NTHR);
    if constexpr (SPLIT) cp_async_commit();  // Q in a group of its own
    if ((!SPLIT || nt > 0) && (!p.kv_resident || qt == (int)blockIdx.y)) load_kv(t0);
    cp_async_commit();
    if constexpr (SPLIT) {
      const cg::cluster_group cluster = cg::this_cluster();
      cp_async_wait<1>();  // rank 0: the Q tile has landed
      cluster.sync();  // every CTA of the row has started; Q is visible
      if (rank > 0 && nt > 0) {
        const bf16* rq = cluster.map_shared_rank(sq, 0);
        for (int i = tid; i < 16 * R * (HD / 8); i += NTHR) {
          const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
          *reinterpret_cast<uint4*>(sq + r * P + c) =
              *reinterpret_cast<const uint4*>(rq + r * P + c);
        }
      }
    }

    float o[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    int qpos[2];  // absolute positions of rows g and g + 8 of the slab
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + slab * 16 + g + 8 * h;
      qpos[h] = (p.q_seq_len > 0 ? qi % p.q_seq_len : qi) + off;
    }
    uint32_t qf[DK][4];

    for (int it = 0; it < nt; ++it) {  // the CTA's it-th tile, kt
      const int kt = t0 + it;
      cp_async_wait<0>();  // tile kt (and at it = 0 the Q tile) has landed ...
      __syncthreads();     // ... for every thread; slot (it + 1) % 2 is free
      if (!p.kv_resident && it + 1 < nt) load_kv(kt + 1);
      cp_async_commit();
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          ldsm_x4(qf[kk], sq + (slab * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
      }
      const int k0 = kt * p.bk;
      const int kv = min(p.bk, p.Lk - k0);  // key columns of this tile
      if (c0 >= kv) continue;               // no key in the slab: zero weight
      const bf16* sk = ring + (it & 1) * SLOT;
      const bf16* sv = sk + BLOCK * P;

      // S = Q K^T over the warp's key slab (n8 tiles past the keys skipped)
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if constexpr (NT == 1) {
          uint32_t b[2];
          ldsm_x2(b, sk + (c0 + (lane & 7)) * P + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[0], qf[kk], b);
        } else {
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            if (c0 + jp * 16 >= kv) break;
            uint32_t b[4];
            ldsm_x4(b, sk + (c0 + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                           kk * 16 + ((lane >> 3) & 1) * 8);
            const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
            mma_bf16(s[2 * jp], qf[kk], b0);
            mma_bf16(s[2 * jp + 1], qf[kk], b1);
          }
        }
      }

      // masks, then the online softmax (log2 domain)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + j * 8 + 2 * t + e, kpos = k0 + c;
          const bool in_range = c < kv;
          const bool key_ok = in_range && kpos < len && (km == nullptr || km[kpos]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = -INFINITY;  // past the keys: zero weight
            if (in_range)
              x = (key_ok && (!p.causal || kpos <= qpos[h])) ? s[j][2 * h + e] * sl2
                                                            : NEG_INF;
            s[j][2 * h + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = exp2f(s[j][e] - m[e >> 1]);
          s[j][e] = pr;
          l[e >> 1] += pr;
        }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

      // O += P V: P from the S registers as bf16 A fragments
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (c0 + kc * 16 >= kv) break;
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        if constexpr (NT > 1) {
          a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
          a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
        } else {  // an 8-key slab: the upper half of k is zero
          a[2] = a[3] = 0u;
        }
        const int kr_ = c0 + kc * 16 + (NT > 1 ? (lane & 15) : (lane & 7));
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t b0[2], b1[2];
          ldsm_x4_t(b0, b1, sv + kr_ * P + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], a, b0);
          mma_bf16(o[2 * dp + 1], a, b1);
        }
      }
    }

    // the row sums over the quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    if constexpr (C > 1) {
      // key slabs 1 .. C - 1 of each row slab hand (m, l, O) to key slab 0
      float* part = merge + (slab * (C - 1)) * PART * 32 + lane;
      if (kslab > 0) {
        float* dst = part + (kslab - 1) * PART * 32;
        dst[0] = m[0];
        dst[32] = m[1];
        dst[64] = l[0];
        dst[96] = l[1];
#pragma unroll
        for (int j = 0; j < DT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(4 + 4 * j + e) * 32] = o[j][e];
      }
      __syncthreads();
      if (kslab == 0) {
        float ms[2] = {m[0], m[1]};
#pragma unroll
        for (int c = 1; c < C; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ms[h] = fmaxf(ms[h], part[((c - 1) * PART + h) * 32]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float w0 = exp2f(m[h] - ms[h]);
          l[h] *= w0;
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            o[j][2 * h] *= w0;
            o[j][2 * h + 1] *= w0;
          }
        }
#pragma unroll
        for (int c = 1; c < C; ++c) {
          const float* src = part + (c - 1) * PART * 32;
          float w[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            w[h] = exp2f(src[h * 32] - ms[h]);
            l[h] += w[h] * src[(2 + h) * 32];
          }
#pragma unroll
          for (int j = 0; j < DT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] += w[e >> 1] * src[(4 + 4 * j + e) * 32];
        }
        m[0] = ms[0];  // the merged row max (read by the statistics' store)
        m[1] = ms[1];
      }
    }
    if constexpr (SPLIT) {
      // the key split's merge: ranks 1 .. S - 1 leave each row slab's (m,
      // l, O) over ring slot 0, lane by lane as the key slabs' merge does;
      // rank 0 reads them through distributed shared memory
      const cg::cluster_group cluster = cg::this_cluster();
      __syncthreads();  // every warp is done with the ring
      float* part = reinterpret_cast<float*>(ring) + slab * PART * 32 + lane;
      if (kslab == 0 && rank > 0) {
        part[0] = m[0];
        part[32] = m[1];
        part[64] = l[0];
        part[96] = l[1];
#pragma unroll
        for (int j = 0; j < DT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[(4 + 4 * j + e) * 32] = o[j][e];
      }
      cluster.sync();  // the partials are published
      if (kslab == 0 && rank == 0) {
        float ms[2] = {m[0], m[1]};
        for (int r = 1; r < S; ++r) {
          const float* src = cluster.map_shared_rank(part, r);
#pragma unroll
          for (int h = 0; h < 2; ++h) ms[h] = fmaxf(ms[h], src[h * 32]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float w0 = exp2f(m[h] - ms[h]);
          l[h] *= w0;
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            o[j][2 * h] *= w0;
            o[j][2 * h + 1] *= w0;
          }
        }
        for (int r = 1; r < S; ++r) {
          const float* src = cluster.map_shared_rank(part, r);
          float w[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            w[h] = exp2f(src[h * 32] - ms[h]);
            l[h] += w[h] * src[(2 + h) * 32];
          }
#pragma unroll
          for (int j = 0; j < DT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] += w[e >> 1] * src[(4 + 4 * j + e) * 32];
        }
        m[0] = ms[0];
        m[1] = ms[1];
      }
      cluster.sync();  // no rank exits before rank 0 has read its partial
    }
    if (kslab == 0 && rank == 0 && p.out_f32) {
      // f32 rows straight from the C fragments: lane (g, t) holds columns
      // 8 j + 2 t and + 1 of rows g and g + 8; with the statistics the
      // accumulator stays unnormalised and lane t = 0 writes (m, l)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = slab * 16 + g + 8 * h, qi = q0 + r;
        if (r >= p.bq || qi >= p.Lq) continue;
        const float inv = m_out ? 1.f : 1.f / (l[h] == 0.f ? 1.f : l[h]);
#pragma unroll
        for (int j = 0; j < DT; ++j)
          *reinterpret_cast<float2*>(orow_f + (long long)qi * HD + j * 8 + 2 * t) =
              make_float2(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
        if (m_out && t == 0) {
          m_out[row * p.Lq + qi] = m[h] == NEG_INF ? NEG_INF : m[h] / LOG2E;
          l_out[row * p.Lq + qi] = l[h];
        }
      }
    } else if (kslab == 0 && rank == 0) {
      // stage the slab's bf16 rows in its Q rows, then 16-byte stores
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) inv[h] = 1.f / (l[h] == 0.f ? 1.f : l[h]);
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(sq + (slab * 16 + g + 8 * h) * P + j * 8 + 2 * t) =
              pack_bf16(o[j][2 * h] * inv[h], o[j][2 * h + 1] * inv[h]);
      __syncwarp();
      constexpr int CPR = HD / 8;  // 16-byte chunks a row
      for (int i = lane; i < 16 * CPR; i += 32) {
        const int r = slab * 16 + i / CPR, c = (i % CPR) * 8, qi = q0 + r;
        if (r < p.bq && qi < p.Lq)
          *reinterpret_cast<uint4*>(orow + (long long)qi * HD + c) =
              *reinterpret_cast<const uint4*>(sq + r * P + c);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the trailing groups are empty)
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  float *m, *l;  // row statistics, or null
  const int *offs, *lens;
  const uint8_t* km;
  long long rows;
  FAParams p;
  cudaStream_t s;
};

// The grid (rows x S, q tiles or 1); S > 1 launches clusters of (S, 1, 1)
// through cudaLaunchKernelEx, whose refusal is returned as it is.
template <typename T, typename K>
cudaError_t launch(K kern, int threads, int smem, unsigned& done, const Args& a) {
  cudaError_t e = configure_once(kern, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(a.rows * a.p.split), a.p.kv_resident ? 1u : (unsigned)a.p.n_q);
  if (a.p.split == 1) {
    kern<<<grid, threads, smem, a.s>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.out, a.m, a.l, a.offs, a.lens, a.km, a.p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = a.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.q),
                         static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                         a.out, a.m, a.l, a.offs, a.lens, a.km, a.p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int HD, int BLOCK>
cudaError_t launch_fma(const Args& a) {
  static unsigned done = 0;
  return launch<float>(flash_kernel<HD, BLOCK>, THREADS,
                       smem_floats<HD, BLOCK>() * (int)sizeof(float), done, a);
}

template <int HD, int BLOCK, int C, bool SPLIT = false>
cudaError_t launch_tc_c(const Args& a) {
  static unsigned done = 0;
  return launch<bf16>(flash_tc_kernel<HD, BLOCK, C, SPLIT>, 32 * tc_warps<BLOCK>(),
                      tc_smem_bytes<HD, BLOCK, C>(), done, a);
}

// R: the smallest power of two with 16 R >= bq (R <= W since bq <= BLOCK);
// C = W / R key slabs. A block of 32 never has R = 4 (C = 1). A key split
// takes one row slab (R 1, C = W) and the SPLIT instance.
template <int HD, int BLOCK>
cudaError_t launch_tc(const Args& a) {
  constexpr int W = tc_warps<BLOCK>();
  int r = 1;
  while (16 * r < a.p.bq) r *= 2;
  if (a.p.split > 1)
    return r == 1 ? launch_tc_c<HD, BLOCK, W, true>(a) : cudaErrorInvalidValue;
  switch (W / r) {
    case 1:
      if constexpr (BLOCK >= 16 * W) return launch_tc_c<HD, BLOCK, 1>(a);
      return cudaErrorInvalidValue;
    case 2: return launch_tc_c<HD, BLOCK, 2>(a);
    case 4: return launch_tc_c<HD, BLOCK, 4>(a);
    case 8:
      if constexpr (W == 8) return launch_tc_c<HD, BLOCK, 8>(a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch_b(int dtype, int block, const Args& a) {
  // the instances repro_torch.kernels.flash_attention names (FLASH_INSTANCES)
  switch (block) {
    case 32: return dtype ? launch_tc<HD, 32>(a) : launch_fma<HD, 32>(a);
    case 64: return dtype ? launch_tc<HD, 64>(a) : launch_fma<HD, 64>(a);
    case 128:
      if constexpr (HD <= 32) return dtype ? launch_tc<HD, 128>(a) : launch_fma<HD, 128>(a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (rows, Lq, hd), k/v (rows, Lk, hd), all one dtype (0 = float32: the
// FMA kernel, 1 = bfloat16: the tensor-core kernel, every pointer on 16
// bytes), contiguous; out (rows, Lq, hd) of out_dtype (the FMA kernel's
// float32; the tensor-core kernel's bfloat16 or float32); m and l float32
// (rows, Lq), both null or both set (then out_dtype is float32: the
// unnormalised accumulator and the row statistics); q_offset and kv_lens
// int32 (rows,), an offset possibly negative; key_mask bool (rows /
// rows_per_batch, Lk) or null. ``block`` selects the compiled tile (the
// plan's), bq/bk <= block the clamped runtime tiles; ``split`` the CTAs of
// a row's cluster (1 to 8; above 1 only for the tensor-core kernel with one
// q tile of one row slab). Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* m, void* l,
    const void* q_offset, const void* kv_lens, const void* key_mask,
    int dtype, int out_dtype, int hd, int block, long long rows, int Lq,
    int Lk, int bq, int bk, int q_seq_len, int rows_per_batch, int causal,
    int split, float scale, void* stream) {
  if (rows <= 0 || split < 1 || split > 8 || rows * split > 0x7fffffffLL ||
      bq <= 0 || bk <= 0 || bq > block ||
      bk > block || (dtype != 0 && dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) || (dtype == 0 && out_dtype != 0) ||
      ((m == nullptr) != (l == nullptr)) || (m != nullptr && out_dtype != 0))
    return (int)cudaErrorInvalidConfiguration;
  if (dtype == 1 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15))
    return (int)cudaErrorMisalignedAddress;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.offs = static_cast<const int*>(q_offset);
  a.lens = static_cast<const int*>(kv_lens);
  a.km = static_cast<const uint8_t*>(key_mask);
  a.rows = rows;
  a.s = static_cast<cudaStream_t>(stream);
  FAParams& p = a.p;
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
  p.out_f32 = out_dtype == 0;
  p.split = split;
  p.scale = scale;
  if (p.n_q > 65535 || (split > 1 && (dtype != 1 || p.n_q != 1)))
    return (int)cudaErrorInvalidConfiguration;
  switch (hd) {
    case 16: return (int)launch_b<16>(dtype, block, a);
    case 32: return (int)launch_b<32>(dtype, block, a);
    case 64: return (int)launch_b<64>(dtype, block, a);
    case 80: return (int)launch_b<80>(dtype, block, a);
    case 128: return (int)launch_b<128>(dtype, block, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
