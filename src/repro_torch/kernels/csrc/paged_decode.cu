// One decode step of GQA attention read straight out of the paged KV pool
// through per-row block tables, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, _paged_decode_kernel
// (:257), whose grid (B, KV, w) fetches physical block tables[b, j] at step
// j through its index map.
//
// What bounds it on an H100: latency. At Lq = 1 the arithmetic is about one
// FMA per byte, and a serving step moves well under a megabyte (Qwen2.5-3B:
// B 4, KV 2, w <= 32 blocks of 16 keys), so the time is a few dependent
// loads (the length, the table entry, the K/V rows) and the launch. The
// design puts as many of those loads in flight at once as the shapes allow:
//
//  * A split over table slots, one thread-block cluster per (row b, kv head
//    h): the grid is (S, KV, B) with cluster dims (S, 1, 1), S <= 8 (the
//    portable cluster size). Rank r of a cluster takes the `spc` slots
//    [r spc, (r + 1) spc) of the row. S and spc depend on the shapes only
//    (slots_per_cta, and kernels/flash_attention.py, paged_launch_config,
//    which computes the same), never on the lengths: the host reads nothing
//    from the device and the launch can be captured in a CUDA graph.
//  * Dead slots are skipped: a CTA loads no table slot that lies wholly at
//    or past lengths[b] (such a slot weighs exactly 0 once the row has a
//    live key). A row of length <= 0 walks all w slots, so that it averages
//    V over them as the reference does (every position at the finite
//    NEG_INF = -1e30). A CTA with no live slot contributes m = NEG_INF,
//    l = 0 and is not read by the merge. Positions at or past the length in
//    a live slot get NEG_INF, as in the reference.
//  * K and V go through a RING-slot ring of KEY_TILE-key tiles in shared
//    memory, kept in their own dtype: rows come in as 16-byte cp.async,
//    zero-filled past the CTA's keys, rows padded to HD + 8 bf16 (HD + 4
//    f32). A tile is formed from the consecutive keys of the CTA's slots,
//    one table entry a row, so any block size works. The prologue issues
//    tiles 0 .. RING - 2; iteration t waits with wait_group(RING - 2),
//    syncs, then issues tile t + RING - 1 into slot (t - 1) % RING. One
//    commit group a tile; the query group goes in a group of its own ahead
//    of them.
//  * The (g, hd) query group is read from HBM once a cluster: rank 0 copies
//    it, and after the first cluster.sync every other live rank copies it
//    from rank 0's shared memory (distributed shared memory).
//  * The merge goes through distributed shared memory: each CTA leaves its
//    (m[g], l[g], O[g][hd]) in f32 in its own shared memory (over the ring,
//    after the walk); after the second cluster.sync rank 0 reads the live
//    ranks' partials with map_shared_rank, combines them as m* = max m_j,
//    O = sum e^(m_j - m*) O_j / sum e^(m_j - m*) l_j (l = 0 -> 1), and
//    stores the (g, hd) output as 16-byte rows. A third cluster.sync keeps
//    every rank resident until rank 0 has read it. No partial goes to HBM,
//    so the words issued are at most paged_decode_hbm_words (the int32
//    table entries and lengths counted once a row, as that counter counts
//    them; the KV clusters of a row re-read them from the L2).
//
// Two kernels, chosen by the dtype before the launch (never after a
// failure), both 128 threads and the same split, ring and merge:
//
// paged_decode_tc_kernel, bf16: tensor cores (mma.sync m16n8k16 bf16 ->
//  f32). The g <= 16 query heads of the kv head are the 16 M rows (rows g ..
//  15 zero). Each of the 4 warps takes a slab of 8 keys of every tile, as
//  flash_tc_kernel's key slabs at decode (csrc/flash_attention.cu): Q's A
//  fragments come once by ldmatrix and stay in registers, K's B fragments by
//  ldmatrix, V's by ldmatrix.trans; P stays in registers as the next A
//  fragment (the upper half of its k16 is zero), rounded to bf16, and l sums
//  the f32 probabilities. The online softmax runs in the log2 domain with
//  exp2. The 4 warps' (m, l, O) are combined through shared memory into the
//  CTA's partial before the cluster merge.
//
// paged_decode_fma_kernel, f32: the FMA pipe (bf16 MMAs would change f32
//  numerics); for the tests and the f32 checks. Per tile: scores of the g x
//  KEY_TILE (head, key) pairs from shared memory, the online softmax one
//  warp a head (a lane a key), P V with fixed (head, dim) accumulators in
//  registers.
#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int NTHR = 32 * WARPS;
constexpr int KEY_TILE = 32;             // keys a ring slot holds (K and V)
constexpr int RING = 4;                  // ring slots
constexpr int SLAB = KEY_TILE / WARPS;   // keys of a warp's slab (bf16)
constexpr int G_MAX = 16;                // query heads a kv head: m16 rows
constexpr int MAX_SPLIT = 8;             // CTAs a cluster (portable size)
constexpr int TARGET_CTAS = 264;         // twice the H100's 132 SMs
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(KEY_TILE == 32, "the FMA kernel's softmax takes a lane a key");
static_assert(SLAB == 8, "a warp's slab is one n8 tile of S");

struct PDParams {
  int KV, g, bs, w;
  int spc;     // table slots a CTA takes
  float sl2;   // 1 / sqrt(hd) * log2(e): logits in the log2 domain
};

// A CTA's partial, f32: m[G_MAX], l[G_MAX], O[G_MAX][HD]
template <int HD>
__host__ __device__ constexpr int part_floats() { return 2 * G_MAX + G_MAX * HD; }

// The keys [k0, k1) of its row that rank r of a cluster walks, in tiles of
// KEY_TILE, and the live ranks of the cluster (a prefix: slots go to the
// ranks in order).
struct Share {
  int k0, k1, tiles, live;
};

__device__ __forceinline__ Share share_of(int rank, int len, const PDParams& p) {
  const int slots =
      len > 0 ? min(p.w, (int)(((long long)len + p.bs - 1) / p.bs)) : p.w;
  const int j0 = rank * p.spc, j1 = min(j0 + p.spc, slots);
  Share s;
  s.k0 = j0 * p.bs;
  s.k1 = j1 > j0 ? j1 * p.bs : s.k0;
  s.tiles = (s.k1 - s.k0 + KEY_TILE - 1) / KEY_TILE;
  s.live = (slots + p.spc - 1) / p.spc;
  return s;
}

// Issue the 16-byte copies of the key tile at row keys [kb, kb + KEY_TILE)
// into a ring slot (K rows, then V rows, pitch P elements); keys at or past
// k1 are zero-filled.
template <typename T, int HD, int P>
__device__ __forceinline__ void load_tile(T* slot, const T* __restrict__ kp,
                                          const T* __restrict__ vp,
                                          const int* __restrict__ tab, int kb,
                                          int k1, int h, const PDParams& p,
                                          int tid) {
  constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte copy
  constexpr int CPR = HD / E;             // copies a row
  for (int i = tid; i < KEY_TILE * CPR; i += NTHR) {
    const int r = i / CPR, c = (i - r * CPR) * E, kpos = kb + r;
    const bool ok = kpos < k1;
    long long off = 0;
    if (ok) {
      const int j = kpos / p.bs;
      off = (((long long)__ldg(tab + j) * p.KV + h) * p.bs + (kpos - j * p.bs)) * HD + c;
    }
    cp_async16(slot + r * P + c, kp + off, ok ? 16 : 0);
    cp_async16(slot + (KEY_TILE + r) * P + c, vp + off, ok ? 16 : 0);
  }
}

// Rank 0 issues the copies of the query group (rows g .. G_MAX - 1 are the
// caller's), one commit group in every rank; the ring's prologue follows.
template <typename T, int HD, int P, typename Load>
__device__ __forceinline__ void prologue(T* sq, const T* __restrict__ qg,
                                         int rank, const Share& sh,
                                         const PDParams& p, int tid, Load load) {
  constexpr int E = 16 / (int)sizeof(T), CPR = HD / E;
  if (rank == 0)
    for (int i = tid; i < p.g * CPR; i += NTHR) {
      const int r = i / CPR, c = (i - r * CPR) * E;
      cp_async16(sq + r * P + c, qg + r * HD + c, 16);
    }
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < RING - 1; ++t) {
    if (t < sh.tiles) load(t);
    cp_async_commit();
  }
}

// After rank 0's query group has landed: the first cluster.sync (every CTA
// has started; the group is visible), then every other live rank copies it
// from rank 0's shared memory.
template <typename T, int HD, int P>
__device__ __forceinline__ void share_query(const cg::cluster_group& cluster,
                                            T* sq, int rank, const Share& sh,
                                            const PDParams& p, int tid) {
  constexpr int E = 16 / (int)sizeof(T), CPR = HD / E;
  cp_async_wait<RING - 1>();  // rank 0: the query group's copies are done
  cluster.sync();
  if (rank == 0 || sh.tiles == 0) return;
  const T* rq = cluster.map_shared_rank(sq, 0);
  for (int i = tid; i < p.g * CPR; i += NTHR) {
    const int r = i / CPR, c = (i - r * CPR) * E;
    *reinterpret_cast<uint4*>(sq + r * P + c) =
        *reinterpret_cast<const uint4*>(rq + r * P + c);
  }
}

__device__ __forceinline__ void store8(bf16* o, const float (&v)[8], float s) {
  uint4 u;
  u.x = pack_bf16(v[0] * s, v[1] * s);
  u.y = pack_bf16(v[2] * s, v[3] * s);
  u.z = pack_bf16(v[4] * s, v[5] * s);
  u.w = pack_bf16(v[6] * s, v[7] * s);
  *reinterpret_cast<uint4*>(o) = u;
}

__device__ __forceinline__ void store8(float* o, const float (&v)[8], float s) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4] * s, v[5] * s, v[6] * s, v[7] * s);
}

// The second cluster.sync, rank 0's merge of the live ranks' partials (at
// `part` in each rank's shared memory) into the (g, HD) output rows at
// `out`, 8 columns an item, and the third cluster.sync.
template <typename T, int HD>
__device__ __forceinline__ void merge_cluster(const cg::cluster_group& cluster,
                                              float* part, int rank, int live,
                                              int g, T* __restrict__ out,
                                              int tid) {
  constexpr int CH = HD / 8;
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < g * CH; i += NTHR) {
      const int r = i / CH, c = (i - r * CH) * 8;
      float ms = NEG_INF;
      for (int k = 0; k < live; ++k) ms = fmaxf(ms, cluster.map_shared_rank(part, k)[r]);
      float den = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < live; ++k) {
        const float* pk = cluster.map_shared_rank(part, k);
        const float wt = exp2f(pk[r] - ms);
        den += wt * pk[G_MAX + r];
        const float4* o4 = reinterpret_cast<const float4*>(pk + 2 * G_MAX + r * HD + c);
        const float4 a = o4[0], b = o4[1];
        acc[0] += wt * a.x;
        acc[1] += wt * a.y;
        acc[2] += wt * a.z;
        acc[3] += wt * a.w;
        acc[4] += wt * b.x;
        acc[5] += wt * b.y;
        acc[6] += wt * b.z;
        acc[7] += wt * b.w;
      }
      store8(out + r * HD + c, acc, 1.f / (den == 0.f ? 1.f : den));
    }
  }
  cluster.sync();
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16).
// ---------------------------------------------------------------------------

template <int HD>
constexpr int tc_smem_bytes() {
  return (G_MAX + RING * 2 * KEY_TILE) * (HD + 8) * 2;
}

template <int HD>
__global__ void __launch_bounds__(NTHR)
paged_decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                       const bf16* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ lengths, bf16* __restrict__ out,
                       PDParams p) {
  constexpr int P = HD + 8;              // an odd multiple of 16 bytes
  constexpr int DK = HD / 16;            // k16 steps of Q K^T
  constexpr int DT = HD / 8;             // n8 tiles of O
  constexpr int SLOT = 2 * KEY_TILE * P;
  constexpr int PF = part_floats<HD>();
  static_assert((WARPS + 1) * PF * 4 <= RING * SLOT * 2, "partials fit the ring");
  extern __shared__ __align__(16) unsigned char smem_pd[];
  bf16* const sq = reinterpret_cast<bf16*>(smem_pd);
  bf16* const ring = sq + G_MAX * P;
  float* const part = reinterpret_cast<float*>(ring);  // after the walk

  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int len = __ldg(lengths + b);
  const Share sh = share_of(rank, len, p);
  const int* tab = tables + (long long)b * p.w;
  const long long head0 = ((long long)b * p.KV + h) * p.g;  // first query head

  auto load = [&](int t) {
    load_tile<bf16, HD, P>(ring + (t % RING) * SLOT, kp, vp, tab,
                           sh.k0 + t * KEY_TILE, sh.k1, h, p, tid);
  };
  for (int i = tid; i < (G_MAX - p.g) * (HD / 8); i += NTHR) {  // zero M rows
    const int r = p.g + i / (HD / 8), c = (i % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(sq + r * P + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  prologue<bf16, HD, P>(sq, q + head0 * HD, rank, sh, p, tid, load);
  share_query<bf16, HD, P>(cluster, sq, rank, sh, p, tid);

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t qf[DK][4];
  const int c0 = warp * SLAB;  // the warp's first key column of a tile

  for (int t = 0; t < sh.tiles; ++t) {
    cp_async_wait<RING - 2>();  // tile t has landed ...
    __syncthreads();            // ... for every thread; slot (t - 1) % RING is free
    if (t + RING - 1 < sh.tiles) load(t + RING - 1);
    cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldsm_x4(qf[kk], sq + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
    }
    const int kb = sh.k0 + t * KEY_TILE;
    const int kv = min(KEY_TILE, sh.k1 - kb);  // key rows of this tile
    if (c0 >= kv) continue;                    // no key in the slab
    const bf16* sk = ring + (t % RING) * SLOT;
    const bf16* sv = sk + KEY_TILE * P;

    // S = Q K^T over the warp's 8 keys
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t bk[2];
      ldsm_x2(bk, sk + (c0 + (lane & 7)) * P + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s, qf[kk], bk);
    }

    // masks, then the online softmax (log2 domain)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 2 * tq + e, kpos = kb + c;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = -INFINITY;  // past the CTA's keys: zero weight
        if (c < kv) x = kpos < len ? s[2 * hh + e] * p.sl2 : NEG_INF;
        s[2 * hh + e] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = exp2f(m[hh] - mx[hh]);
      m[hh] = mx[hh];
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = exp2f(s[e] - m[e >> 1]);
      s[e] = pr;
      l[e >> 1] += pr;
    }
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // O += P V: P from the S registers as the bf16 A fragment (k 8 .. 15
    // zero); V's B fragments by ldmatrix.trans
    uint32_t a[4];
    a[0] = pack_bf16(s[0], s[1]);
    a[1] = pack_bf16(s[2], s[3]);
    a[2] = a[3] = 0u;
    const bf16* vr = sv + (c0 + (lane & 7)) * P + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b0[2], b1[2];
      ldsm_x4_t(b0, b1, vr + dp * 16);
      mma_bf16(o[2 * dp], a, b0);
      mma_bf16(o[2 * dp + 1], a, b1);
    }
  }

  if (sh.tiles > 0) {
    // the row sums over the quad, then the 4 warps' (m, l, O) into the CTA's
    // partial, both over the ring
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    __syncthreads();  // every warp is done with the ring
    float* wp = part + warp * PF;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = gq + 8 * hh;
      if (row >= p.g) continue;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<float2*>(wp + 2 * G_MAX + row * HD + j * 8 + 2 * tq) =
            make_float2(o[j][2 * hh], o[j][2 * hh + 1]);
      if (tq == 0) {
        wp[row] = m[hh];
        wp[G_MAX + row] = l[hh];
      }
    }
    __syncthreads();
    float* cp = part + WARPS * PF;
    for (int i = tid; i < p.g * (HD / 4); i += NTHR) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      float ms = NEG_INF;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) ms = fmaxf(ms, part[k * PF + r]);
      float den = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        const float* wk = part + k * PF;
        const float wt = exp2f(wk[r] - ms);
        den += wt * wk[G_MAX + r];
        const float4 v = *reinterpret_cast<const float4*>(wk + 2 * G_MAX + r * HD + c);
        acc.x += wt * v.x;
        acc.y += wt * v.y;
        acc.z += wt * v.z;
        acc.w += wt * v.w;
      }
      *reinterpret_cast<float4*>(cp + 2 * G_MAX + r * HD + c) = acc;
      if (c == 0) {
        cp[r] = ms;
        cp[G_MAX + r] = den;
      }
    }
  }
  merge_cluster<bf16, HD>(cluster, part + WARPS * PF, rank, sh.live, p.g,
                          out + head0 * HD, tid);
  cp_async_wait<0>();  // no copy outlives the CTA (the trailing groups are empty)
}

// ---------------------------------------------------------------------------
// The FMA kernel (f32).
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

template <int HD>
constexpr int fma_smem_bytes() {
  return ((G_MAX + RING * 2 * KEY_TILE) * (HD + 4) + G_MAX * KEY_TILE + 3 * G_MAX) * 4;
}

template <int HD>
__global__ void __launch_bounds__(NTHR)
paged_decode_fma_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                        const float* __restrict__ vp, const int* __restrict__ tables,
                        const int* __restrict__ lengths, float* __restrict__ out,
                        PDParams p) {
  constexpr int P = HD + 4;
  constexpr int SLOT = 2 * KEY_TILE * P;
  constexpr int NACC = G_MAX * HD / NTHR;  // (head, dim) accumulators a thread
  static_assert(part_floats<HD>() <= RING * SLOT, "the partial fits the ring");
  extern __shared__ __align__(16) unsigned char smem_pd[];
  float* const sq = reinterpret_cast<float*>(smem_pd);  // G_MAX x P
  float* const ring = sq + G_MAX * P;
  float* const ss = ring + RING * SLOT;  // G_MAX x KEY_TILE: scores, then P
  float* const sm = ss + G_MAX * KEY_TILE;
  float* const sl = sm + G_MAX;
  float* const sa = sl + G_MAX;
  float* const part = ring;  // after the walk

  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = __ldg(lengths + b);
  const Share sh = share_of(rank, len, p);
  const int* tab = tables + (long long)b * p.w;
  const long long head0 = ((long long)b * p.KV + h) * p.g;

  auto load = [&](int t) {
    load_tile<float, HD, P>(ring + (t % RING) * SLOT, kp, vp, tab,
                            sh.k0 + t * KEY_TILE, sh.k1, h, p, tid);
  };
  for (int r = tid; r < p.g; r += NTHR) {
    sm[r] = NEG_INF;
    sl[r] = 0.f;
  }
  prologue<float, HD, P>(sq, q + head0 * HD, rank, sh, p, tid, load);
  share_query<float, HD, P>(cluster, sq, rank, sh, p, tid);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int t = 0; t < sh.tiles; ++t) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // tile t has landed; the last tile's P V is done
    if (t + RING - 1 < sh.tiles) load(t + RING - 1);
    cp_async_commit();
    const int kb = sh.k0 + t * KEY_TILE;
    const int kv = min(KEY_TILE, sh.k1 - kb);
    const float* sk = ring + (t % RING) * SLOT;
    const float* sv = sk + KEY_TILE * P;
    for (int e = tid; e < p.g * KEY_TILE; e += NTHR) {
      const int r = e / KEY_TILE, c = e % KEY_TILE, kpos = kb + c;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(sq[r * P + d], sk[c * P + d], dot);
      ss[e] = c < kv ? (kpos < len ? dot * p.sl2 : NEG_INF) : -INFINITY;
    }
    __syncthreads();
    for (int r = warp; r < p.g; r += WARPS) {
      const float m_prev = sm[r];
      const float x = ss[r * KEY_TILE + lane];
      const float mx = fmaxf(m_prev, warp_max(x));
      const float pr = exp2f(x - mx);
      ss[r * KEY_TILE + lane] = pr;
      const float sum = warp_sum(pr);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - mx);
        sa[r] = alpha;
        sl[r] = alpha * sl[r] + sum;
        sm[r] = mx;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + NTHR * i;
      if (e >= p.g * HD) continue;
      const int r = e / HD, d = e % HD;
      float a = acc[i] * sa[r];
#pragma unroll 8
      for (int c = 0; c < KEY_TILE; ++c) a = fmaf(ss[r * KEY_TILE + c], sv[c * P + d], a);
      acc[i] = a;
    }
  }

  if (sh.tiles > 0) {
    __syncthreads();  // every thread is done with the ring
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + NTHR * i;
      if (e < p.g * HD) part[2 * G_MAX + e] = acc[i];  // row pitch HD
    }
    for (int r = tid; r < p.g; r += NTHR) {
      part[r] = sm[r];
      part[G_MAX + r] = sl[r];
    }
  }
  merge_cluster<float, HD>(cluster, part, rank, sh.live, p.g, out + head0 * HD, tid);
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Table slots a CTA takes: as many CTAs a (row, kv head) as bring the grid
// to TARGET_CTAS, at most MAX_SPLIT and at most w, then as few CTAs as take
// the w slots in shares of that size (paged_launch_config computes the same)
int slots_per_cta(int B, int KV, int w) {
  const long long units = (long long)B * KV;
  const long long want = (TARGET_CTAS + units - 1) / units;
  const int s = (int)std::min<long long>(std::min(MAX_SPLIT, w), std::max(1LL, want));
  return (w + s - 1) / s;
}

template <typename T, typename K>
cudaError_t launch_cluster(K kern, int smem, unsigned& done, int S, int B,
                           const void* q, const void* kp, const void* vp,
                           const void* tables, const void* lengths, void* out,
                           const PDParams& p, cudaStream_t s) {
  cudaError_t e = configure_once(kern, smem, done);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S, (unsigned)p.KV, (unsigned)B);
  cfg.blockDim = dim3(NTHR);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                         static_cast<const T*>(kp), static_cast<const T*>(vp),
                         static_cast<const int*>(tables),
                         static_cast<const int*>(lengths), static_cast<T*>(out), p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, int S, int B, const void* q, const void* kp,
                      const void* vp, const void* tables, const void* lengths,
                      void* out, const PDParams& p, cudaStream_t s) {
  static unsigned done_tc = 0, done_fma = 0;
  if (dtype == 1)
    return launch_cluster<bf16>(paged_decode_tc_kernel<HD>, tc_smem_bytes<HD>(),
                                done_tc, S, B, q, kp, vp, tables, lengths, out, p, s);
  return launch_cluster<float>(paged_decode_fma_kernel<HD>, fma_smem_bytes<HD>(),
                               done_fma, S, B, q, kp, vp, tables, lengths, out, p, s);
}

}  // namespace

// q (B, KV, g, hd), pools (num_blocks, KV, bs, hd), out like q, one dtype
// (0 = float32: the FMA kernel, 1 = bfloat16: the tensor-core kernel; every
// pointer on 16 bytes), contiguous; tables int32 (B, w), lengths int32 (B,).
// Returns the launch's cudaError_t.
extern "C" int repro_paged_decode(
    const void* q, const void* kp, const void* vp, const void* tables,
    const void* lengths, void* out, int dtype, int hd, int B, int KV, int g,
    int bs, int w, float scale, void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || KV > 65535 || g <= 0 || g > G_MAX ||
      bs <= 0 || w <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidConfiguration;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kp) |
       reinterpret_cast<uintptr_t>(vp) | reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  PDParams p;
  p.KV = KV;
  p.g = g;
  p.bs = bs;
  p.w = w;
  p.spc = slots_per_cta(B, KV, w);
  p.sl2 = scale * LOG2E;
  const int S = (w + p.spc - 1) / p.spc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch_hd<16>(dtype, S, B, q, kp, vp, tables, lengths, out, p, s);
    case 32: return (int)launch_hd<32>(dtype, S, B, q, kp, vp, tables, lengths, out, p, s);
    case 64: return (int)launch_hd<64>(dtype, S, B, q, kp, vp, tables, lengths, out, p, s);
    case 128: return (int)launch_hd<128>(dtype, S, B, q, kp, vp, tables, lengths, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
