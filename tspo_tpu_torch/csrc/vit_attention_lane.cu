// One-shot-softmax ViT attention over lane slices of [B, S, W] for Hopper
// (sm_90a): the variants of the ViT-attention bench that keep a whole score
// row of a head at once.  bf16 in and out, fp32 inside.
//
// Replaces (scripts/bench_vit_attention_variants.py, Pallas, TPU):
//   _lane_kernel        :43   lane, lane_nt, lane_nomax, lane_nosm, lane_par
//   _lane_fn_kernel     :67   lane_f{F}, lane_f{F}_nosm (F frames a program)
//   _bdp2_kernel        :114  bdp2 (two heads packed block-diagonally)
//   _lane_packed_kernel :212  lane_packed (one packed [B, S, 3W] input)
//   _grid_h2_kernel     :228  grid_h2 (two heads a program)
// Per head h the lane slice [:, h*64:(h+1)*64] gives s = (q k^T) * scale in
// fp32; then p = softmax(s) with the row max subtracted (mode max),
// e / sum(e) without it (nomax) or s * 0.001 (none); p is rounded to bf16 and
// o = p v is accumulated in fp32 and rounded to bf16.  The division comes
// before the rounding, as in the Pallas body.
//
// Bound on the H100: at the bench shape (B=256, S=257, W=1024, 16 heads of
// 64) the function reads q, k, v and writes o once, 539 MB, and does
// 4*B*S^2*W = 69 GFLOP: bound by device memory, ~0.161 ms at 3.35 TB/s.
// bdp2's zero halves double the MMA work (to 138 GFLOP, still under the
// memory time); that doubling is the question its probe asks.
//
// Design (simple form; no TMA, wgmma or warp specialisation):
//   * A block takes one frame (F frames for lane_f{F}) and one tile of 64
//     query rows, and loops over a group of heads: all of them, as the Pallas
//     program does, or two for grid_h2.  4 warps, 16 query rows each,
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//   * One-shot softmax, the contrast with vit_attention.cu's online softmax:
//     every score of the block's 64 rows for one head (or head pair) is kept
//     at once, in shared memory as fp32 ([64][ceil(S/64)*64 + 8], ~82 KB at
//     S=257).  A 16 x 257 row block would take 132 fp32 registers a thread
//     beside the Q fragments and the accumulators, so the scores live in
//     shared memory.  A thread stores its score fragments (rows g, g + 8,
//     columns n*8 + 2t, +1) and takes their running row max; after the last
//     K tile it reduces the max over the row's four threads, writes
//     e = exp(s - max) over its own positions and sums them (two shuffles);
//     in P V it reads the same positions as P's A fragments and divides by the
//     sum.  Every step is thread-private: no barrier, no warp-wide row walk.
//   * K and V stream through three shared-memory stages in tiles of 64 keys
//     (cp.async; src_bytes = 0 zero-fills keys past S and the empty half of a
//     bdp2 tile), two tiles ahead of the one computed: first the K tiles of a
//     head (scores), then its V tiles (P V).  ~111 KB of shared memory at
//     S=257: two blocks an SM.  That cap (set by the score buffer) leaves
//     ~18 KB of K/V in flight a block, and the tile stream's latency, not
//     the bytes, sets the time (PERF.md).
//   * lane writes K^T into shared memory itself ([64 dims][64 keys], plain
//     loads and scattered 2-byte stores: the kh.T relayout the probe asked
//     about) and reads it with ldmatrix.trans; every other variant reads K
//     row-major with ldmatrix.
//   * Scores are written as s * scale.  Keys past S get p = 0 in every mode:
//     e = 0 in modes max and nomax; in mode none their zero-filled K rows give
//     s = 0.  So zero-filled V rows multiply zeros.
//   * bdp2: a group is a head pair of 128 lanes.  Key tiles of the 2S packed
//     keys hold one head's 64 lanes and zeros in the other 64, q is the pair's
//     128 lanes, so one 128-deep contraction gives that head's scores; the
//     softmax is segmented (a max and a sum for each half of the row), and P V
//     runs over 128-lane V tiles with the same zero half.
//   * lane_packed: q, k and v are column offsets 0, W and 2W of one
//     [B, S, 3W] array with row stride 3W.
// hd must be 64.  S up to 768 (bdp2: up to 320) for the score buffer.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per shared-memory tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kHd = 64;        // head dim
constexpr int kStages = 3;     // K/V tiles in flight: this one and two ahead
constexpr int kMaxSmem = 232448;

enum Mode { kMax = 0, kNoMax = 1, kNone = 2 };

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long ld_in;    // row stride of q, k and v (elements)
  long long ld_out;   // row stride of o
  int S;
  int frames;         // frames per block
  int groups;         // head groups per block (a group: one head, or a bdp2 pair)
  int ntiles;         // key tiles of one head: ceil(S / kKeys)
  float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy in the background; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.  Plain: lane (g, t) gets row g, cols 2t..2t+1.
// .trans: lane (g, t) gets rows 2t..2t+1 of col g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool BD>
struct Geometry {
  static constexpr int D = BD ? 2 * kHd : kHd;   // lanes of a group
  static constexpr int SEG = BD ? 2 : 1;         // heads (softmax segments) per group
  static constexpr int LDT = D + 8;              // row stride of a K/V tile
  static constexpr int LDKT = kKeys + 8;         // row stride of a K^T tile
  static constexpr int TILE = (kKeys * LDT > D * LDKT) ? kKeys * LDT : D * LDKT;
  static __host__ __device__ int score_cols(int ntiles) { return SEG * ntiles * kKeys; }
  static __host__ __device__ int lds(int ntiles) { return score_cols(ntiles) + 8; }
  static size_t smem_bytes(int ntiles) {
    return (size_t)kRows * lds(ntiles) * sizeof(float) + kStages * TILE * sizeof(__nv_bfloat16);
  }
};

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A: reg0 (row g, cols 2t..2t+1), reg1 (row g+8, cols 2t..), reg2 (row g,
//      cols 2t+8..), reg3 (row g+8, cols 2t+8..)
//   B: reg0 (k 2t..2t+1, col g), reg1 (k 2t+8..2t+9, col g)
//   C: c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8, cols 2t, 2t+1)
// The score row stride (score columns + 8 floats) keeps the float2 accesses
// of one half-warp on 32 different banks.
template <int MODE, bool TRANSK, bool BD>
__global__ void __launch_bounds__(kThreads)
lane_attention_kernel(const Args a) {
  using G = Geometry<BD>;
  constexpr int D = G::D, SEG = G::SEG, LDT = G::LDT, LDKT = G::LDKT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntiles = a.ntiles;
  const int LDS = G::lds(ntiles);
  float* sS = reinterpret_cast<float*>(smem);
  __nv_bfloat16* sT = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)kRows * LDS * sizeof(float));

  const int S = a.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int wrow = blockIdx.x * kRows + warp * 16;
  const bool active = wrow < S;              // uniform across the warp
  const int r0 = wrow + g;                   // rows r0 and r0 + 8
  float* myS = sS + (size_t)(warp * 16) * LDS;

  // Work items of the block, in order: for each frame, for each group, the
  // SEG * ntiles K tiles of the group, then its SEG * ntiles V tiles.
  const int half = SEG * ntiles;
  const int per_group = 2 * half;
  const int n_items = a.frames * a.groups * per_group;

  auto decode = [&](int item, size_t& frame_in, size_t& frame_out, int& col0,
                    int& j) {
    const int f = item / (a.groups * per_group);
    const int rem = item % (a.groups * per_group);
    const int group = blockIdx.y * a.groups + rem / per_group;
    const size_t frame = (size_t)blockIdx.z * a.frames + f;
    frame_in = frame * S * a.ld_in;
    frame_out = frame * S * a.ld_out;
    col0 = group * D;
    j = rem % per_group;
  };

  auto load = [&](int item, int buf) {
    size_t fin, fout;
    int col0, j;
    decode(item, fin, fout, col0, j);
    const bool is_v = j >= half;
    const int jj = is_v ? j - half : j;
    const int seg = jj / ntiles, key0 = (jj % ntiles) * kKeys;
    const __nv_bfloat16* src = (is_v ? a.v : a.k) + fin + col0;
    __nv_bfloat16* dst = sT + buf * G::TILE;
    constexpr int CH = D / 8;                // 16-byte chunks per key row
    if (TRANSK && !is_v) {
      // K^T [dims][keys]: one 16-byte global load, eight 2-byte stores.
      for (int idx = threadIdx.x; idx < kKeys * CH; idx += kThreads) {
        const int key = idx / CH, c = idx % CH;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (key0 + key < S)
          val = *reinterpret_cast<const uint4*>(src + (size_t)(key0 + key) * a.ld_in + c * 8);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(c * 8 + i) * LDKT + key] = e[i];
      }
    } else {
      for (int idx = threadIdx.x; idx < kKeys * CH; idx += kThreads) {
        const int key = idx / CH, c = idx % CH;
        const bool ok = key0 + key < S && (!BD || c / (kHd / 8) == seg);
        const __nv_bfloat16* p = ok ? src + (size_t)(key0 + key) * a.ld_in + c * 8 : a.k;
        cp_async16(dst + key * LDT + c * 8, p, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
  // Each thread's rows g and g + 8, for each segment: the running max of the
  // scores (mode max) and, after the last K tile, the sum of exp.
  float m[SEG][2], l[SEG][2];

  load(0, 0);
  if (n_items > 1) load(1, 1); else cp_async_commit();
  for (int item = 0; item < n_items; ++item) {
    const int buf = item % kStages;
    if (item + 2 < n_items)
      load(item + 2, (item + 2) % kStages);   // released at the end of item - 1
    else
      cp_async_commit();                      // an empty group keeps the count
    cp_async_wait<kStages - 1>();
    __syncthreads();   // tile `item` is in shared memory for every thread

    size_t fin, fout;
    int col0, j;
    decode(item, fin, fout, col0, j);
    const bool is_v = j >= half;
    const int jj = is_v ? j - half : j;
    const int seg = jj / ntiles, jt = jj % ntiles;
    const int scol = seg * ntiles * kKeys + jt * kKeys;   // first score column
    const __nv_bfloat16* tile = sT + buf * G::TILE;

    if (active && !is_v) {
      if (jj == 0) {
        // Q fragments of the group straight from device memory; rows >= S are 0.
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = r0 + ((i & 1) ? 8 : 0);
            const int c = col0 + kk * 16 + t * 2 + ((i & 2) ? 8 : 0);
            qa[kk][i] = row < S ? *reinterpret_cast<const uint32_t*>(
                                      a.q + fin + (size_t)row * a.ld_in + c)
                                : 0u;
          }
        }
#pragma unroll
        for (int sg = 0; sg < SEG; ++sg)
          m[sg][0] = m[sg][1] = (MODE == kMax) ? -INFINITY : 0.f;
      }
      // s = Q K^T for this warp's 16 rows x 64 keys; one ldmatrix_x4 gives
      // the B fragments of key blocks n and n + 1 for one 16-dim slice.
      float s[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int n = 0; n < kKeys / 8; n += 2) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t b[4];
          if (TRANSK)
            ldmatrix_x4_trans(b, tile + (kk * 16 + (lm & 1) * 8 + lr) * LDKT + (n + (lm >> 1)) * 8);
          else
            ldmatrix_x4(b, tile + ((n + (lm >> 1)) * 8 + lr) * LDT + kk * 16 + (lm & 1) * 8);
          mma_bf16(s[n], qa[kk], b);
          mma_bf16(s[n + 1], qa[kk], b + 2);
        }
      }
      // Store s * scale; keys below S feed the running max.
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] *= a.scale;
          if (MODE == kMax && jt * kKeys + n * 8 + t * 2 + (i & 1) < S)
            m[seg][i >> 1] = fmaxf(m[seg][i >> 1], s[n][i]);
        }
        const int c = scol + n * 8 + t * 2;
        *reinterpret_cast<float2*>(myS + g * LDS + c) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(myS + (g + 8) * LDS + c) = make_float2(s[n][2], s[n][3]);
      }

      if (MODE != kNone && jj == half - 1) {
        // Whole rows are in shared memory: the one-shot softmax.  The score
        // positions a thread stores (rows g, g + 8, columns n*8 + 2t, +1) are
        // the positions it later reads as P's A fragments, so every step is
        // thread-private: e = exp(s - max) in place (0 past S), and its sum.
#pragma unroll
        for (int sg = 0; sg < SEG; ++sg) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (MODE == kMax) {
              m[sg][h] = fmaxf(m[sg][h], __shfl_xor_sync(0xffffffffu, m[sg][h], 1));
              m[sg][h] = fmaxf(m[sg][h], __shfl_xor_sync(0xffffffffu, m[sg][h], 2));
            }
            float sum = 0.f;
            float* row = myS + (g + 8 * h) * LDS + sg * ntiles * kKeys;
            for (int key = t * 2; key < ntiles * kKeys; key += 8) {
              const float2 x = *reinterpret_cast<const float2*>(row + key);
              const float e0 = key < S ? expf(x.x - m[sg][h]) : 0.f;
              const float e1 = key + 1 < S ? expf(x.y - m[sg][h]) : 0.f;
              *reinterpret_cast<float2*>(row + key) = make_float2(e0, e1);
              sum += e0 + e1;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l[sg][h] = sum;
          }
        }
      }
    } else if (active) {
      if (jj == 0) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
      }
      // O += P V over this tile's 64 keys.  P's A fragments come from this
      // thread's own score positions: p = bf16(e / sum) (mode none:
      // bf16(s * 0.001); keys past S met zero-filled K rows, so s = 0 there).
      // One ldmatrix_x4_trans gives the B fragments of dim blocks dn, dn + 1.
      const float d0 = MODE == kNone ? 1.f : l[seg][0];   // row sums
      const float d1 = MODE == kNone ? 1.f : l[seg][1];
      auto prob = [&](float x, float d) { return MODE == kNone ? x * 0.001f : x / d; };
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const int c = scol + kk * 16 + t * 2;
        const float2 p00 = *reinterpret_cast<const float2*>(myS + g * LDS + c);
        const float2 p10 = *reinterpret_cast<const float2*>(myS + (g + 8) * LDS + c);
        const float2 p01 = *reinterpret_cast<const float2*>(myS + g * LDS + c + 8);
        const float2 p11 = *reinterpret_cast<const float2*>(myS + (g + 8) * LDS + c + 8);
        uint32_t pa[4] = {pack_bf16(prob(p00.x, d0), prob(p00.y, d0)),
                          pack_bf16(prob(p10.x, d1), prob(p10.y, d1)),
                          pack_bf16(prob(p01.x, d0), prob(p01.y, d0)),
                          pack_bf16(prob(p11.x, d1), prob(p11.y, d1))};
#pragma unroll
        for (int dn = 0; dn < D / 8; dn += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, tile + (kk * 16 + (lm & 1) * 8 + lr) * LDT + (dn + (lm >> 1)) * 8);
          mma_bf16(acc[dn], pa, b);
          mma_bf16(acc[dn + 1], pa, b + 2);
        }
      }
      if (jj == half - 1) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int d = col0 + dn * 8 + t * 2;
          if (r0 < S)
            *reinterpret_cast<uint32_t*>(a.o + fout + (size_t)r0 * a.ld_out + d) =
                pack_bf16(acc[dn][0], acc[dn][1]);
          if (r0 + 8 < S)
            *reinterpret_cast<uint32_t*>(a.o + fout + (size_t)(r0 + 8) * a.ld_out + d) =
                pack_bf16(acc[dn][2], acc[dn][3]);
        }
      }
    }
    __syncthreads();   // every warp is done with stage buf before it is refilled
  }
}

template <int MODE, bool TRANSK, bool BD>
int launch(const Args& a, int B, int W, int heads_per_block, cudaStream_t st) {
  using G = Geometry<BD>;
  const size_t smem = G::smem_bytes(a.ntiles);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = lane_attention_kernel<MODE, TRANSK, BD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + kRows - 1) / kRows, W / (kHd * heads_per_block), B / a.frames);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int W, int heads, int frames, int heads_per_block) {
  return B <= 0 || S <= 0 || heads <= 0 || W != heads * kHd || frames <= 0 ||
         B % frames || B / frames > 65535 || heads_per_block <= 0 ||
         heads % heads_per_block || (S + kRows - 1) / kRows > 65535;
}

Args make_args(const void* q, const void* k, const void* v, void* o,
               long long ld_in, long long ld_out, int S, int frames,
               int groups, float scale) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.ld_in = ld_in;
  a.ld_out = ld_out;
  a.S = S;
  a.frames = frames;
  a.groups = groups;
  a.ntiles = (S + kKeys - 1) / kKeys;
  a.scale = scale;
  return a;
}

}  // namespace

// lane, lane_nt, lane_par, lane_nomax, lane_nosm, lane_f{F}(_nosm), grid_h2:
// q, k, v, o contiguous [B, S, W], W = heads * 64.  mode: 0 max, 1 nomax,
// 2 none; transpose_k: K^T written into shared memory (lane, mode max only);
// frames: frames per block (B % frames == 0); heads_per_block: heads a block
// loops over (heads % heads_per_block == 0).
extern "C" int tspo_lane_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int W, int heads,
                                   int mode, int transpose_k, int frames,
                                   int heads_per_block, float scale, void* stream) {
  if (bad_shape(B, S, W, heads, frames, heads_per_block)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, o, W, W, S, frames, heads_per_block, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (transpose_k) {
    if (mode != kMax) return (int)cudaErrorInvalidValue;
    return launch<kMax, true, false>(a, B, W, heads_per_block, st);
  }
  switch (mode) {
    case kMax: return launch<kMax, false, false>(a, B, W, heads_per_block, st);
    case kNoMax: return launch<kNoMax, false, false>(a, B, W, heads_per_block, st);
    case kNone: return launch<kNone, false, false>(a, B, W, heads_per_block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// lane_packed: qkv contiguous [B, S, 3W] (q, k, v at column offsets 0, W,
// 2W), o contiguous [B, S, W]; all heads per block, mode max.
extern "C" int tspo_lane_packed_attention(const void* qkv, void* o, int B, int S,
                                          int W, int heads, float scale,
                                          void* stream) {
  if (bad_shape(B, S, W, heads, 1, heads)) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  const Args a = make_args(base, base + W, base + 2 * W, o, 3LL * W, W, S, 1,
                           heads, scale);
  return launch<kMax, false, false>(a, B, W, heads, static_cast<cudaStream_t>(stream));
}

// bdp2: q, k, v, o contiguous [B, S, W], an even number of heads of 64; all
// head pairs per block, K/V tiles packed block-diagonally, mode max.
extern "C" int tspo_bdp2_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int W, int heads,
                                   float scale, void* stream) {
  if (heads % 2 || bad_shape(B, S, W, heads, 1, heads)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, o, W, W, S, 1, heads / 2, scale);
  return launch<kMax, false, true>(a, B, W, heads, static_cast<cudaStream_t>(stream));
}
