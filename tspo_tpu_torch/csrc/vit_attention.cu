// Unmasked multi-head ViT attention over q, k, v in their natural GEMM layout
// [B, S, W], W = heads * hd, for Hopper (sm_90a).
//
// Replaces: tspo_tpu/ops/vit_attention.py::_lane_kernel (Pallas, TPU),
// launched by vit_attention at :71-77.  Same function: per head h, the lane
// slice [:, h*hd:(h+1)*hd] of each frame gives softmax(q k^T / sqrt(hd)) in
// fp32, the probabilities are cast to the input type and multiplied by v with
// fp32 accumulation; the output is [B, S, W] in the input type.  No
// [B, H, S, hd] transposes anywhere: every block reads its head's strided
// slice straight from [B, S, W].
//
// Bound on the H100 (data sheet: 3.35 TB/s, 989 TFLOP/s bf16):
//   * CLIP-L/14 (B=256, S=257, W=1024, 16 x 64): 4*B*S*W*2 B ~= 539 MB (q, k,
//     v read once, o written once) against 4*B*S^2*W ~= 69 GFLOP: ~129
//     FLOP/byte, under the ~295 FLOP/byte ridge, so bytes bound it: 0.161 ms.
//   * SigLIP-so400m (B=64, S=729, W=1152, 16 x 72): 157 GFLOP against 430 MB:
//     operations bound it, 0.158 ms (bytes 0.128 ms).
//
// Routes, chosen here from (dtype, hd) (vit_route):
//   * bf16, hd 64 and 72 -> vit_attention_wgmma_kernel (below), in one of two
//     forms chosen from (hd, S): "resident" for hd 64 and S <= 264 (CLIP),
//     "streamed" otherwise (SigLIP, and hd 64 at longer S).
//   * bf16, other hd (multiples of 8 up to 128) -> vit_attention_bf16_kernel,
//     the first Hopper form (mma.sync, cp.async), described next.
//   * fp32 (the parity path) -> vit_attention_f32_kernel.
//
// vit_attention_bf16_kernel and vit_attention_f32_kernel:
//   * The TPU kernel holds all of S in VMEM and does a one-shot softmax.  A
//     Hopper block has far less fast memory, so here one block handles one
//     (query tile of 64 rows, head, frame) and streams that head's K/V through
//     shared memory in key tiles with an online softmax kept in fp32.  q, k
//     and v are each read from device memory once per query tile; the query
//     tiles of one (head, frame) are neighbours in the grid, so their repeated
//     K/V reads mostly hit L2.
//   * bf16: 4 warps, 16 query rows each, mma.sync m16n8k16 (bf16 in, fp32
//     accumulate).  K/V tiles are copied with cp.async into two shared-memory
//     stages, so the next tile loads while this one is computed.  Both are
//     kept row-major; ldmatrix gives K's B fragments and ldmatrix.trans V's.
//     The S tile's accumulator fragment is reused directly as the A fragment
//     of P @ V, so P never leaves registers.  A warp whose 16 rows all lie
//     past S skips the arithmetic (the fifth query tile of S=257 has one row).
//   * fp32 (the parity path): one thread per query row, plain FMA, per-key
//     online softmax.  Full fp32 throughout; no TF32.
//   * Ragged tails are masked: keys past S are zero-filled and score -inf,
//     query rows past S are computed on zeros and never stored; head dims past
//     hd are zero-padded to a multiple of 16 in shared memory and registers,
//     never in device memory.
// Accepts any S, any hd that is a multiple of 8 up to 128.
//
// vit_attention_wgmma_kernel.  Both forms use wgmma.mma_async (bf16 in, fp32
// accumulate) for S = Q K^T and O += P V with P taken from the S accumulator
// fragment in registers; TMA boxes over the 4-D map (hd, heads, S, B) of each
// [B, S, W] tensor (rows past S in a frame and columns past hd in a head read
// as zero, never as the next frame's rows or the next head's columns);
// mbarrier full stages armed by a producer warp; a softmax in the log2
// domain, one FFMA and one ex2.approx.ftz a score, masked only in the tile
// that crosses S.
//   * resident (bytes bound: CLIP): one block of a consumer warpgroup and a
//     producer warp per (head, frame), two blocks an SM, so one block's
//     loads run under the other's products.  The producer loads the head's
//     whole K and V (keys 0-255 as one 256-row box, keys 256-271 as a
//     16-row tail box) and its four 64-row Q tiles once, so K/V are read
//     once per (frame, head),
//     not once per query tile.  The consumer warpgroup runs the query tiles
//     in turn, each with a one-shot softmax over all keys: S over keys 0-255
//     is one m64n256 product, the 257th key an m64n8 tail product; P V is
//     17 m64n64 k-steps.  Query rows past 256 (one at S=257) are computed on
//     CUDA cores by the producer warp from the same shared K/V while the
//     consumer runs its tiles, so no 64-row tile runs for one live row.
//   * streamed (operations bound: SigLIP): a persistent grid of one block
//     an SM; a work item is (128 query rows, head, frame).  As
//     flash_attention's wgmma kernel: a producer warpgroup (its registers
//     cut to 24 by setmaxnreg.dec, the consumers' raised to 240) keeps
//     a three-stage ring of 128-key K and V tiles full (full and empty
//     mbarriers), two consumer warpgroups of 64 rows each take turns at the
//     tensor cores (ping-pong on named barriers), S_j and P_{j-1} V_{j-1}
//     are issued together and the online softmax of tile j runs under
//     P_{j-1} V_{j-1}.  The producer loads the next item's Q (a second
//     slot) and K/V while the consumers finish and store this one.
//     hd = 72 (144 bytes)
//     is a 64-column box in the 128-byte swizzle plus an unswizzled 8-column
//     box (columns 64-71) beside 16-byte rows of zeros written once
//     (columns 72-79): Q K^T is 4 k-steps in the first layout and 1 in the
//     second, P V an n=64 and an n=16 product, and output columns 72-79 are
//     dropped.  Nothing is padded in device memory; the map's hd extent of
//     72 keeps every box inside its head.  (A 16-column box in the 32-byte
//     swizzle for columns 64-79 gave the same output 12% slower, and five
//     such boxes with one n=80 product 50% slower: PERF.md.)
// Tensor maps are built on the host for each launch with
// cuTensorMapEncodeTiled, reached through the CUDA runtime
// (cudaGetDriverEntryPoint), so the library links no libcuda; if one cannot
// be encoded the launch returns an error and nothing else runs.
//
// Plain C interface for ctypes: tspo_vit_attention returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for a shape it does not take);
// tspo_vit_attention_route names the kernel a (hd, dtype) launches;
// tspo_vit_attention_attributes reports the registers, shared memory and
// resident blocks per SM of the kernel (and form) a (hd, dtype, S) runs.

#include <cuda.h>          // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // query rows per block
constexpr int kKeysF32 = 32;    // keys per shared-memory tile (fp32 kernel)

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

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A: reg0 (row g, cols 2t..2t+1), reg1 (row g+8, cols 2t..), reg2 (row g,
//      cols 2t+8..), reg3 (row g+8, cols 2t+8..)
//   B: reg0 (k 2t..2t+1, col g), reg1 (k 2t+8..2t+9, col g)
//   C: c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8, cols 2t, 2t+1)
// HDP: hd rounded up to 16.  KEYS: keys per shared-memory tile, chosen so that
// two stages of K and V fit the 48 KB of static shared memory.
template <int HDP, int KEYS>
__global__ void __launch_bounds__(128)
vit_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          int S, int W, int hd, float scale) {
  // Row stride HDP + 8: rows stay 16-byte aligned and the 8 rows one ldmatrix
  // phase reads fall in 8 different groups of 4 banks.
  constexpr int LD = HDP + 8;
  constexpr int CHUNKS = HDP / 8;   // 16-byte chunks per key row
  __shared__ __align__(128) __nv_bfloat16 sK[2][KEYS * LD];
  __shared__ __align__(128) __nv_bfloat16 sV[2][KEYS * LD];

  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, row
  const size_t frame = (size_t)blockIdx.z * S * W;
  const int col0 = h * hd;
  const int wrow = blockIdx.x * kRows + warp * 16;
  const bool active = wrow < S;              // uniform across the warp
  const int r0 = wrow + g;                   // rows r0 and r0 + 8

  auto load_tile = [&](int k0, int buf) {
    for (int idx = threadIdx.x; idx < KEYS * CHUNKS; idx += blockDim.x) {
      const int key = idx / CHUNKS, d = (idx % CHUNKS) * 8;
      const bool ok = k0 + key < S && d < hd;
      const size_t off = ok ? frame + (size_t)(k0 + key) * W + col0 + d : 0;
      cp_async16(&sK[buf][key * LD + d], k + off, ok ? 16 : 0);
      cp_async16(&sV[buf][key * LD + d], v + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // Q fragments straight from device memory; rows >= S and dims >= hd are 0.
  uint32_t qa[HDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ((i & 1) ? 8 : 0);
      const int c = kk * 16 + t * 2 + ((i & 2) ? 8 : 0);
      uint32_t val = 0;
      if (row < S && c < hd)
        val = *reinterpret_cast<const uint32_t*>(q + frame + (size_t)row * W + col0 + c);
      qa[kk][i] = val;
    }
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[HDP / 8][4];
#pragma unroll
  for (int dn = 0; dn < HDP / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int ntiles = (S + KEYS - 1) / KEYS;
  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1, k0 = j * KEYS;
    if (j + 1 < ntiles) {
      load_tile(k0 + KEYS, buf ^ 1);   // that stage was released at the end of j-1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile j is in shared memory for every thread

    if (active) {
      const __nv_bfloat16* tK = sK[buf];
      const __nv_bfloat16* tV = sV[buf];

      // S = Q K^T for this warp's 16 rows x KEYS keys.  One ldmatrix_x4
      // gives the B fragments of key blocks n and n + 1 for one 16-dim slice.
      float s[KEYS / 8][4];
#pragma unroll
      for (int n = 0; n < KEYS / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int n = 0; n < KEYS / 8; n += 2) {
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          uint32_t b[4];
          ldmatrix_x4(b, tK + ((n + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
          mma_bf16(s[n], qa[kk], b);
          mma_bf16(s[n + 1], qa[kk], b + 2);
        }
      }

      // Online softmax in fp32; keys >= S score -inf.
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < KEYS / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + n * 8 + t * 2 + (i & 1);
          const float x = key < S ? s[n][i] * scale : -INFINITY;
          s[n][i] = x;
          tmax[i >> 1] = fmaxf(tmax[i >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float mn = fmaxf(m[r], tmax[r]);   // finite: the tile has a key < S
        alpha[r] = expf(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < KEYS / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = expf(s[n][i] - m[i >> 1]);
          l[i >> 1] += p;
          s[n][i] = p;
        }
      }
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }

      // O += P V, with P (cast to bf16) taken straight from the S fragments.
      // One ldmatrix_x4_trans gives the B fragments of dim blocks dn, dn + 1.
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dn = 0; dn < HDP / 8; dn += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, tV + (kk * 16 + (lm & 1) * 8 + lr) * LD + (dn + (lm >> 1)) * 8);
          mma_bf16(acc[dn], pa, b);
          mma_bf16(acc[dn + 1], pa, b + 2);
        }
      }
    }
    __syncthreads();   // every warp is done with stage buf before it is refilled
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
  for (int dn = 0; dn < HDP / 8; ++dn) {
    const int d = dn * 8 + t * 2;
    if (d >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o + frame + (size_t)r0 * W + col0 + d) =
          pack_bf16(acc[dn][0] * inv0, acc[dn][1] * inv0);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(o + frame + (size_t)(r0 + 8) * W + col0 + d) =
          pack_bf16(acc[dn][2] * inv1, acc[dn][3] * inv1);
  }
}

// fp32: one thread per query row, 64 rows per block, K/V tiles of 32 keys.
template <int HDP>
__global__ void __launch_bounds__(64)
vit_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int W, int hd, float scale) {
  __shared__ float sK[kKeysF32 * HDP];
  __shared__ float sV[kKeysF32 * HDP];

  const size_t frame = (size_t)blockIdx.z * S * W;
  const int col0 = blockIdx.y * hd;
  const int row = blockIdx.x * kRows + threadIdx.x;

  float qr[HDP], acc[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) {
    qr[d] = (row < S && d < hd) ? q[frame + (size_t)row * W + col0 + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kKeysF32) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kKeysF32 * HDP; idx += blockDim.x) {
      const int key = idx / HDP, d = idx % HDP;
      const bool ok = k0 + key < S && d < hd;
      const size_t off = frame + (size_t)(k0 + key) * W + col0 + d;
      sK[idx] = ok ? k[off] : 0.f;
      sV[idx] = ok ? v[off] : 0.f;
    }
    __syncthreads();
    const int nk = min(kKeysF32, S - k0);
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HDP; ++d) dot = fmaf(qr[d], sK[j * HDP + d], dot);
      const float x = dot * scale;
      const float mn = fmaxf(m, x);
      const float a = expf(m - mn);
      const float p = expf(x - mn);
      m = mn;
      l = l * a + p;
#pragma unroll
      for (int d = 0; d < HDP; ++d) acc[d] = fmaf(p, sV[j * HDP + d], acc[d] * a);
    }
  }
  if (row < S) {
    const float inv = 1.f / l;
    for (int d = 0; d < hd; ++d) o[frame + (size_t)row * W + col0 + d] = acc[d] * inv;
  }
}


// ---------------------------------------------------------------------------
// vit_attention_wgmma_kernel: bf16, hd 64 or 72 (see the note at the top).

constexpr int kBoxCols = 64;        // hd columns of a 128-byte-swizzled box
constexpr int kTailCols = 8;        // hd 72: columns 64-71 of an unswizzled box
constexpr int kResKeys = 256;       // keys of the resident form's main K/V box
constexpr int kResTail = 16;        // rows of its tail boxes (keys 256-271)
constexpr int kResMaxS = kResKeys + 8;   // the m64n8 tail product: keys 256-263
constexpr int kResThreads = 160;    // one consumer warpgroup + a producer warp
constexpr int kStConsumers = 2;     // consumer warpgroups a streamed block, 64 query rows each
constexpr int kStRows = 64 * kStConsumers;   // query rows a streamed work item
constexpr int kStKeys = 128;        // keys a streamed K/V stage
constexpr int kStages = 3;          // streamed K/V ring depth
constexpr int kStThreads = 128 * (kStConsumers + 1);  // the consumers, then the producer
// Registers: every thread starts at 168 (384 threads, one block an SM); the
// producer warpgroup drops to 24 (setmaxnreg.dec) and the two consumer
// warpgroups take up exactly what it gave back (setmaxnreg.inc to 240).
// (A lone producer warp frees too little for that: the launch allocation
// stays 168 a thread, and an unbalanced setmaxnreg.inc faults.)
static_assert(kStConsumers == 2, "setmaxnreg's 24 / 240 split is for two consumers");

enum Form { kResident = 0, kStreamed = 1 };

struct WgParams {
  const void* q;                    // read directly only by the resident tail rows
  void* o;
  int B, S, W, heads;
  float scale2;                     // (1 / sqrt(hd)) * log2(e)
};

// The maps of one launch.  Resident: q (64-row boxes), k and v (256-row
// boxes), kt and vt (16-row tail boxes at key 256); qt unused.  Streamed: q,
// k, v (128-row boxes of hd columns 0-63) and, at hd 72, qt, kt, vt (128-row
// unswizzled boxes of columns 64-71).
struct Maps {
  CUtensorMap q, k, v, qt, kt, vt;
};

// Byte offsets in shared memory (from a 1024-byte aligned base: the 128-byte
// swizzle repeats every 8 rows of 128 bytes).
struct ResSmem {
  static constexpr int kQ = 0;                         // 4 x [64 rows][128 B]
  static constexpr int kK = 4 * 64 * 128;              // [256 rows][128 B]
  static constexpr int kKTail = kK + kResKeys * 128;   // [16 rows][128 B]: rows 256-271
  static constexpr int kV = kKTail + kResTail * 128;
  static constexpr int kVTail = kV + kResKeys * 128;
  static constexpr int kQRow = kVTail + kResTail * 128;   // fp32 q row of a tail row
  static constexpr int kP = kQRow + 64 * 4;            // its fp32 probabilities
  static constexpr int kBar = kP + (kResKeys + kResTail) * 4;   // q_full[4], k_full, v_full
  static constexpr int kBytes = kBar + 8 * 6 + 1024;   // + alignment slack
};

// A tile of `rows` rows: columns 0-63 in the 128-byte swizzle, then at hd 72
// columns 64-71 (16 bytes a row, no swizzle), then 72-79 (zeros).
template <int HD, int ROWS>
struct StTile {
  static constexpr int kBoxA = ROWS * 128;
  static constexpr int kBoxB = HD > kBoxCols ? ROWS * 16 : 0;
  static constexpr int kBytes = kBoxA + 2 * kBoxB;
  static constexpr int kLoad = kBoxA + kBoxB;                  // bytes TMA writes
};

template <int HD>
struct StSmem {
  using Q = StTile<HD, kStRows>;
  using KV = StTile<HD, kStKeys>;
  static constexpr int kBoxA = KV::kBoxA;
  static constexpr int kBoxB = KV::kBoxB;
  static constexpr int kTile = KV::kBytes;
  static constexpr int kQ = 0;                                 // [2] Q slots
  static constexpr int kK = 2 * Q::kBytes;                     // [kStages] K tiles
  static constexpr int kV = kK + kStages * kTile;              // [kStages] V tiles
  static constexpr int kBar = kV + kStages * kTile;            // 4 + 4 * kStages mbarriers
  static constexpr int kBytes = kBar + 8 * (4 + 4 * kStages) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// One TMA box of a 4-D map at coordinates (col, head, row, frame) into
// shared memory; its bytes complete on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col,
                                         int head, int row, int frame, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head),
         "r"(row), "r"(frame), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout 1 = 128-byte swizzle, 0 = none.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                             uint32_t layout = 1) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// hd 72's columns 64-79, unswizzled: 8-row x 16-byte core matrices, with
// columns 72-79 (zeros) `zeros` bytes after columns 64-71.  As the K-major
// operand of Q K^T at rows `rows`: 8 rows a core matrix, the next 8 rows
// 128 bytes on (stride byte offset), columns 72-79 at the leading byte
// offset.  As the MN-major V operand of k-step kk of P V: 8 keys a core
// matrix, the next 8 keys 128 bytes on (leading), columns 72-79 at the
// stride byte offset.
__device__ __forceinline__ uint64_t tail_desc_k(uint32_t rows, uint32_t zeros) {
  return smem_desc(rows, zeros, 128, 0);
}

__device__ __forceinline__ uint64_t tail_desc_v(uint32_t box, int kk, uint32_t zeros) {
  return smem_desc(box + kk * 16 * 16, 128, zeros, 0);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 2^x on the SFU, denormal results flushed to 0 (x = -inf gives 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barrier over two consumer warpgroups (256 threads): wait for,
// or signal, a warpgroup's turn at the tensor cores.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Keeps the compiler from moving reads of accumulators across wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F8(d, i) WG_F4(d, i), WG_F4(d, i + 4)
#define WG_F32(d, i) WG_F8(d, i), WG_F8(d, i + 8), WG_F8(d, i + 16), WG_F8(d, i + 24)

// D[64xN] (+)= A[64x16] B[16xN]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32), WG_F32(d, 64), WG_F32(d, 96)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : WG_F4(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64xN] += A[64x16] B[16xN]: A from registers, B from shared memory
// MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_F32
#undef WG_F8
#undef WG_F4

// Accumulator fragment of wgmma m64nN (per warp w of the warpgroup, g = lane
// / 4, t = lane % 4): d[4i + e] is row 16w + g + (e & 2 ? 8 : 0), column 8i +
// 2t + (e & 1) -- the m16n8k16 C layout of each 8-column block, so the
// pairs (d[8kk], d[8kk+1]), (d[8kk+2], d[8kk+3]), (d[8kk+4], d[8kk+5]),
// (d[8kk+6], d[8kk+7]) are the A fragment of k-step kk of the next product.

// One query row r in [256, S) of the resident form, on CUDA cores by one
// warp, from the K/V the block holds in shared memory (rows 0-271 of each
// are contiguous, 128 bytes a row, in the 128-byte swizzle: the 16-byte
// chunk c of row j sits at chunk c ^ (j % 8)).  Same numerics as the
// consumer's tiles: fp32 dot products, the log2-domain softmax, bf16
// probabilities, fp32 P V, division by the fp32 row sum.
__device__ __forceinline__ void resident_tail_row(const WgParams& p, const unsigned char* smem, int r,
                                  int h, int frame, int lane) {
  float* qrow = reinterpret_cast<float*>(const_cast<unsigned char*>(smem) + ResSmem::kQRow);
  float* pbuf = reinterpret_cast<float*>(const_cast<unsigned char*>(smem) + ResSmem::kP);
  const unsigned char* ks = smem + ResSmem::kK;
  const unsigned char* vs = smem + ResSmem::kV;
  const size_t row_off = ((size_t)frame * p.S + r) * p.W + (size_t)h * 64 + 2 * lane;
  const __nv_bfloat162 q2 =
      *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(p.q) + row_off);
  qrow[2 * lane] = __low2float(q2);
  qrow[2 * lane + 1] = __high2float(q2);
  __syncwarp();
  constexpr int kPer = (kResMaxS + 31) / 32;     // keys a lane: j = lane + 32 i
  float s[kPer];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    float dot = -INFINITY;
    if (j < p.S) {
      dot = 0.f;
#pragma unroll 2
      for (int c = 0; c < 8; ++c) {
        const uint4 kc = *reinterpret_cast<const uint4*>(ks + j * 128 + ((c ^ (j & 7)) << 4));
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kc);
        const float4 qa = *reinterpret_cast<const float4*>(qrow + 8 * c);
        const float4 qb = *reinterpret_cast<const float4*>(qrow + 8 * c + 4);
        dot = fmaf(qa.x, __low2float(k2[0]), dot);
        dot = fmaf(qa.y, __high2float(k2[0]), dot);
        dot = fmaf(qa.z, __low2float(k2[1]), dot);
        dot = fmaf(qa.w, __high2float(k2[1]), dot);
        dot = fmaf(qb.x, __low2float(k2[2]), dot);
        dot = fmaf(qb.y, __high2float(k2[2]), dot);
        dot = fmaf(qb.z, __low2float(k2[3]), dot);
        dot = fmaf(qb.w, __high2float(k2[3]), dot);
      }
    }
    s[i] = dot;
    mx = fmaxf(mx, dot);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m = mx * p.scale2;
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    if (j < p.S) {
      const float pr = exp2_ftz(fmaf(s[i], p.scale2, -m));
      l += pr;
      pbuf[j] = __bfloat162float(__float2bfloat16_rn(pr));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  __syncwarp();
  // lane owns output columns 2 lane, 2 lane + 1: 4 bytes of 16-byte chunk lane / 4
  float a0 = 0.f, a1 = 0.f;
  for (int j = 0; j < p.S; ++j) {
    const float pj = pbuf[j];
    const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
        vs + j * 128 + (((lane >> 2) ^ (j & 7)) << 4) + (lane & 3) * 4);
    a0 = fmaf(pj, __low2float(v2), a0);
    a1 = fmaf(pj, __high2float(v2), a1);
  }
  const float inv = 1.f / l;
  *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.o) + row_off) =
      pack_bf16(a0 * inv, a1 * inv);
  __syncwarp();                      // qrow and pbuf are free for the next row
}

// Resident form: grid (heads, B), 160 threads (warps 0-3 the consumer
// warpgroup, warp 4 the producer), two blocks an SM.  No setmaxnreg: ptxas
// compiles the whole kernel to the launch bounds' budget (204 registers at
// two 160-thread blocks an SM), which the m64n256 accumulator needs.
__device__ __forceinline__ void resident_body(const Maps& mp, const WgParams& p,
                                              unsigned char* smem, uint32_t base) {
  using L = ResSmem;
  const uint32_t bar = base + L::kBar;
  auto q_full = [&](int i) { return bar + 8 * i; };
  const uint32_t k_full = bar + 32, v_full = bar + 40;
  const int h = blockIdx.x, frame = blockIdx.y;
  const int S = p.S;
  const int n_tiles = min(4, (S + 63) / 64);     // 64-row query tiles on the tensor cores
  const bool tail = S > kResKeys;                // keys and rows 256 .. S-1

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(q_full(i), 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer warp: lane 0 issues every load, then the warp computes the
    // query rows past 256.
    const int lane = threadIdx.x % 32;
    const uint32_t kv_bytes = kResKeys * 128 + (tail ? kResTail * 128 : 0);
    if (lane == 0) {
      mbar_expect_tx(k_full, kv_bytes);
      tma_load(base + L::kK, &mp.k, 0, h, 0, frame, k_full);
      if (tail) tma_load(base + L::kKTail, &mp.kt, 0, h, kResKeys, frame, k_full);
      mbar_expect_tx(q_full(0), 64 * 128);
      tma_load(base + L::kQ, &mp.q, 0, h, 0, frame, q_full(0));
      mbar_expect_tx(v_full, kv_bytes);
      tma_load(base + L::kV, &mp.v, 0, h, 0, frame, v_full);
      if (tail) tma_load(base + L::kVTail, &mp.vt, 0, h, kResKeys, frame, v_full);
      for (int i = 1; i < n_tiles; ++i) {
        mbar_expect_tx(q_full(i), 64 * 128);
        tma_load(base + L::kQ + i * 64 * 128, &mp.q, 0, h, 64 * i, frame, q_full(i));
      }
    }
    __syncwarp();
    if (tail) {
      mbar_wait(k_full, 0);
      mbar_wait(v_full, 0);
      for (int r = kResKeys; r < S; ++r) resident_tail_row(p, smem, r, h, frame, lane);
    }
  } else {
    // Consumer warpgroup (warps 0-3): the 64-row query tiles in turn.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    float sacc[128];          // S over keys 0-255, then its probabilities
    float tacc[4] = {0.f, 0.f, 0.f, 0.f};   // S over keys 256-263 (tail)
    float o[32];
    uint32_t pa[16][4];       // P as bf16 A fragments of P V, keys 0-255
    uint32_t pt[4];           // keys 256-271
    mbar_wait(k_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const uint32_t q_tile = base + L::kQ + i * 64 * 128;
      mbar_wait(q_full(i), 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n256(sacc, smem_desc(q_tile + kk * 32, 16, 1024),
                      smem_desc(base + L::kK + kk * 32, 16, 1024), kk > 0);
      if (tail) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n8(tacc, smem_desc(q_tile + kk * 32, 16, 1024),
                      smem_desc(base + L::kKTail + kk * 32, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(tacc);

      // one-shot softmax over the row's keys; keys past S score -inf
      if (S < kResKeys) {
#pragma unroll
        for (int e = 0; e < 128; ++e)
          if ((e >> 2) * 8 + t * 2 + (e & 1) >= S) sacc[e] = -INFINITY;
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 128; ++e) tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], sacc[e]);
      if (tail) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kResKeys + t * 2 + (e & 1) >= S) tacc[e] = -INFINITY;
          tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], tacc[e]);
        }
      }
      float m[2], l[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        m[r] = tmax[r] * p.scale2;   // finite: every row has key 0
      }
#pragma unroll
      for (int e = 0; e < 128; ++e) {
        const int r = (e >> 1) & 1;
        const float pr = exp2_ftz(fmaf(sacc[e], p.scale2, -m[r]));
        l[r] += pr;
        sacc[e] = pr;
      }
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      if (tail) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (e >> 1) & 1;
          tacc[e] = exp2_ftz(fmaf(tacc[e], p.scale2, -m[r]));
          l[r] += tacc[e];
        }
        pt[0] = pack_bf16(tacc[0], tacc[1]);   // keys 256 + 2t.., row g
        pt[1] = pack_bf16(tacc[2], tacc[3]);   // row g + 8
        pt[2] = pt[3] = 0u;                    // keys 264-271: none live
      }

      // O = P V over the live 16-key steps
      if (i == 0) mbar_wait(v_full, 0);
#pragma unroll
      for (int e = 0; e < 32; ++e) o[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        if (kk * 16 < S)
          wgmma_rs_n64(o, pa[kk], smem_desc(base + L::kV + kk * 16 * 128, 8192, 1024));
      if (tail) wgmma_rs_n64(o, pt, smem_desc(base + L::kVTail, 8192, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
      const int ra = 64 * i + 16 * warp + g;
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) +
                          (size_t)frame * S * p.W + (size_t)h * 64;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int d = c * 8 + t * 2;
        if (ra < S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)ra * p.W + d) =
              pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
        if (ra + 8 < S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)(ra + 8) * p.W + d) =
              pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
      }
    }
  }
}

// Streamed form: a persistent grid of one block an SM (two consumer
// warpgroups, then the producer warpgroup); block i takes work items i,
// i + grid, ... where an item is (kStRows query rows, head, frame), the
// query tiles of one (frame, head) next to each other.  The producer runs
// ahead into the next item (its Q in a second slot, its K/V tiles through
// the same ring) while the consumers finish this one and store it.
template <int HD>
__device__ __forceinline__ void streamed_body(const Maps& mp, const WgParams& p,
                                              uint32_t base) {
  using L = StSmem<HD>;
  constexpr bool kTailBox = HD > kBoxCols;        // hd 72: columns 64-79 in a second box
  constexpr int kOut = kTailBox ? 40 : 32;        // fp32 output accumulators a thread
  // mbarriers: per Q slot full, empty; per K/V stage K full, V full, K empty, V empty
  const uint32_t bar = base + L::kBar;
  auto q_full = [&](int s) { return bar + 8 * s; };
  auto q_empty = [&](int s) { return bar + 8 * (2 + s); };
  auto k_full = [&](int s) { return bar + 8 * (4 + s); };
  auto v_full = [&](int s) { return bar + 8 * (4 + kStages + s); };
  auto k_empty = [&](int s) { return bar + 8 * (4 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (4 + 3 * kStages + s); };

  const int S = p.S;
  const int n = (S + kStKeys - 1) / kStKeys;      // key tiles an item; the last may cross S
  const int q_tiles = (S + kStRows - 1) / kStRows;
  const int items = q_tiles * p.heads * p.B;
  // item -> (first query row, head, frame)
  auto decode = [&](int item, int& q0, int& h, int& frame) {
    q0 = (item % q_tiles) * kStRows;
    h = (item / q_tiles) % p.heads;
    frame = item / q_tiles / p.heads;
  };

  if constexpr (kTailBox) {
    // columns 72-79 of every Q slot and K/V stage: zeros, never loaded
    auto zero = [&](uint32_t at, int bytes) {
      for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" :: "r"(at + i), "r"(0)
                     : "memory");
    };
    for (int b = 0; b < 2; ++b)
      zero(base + L::kQ + b * L::Q::kBytes + L::Q::kBoxA + L::Q::kBoxB, L::Q::kBoxB);
    for (int b = 0; b < 2 * kStages; ++b)
      zero(base + L::kK + b * L::kTile + L::kBoxA + L::kBoxB, L::kBoxB);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), 4 * kStConsumers);    // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * kStConsumers);
      mbar_init(v_empty(s), 4 * kStConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kStConsumers) {
    // Producer warpgroup: one thread keeps the Q slots and the K/V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kStConsumers) {
      int q0, h, frame;
      auto load = [&](uint32_t dst, const CUtensorMap* a, const CUtensorMap* b, int row,
                      uint32_t full, int box_a, int bytes) {
        mbar_expect_tx(full, bytes);
        tma_load(dst, a, 0, h, row, frame, full);
        if constexpr (kTailBox) tma_load(dst + box_a, b, kBoxCols, h, row, frame, full);
      };
      int tile = 0;                                // K/V tiles loaded so far
      for (int item = blockIdx.x, local = 0; item < items; item += gridDim.x, ++local) {
        decode(item, q0, h, frame);
        const int qs = local & 1, quse = local >> 1;
        if (quse > 0) mbar_wait(q_empty(qs), (quse - 1) & 1);
        load(base + L::kQ + qs * L::Q::kBytes, &mp.q, &mp.qt, q0, q_full(qs), L::Q::kBoxA,
             L::Q::kLoad);
        for (int j = 0; j < n; ++j, ++tile) {
          const int s = tile % kStages, use = tile / kStages;
          if (use > 0) mbar_wait(k_empty(s), (use - 1) & 1);
          load(base + L::kK + s * L::kTile, &mp.k, &mp.kt, j * kStKeys, k_full(s), L::kBoxA,
               L::KV::kLoad);
          if (use > 0) mbar_wait(v_empty(s), (use - 1) & 1);
          load(base + L::kV + s * L::kTile, &mp.v, &mp.vt, j * kStKeys, v_full(s), L::kBoxA,
               L::KV::kLoad);
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows of each item each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;

    float o[kOut];           // output columns 0-63, then 64-79 at hd 72 (72-79 dropped)
    float m[2], l[2];
    float sacc[64];          // S of one tile, then its probabilities
    uint32_t pa[8][4];       // P of one tile as bf16 A fragments of P V
    int tile0 = 0;           // ring position of this item's first K/V tile
    uint32_t q_rows = 0, q_rows_b = 0;
    auto stage = [&](int j) { return (tile0 + j) % kStages; };
    auto parity = [&](int j) { return (uint32_t)((tile0 + j) / kStages) & 1u; };

    // S = Q K_j^T: 4 k-steps of 16 columns (32 bytes inside the 128-byte
    // swizzle atom), then at hd 72 one k-step over columns 64-79 (the
    // unswizzled box and its zeros): issued and committed, not waited for.
    auto issue_qk = [&](int j) {
      const uint32_t k_tile = base + L::kK + stage(j) * L::kTile;
      mbar_wait(k_full(stage(j)), parity(j));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128(sacc, smem_desc(q_rows + kk * 32, 16, 1024),
                      smem_desc(k_tile + kk * 32, 16, 1024), kk > 0);
      if constexpr (kTailBox)
        wgmma_ss_n128(sacc, tail_desc_k(q_rows_b, L::Q::kBoxB),
                      tail_desc_k(k_tile + L::kBoxA, L::kBoxB), 1);
      wgmma_commit();
    };

    // O += P V_j over the 128 keys in k-steps of 16 (16 rows: 2 KB of box A,
    // 256 bytes of the unswizzled box): issued and committed, not waited for.
    auto issue_pv = [&](int j) {
      const uint32_t v_tile = base + L::kV + stage(j) * L::kTile;
      mbar_wait(v_full(stage(j)), parity(j));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if constexpr (kTailBox) {
          wgmma_rs_n64(reinterpret_cast<float(&)[32]>(o[0]), pa[kk],
                       smem_desc(v_tile + kk * 16 * 128, L::kBoxA, 1024));
          wgmma_rs_n16(reinterpret_cast<float(&)[8]>(o[32]), pa[kk],
                       tail_desc_v(v_tile + L::kBoxA, kk, L::kBoxB));
        } else {
          wgmma_rs_n64(o, pa[kk], smem_desc(v_tile + kk * 16 * 128, L::kBoxA, 1024));
        }
      }
      wgmma_commit();
    };

    // Online softmax of tile j on sacc in the log2 domain; alpha rescales what
    // O held before this tile.  Keys past S (only in the last tile) score
    // -inf, so their probability is exactly 0; the running max starts at
    // -inf and is finite after the first tile (key 0 is live).
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = j * kStKeys;
      if (k0 + kStKeys > S) {
#pragma unroll
        for (int e = 0; e < 64; ++e)
          if (k0 + (e >> 2) * 8 + t * 2 + (e & 1) >= S) sacc[e] = -INFINITY;
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 64; ++e) tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], sacc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float mn = fmaxf(m[r], tmax[r] * p.scale2);
        alpha[r] = exp2_ftz(m[r] - mn);             // m = -inf at tile 0: alpha = 0
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e >> 1) & 1;
        const float pr = exp2_ftz(fmaf(sacc[e], p.scale2, -m[r]));
        l[r] += pr;
        sacc[e] = pr;
      }
    };

    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };

    // Within an item, pipelined as flash_attention's wgmma kernel: S_j and
    // P_{j-1} V_{j-1} go to the tensor cores together, the softmax of tile j
    // runs while P_{j-1} V_{j-1} is still in them, and the two warpgroups
    // take turns to issue (named barrier 3 + c is warpgroup c's turn),
    // warpgroup 0 first; each has n + 1 issue points an item, and warpgroup
    // 1 passes no turn after its last, so every item starts as the first.
    auto take_turn = [&]() { turn_wait(3 + c); };
    for (int item = blockIdx.x, local = 0; item < items; item += gridDim.x, ++local) {
      int q0, h, frame;
      decode(item, q0, h, frame);
      const int qs = local & 1;
      q_rows = base + L::kQ + qs * L::Q::kBytes + c * 64 * 128;
      q_rows_b = base + L::kQ + qs * L::Q::kBytes + L::Q::kBoxA + c * 64 * 16;
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      int turns_left = n + 1;
      auto pass_turn = [&]() {
        if (c != kStConsumers - 1 || --turns_left > 0) turn_pass(3 + (c + 1) % kStConsumers);
      };

      mbar_wait(q_full(qs), (uint32_t)(local >> 1) & 1u);
      if (c == kStConsumers - 1) turn_pass(3);
      float alpha[2];
      take_turn();
      issue_qk(0);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sacc);
      if (lane == 0) mbar_arrive(k_empty(stage(0)));
      softmax(0, alpha);                    // O is still 0: nothing to rescale
      pack_p();
      for (int j = 1; j < n; ++j) {
        take_turn();
        issue_qk(j);
        issue_pv(j - 1);
        pass_turn();
        wgmma_wait<1>();                    // S_j is in; P_{j-1} V_{j-1} may not be
        fence_regs(sacc);
        if (lane == 0) mbar_arrive(k_empty(stage(j)));
        softmax(j, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(v_empty(stage(j - 1)));
#pragma unroll
        for (int e = 0; e < kOut; ++e) o[e] *= alpha[(e >> 1) & 1];
        pack_p();
      }
      if (lane == 0) mbar_arrive(q_empty(qs));   // every S of the item is in
      take_turn();
      issue_pv(n - 1);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty(stage(n - 1)));
      tile0 += n;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + (size_t)frame * S * p.W +
                          (size_t)h * HD;
      const int ra = q0 + 64 * c + 16 * warp + g;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int d = i * 8 + t * 2;
        const float x0 = o[4 * i], x1 = o[4 * i + 1], x2 = o[4 * i + 2], x3 = o[4 * i + 3];
        if (ra < S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)ra * p.W + d) =
              pack_bf16(x0 * inv0, x1 * inv0);
        if (ra + 8 < S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)(ra + 8) * p.W + d) =
              pack_bf16(x2 * inv1, x3 * inv1);
      }
    }
  }
}

template <int HD, int FORM>
__global__ void __launch_bounds__(FORM == kResident ? kResThreads : kStThreads,
                                  FORM == kResident ? 2 : 1)
vit_attention_wgmma_kernel(const __grid_constant__ Maps maps, WgParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];   // aligned below
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  if constexpr (FORM == kResident) resident_body(maps, p, smem, base);
  else streamed_body<HD>(maps, p, base);
}

// ---------------------------------------------------------------------------
// Host side.

enum Route { kRouteWgmma = 0, kRouteMmaSync = 1, kRouteFma = 2 };

// The kernel a (hd, dtype) launches, or -1 for a head dim the source does not
// take; the wgmma kernel's form follows from (hd, S) (wgmma_form).
int vit_route(int hd, int is_bf16) {
  if (hd <= 0 || hd % 8 != 0 || hd > 128) return -1;
  if (!is_bf16) return kRouteFma;
  return hd == 64 || hd == 72 ? kRouteWgmma : kRouteMmaSync;
}

int wgmma_form(int hd, int S) { return hd == 64 && S <= kResMaxS ? kResident : kStreamed; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                  cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// 4-D map (hd, heads, S, B) of a [B, S, heads * hd] bf16 tensor, read in
// boxes of `cols` x `rows`; rows past S and columns past hd read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B,
              int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t es = sizeof(__nv_bfloat16);
  const cuuint64_t row_b = (cuuint64_t)heads * hd * es;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {hd * es, row_b, row_b * S};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The streamed form's persistent grid: one block an SM of the current
// device, or one a work item where there are fewer.
int streamed_grid(int S, int heads, int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const long long items = (long long)((S + kStRows - 1) / kStRows) * heads * B;
  return (int)(items < sms ? items : sms);
}

template <int HD, int FORM>
constexpr int wgmma_smem() {
  return FORM == kResident ? ResSmem::kBytes : StSmem<HD>::kBytes;
}

template <int HD, int FORM>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                         int S, int heads, float scale, cudaStream_t st) {
  Maps mp;
  const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  bool ok;
  if (FORM == kResident) {
    ok = make_map(&mp.q, q, HD, heads, S, B, kBoxCols, 64, sw128) &&
         make_map(&mp.k, k, HD, heads, S, B, kBoxCols, kResKeys, sw128) &&
         make_map(&mp.v, v, HD, heads, S, B, kBoxCols, kResKeys, sw128) &&
         make_map(&mp.kt, k, HD, heads, S, B, kBoxCols, kResTail, sw128) &&
         make_map(&mp.vt, v, HD, heads, S, B, kBoxCols, kResTail, sw128);
    mp.qt = mp.q;
  } else {
    ok = make_map(&mp.q, q, HD, heads, S, B, kBoxCols, kStRows, sw128) &&
         make_map(&mp.k, k, HD, heads, S, B, kBoxCols, kStKeys, sw128) &&
         make_map(&mp.v, v, HD, heads, S, B, kBoxCols, kStKeys, sw128);
    if (HD > kBoxCols) {
      const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
      ok = ok && make_map(&mp.qt, q, HD, heads, S, B, kTailCols, kStRows, none) &&
           make_map(&mp.kt, k, HD, heads, S, B, kTailCols, kStKeys, none) &&
           make_map(&mp.vt, v, HD, heads, S, B, kTailCols, kStKeys, none);
    } else {
      mp.qt = mp.q, mp.kt = mp.k, mp.vt = mp.v;
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  const WgParams p{q, o, B, S, heads * HD, heads, scale * 1.4426950408889634f};
  const int smem = wgmma_smem<HD, FORM>();
  const cudaError_t e = set_smem(vit_attention_wgmma_kernel<HD, FORM>, smem);
  if (e != cudaSuccess) return e;
  if (FORM == kResident)
    vit_attention_wgmma_kernel<HD, FORM><<<dim3(heads, B), kResThreads, smem, st>>>(mp, p);
  else
    vit_attention_wgmma_kernel<HD, FORM><<<streamed_grid(S, heads, B), kStThreads, smem,
                                           st>>>(mp, p);
  return cudaGetLastError();
}

cudaError_t launch_wgmma_route(const void* q, const void* k, const void* v, void* o,
                               int B, int S, int heads, int hd, float scale,
                               cudaStream_t st) {
  if (wgmma_form(hd, S) == kResident)
    return launch_wgmma<64, kResident>(q, k, v, o, B, S, heads, scale, st);
  return hd == 64 ? launch_wgmma<64, kStreamed>(q, k, v, o, B, S, heads, scale, st)
                  : launch_wgmma<72, kStreamed>(q, k, v, o, B, S, heads, scale, st);
}

template <int HDP>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S,
            int W, int heads, int hd, float scale, int is_bf16, cudaStream_t st) {
  const dim3 grid((S + kRows - 1) / kRows, heads, B);
  if (is_bf16) {
    constexpr int keys = HDP <= 80 ? 64 : 32;
    vit_attention_bf16_kernel<HDP, keys><<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, W,
        hd, scale);
  } else {
    vit_attention_f32_kernel<HDP><<<grid, 64, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, W, hd, scale);
  }
}

// Registers a thread, shared memory a block (static + the dynamic bytes a
// launch requests) and resident blocks an SM of one kernel.
template <typename Kernel>
cudaError_t attributes(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes + smem;
  out[2] = blocks;
  out[3] = threads;
  return cudaSuccess;
}

template <int HDP>
cudaError_t attributes_simple(int is_bf16, int* out) {
  constexpr int keys = HDP <= 80 ? 64 : 32;
  return is_bf16 ? attributes(vit_attention_bf16_kernel<HDP, keys>, 128, 0, out)
                 : attributes(vit_attention_f32_kernel<HDP>, 64, 0, out);
}

}  // namespace

extern "C" int tspo_vit_attention_route(int hd, int is_bf16) {
  return vit_route(hd, is_bf16);
}

// out[5]: registers per thread at launch, shared memory per block (bytes),
// resident blocks per SM, threads per block of the kernel a (hd, dtype, S)
// runs, and its form (0 resident, 1 streamed; -1 for the other kernels).
extern "C" int tspo_vit_attention_attributes(int hd, int is_bf16, int S, int* out) {
  const int route = vit_route(hd, is_bf16);
  if (route < 0 || S <= 0) return (int)cudaErrorInvalidValue;
  out[4] = -1;
  if (route == kRouteWgmma) {
    const int form = wgmma_form(hd, S);
    out[4] = form;
    if (form == kResident)
      return (int)attributes(vit_attention_wgmma_kernel<64, kResident>, kResThreads,
                             wgmma_smem<64, kResident>(), out);
    return hd == 64 ? (int)attributes(vit_attention_wgmma_kernel<64, kStreamed>, kStThreads,
                                      wgmma_smem<64, kStreamed>(), out)
                    : (int)attributes(vit_attention_wgmma_kernel<72, kStreamed>, kStThreads,
                                      wgmma_smem<72, kStreamed>(), out);
  }
  switch ((hd + 15) / 16 * 16) {
    case 16:  return (int)attributes_simple<16>(is_bf16, out);
    case 32:  return (int)attributes_simple<32>(is_bf16, out);
    case 48:  return (int)attributes_simple<48>(is_bf16, out);
    case 64:  return (int)attributes_simple<64>(is_bf16, out);
    case 80:  return (int)attributes_simple<80>(is_bf16, out);
    case 96:  return (int)attributes_simple<96>(is_bf16, out);
    case 112: return (int)attributes_simple<112>(is_bf16, out);
    default:  return (int)attributes_simple<128>(is_bf16, out);
  }
}

extern "C" int tspo_vit_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int W, int heads,
                                  float scale, int is_bf16, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || heads <= 0 || heads > 65535 || W % heads)
    return (int)cudaErrorInvalidValue;
  const int hd = W / heads;
  const int route = vit_route(hd, is_bf16);
  if (route < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma)
    return (int)launch_wgmma_route(q, k, v, o, B, S, heads, hd, scale, st);
  switch ((hd + 15) / 16 * 16) {
    case 16:  launch<16>(q, k, v, o, B, S, W, heads, hd, scale, is_bf16, st); break;
    case 32:  launch<32>(q, k, v, o, B, S, W, heads, hd, scale, is_bf16, st); break;
    case 48:  launch<48>(q, k, v, o, B, S, W, heads, hd, scale, is_bf16, st); break;
    case 64:  launch<64>(q, k, v, o, B, S, W, heads, hd, scale, is_bf16, st); break;
    case 80:  launch<80>(q, k, v, o, B, S, W, heads, hd, scale, is_bf16, st); break;
    case 96:  launch<96>(q, k, v, o, B, S, W, heads, hd, scale, is_bf16, st); break;
    case 112: launch<112>(q, k, v, o, B, S, W, heads, hd, scale, is_bf16, st); break;
    case 128: launch<128>(q, k, v, o, B, S, W, heads, hd, scale, is_bf16, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
