// Blocked GQA flash attention with an online softmax, for Hopper (sm_90a).
//
// Replaces: tspo_tpu/ops/pallas_attention.py::_kernel (Pallas, TPU, :46-104),
// launched by pallas_flash_attention (:107-175).  Same function:
//   q [B, Sq, H, hd], k/v [B, Sk, KV, hd] -> o [B, Sq, H, hd]
//   * native GQA: query head h reads kv head h / (H / KV), nothing repeated;
//   * key validity is a prefix length per batch row (lengths[b]);
//   * causal masking with the query rows at key positions [q_off, q_off+Sq);
//   * an optional sliding window: q_pos - k_pos < window;
//   * scores q.k^T accumulated in fp32, then scaled by 1/sqrt(hd); masked
//     scores are the finite sentinel -1e30, never -inf; probabilities are
//     cast to the input type before P.V, which accumulates in fp32; the
//     output is acc / max(l, 1e-37).
// Key tiles that are wholly dead for a block (past the valid length, above
// the causal diagonal, or before the window) are never loaded or computed.
// q/k/v are read in place in their [B, S, heads, hd] layout through batch
// and row strides (the KV-cache slice k_l[:, :S] has batch stride T*KV*hd),
// and o is written in place: no transposes, no padding in device memory.
//
// Bound on the H100: at the LLaVA-Video prefill (B=1, S=11784, H=28, KV=4,
// hd=128, causal, bf16) one launch does 4*H*hd * (causal key count) = 0.996
// TFLOP against ~190 MB of q, k, v and o: ~5000 FLOP/byte, far above the
// card's ~295 FLOP/byte ridge, so the tensor cores bound it: 1.007 ms at
// 989 TFLOP/s (data sheet).
//
// Routes, chosen here from (dtype, hd) (flash_route):
//   * bf16, hd 64 and 128 -> flash_wgmma_kernel (below): Qwen2-7B, Llama,
//     Mistral.
//   * bf16, hd 16 and 80 -> flash_bf16_kernel: mma.sync m16n8k16, 128 query
//     rows a block in 4 warps, cp.async double-buffered 64-key K/V tiles,
//     ldmatrix fragments (the first Hopper form of this kernel, kept for
//     the head dims wgmma's 64-column boxes do not fit).
//   * fp32 (the parity path), every hd -> flash_f32_kernel: one thread per
//     query row, plain FMA, per-key online softmax; full fp32, no TF32.
//
// flash_wgmma_kernel: one block of three warpgroups (384 threads, one
// block an SM) per (128-row query tile, query head, batch row), heaviest
// query tiles first.  What it does about the four limits of the mma.sync
// form (255 registers, two 4-warp blocks an SM, 4.47 ms at the prefill):
//   1. Tensor-core path: S = Q K^T and O += P V are wgmma.mma_async
//      m64n128k16 (bf16 in, fp32 accumulate), the instruction that reaches
//      the full rate on Hopper, where mma.sync does not.
//   2. Latency: warpgroup 0 is a producer whose one thread issues the TMA
//      loads, its registers cut to 24 (setmaxnreg.dec); warpgroups 1 and 2
//      are consumers of 64 query rows each, raised to 240 (setmaxnreg.inc)
//      for a 64x128 fp32 score tile, its bf16 P and a 64 x hd fp32 output
//      accumulator in registers.  Loads run ahead through a ring of two K
//      and two V stages of 128 keys.  No warp waits for its own products
//      with nothing to do: each consumer issues S_j = Q K_j^T together with
//      O += P_{j-1} V_{j-1} and runs the softmax of tile j while P_{j-1}
//      V_{j-1} is in the tensor cores, and the two consumers take turns to
//      issue (a ping-pong on named barriers), so one's softmax runs under
//      the other's products.
//   3. K/V reuse: wgmma reads its B operand (K for S, V for P V) from
//      shared memory once per warpgroup of 64 rows, not once per warp.
//   4. Copies: one thread issues each 128-row x 64-column TMA box (two per
//      hd=128 tile); completion is counted in bytes on an mbarrier, so no
//      thread computes an address and no __syncthreads runs in the loop.
//      Each stage has a full barrier (armed by the producer with expect_tx)
//      and an empty barrier (one arrival per consumer warp once its wgmma
//      has read the stage); K and V have their own, so the next K tile loads
//      while P V still reads this V.
// Shared memory (dynamic, 1024-byte aligned): Q (32 KB at hd=128), 2 x K,
// 2 x V (128 KB), the barriers: ~161 KB.  Tiles are TMA's 128-byte swizzle,
// which the wgmma descriptors name: Q and K K-major (hd contiguous, a
// k-step of 16 columns is +32 bytes inside the swizzle atom), V MN-major
// through the descriptor's transpose bit (a k-step of 16 keys is +2 KB,
// the second 64-column box is the leading-byte offset).  P never leaves
// registers: the fp32 S accumulator's fragment is, pairwise packed to
// bf16, the A fragment of P V.  The softmax works on the accumulator
// fragments: scores in the log2 domain (one FFMA and one ex2.approx.ftz a
// score), a row's max and sum over the 4 threads of a quad, masking only on
// tiles that touch a boundary; inside the kernel a masked score is -inf, so
// its probability is exactly 0, as the -1e30 sentinel's is.  Both
// consumers walk the block's tiles; one dead for a warpgroup is masked
// whole.  Ragged edges: TMA zero-fills rows past Sq and Sk; keys in
// [lengths[b], Sk) lie inside the map and are loaded, so the consumers zero
// those V rows in the one tile that straddles lengths[b] before P V, and
// stale cache values (even NaN or inf) never reach the output.
// Tensor maps (4-D: hd, heads, S, B over the strides given) are built on
// the host for each launch with cuTensorMapEncodeTiled, reached through the
// CUDA runtime (cudaGetDriverEntryPoint), so the library needs no -lcuda.
//
// Plain C interface for ctypes: tspo_flash_attention returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for a shape
// it does not take); tspo_flash_attention_route names the kernel a (hd,
// dtype) launches; tspo_flash_attention_attributes reports its registers,
// shared memory and resident blocks per SM.

#include <cuda.h>          // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTiles = 2;          // 16-row MMA tiles per warp (bf16)
constexpr int kRowsBf16 = 4 * 16 * kTiles;   // query rows per bf16 block
constexpr int kRows = 64;          // query rows per fp32 block
constexpr int kKeys = 64;          // keys per shared-memory tile (bf16)
constexpr int kKeysF32 = 32;       // keys per shared-memory tile (fp32)
constexpr float kNeg = -1e30f;     // finite mask sentinel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lengths;              // [B] valid key prefix, or null (all Sk)
  long long q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, o_sb, o_sr;   // elements
  int Sq, Sk, H, KV, causal, window, q_off;
  float scale;
};

// Live key range [kbeg, kend) of a block whose query rows are [q0, q1).
__device__ __forceinline__ void live_keys(const Params& p, int q0, int q1,
                                          int n_valid, int& kbeg, int& kend) {
  kend = n_valid;
  if (p.causal) kend = min(kend, p.q_off + q1);
  kbeg = p.window > 0 ? max(0, p.q_off + q0 - p.window + 1) : 0;
}

__device__ __forceinline__ bool key_ok(const Params& p, int key, int qpos,
                                       int n_valid) {
  return key < n_valid && (!p.causal || key <= qpos) &&
         (p.window <= 0 || qpos - key < p.window);
}

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
template <int HD>
__global__ void __launch_bounds__(128) flash_bf16_kernel(Params p) {
  // Row stride HD + 8: rows stay 16-byte aligned and the 8 rows one ldmatrix
  // phase reads fall in 8 different groups of 4 banks.
  constexpr int LD = HD + 8;
  constexpr int CHUNKS = HD / 8;            // 16-byte chunks per row
  constexpr int TILE = kKeys * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kRowsBf16][LD]
  __nv_bfloat16* sK = sQ + kRowsBf16 * LD;                            // [2][TILE]
  __nv_bfloat16* sV = sK + 2 * TILE;                                  // [2][TILE]

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;        // ldmatrix: matrix, row
  const int q0 = qt * kRowsBf16;
  const int q1 = min(q0 + kRowsBf16, p.Sq);
  const int wrow = q0 + warp * 16 * kTiles;       // this warp's first row
  const bool active = wrow < p.Sq;                // uniform across the warp
  const int n_valid = p.lengths ? min(max(p.lengths[b], 0), p.Sk) : p.Sk;
  // scores in the log2 domain: exp2(x * scale * log2 e) = exp(x * scale)
  const float scale2 = p.scale * 1.4426950408889634f;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * HD;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * HD;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * HD;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * HD;

  int kbeg, kend;
  live_keys(p, q0, q1, n_valid, kbeg, kend);
  const int j_lo = kbeg / kKeys;
  const int j_hi = kend > kbeg ? (kend + kKeys - 1) / kKeys : j_lo;

  // The block's Q rows (zero past Sq), then the first K/V tile.
  for (int idx = threadIdx.x; idx < kRowsBf16 * CHUNKS; idx += blockDim.x) {
    const int row = idx / CHUNKS, d = (idx % CHUNKS) * 8;
    const bool ok = q0 + row < p.Sq;
    const long long qr = ok ? (long long)(q0 + row) : 0;
    cp_async16(&sQ[row * LD + d], qb + qr * p.q_sr + d, ok ? 16 : 0);
  }
  cp_async_commit();
  auto load_tile = [&](int j, int buf) {
    const int k0 = j * kKeys;
    for (int idx = threadIdx.x; idx < kKeys * CHUNKS; idx += blockDim.x) {
      const int key = idx / CHUNKS, d = (idx % CHUNKS) * 8;
      const bool ok = k0 + key < n_valid;
      const long long kr = ok ? (long long)(k0 + key) : 0;
      cp_async16(&sK[buf * TILE + key * LD + d], kb + kr * p.k_sr + d, ok ? 16 : 0);
      cp_async16(&sV[buf * TILE + key * LD + d], vb + kr * p.v_sr + d, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  if (j_lo < j_hi) load_tile(j_lo, 0);

  float m[kTiles][2], l[kTiles][2];
  float acc[kTiles][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < kTiles; ++mt) {
    m[mt][0] = m[mt][1] = kNeg;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn)
      acc[mt][dn][0] = acc[mt][dn][1] = acc[mt][dn][2] = acc[mt][dn][3] = 0.f;
  }

  for (int j = j_lo; j < j_hi; ++j) {
    const int buf = (j - j_lo) & 1, k0 = j * kKeys;
    if (j + 1 < j_hi) {
      load_tile(j + 1, buf ^ 1);   // that stage was released at the end of j-1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // Q and tile j are in shared memory for every thread

    // A tile wholly above the diagonal of every row of this warp adds
    // nothing (its keys come after the rows' real keys): skip it.
    const bool skip = p.causal && k0 > p.q_off + wrow + 16 * kTiles - 1;
    if (active && !skip) {
      const __nv_bfloat16* tK = sK + buf * TILE;
      const __nv_bfloat16* tV = sV + buf * TILE;

      // S = Q K^T for this warp's 2 x 16 rows x 64 keys.  Each K fragment
      // (one ldmatrix_x4: key blocks n and n + 1 of one 16-dim slice) feeds
      // both row tiles.
      float s[kTiles][kKeys / 8][4];
#pragma unroll
      for (int mt = 0; mt < kTiles; ++mt)
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[kTiles][4];
#pragma unroll
        for (int mt = 0; mt < kTiles; ++mt)
          ldmatrix_x4(qa[mt], sQ + (warp * 16 * kTiles + mt * 16 + (lm & 1) * 8 + lr) * LD +
                                  kk * 16 + (lm >> 1) * 8);
#pragma unroll
        for (int n = 0; n < kKeys / 8; n += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, tK + ((n + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < kTiles; ++mt) {
            mma_bf16(s[mt][n], qa[mt], bk);
            mma_bf16(s[mt][n + 1], qa[mt], bk + 2);
          }
        }
      }

#pragma unroll
      for (int mt = 0; mt < kTiles; ++mt) {
        // Scale, then mask with -1e30 where the tile touches a boundary of
        // this row tile (valid length, diagonal or window).
        const int mrow = wrow + mt * 16;
        const bool full = k0 + kKeys <= n_valid &&
                          (!p.causal || k0 + kKeys - 1 <= p.q_off + mrow) &&
                          (p.window <= 0 || p.q_off + mrow + 15 - k0 < p.window);
        float tmax[2] = {kNeg, kNeg};
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[mt][n][i] * scale2;
            if (!full) {
              const int key = k0 + n * 8 + t * 2 + (i & 1);
              const int qpos = p.q_off + mrow + g + ((i & 2) ? 8 : 0);
              if (!key_ok(p, key, qpos, n_valid)) x = kNeg;
            }
            s[mt][n][i] = x;
            tmax[i >> 1] = fmaxf(tmax[i >> 1], x);
          }
        }
        // Online softmax in fp32 (log2 domain).  A row whose keys so far
        // are all masked has m = -1e30 and takes exp2(0) = 1 garbage, which
        // alpha = 0 cancels at its first real key; nothing makes a NaN.
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          const float mn = fmaxf(m[mt][r], tmax[r]);
          alpha[r] = exp2f(m[mt][r] - mn);
          m[mt][r] = mn;
          l[mt][r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pr = exp2f(s[mt][n][i] - m[mt][i >> 1]);
            l[mt][i >> 1] += pr;
            s[mt][n][i] = pr;
          }
        }
#pragma unroll
        for (int dn = 0; dn < HD / 8; ++dn) {
          acc[mt][dn][0] *= alpha[0];
          acc[mt][dn][1] *= alpha[0];
          acc[mt][dn][2] *= alpha[1];
          acc[mt][dn][3] *= alpha[1];
        }
      }

      // O += P V, with P (cast to bf16) taken straight from the S fragments.
      // Each V fragment (one ldmatrix_x4_trans: dim blocks dn, dn + 1) feeds
      // both row tiles.
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t pa[kTiles][4];
#pragma unroll
        for (int mt = 0; mt < kTiles; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dn = 0; dn < HD / 8; dn += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, tV + (kk * 16 + (lm & 1) * 8 + lr) * LD + (dn + (lm >> 1)) * 8);
#pragma unroll
          for (int mt = 0; mt < kTiles; ++mt) {
            mma_bf16(acc[mt][dn], pa[mt], bv);
            mma_bf16(acc[mt][dn + 1], pa[mt], bv + 2);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with stage buf before it is refilled
  }
  cp_async_wait<0>();  // nothing in flight at exit (a block with no live tile)

  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < kTiles; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
    const float inv0 = 1.f / fmaxf(l[mt][0], 1e-37f);
    const float inv1 = 1.f / fmaxf(l[mt][1], 1e-37f);
    const int r0 = wrow + mt * 16 + g;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      const int d = dn * 8 + t * 2;
      if (r0 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)r0 * p.o_sr + d) =
            pack_bf16(acc[mt][dn][0] * inv0, acc[mt][dn][1] * inv0);
      if (r0 + 8 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * p.o_sr + d) =
            pack_bf16(acc[mt][dn][2] * inv1, acc[mt][dn][3] * inv1);
    }
  }
}

// fp32: one thread per query row, 64 rows per block.  The block's Q tile sits
// in shared memory dim-major (thread r reads column r: no bank conflicts),
// K/V tiles of 32 keys beside it; the accumulator stays in registers.
template <int HD>
__global__ void __launch_bounds__(64) flash_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [HD][kRows]
  float* sK = sQ + HD * kRows;                       // [kKeysF32][HD]
  float* sV = sK + kKeysF32 * HD;                    // [kKeysF32][HD]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kRows;
  const int q1 = min(q0 + kRows, p.Sq);
  const int row = q0 + threadIdx.x;
  const int qpos = p.q_off + row;
  const int n_valid = p.lengths ? min(max(p.lengths[b], 0), p.Sk) : p.Sk;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * HD;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * HD;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * HD;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * HD;

  for (int idx = threadIdx.x; idx < kRows * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD;
    sQ[d * kRows + r] = q0 + r < p.Sq ? qb[(long long)(q0 + r) * p.q_sr + d] : 0.f;
  }

  int kbeg, kend;
  live_keys(p, q0, q1, n_valid, kbeg, kend);
  const int j_lo = kbeg / kKeysF32;
  const int j_hi = kend > kbeg ? (kend + kKeysF32 - 1) / kKeysF32 : j_lo;

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kNeg, l = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kKeysF32;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kKeysF32 * HD; idx += blockDim.x) {
      const int key = idx / HD, d = idx % HD;
      const bool ok = k0 + key < n_valid;
      sK[idx] = ok ? kb[(long long)(k0 + key) * p.k_sr + d] : 0.f;
      sV[idx] = ok ? vb[(long long)(k0 + key) * p.v_sr + d] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kKeysF32; ++jj) {
      if (!key_ok(p, k0 + jj, qpos, n_valid)) continue;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(sQ[d * kRows + threadIdx.x], sK[jj * HD + d], dot);
      const float x = dot * p.scale;
      const float mn = fmaxf(m, x);
      const float a = expf(m - mn);
      const float pr = expf(x - mn);
      m = mn;
      l = l * a + pr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(pr, sV[jj * HD + d], acc[d] * a);
    }
  }
  if (row < p.Sq) {
    const float inv = 1.f / fmaxf(l, 1e-37f);
#pragma unroll
    for (int d = 0; d < HD; ++d) ob[(long long)row * p.o_sr + d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// flash_wgmma_kernel: bf16, hd 64 or 128 (see the note at the top).

constexpr int kWgRows = 128;       // query rows a block (two consumer warpgroups)
constexpr int kWgKeys = 128;       // keys a K/V stage
constexpr int kStages = 2;         // K/V ring depth
constexpr int kBoxCols = 64;       // hd columns a TMA box: 128 bytes, the swizzle width
constexpr int kBoxBytes = 128 * kBoxCols * 2;   // one [128 rows][64 cols] bf16 box
constexpr int kThreadsWg = 384;    // producer warpgroup + two consumer warpgroups

// Byte offsets in the kernel's shared memory (from a 1024-byte aligned base:
// the 128-byte swizzle repeats every 8 rows of 128 bytes).  Each tile is
// hd / 64 boxes, one after the other.
template <int HD>
struct WgSmem {
  static constexpr int kTile = HD / kBoxCols * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                      // [kStages] K tiles
  static constexpr int kV = kK + kStages * kTile;       // [kStages] V tiles
  static constexpr int kBar = kV + kStages * kTile;     // 1 + 4 * kStages mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
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

// One TMA box of a 4-D map at coordinates (col, head, row, batch) into
// shared memory; its bytes complete on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col,
                                         int head, int row, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head),
         "r"(row), "r"(batch), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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

// Named barrier over the 256 consumer threads: wait for, or signal, a
// warpgroup's turn at the tensor cores.
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

#define WG_F8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d, i) WG_F8(d, i), WG_F8(d, i + 8), WG_F8(d, i + 16), WG_F8(d, i + 24)

// D[64x128] (+)= A[64x16] B[16x128]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64x128] += A[64x16] B[16x128]: A from registers, B from shared memory
// MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same at N = 64 (hd = 64).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_F32
#undef WG_F8

// Accumulator fragment of wgmma m64nN (per warp w of the warpgroup, g = lane
// / 4, t = lane % 4): d[4i + e] is row 16w + g + (e & 2 ? 8 : 0), column 8i +
// 2t + (e & 1) -- the m16n8k16 C layout of each 8-column block, so the
// pairs (d[8kk], d[8kk+1]), (d[8kk+2], d[8kk+3]), (d[8kk+4], d[8kk+5]),
// (d[8kk+6], d[8kk+7]) are the A fragment of k-step kk of the next product.
template <int HD>
__global__ void __launch_bounds__(kThreadsWg, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Params p) {
  using L = WgSmem<HD>;
  constexpr int kBoxes = HD / kBoxCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];   // aligned below
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // mbarriers: Q full; then per stage K full, V full, K empty, V empty
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kWgRows;
  const int q1 = min(q0 + kWgRows, p.Sq);
  const int n_valid = p.lengths ? min(max(p.lengths[b], 0), p.Sk) : p.Sk;
  int kbeg, kend;
  live_keys(p, q0, q1, n_valid, kbeg, kend);
  const int j_lo = kbeg / kWgKeys;                // producer and consumers walk
  const int j_hi = kend > kbeg ? (kend + kWgKeys - 1) / kWgKeys : j_lo;   // [j_lo, j_hi)

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);    // one arrival per consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < kBoxes; ++c)
        tma_load(base + L::kQ + c * kBoxBytes, &tq, c * kBoxCols, h, q0, b, q_full);
      for (int j = j_lo; j < j_hi; ++j) {
        const int i = j - j_lo, s = i % kStages, use = i / kStages;
        if (use > 0) mbar_wait(k_empty(s), (use - 1) & 1);
        mbar_expect_tx(k_full(s), L::kTile);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(base + L::kK + s * L::kTile + c * kBoxBytes, &tk, c * kBoxCols, kvh,
                   j * kWgKeys, b, k_full(s));
        if (use > 0) mbar_wait(v_empty(s), (use - 1) & 1);
        mbar_expect_tx(v_full(s), L::kTile);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(base + L::kV + s * L::kTile + c * kBoxBytes, &tv, c * kBoxCols, kvh,
                   j * kWgKeys, b, v_full(s));
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * c;                   // this warpgroup's first row
    const int wrow = r0 + 16 * warp;              // this warp's first row
    // scores in the log2 domain: exp2(x * scale * log2 e) = exp(x * scale)
    const float scale2 = p.scale * 1.4426950408889634f;
    const uint32_t q_rows = base + L::kQ + c * 64 * 128;   // rows r0.. of each Q box

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    float sacc[64];          // S of one tile, then its probabilities
    uint32_t pa[8][4];       // P of one tile as bf16 A fragments of P V
    auto stage = [&](int j) { return (j - j_lo) % kStages; };
    auto parity = [&](int j) { return (uint32_t)((j - j_lo) / kStages) & 1u; };

    // S = Q K_j^T over hd in k-steps of 16 columns (32 bytes inside a box):
    // issued and committed, not waited for.
    auto issue_qk = [&](int j) {
      const uint32_t k_tile = base + L::kK + stage(j) * L::kTile;
      mbar_wait(k_full(stage(j)), parity(j));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sacc, smem_desc(q_rows + off, 16, 1024),
                      smem_desc(k_tile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };

    // O += P V_j over the 128 keys in k-steps of 16 (16 rows of 128 bytes):
    // issued and committed, not waited for.
    auto issue_pv = [&](int j) {
      const int k0 = j * kWgKeys;
      const uint32_t v_tile = base + L::kV + stage(j) * L::kTile;
      mbar_wait(v_full(stage(j)), parity(j));
      if (n_valid < p.Sk && k0 + kWgKeys > n_valid) {
        // Keys [n_valid, k0 + 128) of this tile were loaded from the cache:
        // zero their V rows (p is 0 there, but 0 * NaN is not), then make
        // the writes visible to wgmma's async reads.
        const int first = n_valid - k0, n = (kWgKeys - first) * 8;   // 16-byte chunks a box
        uint4* tile = reinterpret_cast<uint4*>(smem + (v_tile - base));
        for (int idx = threadIdx.x % 128; idx < n * kBoxes; idx += 128)
          tile[(idx / n) * (kBoxBytes / 16) + first * 8 + idx % n] = make_uint4(0, 0, 0, 0);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = smem_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024);
        if constexpr (HD == 128) wgmma_rs_n128(o, pa[kk], dv);
        else wgmma_rs_n64(o, pa[kk], dv);
      }
      wgmma_commit();
    };

    // Online softmax of tile j on sacc, in fp32 with the running max m in
    // the scaled log2 domain (it starts at the -1e30 sentinel, so it stays
    // finite); alpha rescales what O held before this tile.  A masked score
    // is -inf here: its probability is exactly 0, as the sentinel's is, and
    // a row with no valid key so far keeps p = 0 and l = 0.
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = j * kWgKeys;
      // mask only where the tile touches a boundary of this warp's 16 rows
      const bool full = k0 + kWgKeys <= n_valid &&
                        (!p.causal || k0 + kWgKeys - 1 <= p.q_off + wrow) &&
                        (p.window <= 0 || p.q_off + wrow + 15 - k0 < p.window);
      if (!full) {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int key = k0 + (e >> 2) * 8 + t * 2 + (e & 1);
          const int qpos = p.q_off + wrow + g + ((e & 2) ? 8 : 0);
          if (!key_ok(p, key, qpos, n_valid)) sacc[e] = -INFINITY;
        }
      }
      float tmax[2] = {kNeg, kNeg};
#pragma unroll
      for (int e = 0; e < 64; ++e) tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], sacc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float mn = fmaxf(m[r], tmax[r] * scale2);
        alpha[r] = exp2_ftz(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e >> 1) & 1;
        const float pr = exp2_ftz(fmaf(sacc[e], scale2, -m[r]));
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

    // Both warpgroups walk the block's tiles [j_lo, j_hi); a tile dead for
    // one of them (before its window, above its diagonal) is masked whole
    // and adds nothing, and rows past Sq are computed but never stored.
    // Pipelined: S_j and P_{j-1} V_{j-1} go
    // to the tensor cores together, and the softmax of tile j runs while
    // P_{j-1} V_{j-1} is still in them.  Ping-pong: the warpgroups take turns
    // to issue their products (named barrier 3 + c is warpgroup c's turn),
    // so one's softmax runs under the other's products.  Each of the n + 1
    // issue points of a warpgroup waits for its turn and then passes the
    // turn on, warpgroup 0 first; warpgroup 1 passes none after its last.
    const int n = j_hi - j_lo;
    int turns_left = n + 1;
    auto take_turn = [&]() { turn_wait(3 + c); };
    auto pass_turn = [&]() {
      if (c == 0 || --turns_left > 0) turn_pass(3 + (1 - c));
    };
    mbar_wait(q_full, 0);
    if (n > 0) {
      if (c == 1) turn_pass(3);
      float alpha[2];
      take_turn();
      issue_qk(j_lo);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sacc);
      if (lane == 0) mbar_arrive(k_empty(stage(j_lo)));
      softmax(j_lo, alpha);               // O is still 0: nothing to rescale
      pack_p();
      for (int j = j_lo + 1; j < j_hi; ++j) {
        take_turn();
        issue_qk(j);
        issue_pv(j - 1);
        pass_turn();
        wgmma_wait<1>();                  // S_j is in; P_{j-1} V_{j-1} may not be
        fence_regs(sacc);
        if (lane == 0) mbar_arrive(k_empty(stage(j)));
        softmax(j, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(v_empty(stage(j - 1)));
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
        pack_p();
      }
      take_turn();
      issue_pv(j_hi - 1);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty(stage(j_hi - 1)));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / fmaxf(l[0], 1e-37f);
    const float inv1 = 1.f / fmaxf(l[1], 1e-37f);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * HD;
    const int ra = wrow + g;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int d = i * 8 + t * 2;
      if (ra < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)ra * p.o_sr + d) =
            pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      if (ra + 8 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(ra + 8) * p.o_sr + d) =
            pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

enum Route { kRouteWgmma = 0, kRouteMmaSync = 1, kRouteFma = 2 };

// The kernel a (hd, dtype) launches, or -1 for a head dim not instantiated.
int flash_route(int hd, int is_bf16) {
  if (hd != 16 && hd != 64 && hd != 80 && hd != 128) return -1;
  if (!is_bf16) return kRouteFma;
  return hd == 64 || hd == 128 ? kRouteWgmma : kRouteMmaSync;
}

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

// 4-D map (hd, heads, rows, batch) of a [B, rows, heads, hd] bf16 tensor
// with row stride sr and batch stride sb (elements), read in 128-row x
// 64-column boxes with the 128-byte swizzle; rows past `rows` read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int rows, int B,
              long long sr, long long sb) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t es = sizeof(__nv_bfloat16);
  // the stride of an extent-1 dimension is never used: give it a valid one
  const cuuint64_t row_b = rows > 1 ? sr * es : (cuuint64_t)heads * hd * es;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {hd * es, row_b, B > 1 ? sb * es : row_b * rows};
  const cuuint32_t box[4] = {kBoxCols, 1, kWgRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
int smem_bf16() { return (kRowsBf16 + 4 * kKeys) * (HD + 8) * (int)sizeof(__nv_bfloat16); }

template <int HD>
int smem_f32() { return (HD * kRows + 2 * kKeysF32 * HD) * (int)sizeof(float); }

template <int HD>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t st) {
  alignas(64) CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, HD, p.H, p.Sq, B, p.q_sr, p.q_sb) ||
      !make_map(&tk, p.k, HD, p.KV, p.Sk, B, p.k_sr, p.k_sb) ||
      !make_map(&tv, p.v, HD, p.KV, p.Sk, B, p.v_sr, p.v_sb))
    return cudaErrorInvalidValue;
  const int smem = WgSmem<HD>::kBytes;
  const cudaError_t e = set_smem(flash_wgmma_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  flash_wgmma_kernel<HD><<<dim3((p.Sq + kWgRows - 1) / kWgRows, p.H, B), kThreadsWg,
                           smem, st>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t st) {
  const int smem = smem_bf16<HD>();
  const cudaError_t e = set_smem(flash_bf16_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  flash_bf16_kernel<HD><<<dim3((p.Sq + kRowsBf16 - 1) / kRowsBf16, p.H, B), 128, smem,
                          st>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t st) {
  const int smem = smem_f32<HD>();
  const cudaError_t e = set_smem(flash_f32_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  flash_f32_kernel<HD><<<dim3((p.Sq + kRows - 1) / kRows, p.H, B), 64, smem, st>>>(p);
  return cudaGetLastError();
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

}  // namespace

extern "C" int tspo_flash_attention_route(int hd, int is_bf16) {
  return flash_route(hd, is_bf16);
}

// out[4]: registers per thread at launch, shared memory per block (bytes),
// resident blocks per SM, threads per block of the kernel (hd, dtype) routes to.
extern "C" int tspo_flash_attention_attributes(int hd, int is_bf16, int* out) {
  switch (flash_route(hd, is_bf16)) {
    case kRouteWgmma:
      return hd == 64 ? (int)attributes(flash_wgmma_kernel<64>, kThreadsWg,
                                        WgSmem<64>::kBytes, out)
                      : (int)attributes(flash_wgmma_kernel<128>, kThreadsWg,
                                        WgSmem<128>::kBytes, out);
    case kRouteMmaSync:
      return hd == 16 ? (int)attributes(flash_bf16_kernel<16>, 128, smem_bf16<16>(), out)
                      : (int)attributes(flash_bf16_kernel<80>, 128, smem_bf16<80>(), out);
    case kRouteFma:
      switch (hd) {
        case 16: return (int)attributes(flash_f32_kernel<16>, 64, smem_f32<16>(), out);
        case 64: return (int)attributes(flash_f32_kernel<64>, 64, smem_f32<64>(), out);
        case 80: return (int)attributes(flash_f32_kernel<80>, 64, smem_f32<80>(), out);
        default: return (int)attributes(flash_f32_kernel<128>, 64, smem_f32<128>(), out);
      }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int tspo_flash_attention(
    const void* q, const void* k, const void* v, void* o, const int* lengths,
    long long q_sb, long long q_sr, long long k_sb, long long k_sr,
    long long v_sb, long long v_sr, long long o_sb, long long o_sr,
    int B, int Sq, int Sk, int H, int KV, int hd, int causal, int window,
    int q_off, float scale, int is_bf16, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || H <= 0 || H > 65535 ||
      KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, lengths, q_sb, q_sr, k_sb, k_sr, v_sb, v_sr,
                 o_sb, o_sr, Sq, Sk, H, KV, causal, window, q_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flash_route(hd, is_bf16)) {
    case kRouteWgmma:
      return (int)(hd == 64 ? launch_wgmma<64>(p, B, st) : launch_wgmma<128>(p, B, st));
    case kRouteMmaSync:
      return (int)(hd == 16 ? launch_bf16<16>(p, B, st) : launch_bf16<80>(p, B, st));
    case kRouteFma:
      switch (hd) {
        case 16: return (int)launch_f32<16>(p, B, st);
        case 64: return (int)launch_f32<64>(p, B, st);
        case 80: return (int)launch_f32<80>(p, B, st);
        default: return (int)launch_f32<128>(p, B, st);
      }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
