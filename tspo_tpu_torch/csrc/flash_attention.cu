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
//
// Layouts: q/k/v are read in place in their [B, S, heads, hd] layout through
// batch and row strides (the KV-cache slice k_l[:, :S] has batch stride
// T*KV*hd); the head dim is contiguous.  The output is written in place in
// [B, Sq, H, hd].  No [B, H, S, hd] transposes and no padding in device
// memory: ragged edges are masked here.
//
// Bound on the H100: at the LLaVA-Video prefill shape (B=1, S~11.7k, H=28,
// KV=4, hd=128, causal, bf16) one launch does ~2*H*hd*S^2 ~ 0.98 TFLOP (the
// causal half of 4*H*hd*S^2) against ~192 MB of q, k, v and o: ~5000
// FLOP/byte, far above the card's ~295 FLOP/byte ridge, so it is bound by
// the tensor cores: ~0.99 ms at 989 TFLOP/s (data sheet).
//
// Design (mma.sync; no TMA, wgmma or warp specialisation yet):
//   * bf16: one block per (128-row query tile, query head, batch row); 4
//     warps, each two 16-row MMA tiles (mma.sync m16n8k16, bf16 in, fp32
//     accumulate), so every K and V fragment read from shared memory feeds
//     two MMAs.  Query tiles run heaviest-first (last tile first), so the
//     long causal rows start early and the short ones fill the tail.  The
//     block's Q rows are staged in shared memory and read with ldmatrix; K/V
//     tiles of 64 keys are copied with cp.async into two shared-memory stages
//     (Q + 2 x (K + V) = (128 + 256) x (hd+8) bf16 = 104 KB at hd=128,
//     dynamic shared memory, two blocks per SM), so the next tile loads while
//     this one is computed.  ldmatrix gives K's B fragments, ldmatrix.trans
//     V's; the S accumulator fragment is reused as the A fragment of P.V, so
//     P never leaves registers.  Scores live in the log2 domain (scale *
//     log2 e folded in) for exp2f.  Masking is applied only on tiles that
//     touch a boundary of a row tile; a tile wholly above a warp's diagonal
//     is skipped.  At hd=128 this holds 255 registers a thread, no spills.
//     (First form, slower: 64-row blocks, one MMA tile per warp, Q fragments
//     in registers, expf; PERF.md has both forms' times.)
//   * fp32 (the parity path): one thread per query row, plain FMA, per-key
//     online softmax; masked keys are skipped.  Full fp32; no TF32.
//   * Keys past the valid length are zero-filled in shared memory (never
//     read), so stale cache slots cannot reach P.V.
// Instantiated for hd in {16, 64, 80, 128} (the tiny test geometry, Qwen2.5-VL
// vision layers at 80, Qwen2 at 128); any S.
//
// Plain C interface for ctypes: tspo_flash_attention returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for a shape
// it does not take).

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

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, int smem,
                          cudaStream_t st, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Params& p, int B, int is_bf16, cudaStream_t st) {
  if (is_bf16)
    return launch_kernel(flash_bf16_kernel<HD>,
                         dim3((p.Sq + kRowsBf16 - 1) / kRowsBf16, p.H, B), 128,
                         (kRowsBf16 + 4 * kKeys) * (HD + 8) * (int)sizeof(__nv_bfloat16),
                         st, p);
  const dim3 grid((p.Sq + kRows - 1) / kRows, p.H, B);
  return launch_kernel(flash_f32_kernel<HD>, grid, 64,
                       (HD * kRows + 2 * kKeysF32 * HD) * (int)sizeof(float), st, p);
}

}  // namespace

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
  cudaError_t e;
  switch (hd) {
    case 16:  e = launch<16>(p, B, is_bf16, st); break;
    case 64:  e = launch<64>(p, B, is_bf16, st); break;
    case 80:  e = launch<80>(p, B, is_bf16, st); break;
    case 128: e = launch<128>(p, B, is_bf16, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
