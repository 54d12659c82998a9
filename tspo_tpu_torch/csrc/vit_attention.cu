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
// Bound on the H100: at the CLIP-L/14 shape (B=256, S=257, W=1024, H=16,
// bf16) one launch moves 4*B*S*W*2 B ~= 539 MB (q, k, v read once, o written
// once) and does 4*B*S^2*W ~= 69 GFLOP: ~129 FLOP/byte, under the card's
// ~295 FLOP/byte ridge, so it is bound by device memory.  Floor ~161 us per
// launch at 3.35 TB/s (data sheet).
//
// Design (simple form; no TMA, wgmma or warp specialisation yet):
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
// Plain C interface for ctypes: tspo_vit_attention returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for a shape it does not take).

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

}  // namespace

extern "C" int tspo_vit_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int W, int heads,
                                  float scale, int is_bf16, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || heads <= 0 || heads > 65535 || W % heads)
    return (int)cudaErrorInvalidValue;
  const int hd = W / heads;
  if (hd % 8 != 0 || hd > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
