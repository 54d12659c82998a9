// Persistent, explicitly pipelined ViT attention over [B, S, W] for Hopper
// (sm_90a), and its copy-only probe.  bf16 in and out, fp32 inside.
//
// Replaces scripts/bench_vit_attention_variants.py::_manual_dma_kernel
// (Pallas, TPU, :152, launched at :348; bench names manual_dma and
// manual_dma_copy).  Same function: exact attention per head of 64 lanes,
// p = softmax((q k^T) * scale) in fp32 rounded to bf16 after the division,
// o = p v accumulated in fp32 (manual_dma); or o = q (manual_dma_copy, the
// Pallas kernel with heads = 0).
//
// Bound on the H100: attention reads q, k, v and writes o once (539 MB at
// B=256, S=257, W=1024), bound by device memory at ~0.161 ms; the copy reads
// q and writes o (269 MB, ~0.080 ms).
//
// Design.  The Pallas kernel is one program that walks all B frames with
// explicit double-buffered async copies, because the TPU's automatic block
// pipeline sustained too little bandwidth.  On Hopper one block for all of B
// would use one SM, so the question it asks takes this form here:
//   * A persistent grid, one block per SM (from cudaDevAttrMultiProcessorCount),
//     walks (frame, head) work items: item i = frame i / (W/64), lane slice
//     i % (W/64).  Blocks take items blockIdx.x, + gridDim.x, ...; they finish
//     different numbers of items.
//   * A two-stage cp.async pipeline: while item i is computed, item i + 1's
//     q, k and v head slices ([S, 64] each, ~33 KB at S=257, rows past S
//     zero-filled) land in the other stage.  Rows of 128 bytes are stored with
//     their 16-byte chunks XOR-swizzled by the row index, so ldmatrix reads are
//     free of bank conflicts without padding: 2 stages x 3 x 272 x 128 B =
//     209 KB of shared memory at S=257.  The copy probe walks the same items
//     through the same pipeline, loading q only.
//   * 8 warps share the item's 16-row query tiles (17 at S=257).  The softmax
//     keeps the Pallas numerics without a score buffer: a first pass over the
//     keys takes each row's max and sum, a second recomputes the scores, forms
//     p = bf16(exp(s - max) / sum) and multiplies by V (mma.sync m16n8k16; the
//     score fragments become P's A fragments in registers).  Q K^T is done
//     twice; the products are not the bound.
//   * Outputs are written from registers (the output copies the Pallas kernel
//     retires two frames behind are plain stores here).  TMA with mbarriers is
//     later work.
// hd must be 64; S up to 288 (both stages in shared memory).
//
// Plain C interface for ctypes: tspo_pipelined_attention returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;         // head dim: rows of 128 bytes, 8 chunks
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Element offset of (row, 16-byte chunk) in a swizzled [rows][64] tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kHd + ((chunk ^ (row & 7)) << 3);
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int S, W, spad, n_items, slices;
  float scale;
};

// Fragment layouts of m16n8k16 as in vit_attention.cu (g = lane / 4,
// t = lane % 4).
template <bool COPY>
__global__ void __launch_bounds__(kThreads, 1)
pipelined_attention_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem);
  const int S = a.S, W = a.W, spad = a.spad;
  const int tile = spad * kHd;                 // elements of one [spad][64] slice
  constexpr int kArrays = COPY ? 1 : 3;        // q (and k, v) per stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;

  auto load = [&](int item, int stage) {
    const size_t base = (size_t)(item / a.slices) * S * W + (item % a.slices) * kHd;
    __nv_bfloat16* dst = buf + (size_t)stage * kArrays * tile;
    for (int idx = threadIdx.x; idx < kArrays * spad * 8; idx += kThreads) {
      const int arr = idx / (spad * 8), rem = idx % (spad * 8);
      const int row = rem >> 3, c = rem & 7;
      const __nv_bfloat16* src = arr == 0 ? a.q : (arr == 1 ? a.k : a.v);
      const bool ok = row < S;
      cp_async16(dst + arr * tile + swz(row, c),
                 ok ? src + base + (size_t)row * W + c * 8 : a.q, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  int stage = 0;
  if ((int)blockIdx.x < a.n_items) load(blockIdx.x, 0);
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x, stage ^= 1) {
    const int next = item + gridDim.x;
    if (next < a.n_items) {
      load(next, stage ^ 1);     // that stage was released at the end of the last item
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const size_t base = (size_t)(item / a.slices) * S * W + (item % a.slices) * kHd;
    const __nv_bfloat16* sQ = buf + (size_t)stage * kArrays * tile;
    if (COPY) {
      for (int idx = threadIdx.x; idx < S * 8; idx += kThreads) {
        const int row = idx >> 3, c = idx & 7;
        *reinterpret_cast<uint4*>(a.o + base + (size_t)row * W + c * 8) =
            *reinterpret_cast<const uint4*>(sQ + swz(row, c));
      }
    } else {
      const __nv_bfloat16* sK = sQ + tile;
      const __nv_bfloat16* sV = sK + tile;
      const int kblocks = spad / 16;
      for (int rt = warp; rt < spad / 16; rt += kWarps) {
        uint32_t qa[kHd / 16][4];
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk)
          ldmatrix_x4(qa[kk], sQ + swz(rt * 16 + (lm & 1) * 8 + lr, kk * 2 + (lm >> 1)));

        // S = Q K^T for 16 keys: one ldmatrix_x4 gives key blocks 0 and 1 of
        // a 16-dim slice.
        auto scores = [&](int kb, float s[2][4]) {
#pragma unroll
          for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kHd / 16; ++kk) {
            uint32_t b[4];
            ldmatrix_x4(b, sK + swz(kb * 16 + (lm >> 1) * 8 + lr, kk * 2 + (lm & 1)));
            mma_bf16(s[0], qa[kk], b);
            mma_bf16(s[1], qa[kk], b + 2);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int key = kb * 16 + n * 8 + t * 2 + (i & 1);
              s[n][i] = key < S ? s[n][i] * a.scale : -INFINITY;
            }
        };

        // Pass 1: each row's max and sum of exp(s - max).
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        for (int kb = 0; kb < kblocks; ++kb) {
          float s[2][4];
          scores(kb, s);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float tm = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1]));
            tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
            tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
            const float mn = fmaxf(m[r], tm);    // finite: key 0 < S
            l[r] = l[r] * expf(m[r] - mn) + expf(s[0][2 * r] - mn) +
                   expf(s[0][2 * r + 1] - mn) + expf(s[1][2 * r] - mn) +
                   expf(s[1][2 * r + 1] - mn);
            m[r] = mn;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }

        // Pass 2: p = bf16(exp(s - max) / sum), O += P V.
        float acc[kHd / 8][4];
#pragma unroll
        for (int dn = 0; dn < kHd / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
        for (int kb = 0; kb < kblocks; ++kb) {
          float s[2][4];
          scores(kb, s);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = expf(s[n][i] - m[i >> 1]) / l[i >> 1];
          const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                  pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
          for (int dn = 0; dn < kHd / 8; dn += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, sV + swz(kb * 16 + (lm & 1) * 8 + lr, dn + (lm >> 1)));
            mma_bf16(acc[dn], pa, b);
            mma_bf16(acc[dn + 1], pa, b + 2);
          }
        }
        const int r0 = rt * 16 + g;
#pragma unroll
        for (int dn = 0; dn < kHd / 8; ++dn) {
          const int d = dn * 8 + t * 2;
          if (r0 < S)
            *reinterpret_cast<uint32_t*>(a.o + base + (size_t)r0 * W + d) =
                pack_bf16(acc[dn][0], acc[dn][1]);
          if (r0 + 8 < S)
            *reinterpret_cast<uint32_t*>(a.o + base + (size_t)(r0 + 8) * W + d) =
                pack_bf16(acc[dn][2], acc[dn][3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
}

template <bool COPY>
int launch(const Args& a, cudaStream_t st) {
  const size_t smem = (size_t)2 * (COPY ? 1 : 3) * a.spad * kHd * sizeof(__nv_bfloat16);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pipelined_attention_kernel<COPY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = a.n_items < sms ? a.n_items : sms;
  pipelined_attention_kernel<COPY><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o contiguous [B, S, W], W = heads * 64.  copy != 0: o = q (k and v
// are not read).
extern "C" int tspo_pipelined_attention(const void* q, const void* k,
                                        const void* v, void* o, int B, int S,
                                        int W, int heads, int copy, float scale,
                                        void* stream) {
  if (B <= 0 || S <= 0 || heads <= 0 || W != heads * kHd ||
      (long long)B * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.S = S;
  a.W = W;
  a.spad = (S + 15) / 16 * 16;
  a.slices = heads;
  a.n_items = B * heads;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return copy ? launch<true>(a, st) : launch<false>(a, st);
}
