// A tiled bf16 matrix product and a row softmax for Hopper (sm_90a): the
// products of the ViT-attention bench's gemm_inkernel and fullwidth probes.
//
// Replaces (scripts/bench_vit_attention_variants.py, Pallas, TPU):
//   _gemm_inkernel    :106  [S, W] @ [W, 3W] per frame, fp32 accumulation,
//                           bf16 out (bench name gemm_inkernel; the product
//                           the TPU kernel computes in its own body)
//   _fullwidth_kernel :85   attribution only: one "head" of width W,
//                           softmax((q k^T) * scale) v (bench name fullwidth),
//                           here in three launches: a batched q k^T to fp32
//                           (tspo_gemm, B transposed), tspo_row_softmax (fp32
//                           scores to bf16 P, rounded after the division), and
//                           a batched P v (tspo_gemm, bf16 out).
//
// Bound on the H100: gemm_inkernel at B=256, S=257, W=1024 does
// 2 * 65792 * 3072 * 1024 = 414 GFLOP over 545 MB: bound by the tensor cores,
// ~0.419 ms at 989 TFLOP/s.  fullwidth does 4*B*S^2*W = 69 GFLOP over 539 MB
// of q, k, v and o: bound by device memory, ~0.161 ms (its fp32 scores and P
// are the kernel's own traffic).  The row softmax is bound by its bytes.
//
// Design (simple form; no TMA or wgmma):
//   * C[M, N] = A[M, K] @ B, with B row-major [K, N] or transposed ([N, K]
//     row-major), batched over blockIdx.z with element strides; bf16 or fp32
//     output.  A block computes a 128 x 128 tile with 8 warps of 64 x 32,
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate), a 32-deep k step, three
//     cp.async stages in dynamic shared memory (rows padded by 16 bytes, so
//     ldmatrix reads hit 8 different bank groups), ldmatrix for A and for a
//     transposed B, ldmatrix.trans for a row-major B.
//   * Ragged M, N and K are masked at the copy: a 16-byte chunk past the edge
//     copies only its live bytes (cp.async src_bytes) and zero-fills the rest,
//     so K = 257 (fullwidth's P v) and N = 257 (its q k^T) need no padding in
//     device memory beyond 16-byte aligned rows.  Stores past M or N are
//     skipped.
//   * Row softmax: one warp per row, two passes over the row (max, then sum
//     of exp), then p = bf16(exp(x * scale - max) / sum); the columns between
//     the row's end and the output row stride are written as zeros.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int kThreads = 256;          // 8 warps: 2 (M) x 4 (N) of 64 x 32
constexpr int LDA = BK + 8;            // A tile [BM][BK] row stride
constexpr int LDB = BN + 8;            // row-major B tile [BK][BN]
constexpr int LDBT = BK + 8;           // transposed B tile [BN][BK]
constexpr int A_TILE = BM * LDA;
constexpr int B_TILE = (BK * LDB > BN * LDBT) ? BK * LDB : BN * LDBT;
constexpr int kSmem = STAGES * (A_TILE + B_TILE) * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; the first src_bytes come from src, the rest
// of the 16 are zeros.
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

__device__ __forceinline__ int live_bytes(int k0, int K) {
  const int n = (K - k0) * 2;
  return n <= 0 ? 0 : (n >= 16 ? 16 : n);
}

struct GemmArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  void* c;
  int M, N, K;
  long long lda, ldb, ldc;        // row strides (elements)
  long long sa, sb, sc;           // batch strides (elements)
};

// Fragment layouts of m16n8k16 as in vit_attention.cu (g = lane / 4,
// t = lane % 4).
template <bool TRANS_B, bool OUT_F32>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + STAGES * A_TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* A = p.a + (size_t)blockIdx.z * p.sa;
  const __nv_bfloat16* Bm = p.b + (size_t)blockIdx.z * p.sb;
  const int M = p.M, N = p.N, K = p.K;

  auto load = [&](int kt, int stage) {
    const int k0 = kt * BK;
    __nv_bfloat16* dA = sA + stage * A_TILE;
    __nv_bfloat16* dB = sB + stage * B_TILE;
    for (int idx = threadIdx.x; idx < BM * (BK / 8); idx += kThreads) {
      const int row = idx / (BK / 8), c = idx % (BK / 8);
      const int gm = m0 + row, gk = k0 + c * 8;
      const int nb = gm < M ? live_bytes(gk, K) : 0;
      cp_async16(dA + row * LDA + c * 8, nb ? A + (size_t)gm * p.lda + gk : A, nb);
    }
    if (TRANS_B) {
      for (int idx = threadIdx.x; idx < BN * (BK / 8); idx += kThreads) {
        const int row = idx / (BK / 8), c = idx % (BK / 8);
        const int gn = n0 + row, gk = k0 + c * 8;
        const int nb = gn < N ? live_bytes(gk, K) : 0;
        cp_async16(dB + row * LDBT + c * 8, nb ? Bm + (size_t)gn * p.ldb + gk : Bm, nb);
      }
    } else {
      for (int idx = threadIdx.x; idx < BK * (BN / 8); idx += kThreads) {
        const int row = idx / (BN / 8), c = idx % (BN / 8);
        const int gk = k0 + row, gn = n0 + c * 8;
        const int nb = gk < K ? live_bytes(gn, N) : 0;
        cp_async16(dB + row * LDB + c * 8, nb ? Bm + (size_t)gk * p.ldb + gn : Bm, nb);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt is in; every warp is done with stage kt - 1
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const __nv_bfloat16* tA = sA + (kt % STAGES) * A_TILE;
    const __nv_bfloat16* tB = sB + (kt % STAGES) * B_TILE;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], tA + (wm + mi * 16 + (lm & 1) * 8 + lr) * LDA + ks * 16 + (lm >> 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        if (TRANS_B)
          ldmatrix_x4(bf[nj], tB + (wn + nj * 16 + (lm >> 1) * 8 + lr) * LDBT + ks * 16 + (lm & 1) * 8);
        else
          ldmatrix_x4_trans(bf[nj], tB + (ks * 16 + (lm & 1) * 8 + lr) * LDB + wn + nj * 16 + (lm >> 1) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], &bf[ni >> 1][(ni & 1) * 2]);
    }
  }

  // Epilogue: pairs of columns where both are live and the row stride is
  // even, single values otherwise.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + t * 2;
        const float x0 = acc[mi][ni][2 * h], x1 = acc[mi][ni][2 * h + 1];
        const size_t off = (size_t)blockIdx.z * p.sc + (size_t)row * p.ldc + col;
        if (OUT_F32) {
          float* C = static_cast<float*>(p.c) + off;
          if (col + 1 < N && (p.ldc & 1) == 0) {
            *reinterpret_cast<float2*>(C) = make_float2(x0, x1);
          } else {
            if (col < N) C[0] = x0;
            if (col + 1 < N) C[1] = x1;
          }
        } else {
          __nv_bfloat16* C = static_cast<__nv_bfloat16*>(p.c) + off;
          if (col + 1 < N && (p.ldc & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(C) = __floats2bfloat162_rn(x0, x1);
          } else {
            if (col < N) C[0] = __float2bfloat16_rn(x0);
            if (col + 1 < N) C[1] = __float2bfloat16_rn(x1);
          }
        }
      }
    }
  }
}

template <bool TRANS_B, bool OUT_F32>
int launch_gemm(const GemmArgs& p, int batch, cudaStream_t st) {
  auto kernel = gemm_kernel<TRANS_B, OUT_F32>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, batch);
  kernel<<<grid, kThreads, kSmem, st>>>(p);
  return (int)cudaGetLastError();
}

constexpr int kRowWarps = 8;

__global__ void __launch_bounds__(kRowWarps * 32)
row_softmax_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
                   long long rows, int ncols, long long ld_in, long long ld_out,
                   float scale) {
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + row * ld_in;
  __nv_bfloat16* pr = out + row * ld_out;
  float m = -INFINITY;
  for (int c = lane; c < ncols; c += 32) m = fmaxf(m, xr[c] * scale);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  for (int c = lane; c < ncols; c += 32) l += expf(xr[c] * scale - m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  for (int c = lane; c < ld_out; c += 32)
    pr[c] = __float2bfloat16_rn(c < ncols ? expf(xr[c] * scale - m) / l : 0.f);
}

}  // namespace

// C = A @ B (trans_b: A @ B^T), batched.  A [batch][M][K] bf16 with row stride
// lda; B [batch][K][N] (trans_b: [batch][N][K]) bf16 with row stride ldb; C
// [batch][M][N] bf16 or fp32 (out_f32) with row stride ldc; batch strides sa,
// sb, sc.  Row strides and batch strides of A and B must be multiples of 8
// elements and the bases 16-byte aligned.
extern "C" int tspo_gemm(const void* a, const void* b, void* c, int M, int N,
                         int K, long long lda, long long ldb, long long ldc,
                         long long sa, long long sb, long long sc, int batch,
                         int trans_b, int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0 || batch > 65535 ||
      (M + BM - 1) / BM > 65535 || lda % 8 || ldb % 8 || sa % 8 || sb % 8 ||
      lda < K || ldb < (trans_b ? K : N) || ldc < N)
    return (int)cudaErrorInvalidValue;
  GemmArgs p;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.c = c;
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.ldb = ldb;
  p.ldc = ldc;
  p.sa = sa;
  p.sb = sb;
  p.sc = sc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (trans_b)
    return out_f32 ? launch_gemm<true, true>(p, batch, st) : launch_gemm<true, false>(p, batch, st);
  return out_f32 ? launch_gemm<false, true>(p, batch, st) : launch_gemm<false, false>(p, batch, st);
}

// out[r, c] = bf16(softmax(x[r, :ncols] * scale)[c]) for c < ncols, 0 for
// ncols <= c < ld_out.  x fp32 with row stride ld_in, out bf16 with row
// stride ld_out.
extern "C" int tspo_row_softmax(const void* x, void* out, long long rows,
                                int ncols, long long ld_in, long long ld_out,
                                float scale, void* stream) {
  if (rows <= 0 || ncols <= 0 || ld_in < ncols || ld_out < ncols ||
      (rows + kRowWarps - 1) / kRowWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
  row_softmax_kernel<<<blocks, kRowWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), rows, ncols,
      ld_in, ld_out, scale);
  return (int)cudaGetLastError();
}
