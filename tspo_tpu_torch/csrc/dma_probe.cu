// The copy-floor probe of the ViT-attention bench for Hopper (sm_90a):
// o = q + bf16(f32(k)) over the first `rows` rows of each frame of [B, S, W],
// bf16.
//
// Replaces scripts/bench_vit_attention_variants.py::_dma_kernel (:97) and
// ::_dma_fn_kernel (:102) (Pallas, TPU; bench names dma_only, dma_s{S2},
// dma_f{F}).  On the TPU they measured the DMA and per-program floor of the
// block pipeline; the function is an elementwise add (bf16(f32(k)) is k).
//
// Bound on the H100: reads q and k and writes o once, 3 * B * rows * W * 2
// bytes (404 MB at B=256, S=257, W=1024, ~0.121 ms at 3.35 TB/s): bound by
// device memory, one FLOP per element.
//
// Design: one thread per 16 bytes (8 values) of the output, neighbouring
// threads on neighbouring addresses, a grid-stride loop.  The sum is taken in
// fp32 and rounded to bf16, as the plain version does.  A frame stride lets
// dma_s{S2} read the first S2 rows of each frame in place; F (frames a TPU
// program took) is TPU blocking only, so dma_f{F} is this same kernel.
//
// Plain C interface for ctypes: tspo_dma_add returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dma_add_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               __nv_bfloat16* __restrict__ o, long long n_chunks,
               long long chunks_per_frame, long long frame_stride) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n_chunks;
       i += (long long)gridDim.x * kThreads) {
    const long long f = i / chunks_per_frame, w = i % chunks_per_frame;
    const long long in = f * frame_stride + w * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(q + in);
    const uint4 b = *reinterpret_cast<const uint4*>(k + in);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
    uint4 r;
    __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fx = __bfloat1622float2(x[j]), fy = __bfloat1622float2(y[j]);
      z[j] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
    }
    *reinterpret_cast<uint4*>(o + i * 8) = r;
  }
}

}  // namespace

// q, k contiguous [B, S, W] (W % 8 == 0); o contiguous [B, rows, W] with
// rows <= S: o = q[:, :rows] + k[:, :rows].
extern "C" int tspo_dma_add(const void* q, const void* k, void* o, int B, int S,
                            int rows, int W, void* stream) {
  if (B <= 0 || S <= 0 || rows <= 0 || rows > S || W <= 0 || W % 8)
    return (int)cudaErrorInvalidValue;
  const long long per_frame = (long long)rows * W / 8;
  const long long n = per_frame * B;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond 32 blocks an SM
  dma_add_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(o), n, per_frame, (long long)S * W);
  return (int)cudaGetLastError();
}
