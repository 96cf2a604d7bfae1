// fused_attn_block and fused_attn_sublayer for Hopper (sm_90a): the ViT
// attention sublayer between LayerNorm and the residual add, and the whole
// pre-LN sublayer with both.
//
// Replaces clipx/ops/packed_sdpa.py::fused_attn_block (`_attn_block_kernel`,
// :187, and `_attn_block_core`, :220; pallas_call at :344):
//
//     qkv = bf16(x @ [Wq|Wk|Wv] + b_qkv)                 (f32 accumulate)
//     o_h = bf16(softmax(q_h k_h^T / 8, keys >= S masked) @ v_h)   per head
//     out = bf16(o @ Wo + b_o)                           (f32 accumulate)
//
// On the TPU one program held the weights in VMEM and packed two batch rows
// per 128x128 MXU tile. Here the sublayer is three hand-written kernels on
// one stream, launched by one C call: a bf16 tensor-core GEMM with an f32
// bias epilogue for the qkv projection, the short-SDPA kernel of
// short_sdpa.cuh over the packed (B*S, 3W) projection output, and the same
// GEMM for the out-projection. The bf16 rounding points are those of the
// Pallas kernel: qkv, the probabilities, the per-head outputs and the result.
//
// What bounds it on this card: at ViT-B/32, batch 128 (S = 50, W = 768) the
// call does ~31 GFLOP (22.6 qkv, 7.6 out-projection, 1.0 attention) against
// ~24 MB of compulsory traffic, so it is bound by operations: ~32 us at the
// 989 TFLOP/s bf16 peak. The GEMM tiles a 64x64 output block per 128-thread
// block (each warp a 32x32 quarter) and runs mma.sync m16n8k16 bf16 -> f32
// on tiles staged through shared memory; weights (4.7 MB) stay in the 50 MB
// L2 across blocks. The qkv intermediate (29 MB at batch 128) makes one
// round trip through L2/HBM, which the TPU kernel kept on chip: that, the
// lack of a load pipeline and mma.sync instead of wgmma are what a later,
// faster version removes. The GEMM lives in gemm.cuh (shared with
// long_sdpa.cu).
//
// fused_attn_sublayer replaces clipx/ops/packed_sdpa.py::fused_attn_sublayer
// (`_attn_sublayer_kernel`, :200, on the same core; pallas_call at :291):
//
//     y   = bf16(LayerNorm(x) * scale + bias)            (f32 statistics)
//     out = bf16(x + bf16(fused_attn_block(y)))
//
// in four launches: a LayerNorm kernel (one warp per row: the f32 mean, then
// the mean of squared deviations, two passes as the Pallas kernel's
// :208-213), then fused_attn_block's three, the out-projection GEMM with the
// residual epilogue of gemm.cuh (round the projection, then add, :253-256).
// The LN output and the residual make the round trips through L2/HBM that
// the TPU kernel kept in VMEM. The TPU kernel's two batch rows a program
// and its zero padding to S = 64 are tiling choices with no counterpart.
//
// C interface for ctypes; each entry returns cudaGetLastError() after its
// launches.

#include "gemm.cuh"
#include "short_sdpa.cuh"

namespace {

constexpr int kLnThreads = 256;  // one warp per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// y[r, :] = bf16((x[r, :] - mean) * rsqrt(var + eps) * scale + bias), with
// the mean and the variance (mean of squared deviations) in f32.
__global__ void __launch_bounds__(kLnThreads)
layernorm_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int rows,
                      int width, float eps) {
    const int row = (blockIdx.x * kLnThreads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const __nv_bfloat16* xr = x + (size_t)row * width;
    float sum = 0.f;
    for (int j = lane; j < width; j += 32) sum += __bfloat162float(xr[j]);
    const float mean = warp_sum(sum) / width;
    float sq = 0.f;
    for (int j = lane; j < width; j += 32) {
        const float d = __bfloat162float(xr[j]) - mean;
        sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / width + eps);
    __nv_bfloat16* yr = y + (size_t)row * width;
    for (int j = lane; j < width; j += 32)
        yr[j] = __float2bfloat16_rn((__bfloat162float(xr[j]) - mean) * inv * scale[j] + bias[j]);
}

}  // namespace

// x: (B, S, W) bf16; wqkv: (W, 3W) bf16; bqkv: (3W,) f32; wo: (W, W) bf16;
// bo: (W,) f32; qkv_buf: (B*S, 3W) bf16 scratch; attn_buf: (B*S, W) bf16
// scratch; out: (B, S, W) bf16. S <= 64, W = heads * 64.
extern "C" int clipx_fused_attn_block(const void* x, const void* wqkv, const void* bqkv,
                                      const void* wo, const void* bo, void* qkv_buf,
                                      void* attn_buf, void* out, int batch, int seq,
                                      int width, int heads, void* stream) {
    using bf16 = __nv_bfloat16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows = batch * seq;
    bf16* qkv = static_cast<bf16*>(qkv_buf);
    bf16* attn = static_cast<bf16*>(attn_buf);
    clipx::launch_gemm_bias(static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
                            static_cast<const float*>(bqkv), qkv, rows, 3 * width, width,
                            st);
    clipx::launch_short_sdpa(qkv, qkv + width, qkv + 2 * width, attn, batch, seq, heads,
                             3 * width, width, st);
    clipx::launch_gemm_bias(attn, static_cast<const bf16*>(wo),
                            static_cast<const float*>(bo), static_cast<bf16*>(out), rows,
                            width, width, st);
    return static_cast<int>(cudaGetLastError());
}

// x: (B, S, W) bf16; ln_scale, ln_bias: (W,) f32; wqkv, bqkv, wo, bo as in
// clipx_fused_attn_block; ln_buf: (B*S, W) bf16 scratch; qkv_buf, attn_buf
// as there; out: (B, S, W) bf16 = x + attention(LayerNorm(x)).
extern "C" int clipx_fused_attn_sublayer(const void* x, const void* ln_scale,
                                         const void* ln_bias, const void* wqkv,
                                         const void* bqkv, const void* wo, const void* bo,
                                         void* ln_buf, void* qkv_buf, void* attn_buf,
                                         void* out, int batch, int seq, int width, int heads,
                                         float eps, void* stream) {
    using bf16 = __nv_bfloat16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows = batch * seq;
    const bf16* raw = static_cast<const bf16*>(x);
    bf16* ln = static_cast<bf16*>(ln_buf);
    bf16* qkv = static_cast<bf16*>(qkv_buf);
    bf16* attn = static_cast<bf16*>(attn_buf);
    layernorm_rows_kernel<<<(rows * 32 + kLnThreads - 1) / kLnThreads, kLnThreads, 0, st>>>(
        raw, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), ln, rows,
        width, eps);
    clipx::launch_gemm_bias(ln, static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
                            qkv, rows, 3 * width, width, st);
    clipx::launch_short_sdpa(qkv, qkv + width, qkv + 2 * width, attn, batch, seq, heads,
                             3 * width, width, st);
    clipx::launch_gemm<clipx::kEpiResidual>(attn, static_cast<const bf16*>(wo),
                                            static_cast<const float*>(bo), raw,
                                            static_cast<bf16*>(out), rows, width, width, st);
    return static_cast<int>(cudaGetLastError());
}
