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
// in two launches on one stream: attn_core_sm90.cuh's kernel (the qkv
// projection and the attention of two batch rows and one head a block,
// qkv kept on chip), then gemm_sm90.cuh's TMA + wgmma GEMM with the bias
// epilogue for the out projection. The bf16 rounding points are those of
// the Pallas kernel: qkv, the probabilities, the per-head outputs and the
// result.
//
// What bounds it on this card: at ViT-B/32, batch 128 (S = 50, W = 768)
// the call does ~31 GFLOP (22.6 qkv, 7.6 out projection, 1.0 attention)
// against ~24 MB of compulsory traffic, so it is bound by operations:
// ~32 us at the 989 TFLOP/s bf16 peak. The head outputs (9.8 MB) make one
// round trip through L2 between the two kernels; qkv (29.5 MB) makes none.
// The design notes of each kernel are in its header.
//
// fused_attn_sublayer replaces clipx/ops/packed_sdpa.py::fused_attn_sublayer
// (`_attn_sublayer_kernel`, :200, on the same core; pallas_call at :291):
//
//     y   = bf16(LayerNorm(x) * scale + bias)            (f32 statistics)
//     out = bf16(x + bf16(fused_attn_block(y)))
//
// in three launches: a LayerNorm kernel (one warp a row, 16-byte loads;
// the f32 mean, then the mean of squared deviations, two passes as the
// Pallas kernel's :208-213; bound by its 2 x 9.8 MB of bytes, ~6 us), the
// attention core on y, then the GEMM with the residual epilogue (round the
// projection, then add, :253-256). The LN output and the head outputs make
// the round trips through L2 that the TPU kernel kept in VMEM.
//
// C interface for ctypes; each entry returns the first launch error, or
// cudaGetLastError() after its launches.

#include "attn_core_sm90.cuh"

namespace {

using clipx::sm90::bf16;

constexpr int kLnThreads = 256;  // one warp per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(p[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}

// y[r, :] = bf16((x[r, :] - mean) * rsqrt(var + eps) * scale + bias), with
// the mean and the variance (mean of squared deviations) in f32. Rows are
// read as 16-byte vectors (width % 8 == 0); the second and third passes
// hit the L1.
__global__ void __launch_bounds__(kLnThreads)
layernorm_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, bf16* __restrict__ y, int rows,
                      int width, float eps) {
    const int row = (blockIdx.x * kLnThreads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const int nv = width / 8;
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * width);
    float f[8];
    float sum = 0.f;
    for (int v = lane; v < nv; v += 32) {
        unpack8(xr[v], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += f[i];
    }
    const float mean = warp_sum(sum) / width;
    float sq = 0.f;
    for (int v = lane; v < nv; v += 32) {
        unpack8(xr[v], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float d = f[i] - mean;
            sq += d * d;
        }
    }
    const float inv = rsqrtf(warp_sum(sq) / width + eps);
    const float4* s4 = reinterpret_cast<const float4*>(scale);
    const float4* b4 = reinterpret_cast<const float4*>(bias);
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * width);
    for (int v = lane; v < nv; v += 32) {
        unpack8(xr[v], f);
        const float4 sa = s4[2 * v], sb = s4[2 * v + 1];
        const float4 ba = b4[2 * v], bb = b4[2 * v + 1];
        const float s[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
        const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
        uint4 out;
        uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            o[i] = clipx::sm90::pack_bf16((f[2 * i] - mean) * inv * s[2 * i] + b[2 * i],
                                          (f[2 * i + 1] - mean) * inv * s[2 * i + 1] +
                                              b[2 * i + 1]);
        yr[v] = out;
    }
}

}  // namespace

// x: (B, S, W) bf16; wqkv: (W, 3W) bf16; bqkv: (3W,) f32; wo: (W, W) bf16;
// bo: (W,) f32; attn_buf: (B*S, W) bf16 scratch; out: (B, S, W) bf16.
// S <= 64, W = heads * 64; bn: the out projection's tile width (64, 128 or
// 192, dividing W).
extern "C" int clipx_fused_attn_block(const void* x, const void* wqkv, const void* bqkv,
                                      const void* wo, const void* bo, void* attn_buf,
                                      void* out, int batch, int seq, int width, int heads,
                                      int bn, void* stream) {
    namespace sm = clipx::sm90;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bf16* attn = static_cast<bf16*>(attn_buf);
    cudaError_t e = sm::launch_attn_core(static_cast<const bf16*>(x),
                                         static_cast<const bf16*>(wqkv),
                                         static_cast<const float*>(bqkv), attn, batch, seq,
                                         width, heads, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = sm::launch_gemm<sm::kEpiBias>(attn, static_cast<const bf16*>(wo),
                                      static_cast<const float*>(bo), nullptr,
                                      static_cast<bf16*>(out), batch * seq, width, width, bn,
                                      st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// x: (B, S, W) bf16; ln_scale, ln_bias: (W,) f32; wqkv, bqkv, wo, bo, bn as
// in clipx_fused_attn_block; ln_buf, attn_buf: (B*S, W) bf16 scratch; out:
// (B, S, W) bf16 = x + attention(LayerNorm(x)).
extern "C" int clipx_fused_attn_sublayer(const void* x, const void* ln_scale,
                                         const void* ln_bias, const void* wqkv,
                                         const void* bqkv, const void* wo, const void* bo,
                                         void* ln_buf, void* attn_buf, void* out, int batch,
                                         int seq, int width, int heads, int bn, float eps,
                                         void* stream) {
    namespace sm = clipx::sm90;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows = batch * seq;
    const bf16* raw = static_cast<const bf16*>(x);
    bf16* ln = static_cast<bf16*>(ln_buf);
    bf16* attn = static_cast<bf16*>(attn_buf);
    layernorm_rows_kernel<<<(rows * 32 + kLnThreads - 1) / kLnThreads, kLnThreads, 0, st>>>(
        raw, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), ln, rows,
        width, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    e = sm::launch_attn_core(ln, static_cast<const bf16*>(wqkv),
                             static_cast<const float*>(bqkv), attn, batch, seq, width, heads,
                             st);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = sm::launch_gemm<sm::kEpiResidual>(attn, static_cast<const bf16*>(wo),
                                          static_cast<const float*>(bo), raw,
                                          static_cast<bf16*>(out), rows, width, width, bn, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
