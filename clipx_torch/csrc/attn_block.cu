// fused_attn_block for Hopper (sm_90a): the whole ViT attention sublayer
// between LayerNorm and the residual add.
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
// C interface for ctypes; returns cudaGetLastError() after the launches.

#include "gemm.cuh"
#include "short_sdpa.cuh"

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
