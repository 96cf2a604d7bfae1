// The port's SDPA entries for Hopper (sm_90a), all on sdpa_sm90.cuh's TMA +
// wgmma kernel: packed_sdpa, packed_sdpa_rows, packed_sdpa_qkv,
// fused_sdpa_long and flash_attention through clipx_sdpa (each wrapper
// passes its own pointers and strides), and fused_sdpa_long_qkv, whose
// attention step is the same kernel on the packed projection and whose out
// projection and bias run on gemm_sm90.cuh's GEMM.
//
// fused_sdpa_long_qkv replaces clipx/ops/packed_sdpa.py::fused_sdpa_long_qkv
// (`_long_qkv_kernel`, :670; pallas_call :742). Its out projection at
// ViT-L/14@336px and batch 128 is a 73,856 x 1024 x 1024 GEMM, 155 GFLOP
// against ~305 MB, bound by operations (0.157 ms at the bf16 peak); the head
// outputs make one bf16 round trip through attn_buf between the launches.
//
// C interface for ctypes; each entry returns the first launch error, or
// cudaGetLastError() after its launches.

#include "sdpa_sm90.cuh"

// q, k, v, o: bf16; element (b, h, s, d) at ptr[b * s_b + h * s_h + s * s_s + d]
// (inputs share one set of strides, the output has its own). head_dim is 32,
// 64, 72 or 128; bases 16-byte aligned and input strides multiples of 8 (the
// wrappers check; the tensor maps refuse anything else).
extern "C" int clipx_sdpa(const void* q, const void* k, const void* v, void* o, int batch,
                          int heads, int seq, int head_dim, long long in_b, long long in_h,
                          long long in_s, long long out_b, long long out_h, long long out_s,
                          int causal, void* stream) {
    using clipx::sm90::bf16;
    const long long in[3] = {in_s, in_h, in_b};
    const long long out[3] = {out_s, out_h, out_b};
    return static_cast<int>(clipx::sm90::launch_sdpa(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), batch, heads, seq, head_dim, in, out, causal,
        static_cast<cudaStream_t>(stream)));
}

// fused_sdpa_long_qkv. qkv: (B, S, 3W) bf16, lanes [q | k | v]; wo: (W, W)
// bf16; bo: (W,) f32; attn_buf: (B*S, W) bf16 scratch; out: (B, S, W) bf16.
// W = heads * head_dim, W % 64 == 0; bn: the out projection's tile width
// (64, 128 or 192, dividing W). The attention writes bf16 head outputs
// (the Pallas kernel's rounding of o_h) into attn_buf; the GEMM then sums
// o_h @ wo_h over all heads in one f32 accumulator and adds bo, which is
// the Pallas kernel's head-by-head f32 sum up to summation order.
extern "C" int clipx_fused_sdpa_long_qkv(const void* qkv, const void* wo, const void* bo,
                                         void* attn_buf, void* out, int batch, int seq,
                                         int width, int heads, int causal, int bn,
                                         void* stream) {
    namespace sm = clipx::sm90;
    using sm::bf16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* t = static_cast<const bf16*>(qkv);
    bf16* attn = static_cast<bf16*>(attn_buf);
    const int head_dim = width / heads;
    const long long w3 = 3LL * width;
    const long long in[3] = {w3, head_dim, seq * w3};
    const long long o_st[3] = {width, head_dim, static_cast<long long>(seq) * width};
    const cudaError_t rc = sm::launch_sdpa(t, t + width, t + 2 * width, attn, batch, heads, seq,
                                           head_dim, in, o_st, causal, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(sm::launch_gemm<sm::kEpiBias>(
        attn, static_cast<const bf16*>(wo), static_cast<const float*>(bo), nullptr,
        static_cast<bf16*>(out), batch * seq, width, width, bn, st));
}
