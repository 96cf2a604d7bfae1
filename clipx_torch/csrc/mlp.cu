// The transformer MLP for Hopper (sm_90a): fused_mlp (bf16) and
// fused_mlp_w8a8 (W8A8), each one C call over (R, W) token rows.
//
// Replaces, in clipx/ops/packed_sdpa.py:
// - fused_mlp (`_mlp_block_kernel`, :370; pallas_call at :530):
//       h = bf16(x @ W1 + b1);  a = bf16(act(f32(h)));  y = bf16(a @ W2 + b2)
//   with f32 accumulation, act QuickGELU (x * sigmoid(1.702 x)) or the exact
//   erf GELU in f32. Two launches of gemm_sm90.cuh's TMA + wgmma GEMM: the
//   up projection with the activation epilogue into the bf16 hidden layer,
//   the down projection with the bias epilogue.
// - fused_mlp_w8a8 (`_mlp_w8a8_kernel`, :426; pallas_call at :485):
//       xq, xs = quant_rows(f32(x))
//       h = act(f32(xq @ W1q) * (xs * s1) + b1)        (f32)
//       hq, hs = quant_rows(h)
//       y = bf16(f32(hq @ W2q) * (hs * s2) + b2)
//   Four launches: the row quantizer, gemm_s8_sm90.cuh's TMA + wgmma int8
//   GEMM with the dequantize + activation epilogue into an f32 scratch (its
//   epilogue also folds each row's |h| max by atomicMax, so that the second
//   quantizer reads h once), the quantizer again, the int8 GEMM with the
//   dequantize epilogue. The int8 GEMM reads K-major (N, K) weight copies,
//   w1_qt (H, W) and w2_qt (W, H): int8 wgmma has no transpose bit.
//
// On the TPU one program held both weight matrices in VMEM and kept its
// 128 rows' hidden tile on chip. Here the hidden layer makes one round trip
// through L2/HBM: bf16 (R, H) for fused_mlp (39 MB at ViT-B/32, batch 128,
// against a 50 MB L2), f32 plus int8 codes for fused_mlp_w8a8 (79 + 20
// MB). Keeping it on chip does not fit: a 128-row block's f32 accumulator
// of the output at W = 768 is 384 KB. The weights (4.7 MB bf16, 2.4 MB
// int8 a layer at ViT-B/32) stay in L2 across blocks.
//
// What bounds them on this card, at ViT-B/32 batch 128 (R = 6,400, W = 768,
// H = 3,072): 4 R W H = 60.4 G operations against ~24-29 MB of compulsory
// traffic, so operations: 0.061 ms at the bf16 peak (989 TFLOP/s) and 0.031
// ms at the int8 peak (1,979 TOP/s). Both reach that rate only through
// wgmma, which their GEMMs use; what stays between them and the bound is
// the GEMM's own (one block an SM, a tail of partial waves: the wrapper
// picks each GEMM's tile width by a measured rule) and, for the W8A8 MLP,
// the f32 hidden layer's round trip and its two quantizer passes.
//
// C interface for ctypes; each entry returns cudaGetLastError() after its
// launches.

#include "gemm_s8_sm90.cuh"

// x: (R, W) bf16; w1: (W, H) bf16; b1: (H,) f32; w2: (H, W) bf16; b2: (W,)
// f32; h_buf: (R, H) bf16 scratch; out: (R, W) bf16; every pointer 16-byte
// aligned (the TMA tensor maps need it). W % 64 == 0, H % 64 == 0. quick:
// 1 for QuickGELU, 0 for the erf GELU. bn_up, bn_down: the two GEMMs' tile
// widths (64, 128 or 192), dividing H and W.
extern "C" int clipx_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* h_buf, void* out, int rows, int width,
                               int hidden, int quick, int bn_up, int bn_down, void* stream) {
    namespace sm = clipx::sm90;
    using bf16 = __nv_bfloat16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bf16* h = static_cast<bf16*>(h_buf);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* w1b = static_cast<const bf16*>(w1);
    const float* b1f = static_cast<const float*>(b1);
    const cudaError_t e =
        quick ? sm::launch_gemm<sm::kEpiQuickGelu>(xb, w1b, b1f, nullptr, h, rows, hidden,
                                                   width, bn_up, st)
              : sm::launch_gemm<sm::kEpiGelu>(xb, w1b, b1f, nullptr, h, rows, hidden, width,
                                              bn_up, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(sm::launch_gemm<sm::kEpiBias>(
        h, static_cast<const bf16*>(w2), static_cast<const float*>(b2), nullptr,
        static_cast<bf16*>(out), rows, width, hidden, bn_down, st));
}

// x: (R, W) bf16; w1qt: (H, W) int8 (W1's codes, K-major), s1, b1: (H,)
// f32; w2qt: (W, H) int8, s2, b2: (W,) f32; scratch xq: (R, W) int8, xs:
// (R,) f32, h: (R, H) f32, hq: (R, H) int8, hs: (R,) f32; out: (R, W) bf16;
// every pointer 16-byte aligned. W % 64 == 0, H % 64 == 0. bn_up, bn_down:
// the two GEMMs' tile widths (64, 128 or 192), dividing H and W.
extern "C" int clipx_fused_mlp_w8a8(const void* x, const void* w1qt, const void* s1,
                                    const void* b1, const void* w2qt, const void* s2,
                                    const void* b2, void* xq, void* xs, void* h, void* hq,
                                    void* hs, void* out, int rows, int width, int hidden,
                                    int quick, int bn_up, int bn_down, void* stream) {
    namespace sm = clipx::sm90;
    using bf16 = __nv_bfloat16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int8_t* xq8 = static_cast<int8_t*>(xq);
    int8_t* hq8 = static_cast<int8_t*>(hq);
    float* xsf = static_cast<float*>(xs);
    float* hsf = static_cast<float*>(hs);
    float* hf = static_cast<float*>(h);
    const auto* w1 = static_cast<const int8_t*>(w1qt);
    const auto* s1f = static_cast<const float*>(s1);
    const auto* b1f = static_cast<const float*>(b1);
    // hs first carries the hidden rows' |h| maxima as f32 bits: zeroed by
    // the first quantizer, folded by the up GEMM's epilogue, read by the
    // second quantizer, which overwrites each with the row's scale
    unsigned* h_amax = reinterpret_cast<unsigned*>(hsf);
    sm::launch_quant_rows(static_cast<const bf16*>(x), xq8, xsf, nullptr, h_amax, rows, width,
                          st);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    e = quick ? sm::launch_gemm_s8<sm::kS8QuickGelu>(xq8, w1, xsf, s1f, b1f, hf, h_amax, rows,
                                                     hidden, width, bn_up, st)
              : sm::launch_gemm_s8<sm::kS8Gelu>(xq8, w1, xsf, s1f, b1f, hf, h_amax, rows, hidden,
                                                width, bn_up, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    sm::launch_quant_rows(static_cast<const float*>(hf), hq8, hsf, h_amax, nullptr, rows, hidden,
                          st);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(sm::launch_gemm_s8<sm::kS8Bf16>(
        hq8, static_cast<const int8_t*>(w2qt), hsf, static_cast<const float*>(s2),
        static_cast<const float*>(b2), static_cast<bf16*>(out), nullptr, rows, width, hidden,
        bn_down, st));
}
