// The MLP activations in f32, one copy for every GEMM epilogue that applies
// them: gemm_sm90.cuh (fused_mlp, bf16) and gemm_s8_sm90.cuh (fused_mlp_w8a8,
// int8). The forms are the Pallas kernels' (clipx/ops/packed_sdpa.py
// :386-388, :447-449): QuickGELU v * sigmoid(1.702 v) through expf, and
// the exact erf GELU through erff. The build uses no fast-math, so both are the
// library's accurate versions and B6's requantized codes stay bitwise.

#pragma once

namespace clipx {

__device__ __forceinline__ float quick_gelu_f32(float v) {
    return v * (1.f / (1.f + expf(-1.702f * v)));
}

__device__ __forceinline__ float gelu_erf_f32(float v) {
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

}  // namespace clipx
