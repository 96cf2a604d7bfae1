// What is left of the port's first tensor-core GEMM, for Hopper (sm_90a):
// the mma.sync m16n8k16 bf16 -> f32 instruction and the 64 x 64,
// 128-thread tiling that gemm_s8.cuh's int8 GEMM (fused_mlp_w8a8) still
// uses. long_sdpa.cu calls mma_bf16_16816 for QK^T and P @ V.
//
// Every bf16 GEMM of the port (the out projections of fused_attn_block,
// fused_attn_sublayer and fused_sdpa_long_qkv, both GEMMs of fused_mlp)
// runs on gemm_sm90.cuh's TMA + wgmma GEMM. This header goes when
// fused_mlp_w8a8's int8 GEMM moves to wgmma too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace clipx {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kGemmThreads = 128;

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace clipx
