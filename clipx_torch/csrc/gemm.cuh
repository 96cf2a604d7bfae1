// What is left of the port's first tensor-core GEMM, for Hopper (sm_90a):
// the 64 x 64, 128-thread tiling that gemm_s8.cuh's int8 GEMM
// (fused_mlp_w8a8) still uses.
//
// Every bf16 GEMM of the port (the out projections of fused_attn_block,
// fused_attn_sublayer and fused_sdpa_long_qkv, both GEMMs of fused_mlp)
// runs on gemm_sm90.cuh's TMA + wgmma GEMM, and every SDPA on
// sdpa_sm90.cuh's. This header goes when fused_mlp_w8a8's int8 GEMM moves
// to wgmma too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace clipx {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kGemmThreads = 128;

}  // namespace clipx
