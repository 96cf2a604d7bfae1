// Short-sequence scaled dot-product attention for ViT towers on Hopper.
//
// Shared by short_sdpa.cu (packed_sdpa / packed_sdpa_rows) and
// attn_block.cu (the SDPA step of fused_attn_block).
//
// Replaces the SDPA body of the Pallas kernels in clipx/ops/packed_sdpa.py:
// `_kernel` (packed_sdpa, :35), `_rows_kernel` (packed_sdpa_rows, :75) and
// the per-head loop of `_attn_block_core` (:220). Those kernels pack two
// heads (or two batch rows) into one 128x128 MXU tile with a block-diagonal
// mask; that is a TPU tile trick and is not carried over. Here one thread
// block computes one (batch row, head) pair.
//
// Numerics (kept from the Pallas kernels): scores accumulate in f32 and are
// scaled by 1/sqrt(64); keys at positions >= seq_len are masked to -1e30;
// softmax is f32 and max-subtracted; probabilities are rounded to bf16;
// probs @ V accumulates in f32 and is stored bf16.
//
// What bounds it on this card: at the ViT-B/32 shapes (S = 50, D = 64) one
// (row, head) pair moves 3 x 6.4 KB in and 6.4 KB out for ~0.6 MFLOP, about
// 25 FLOP per byte, far below the H100's ~295 FLOP/byte ridge, so it is
// bound by bytes (and, at batch 1, by the launch itself). The design reads
// each Q/K/V element from device memory once into shared memory and keeps
// scores and probabilities in registers: one warp owns a query row, each
// lane two keys, and the row's softmax is two warp reductions. Plain FMA
// instead of tensor cores is enough while the kernel is byte-bound.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace clipx {

constexpr int kSP = 64;            // padded sequence block: S <= 64
constexpr int kHeadDim = 64;       // D
constexpr int kSdpaThreads = 128;  // 4 warps
constexpr int kSmemRow = kHeadDim + 2;  // bf16 row pitch: 33 words, no bank conflicts
constexpr float kNegMask = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// q, k, v: element (b, s, h*64 + d) at ptr[(b * seq + s) * ld_in + h * 64 + d].
// o:       element (b, s, h*64 + d) at o[(b * seq + s) * ld_out + h * 64 + d].
// Grid: batch * heads blocks of kSdpaThreads threads.
__global__ void __launch_bounds__(kSdpaThreads)
short_sdpa_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o,
                  int seq, int heads, int ld_in, int ld_out, float scale) {
    __shared__ __align__(16) __nv_bfloat16 qs[kSP * kSmemRow];
    __shared__ __align__(16) __nv_bfloat16 ks[kSP * kSmemRow];
    __shared__ __align__(16) __nv_bfloat16 vs[kSP * kSmemRow];

    const int b = blockIdx.x / heads;
    const int h = blockIdx.x % heads;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // Load the (seq, 64) head slices: 8 x 16-byte vectors per row. Shared
    // rows are 132 bytes apart, so each vector is stored as 4 words.
    const int vecs = seq * (kHeadDim / 8);
    for (int t = tid; t < 3 * vecs; t += kSdpaThreads) {
        const int which = t / vecs;
        const int r = (t % vecs) / (kHeadDim / 8);
        const int c = (t % (kHeadDim / 8)) * 8;
        const __nv_bfloat16* src = which == 0 ? q : (which == 1 ? k : v);
        const uint4 val = *reinterpret_cast<const uint4*>(
            src + (size_t)(b * seq + r) * ld_in + h * kHeadDim + c);
        __nv_bfloat16* dst = (which == 0 ? qs : (which == 1 ? ks : vs)) + r * kSmemRow + c;
        uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
        d32[0] = val.x;
        d32[1] = val.y;
        d32[2] = val.z;
        d32[3] = val.w;
    }
    __syncthreads();

    for (int i = warp; i < seq; i += kSdpaThreads / 32) {
        const __nv_bfloat162* qrow = reinterpret_cast<const __nv_bfloat162*>(qs + i * kSmemRow);
        float s[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = lane + 32 * half;
            if (j < seq) {
                const __nv_bfloat162* krow =
                    reinterpret_cast<const __nv_bfloat162*>(ks + j * kSmemRow);
                float acc = 0.f;
#pragma unroll
                for (int d2 = 0; d2 < kHeadDim / 2; ++d2) {
                    const float2 qf = __bfloat1622float2(qrow[d2]);
                    const float2 kf = __bfloat1622float2(krow[d2]);
                    acc = fmaf(qf.x, kf.x, acc);
                    acc = fmaf(qf.y, kf.y, acc);
                }
                s[half] = acc * scale;
            } else {
                s[half] = kNegMask;
            }
        }
        const float m = warp_max(fmaxf(s[0], s[1]));
        const float e0 = expf(s[0] - m);
        const float e1 = expf(s[1] - m);
        const float denom = warp_sum(e0 + e1);
        // probabilities rounded to bf16, as the Pallas kernels cast them
        const float p0 = __bfloat162float(__float2bfloat16_rn(e0 / denom));
        const float p1 = __bfloat162float(__float2bfloat16_rn(e1 / denom));

        float acc0 = 0.f, acc1 = 0.f;
        for (int j = 0; j < seq; ++j) {
            const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
            const __nv_bfloat16* vrow = vs + j * kSmemRow;
            acc0 = fmaf(pj, __bfloat162float(vrow[lane]), acc0);
            acc1 = fmaf(pj, __bfloat162float(vrow[lane + 32]), acc1);
        }
        __nv_bfloat16* orow = o + (size_t)(b * seq + i) * ld_out + h * kHeadDim;
        orow[lane] = __float2bfloat16_rn(acc0);
        orow[lane + 32] = __float2bfloat16_rn(acc1);
    }
}

inline void launch_short_sdpa(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* o, int batch,
                              int seq, int heads, int ld_in, int ld_out,
                              cudaStream_t stream) {
    const float scale = 0.125f;  // 1 / sqrt(64)
    short_sdpa_kernel<<<batch * heads, kSdpaThreads, 0, stream>>>(
        q, k, v, o, seq, heads, ld_in, ld_out, scale);
}

}  // namespace clipx
