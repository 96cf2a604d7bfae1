// bf16 tensor-core GEMM with f32 bias epilogues, for Hopper (sm_90a).
//
// Shared by long_sdpa.cu (the out projection of fused_sdpa_long_qkv) and
// mlp.cu (both GEMMs of fused_mlp; gemm_s8.cuh reuses its tiling). This
// header goes when they move to gemm_sm90.cuh's TMA + wgmma GEMM:
//
//     t = x[M, K] @ w[K, N] + bias[N]                  (f32 accumulate)
//     kEpiBias:      y = bf16(t)
//     kEpiQuickGelu: y = bf16(a(f32(bf16(t)))), a(v) = v * sigmoid(1.702 v)
//     kEpiGelu:      the same with the exact erf GELU
//     kEpiResidual:  y = bf16(f32(res) + f32(bf16(t)))
//
// The activation and residual forms keep the Pallas kernels' rounding
// points: fused_mlp rounds x @ w1 + b1 to bf16 before its f32 activation
// (clipx/ops/packed_sdpa.py:379-389), fused_attn_sublayer rounds the out
// projection before the residual add (:253-256).
//
// A 128-thread block computes a 64x64 output tile, each warp a 32x32
// quarter, with mma.sync m16n8k16 bf16 -> f32 on 64x32 / 32x64 tiles staged
// through shared memory. No load pipeline and no wgmma: a later, faster
// version adds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace clipx {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 128;
constexpr int kTilePitch = kBK + 8;  // bf16; 80-byte rows keep 16-byte alignment

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

enum GemmEpilogue : int { kEpiBias = 0, kEpiQuickGelu = 1, kEpiGelu = 2, kEpiResidual = 3 };

__device__ __forceinline__ float quick_gelu_f32(float v) {
    return v * (1.f / (1.f + expf(-1.702f * v)));
}

__device__ __forceinline__ float gelu_erf_f32(float v) {
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// The value an epilogue rounds to bf16, from the f32 accumulator, the bias
// and (kEpiResidual) the residual element.
template <int kEpi>
__device__ __forceinline__ float gemm_epilogue(float acc, float bias, float res) {
    const float t = acc + bias;
    if constexpr (kEpi == kEpiBias) return t;
    const float r = __bfloat162float(__float2bfloat16_rn(t));
    if constexpr (kEpi == kEpiQuickGelu) return quick_gelu_f32(r);
    if constexpr (kEpi == kEpiGelu) return gelu_erf_f32(r);
    return res + r;
}

// y[M, N] = epilogue(x[M, K] @ w[K, N], bias[N], res[M, N]); all row-major
// and contiguous (res is read only by kEpiResidual). Needs K % 32 == 0 and
// N % 64 == 0 (the wrappers check); rows past M are zero-filled on load and
// not stored.
template <int kEpi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                 __nv_bfloat16* __restrict__ y, int M, int N, int K) {
    __shared__ __align__(16) __nv_bfloat16 as[kBM][kTilePitch];  // [m][k]
    __shared__ __align__(16) __nv_bfloat16 bs[kBN][kTilePitch];  // [n][k], transposed

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // mma group id
    const int t = lane & 3;   // thread in group
    const int m0 = blockIdx.y * kBM;
    const int n0 = blockIdx.x * kBN;
    const int wm = (warp >> 1) * 32;
    const int wn = (warp & 1) * 32;

    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kBK) {
        // A tile: 64 rows x 32 k = 256 vectors of 8 bf16
        for (int i = tid; i < kBM * kBK / 8; i += kGemmThreads) {
            const int r = i / (kBK / 8);
            const int c = (i % (kBK / 8)) * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (m0 + r < M)
                val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
            *reinterpret_cast<uint4*>(&as[r][c]) = val;
        }
        // B tile: 32 k rows x 64 n, stored transposed so fragments are k-contiguous
        for (int i = tid; i < kBK * kBN / 8; i += kGemmThreads) {
            const int kr = i / (kBN / 8);
            const int c = (i % (kBN / 8)) * 8;
            const uint4 val =
                *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kr) * N + n0 + c);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
            for (int j = 0; j < 8; ++j) bs[c + j][kr] = e[j];
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            uint32_t a[2][4];
            uint32_t b[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int r = wm + mi * 16 + g;
                a[mi][0] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 2 * t]);
                a[mi][1] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 2 * t]);
                a[mi][2] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 2 * t + 8]);
                a[mi][3] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 2 * t + 8]);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int c = wn + ni * 8 + g;
                b[ni][0] = *reinterpret_cast<const uint32_t*>(&bs[c][kk + 2 * t]);
                b[ni][1] = *reinterpret_cast<const uint32_t*>(&bs[c][kk + 2 * t + 8]);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
        }
        __syncthreads();
    }

    // epilogue: f32 accumulator + f32 bias (and the activation or the
    // residual), rounded once more to bf16
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn + ni * 8 + 2 * t;
            const float b0 = bias[col];
            const float b1 = bias[col + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm + mi * 16 + g + 8 * half;
                if (row >= M) continue;
                const size_t at = (size_t)row * N + col;
                float2 r = make_float2(0.f, 0.f);
                if constexpr (kEpi == kEpiResidual)
                    r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + at));
                *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(
                    gemm_epilogue<kEpi>(acc[mi][ni][2 * half], b0, r.x),
                    gemm_epilogue<kEpi>(acc[mi][ni][2 * half + 1], b1, r.y));
            }
        }
    }
}

template <int kEpi>
inline void launch_gemm(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                        const __nv_bfloat16* res, __nv_bfloat16* y, int M, int N, int K,
                        cudaStream_t stream) {
    const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
    gemm_bias_kernel<kEpi><<<grid, kGemmThreads, 0, stream>>>(x, w, bias, res, y, M, N, K);
}

inline void launch_gemm_bias(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const float* bias, __nv_bfloat16* y, int M, int N, int K,
                             cudaStream_t stream) {
    launch_gemm<kEpiBias>(x, w, bias, nullptr, y, M, N, K, stream);
}

}  // namespace clipx
