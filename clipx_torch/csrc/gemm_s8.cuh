// int8 tensor-core GEMM with f32 dequantizing epilogues, and the per-row
// dynamic int8 quantizer that feeds it, for Hopper (sm_90a). Used by mlp.cu
// (fused_mlp_w8a8).
//
//     acc[M, N] = xq[M, K] @ wq[K, N]          (int8 x int8, exact int32)
//     v = f32(acc) * (row_scale[m] * col_scale[n]) + bias[n]
//     kS8Bf16:      y = bf16(v)
//     kS8QuickGelu: y = v * sigmoid(1.702 v), stored f32
//     kS8Gelu:      y = the exact erf GELU of v, stored f32
//
// The dequantization is the Pallas kernel's order (clipx/ops/packed_sdpa.py
// :444-445, :453): the two scales multiply first, then the accumulator, then
// the bias is added. __fmul_rn / __fadd_rn keep nvcc from contracting it
// into an FMA, which would round once instead of twice and, through the
// requantization of the hidden layer, flip an occasional int8 code.
//
// The tile layout is gemm.cuh's: a 128-thread block computes a 64x64 output
// tile, each warp a 32x32 quarter, staged through shared memory (the B tile
// transposed so fragments are k-contiguous), here with 64-byte K tiles and
// mma.sync m16n8k32 s8 -> s32. The int8 fragments hold four values a
// register in the byte positions the bf16 m16n8k16 fragments hold two. No
// load pipeline and no wgmma: a later, faster version adds them. The
// activations are act.cuh's, the same functions the bf16 MLP's epilogue
// calls.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act.cuh"
#include "gemm.cuh"

namespace clipx {

constexpr int kS8BK = 64;              // K tile, bytes
constexpr int kS8Pitch = kS8BK + 16;   // 80-byte rows keep 16-byte alignment
constexpr int kQuantThreads = 256;     // quant_rows: one warp per row

enum GemmS8Epilogue : int { kS8Bf16 = 0, kS8QuickGelu = 1, kS8Gelu = 2 };

// c += a (16x32 int8, row-major fragment) * b (32x8 int8, column-major)
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kEpi>
__device__ __forceinline__ float s8_epilogue(int acc, float row_scale, float col_scale,
                                             float bias) {
    const float v = __fadd_rn(__fmul_rn(static_cast<float>(acc), __fmul_rn(row_scale, col_scale)),
                              bias);
    if constexpr (kEpi == kS8QuickGelu) return quick_gelu_f32(v);
    if constexpr (kEpi == kS8Gelu) return gelu_erf_f32(v);
    return v;
}

// y[M, N] = epilogue(xq[M, K] @ wq[K, N]); all row-major and contiguous.
// OutT is __nv_bfloat16 for kS8Bf16 and float otherwise. Needs K % 64 == 0
// and N % 64 == 0 (the wrapper checks); rows past M are zero-filled on load
// and not stored.
template <int kEpi, typename OutT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ row_scale, const float* __restrict__ col_scale,
               const float* __restrict__ bias, OutT* __restrict__ y, int M, int N, int K) {
    __shared__ __align__(16) int8_t as[kBM][kS8Pitch];  // [m][k]
    __shared__ __align__(16) int8_t bs[kBN][kS8Pitch];  // [n][k], transposed

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // mma group id
    const int t = lane & 3;   // thread in group
    const int m0 = blockIdx.y * kBM;
    const int n0 = blockIdx.x * kBN;
    const int wm = (warp >> 1) * 32;
    const int wn = (warp & 1) * 32;

    int acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

    for (int k0 = 0; k0 < K; k0 += kS8BK) {
        // A tile: 64 rows x 64 k = 256 vectors of 16 bytes
        for (int i = tid; i < kBM * kS8BK / 16; i += kGemmThreads) {
            const int r = i / (kS8BK / 16);
            const int c = (i % (kS8BK / 16)) * 16;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (m0 + r < M)
                val = *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * K + k0 + c);
            *reinterpret_cast<uint4*>(&as[r][c]) = val;
        }
        // B tile: 64 k rows x 64 n, stored transposed
        for (int i = tid; i < kS8BK * kBN / 16; i += kGemmThreads) {
            const int kr = i / (kBN / 16);
            const int c = (i % (kBN / 16)) * 16;
            const uint4 val =
                *reinterpret_cast<const uint4*>(wq + (size_t)(k0 + kr) * N + n0 + c);
            const int8_t* e = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
            for (int j = 0; j < 16; ++j) bs[c + j][kr] = e[j];
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < kS8BK; kk += 32) {
            uint32_t a[2][4];
            uint32_t b[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int r = wm + mi * 16 + g;
                a[mi][0] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 4 * t]);
                a[mi][1] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 4 * t]);
                a[mi][2] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 4 * t + 16]);
                a[mi][3] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 4 * t + 16]);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int c = wn + ni * 8 + g;
                b[ni][0] = *reinterpret_cast<const uint32_t*>(&bs[c][kk + 4 * t]);
                b[ni][1] = *reinterpret_cast<const uint32_t*>(&bs[c][kk + 4 * t + 16]);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma_s8_16832(acc[mi][ni], a[mi], b[ni]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn + ni * 8 + 2 * t;
            const float cs0 = col_scale[col], cs1 = col_scale[col + 1];
            const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm + mi * 16 + g + 8 * half;
                if (row >= M) continue;
                const float rs = row_scale[row];
                const float v0 = s8_epilogue<kEpi>(acc[mi][ni][2 * half], rs, cs0, b0);
                const float v1 = s8_epilogue<kEpi>(acc[mi][ni][2 * half + 1], rs, cs1, b1);
                OutT* dst = y + (size_t)row * N + col;
                if constexpr (kEpi == kS8Bf16)
                    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
                else
                    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            }
        }
    }
}

template <int kEpi, typename OutT>
inline void launch_gemm_s8(const int8_t* xq, const int8_t* wq, const float* row_scale,
                           const float* col_scale, const float* bias, OutT* y, int M, int N,
                           int K, cudaStream_t stream) {
    const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
    gemm_s8_kernel<kEpi, OutT>
        <<<grid, kGemmThreads, 0, stream>>>(xq, wq, row_scale, col_scale, bias, y, M, N, K);
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f32(const float* p) { return *p; }

// Per-row dynamic quantization, clipx.models.quant.dense_w8a8's rule:
//     scale[r] = max(max_j |x[r, j]|, 1e-12) / 127
//     q[r, j] = clamp(rint(x[r, j] / scale[r]), -127, 127)
// in f32 with IEEE division (the build uses no fast-math) and rintf's
// round-half-to-even, so the codes are bitwise those of the plain version.
// One warp per row.
template <typename InT>
__global__ void __launch_bounds__(kQuantThreads)
quant_rows_kernel(const InT* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, int rows, int width) {
    const int row = (blockIdx.x * kQuantThreads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const InT* xr = x + (size_t)row * width;
    float amax = 0.f;
    for (int j = lane; j < width; j += 32) amax = fmaxf(amax, fabsf(load_f32(xr + j)));
#pragma unroll
    for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = fmaxf(amax, 1e-12f) / 127.f;
    int8_t* qr = q + (size_t)row * width;
    for (int j = lane; j < width; j += 32)
        qr[j] = static_cast<int8_t>(fminf(fmaxf(rintf(load_f32(xr + j) / s), -127.f), 127.f));
    if (lane == 0) scale[row] = s;
}

template <typename InT>
inline void launch_quant_rows(const InT* x, int8_t* q, float* scale, int rows, int width,
                              cudaStream_t stream) {
    const int blocks = (rows * 32 + kQuantThreads - 1) / kQuantThreads;
    quant_rows_kernel<InT><<<blocks, kQuantThreads, 0, stream>>>(x, q, scale, rows, width);
}

}  // namespace clipx
