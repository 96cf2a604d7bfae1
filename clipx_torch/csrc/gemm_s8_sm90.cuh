// Warp-specialised int8 GEMM for Hopper (sm_90a) with f32 dequantizing
// epilogues, and the per-row dynamic int8 quantizer that feeds it. Used by
// mlp.cu (fused_mlp_w8a8, clipx/ops/packed_sdpa.py:458; `_mlp_w8a8_kernel`,
// :426).
//
//     acc[M, N] = xq[M, K] @ wq[K, N]          (int8 x int8, exact int32)
//     v = f32(acc) * (row_scale[m] * col_scale[n]) + bias[n]
//     kS8Bf16:      y = bf16(v)
//     kS8QuickGelu: y = v * sigmoid(1.702 v), stored f32
//     kS8Gelu:      y = the exact erf GELU of v, stored f32
//
// The dequantization is the Pallas kernel's order (:444-445, :453): the
// two scales multiply first, then the accumulator, then the bias is added.
// __fmul_rn / __fadd_rn keep nvcc from contracting it into an FMA, which
// would round once instead of twice and, through the requantization of the
// hidden layer, flip an occasional int8 code. The int32 sums are exact in
// any order, so the f32 hidden layer is bitwise what any exact int8 GEMM
// with this epilogue writes. The activations are act.cuh's, the functions
// the bf16 MLP's epilogue calls.
//
// What bounds it on this card: at ViT-B/32, batch 128 each of the MLP's two
// GEMMs is 6,400 x 3,072 x 768, 30.2 G int8 operations against ~27 MB of
// operands: bound by operations, 15 us at the 1,979 TOP/s int8 peak, a
// rate only wgmma reaches. The up GEMM's f32 hidden layer (79 MB) is a
// store of ~23 us at 3.35 TB/s behind its epilogue.
//
// Design: gemm_sm90.cuh's warp-specialised GEMM, on its PTX helpers, with
// int8 operands. A block owns a 128 x BN output tile (BN in {64, 128, 192},
// the caller picks one that divides N). One producer thread keeps kStages
// stages full through TMA with the 128-byte swizzle: a 128 x 128-byte box
// of xq and a BN x 128-byte box of the weights a stage, K = 128 a stage,
// signalled on an mbarrier. Two consumer warpgroups each run four wgmma
// m64nBNk32 s8 x s8 -> s32 a stage on their 64 rows, both operands from
// shared memory. int8 wgmma takes K-major operands only (the transpose bit
// exists for 16-bit types alone), so the weights come as (N, K) row-major
// copies, made once when the model is quantized (models/quant.py's
// w1_qt, w2_qt), not the (K, N) layout the bf16 GEMM reads through the
// transpose bit. setmaxnreg moves registers from the producer to the
// consumers; rows past M are TMA's zero fill and are not stored. While the
// ring fills, the consumers load their row scales and stage the tile's
// column scales and biases in shared memory, so that the epilogue (which
// bounds the up GEMM: an expf and an IEEE division a value, and a 79 MB
// f32 store at ViT-B/32) waits on no global load.

#pragma once

#include "gemm_sm90.cuh"

namespace clipx {
namespace sm90 {

constexpr int kS8BK = 128;             // K per stage: one 128-byte swizzled row of int8
constexpr int kS8ABytes = kGemmRows * kS8BK;
constexpr int kQuantThreads = 256;     // quant_rows: one warp per row

enum GemmS8Epilogue : int { kS8Bf16 = 0, kS8QuickGelu = 1, kS8Gelu = 2 };

template <int BN>
__host__ __device__ constexpr int gemm_s8_stage_bytes() {
    return kS8ABytes + BN * kS8BK;
}

#define CLIPX_S8_R0_31                                                                   \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define CLIPX_S8_R32_63                                                                  \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define CLIPX_S8_R64_95                                                                  \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "   \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define CLIPX_S8_D8(i)                                                                   \
    "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),          \
        "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define CLIPX_S8_D32 CLIPX_S8_D8(0), CLIPX_S8_D8(8), CLIPX_S8_D8(16), CLIPX_S8_D8(24)
#define CLIPX_S8_D64 CLIPX_S8_D32, CLIPX_S8_D8(32), CLIPX_S8_D8(40), CLIPX_S8_D8(48), CLIPX_S8_D8(56)
#define CLIPX_S8_D96 CLIPX_S8_D64, CLIPX_S8_D8(64), CLIPX_S8_D8(72), CLIPX_S8_D8(80), CLIPX_S8_D8(88)

// d[64 x N] += A[64 x 32] @ B[32 x N], s8 -> s32, both K-major from shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_ss_s8(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{" CLIPX_S8_R0_31 "}, %32, %33, p;\n}\n"
        : CLIPX_S8_D32
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{" CLIPX_S8_R0_31 ", " CLIPX_S8_R32_63 "}, %64, %65, p;\n}\n"
        : CLIPX_S8_D64
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_s8<192>(int (&d)[96], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
        "{" CLIPX_S8_R0_31 ", " CLIPX_S8_R32_63 ", " CLIPX_S8_R64_95 "}, %96, %97, p;\n}\n"
        : CLIPX_S8_D96
        : "l"(da), "l"(db), "r"(1));
}

#undef CLIPX_S8_D96
#undef CLIPX_S8_D64
#undef CLIPX_S8_D32
#undef CLIPX_S8_D8
#undef CLIPX_S8_R64_95
#undef CLIPX_S8_R32_63
#undef CLIPX_S8_R0_31

template <int kEpi>
__device__ __forceinline__ float s8_epilogue(int acc, float row_scale, float col_scale,
                                             float bias) {
    const float v = __fadd_rn(__fmul_rn(static_cast<float>(acc), __fmul_rn(row_scale, col_scale)),
                              bias);
    if constexpr (kEpi == kS8QuickGelu) return quick_gelu_f32(v);
    if constexpr (kEpi == kS8Gelu) return gelu_erf_f32(v);
    return v;
}

// y[M, N] = epilogue(xq[M, K] @ wt[N, K]^T); tm_x: xq in (128, 128-byte)
// boxes, tm_w: the (N, K) weights in (BN, 128-byte) boxes. OutT is
// __nv_bfloat16 for kS8Bf16 and float otherwise. K % 16 == 0 (the TMA
// row pitch), N % BN == 0. Grid: (N / BN, ceil(M / 128)); kThreads threads.
template <int BN, int kEpi, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
gemm_s8_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ row_scale, const float* __restrict__ col_scale,
                    const float* __restrict__ bias, OutT* __restrict__ y,
                    unsigned* __restrict__ row_amax, int M, int N, int K) {
    constexpr int kStageBytes = gemm_s8_stage_bytes<BN>();
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t full = base + kStages * kStageBytes;  // kStages barriers, 8 bytes each
    const uint32_t empty = full + kStages * 8;
    // the tile's column scales and biases, for the epilogue
    float* col_s = reinterpret_cast<float*>(smem_raw + (empty + kStages * 8 - smem_u32(smem_raw)));
    float* bias_s = col_s + BN;
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
    const int m0 = blockIdx.y * kGemmRows;
    const int n0 = blockIdx.x * BN;
    const int ktiles = (K + kS8BK - 1) / kS8BK;  // a ragged last K box is TMA's zero fill

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, kConsumers * 4);  // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == kConsumers) {
        // producer: one thread keeps the ring full
        regs_dec<kProducerRegs>();
        if (threadIdx.x == kConsumers * 128) {
            for (int kt = 0; kt < ktiles; ++kt) {
                const int s = kt % kStages;
                mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
                const uint32_t stage = base + s * kStageBytes;
                mbar_expect_tx(full + 8 * s, kStageBytes);
                tma_load(stage, &tm_x, full + 8 * s, kt * kS8BK, m0);
                tma_load(stage + kS8ABytes, &tm_w, full + 8 * s, kt * kS8BK, n0);
            }
        }
    } else {
        regs_inc<kConsumerRegs>();
        // loaded while the ring fills, so that the epilogue does not wait
        // on global loads: this thread's two row scales, and the tile's
        // column scales and biases in shared memory
        const int warp = (threadIdx.x / 32) % 4;
        const int g = (threadIdx.x & 31) >> 2;
        const int t = threadIdx.x & 3;
        float rs[2], amax[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
            rs[h] = row < M ? row_scale[row] : 0.f;
        }
        for (int i = threadIdx.x; i < BN; i += kConsumers * 128) {
            col_s[i] = col_scale[n0 + i];
            bias_s[i] = bias[n0 + i];
        }
        int acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        for (int kt = 0; kt < ktiles; ++kt) {
            const int s = kt % kStages;
            mbar_wait(full + 8 * s, (kt / kStages) & 1);
            const uint32_t a = base + s * kStageBytes + wg * (64 * kS8BK);
            const uint32_t b = base + s * kStageBytes + kS8ABytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kS8BK / 32; ++kk)
                wgmma_ss_s8<BN>(acc, desc_sw128(a + 32 * kk, 16), desc_sw128(b + 32 * kk, 16));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(acc);
            __syncwarp();
            if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
        }

        named_bar_sync(1, kConsumers * 128);  // col_s and bias_s are written

        // epilogue from the accumulator layout: register 4j + 2h + e holds
        // row 16 * warp + g + 8h, column 8j + 2t + e of the warpgroup's tile
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            const float2 cs = *reinterpret_cast<const float2*>(col_s + 8 * j + 2 * t);
            const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
                if (row >= M) continue;
                const float v0 = s8_epilogue<kEpi>(acc[4 * j + 2 * h], rs[h], cs.x, bb.x);
                const float v1 = s8_epilogue<kEpi>(acc[4 * j + 2 * h + 1], rs[h], cs.y, bb.y);
                OutT* dst = y + static_cast<size_t>(row) * N + col;
                if constexpr (kEpi == kS8Bf16) {
                    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
                } else {
                    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                    amax[h] = fmaxf(amax[h], fmaxf(fabsf(v0), fabsf(v1)));
                }
            }
        }
        if constexpr (kEpi != kS8Bf16) {
            // each row's |y| max over this tile's columns, folded into
            // row_amax as f32 bits (non-negative floats order as unsigned
            // ints): the next quantizer then reads y once
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float m = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
                const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
                if (t == 0 && row < M) atomicMax(row_amax + row, __float_as_uint(m));
            }
        }
    }
}

template <int BN, int kEpi, typename OutT>
inline cudaError_t launch_gemm_s8_bn(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                                     const float* row_scale, const float* col_scale,
                                     const float* bias, OutT* y, unsigned* row_amax, int M,
                                     int N, int K, cudaStream_t stream) {
    constexpr int kSmem = smem_bytes(kStages * gemm_s8_stage_bytes<BN>()) + 2 * BN * 4;
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_s8_sm90_kernel<BN, kEpi, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid(N / BN, (M + kGemmRows - 1) / kGemmRows);
    gemm_s8_sm90_kernel<BN, kEpi, OutT><<<grid, kThreads, kSmem, stream>>>(
        tm_x, tm_w, row_scale, col_scale, bias, y, row_amax, M, N, K);
    return cudaGetLastError();
}

// y = epilogue(xq @ wt^T) on the stream: xq (M, K) and wt (N, K) int8,
// row-major; bn is the tile width (64, 128 or 192, dividing N). K % 16 == 0.
// The f32 epilogues also fold each row's max |y| into row_amax (M,), which
// must hold zeros (or smaller maxima) before the launch; kS8Bf16 ignores it.
template <int kEpi, typename OutT>
inline cudaError_t launch_gemm_s8(const int8_t* xq, const int8_t* wt, const float* row_scale,
                                  const float* col_scale, const float* bias, OutT* y,
                                  unsigned* row_amax, int M, int N, int K, int bn,
                                  cudaStream_t stream) {
    CUtensorMap tm_x, tm_w;
    if (!make_tmap_sw128(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, kGemmRows) ||
        !make_tmap_sw128(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, N, K, bn))
        return cudaErrorInvalidValue;
    switch (bn) {
        case 64:
            return launch_gemm_s8_bn<64, kEpi>(tm_x, tm_w, row_scale, col_scale, bias, y,
                                               row_amax, M, N, K, stream);
        case 128:
            return launch_gemm_s8_bn<128, kEpi>(tm_x, tm_w, row_scale, col_scale, bias, y,
                                                row_amax, M, N, K, stream);
        case 192:
            return launch_gemm_s8_bn<192, kEpi>(tm_x, tm_w, row_scale, col_scale, bias, y,
                                                row_amax, M, N, K, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// The kPer values of one 16-byte load, as f32.
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(p[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
}

// Per-row dynamic quantization, clipx.models.quant.dense_w8a8's rule:
//     scale[r] = max(max_j |x[r, j]|, 1e-12) / 127
//     q[r, j] = clamp(rint(x[r, j] / scale[r]), -127, 127)
// in f32 with IEEE division (the build uses no fast-math) and rintf's
// round-half-to-even, so the codes are bitwise those of the plain version
// (a max is exact in any order). One warp per row, 16-byte loads: width *
// sizeof(InT) % 16 == 0 and 16-byte aligned rows (W and H are multiples
// of 64). With row_amax the row maxima come from there, as f32 bits (the
// up GEMM's fold), and x is read once; clear, when given, is zeroed for
// the next GEMM's fold. scale may be row_amax itself: a warp reads its
// row's entry before lane 0 writes the scale there.
template <typename InT>
__global__ void __launch_bounds__(kQuantThreads)
quant_rows_kernel(const InT* __restrict__ x, int8_t* __restrict__ q, float* scale,
                  const unsigned* row_amax, unsigned* __restrict__ clear, int rows, int width) {
    constexpr int kPer = 16 / sizeof(InT);  // values a 16-byte load
    const int row = (blockIdx.x * kQuantThreads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * width);
    const int vecs = width / kPer;
    float amax = 0.f;
    if (row_amax != nullptr) {
        amax = __uint_as_float(row_amax[row]);
    } else {
#pragma unroll 4
        for (int j = lane; j < vecs; j += 32) {
            float f[kPer];
            unpack16(__ldg(xr + j), f);
#pragma unroll
            for (int i = 0; i < kPer; ++i) amax = fmaxf(amax, fabsf(f[i]));
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float s = fmaxf(amax, 1e-12f) / 127.f;
    __syncwarp();
    int8_t* qr = q + (size_t)row * width;
#pragma unroll 4
    for (int j = lane; j < vecs; j += 32) {
        float f[kPer];
        unpack16(__ldg(xr + j), f);
        uint32_t w[kPer / 4];
#pragma unroll
        for (int i = 0; i < kPer / 4; ++i) w[i] = 0u;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int c = static_cast<int>(fminf(fmaxf(rintf(f[i] / s), -127.f), 127.f));
            w[i / 4] |= static_cast<uint32_t>(c & 0xFF) << (8 * (i % 4));
        }
        if constexpr (kPer == 8)
            *reinterpret_cast<uint2*>(qr + j * kPer) = make_uint2(w[0], w[1]);
        else
            *reinterpret_cast<uint32_t*>(qr + j * kPer) = w[0];
    }
    if (lane == 0) {
        scale[row] = s;
        if (clear != nullptr) clear[row] = 0u;
    }
}

template <typename InT>
inline void launch_quant_rows(const InT* x, int8_t* q, float* scale, const unsigned* row_amax,
                              unsigned* clear, int rows, int width, cudaStream_t stream) {
    const int blocks = (rows * 32 + kQuantThreads - 1) / kQuantThreads;
    quant_rows_kernel<InT>
        <<<blocks, kQuantThreads, 0, stream>>>(x, q, scale, row_amax, clear, rows, width);
}

}  // namespace sm90
}  // namespace clipx
