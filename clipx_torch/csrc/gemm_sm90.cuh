// Warp-specialised bf16 GEMM for Hopper (sm_90a): TMA loads into a ring of
// shared-memory stages, wgmma on two consumer warpgroups, f32 accumulators
// in registers. Also the PTX helpers (mbarrier, TMA, wgmma, shared-memory
// descriptors, tensor maps) that attn_core_sm90.cuh, sdpa_sm90.cuh and
// gemm_s8_sm90.cuh build on.
//
// Every bf16 GEMM of the port runs on it:
// - attn_block.cu: the out projections of fused_attn_block and
//   fused_attn_sublayer (clipx/ops/packed_sdpa.py:312, :261; the GEMM steps
//   of `_attn_block_core`, :220-257);
// - sdpa.cu: the out projection of fused_sdpa_long_qkv (:715;
//   `_long_qkv_kernel`, :670);
// - mlp.cu: both GEMMs of fused_mlp (:504; `_mlp_block_kernel`, :370).
//
//     t = x[M, K] @ w[K, N] + bias[N]                  (f32 accumulate)
//     kEpiBias:      y = bf16(t)
//     kEpiResidual:  y = bf16(f32(res) + f32(bf16(t)))  (B5: round, then add)
//     kEpiQuickGelu: y = bf16(a(f32(bf16(t)))), a(v) = v * sigmoid(1.702 v)
//     kEpiGelu:      the same with the exact erf GELU
//
// The activation forms keep _mlp_block_kernel's rounding points (:379-389):
// x @ w1 + b1 rounds to bf16, the activation (act.cuh) runs in f32 on that,
// and its result rounds to bf16 again.
//
// What bounds it on this card: every GEMM on the port's paths is above the
// H100's ~295 FLOP-a-byte ridge, so bound by operations, a rate that only
// wgmma reaches, fed by TMA so that no thread spends instructions on loads.
// At ViT-B/32, batch 128 the out projection is M = 6400, N = K = 768 (7.55
// GFLOP, ~21 MB, ~360 FLOP a byte: 7.6 us at the 989 TFLOP/s bf16 peak);
// fused_mlp's up projection 6400 x 3072 x 768 (30.2 GFLOP, ~54 MB with the
// bf16 hidden layer written) and its down projection 6400 x 768 x 3072;
// at ViT-L/14@336px fused_sdpa_long_qkv's out projection is 73856 x 1024 x
// 1024 (155 GFLOP, ~305 MB: 0.157 ms at the peak).
//
// Design: a block owns a 128 x BN output tile (BN in {64, 128, 192}, the
// caller picks one that divides N: ops/packed_sdpa.py's gemm_tile_n for the
// out projections of B1 and B5, its measured rule gemm_tile_n_mn for the
// others). One producer thread keeps kStages
// stages full through TMA with the 128-byte swizzle: a 128 x 64 box of x
// and BN/64 boxes of 64 x 64 of w per stage, signalled on an mbarrier. Two
// consumer warpgroups each run wgmma m64nBNk16 on their 64 rows, A from
// shared memory K-major, B straight from w's row-major (K, N) tiles read
// as MN-major (the transpose bit), so no transposed copy of a weight
// exists. setmaxnreg moves registers from the producer to the consumers.
// Rows past M are TMA's zero fill and are not stored; the epilogue stores
// from registers.
//
// Tensor maps are encoded on the host per call through the driver entry
// point that the runtime hands out, so the library links no libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act.cuh"

namespace clipx {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                   // K per stage: one 128-byte swizzled row
constexpr int kBox = 64;                  // rows and columns of a 64 x 64 box
constexpr int kBoxBytes = kBox * kBK * 2;  // 8 KB
constexpr int kStages = 4;
constexpr int kConsumers = 2;             // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kGemmRows = 64 * kConsumers;  // 128

enum Epilogue : int { kEpiBias = 0, kEpiResidual = 1, kEpiQuickGelu = 2, kEpiGelu = 3 };

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

// One TMA box of a 2-D tensor map into shared memory; completion counts
// the box's bytes on the mbarrier. col is the inner (contiguous) coordinate.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
        : "memory");
}

// Generic-proxy shared-memory writes made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

template <uint32_t kRegs>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <uint32_t kRegs>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions (called after wgmma_wait_all).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a tile stored in 128-byte rows with
// the 128-byte swizzle (as TMA writes it), 8-row groups 1024 bytes apart
// (the stride byte offset). K-major operands step 32 bytes per k16 inside
// a row; MN-major operands step 16 rows (2048 bytes) per k16 and find the
// next 64-wide MN chunk lbo bytes on (the leading byte offset). The tile
// must start 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

#define CLIPX_R0_31                                                                      \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define CLIPX_R32_63                                                                     \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define CLIPX_R64_95                                                                     \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "   \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define CLIPX_D8(i)                                                                      \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define CLIPX_D32 CLIPX_D8(0), CLIPX_D8(8), CLIPX_D8(16), CLIPX_D8(24)
#define CLIPX_D64 CLIPX_D32, CLIPX_D8(32), CLIPX_D8(40), CLIPX_D8(48), CLIPX_D8(56)
#define CLIPX_D96 CLIPX_D64, CLIPX_D8(64), CLIPX_D8(72), CLIPX_D8(80), CLIPX_D8(88)

// d[64 x N] += A[64 x 16] @ B[16 x N], bf16 -> f32: A K-major and B
// MN-major (transpose bit set), both from shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" CLIPX_R0_31 "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : CLIPX_D32
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" CLIPX_R0_31 ", " CLIPX_R32_63 "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : CLIPX_D64
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{" CLIPX_R0_31 ", " CLIPX_R32_63 ", " CLIPX_R64_95 "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        : CLIPX_D96
        : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64], A from registers in the mma.sync
// m16n8k16 fragment layout (warp w of the warpgroup holds rows 16w..16w+15),
// B from shared memory, K-major (kTnspB = 0) or MN-major (kTnspB = 1).
template <int kTnspB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" CLIPX_R0_31 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : CLIPX_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTnspB));
}

#undef CLIPX_D96
#undef CLIPX_D64
#undef CLIPX_D32
#undef CLIPX_D8
#undef CLIPX_R64_95
#undef CLIPX_R32_63
#undef CLIPX_R0_31

// The dynamic shared memory a kernel asks for: its tiles and barriers,
// plus the slack that aligns the tiles to 1024 bytes.
__host__ __device__ constexpr int smem_bytes(int tile_bytes) {
    return tile_bytes + 2 * kStages * 8 + 1024;
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A row-major (rows, cols) matrix of elem_bytes-wide elements read in
// (box_rows, 128-byte) boxes with the 128-byte swizzle; a box's rows past
// the end arrive as zeros. Needs a 16-byte aligned base and a row pitch
// that is a multiple of 16 bytes (the wrappers check).
inline bool make_tmap_sw128(CUtensorMap* map, CUtensorMapDataType type, uint32_t elem_bytes,
                            const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows) {
    const EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * elem_bytes};
    const cuuint32_t box[2] = {128 / elem_bytes, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) bf16 matrix in (box_rows, 64) boxes.
inline bool make_tmap(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                      uint32_t box_rows) {
    return make_tmap_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), ptr, rows, cols,
                           box_rows);
}

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------

template <int BN>
__host__ __device__ constexpr int gemm_stage_bytes() {
    return kGemmRows * kBK * 2 + (BN / kBox) * kBoxBytes;
}

// y[M, N] = epilogue(x[M, K] @ w[K, N] + bias[N]; res[M, N]). tm_x: x in
// (128, 64) boxes; tm_w: w in (64, 64) boxes. K % 64 == 0, N % BN == 0.
// Grid: (N / BN, ceil(M / 128)); kThreads threads.
template <int BN, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const float* __restrict__ bias, const bf16* __restrict__ res,
                 bf16* __restrict__ y, int M, int N, int K) {
    constexpr int kABytes = kGemmRows * kBK * 2;
    constexpr int kStageBytes = gemm_stage_bytes<BN>();
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t full = base + kStages * kStageBytes;  // kStages barriers, 8 bytes each
    const uint32_t empty = full + kStages * 8;
    const int wg = threadIdx.x / 128;
    const int m0 = blockIdx.y * kGemmRows;
    const int n0 = blockIdx.x * BN;
    const int ktiles = K / kBK;

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
                tma_load(stage, &tm_x, full + 8 * s, kt * kBK, m0);
#pragma unroll
                for (int c = 0; c < BN / kBox; ++c)
                    tma_load(stage + kABytes + c * kBoxBytes, &tm_w, full + 8 * s,
                             n0 + c * kBox, kt * kBK);
            }
        }
    } else {
        regs_inc<kConsumerRegs>();
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        for (int kt = 0; kt < ktiles; ++kt) {
            const int s = kt % kStages;
            mbar_wait(full + 8 * s, (kt / kStages) & 1);
            const uint32_t a = base + s * kStageBytes + wg * (64 * kBK * 2);
            const uint32_t b = base + s * kStageBytes + kABytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
                wgmma_ss<BN>(acc, desc_sw128(a + 32 * kk, 16),
                             desc_sw128(b + 2048 * kk, kBoxBytes));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(acc);
            __syncwarp();
            if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
        }

        // epilogue from the accumulator layout: register 4j + 2h + e holds
        // row 16 * warp + g + 8h, column 8j + 2t + e of the warpgroup's tile
        const int warp = (threadIdx.x / 32) % 4;
        const int g = (threadIdx.x & 31) >> 2;
        const int t = threadIdx.x & 3;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
                if (row >= M) continue;
                const size_t at = static_cast<size_t>(row) * N + col;
                float v0 = acc[4 * j + 2 * h] + bb.x;
                float v1 = acc[4 * j + 2 * h + 1] + bb.y;
                if constexpr (kEpi == kEpiResidual) {
                    const float2 r =
                        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + at));
                    v0 = r.x + __bfloat162float(__float2bfloat16_rn(v0));
                    v1 = r.y + __bfloat162float(__float2bfloat16_rn(v1));
                } else if constexpr (kEpi == kEpiQuickGelu) {
                    v0 = quick_gelu_f32(__bfloat162float(__float2bfloat16_rn(v0)));
                    v1 = quick_gelu_f32(__bfloat162float(__float2bfloat16_rn(v1)));
                } else if constexpr (kEpi == kEpiGelu) {
                    v0 = gelu_erf_f32(__bfloat162float(__float2bfloat16_rn(v0)));
                    v1 = gelu_erf_f32(__bfloat162float(__float2bfloat16_rn(v1)));
                }
                *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(v0, v1);
            }
        }
    }
}

template <int BN, int kEpi>
inline cudaError_t launch_gemm_bn(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                                  const float* bias, const bf16* res, bf16* y, int M, int N,
                                  int K, cudaStream_t stream) {
    constexpr int kSmem = smem_bytes(kStages * gemm_stage_bytes<BN>());
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_sm90_kernel<BN, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid(N / BN, (M + kGemmRows - 1) / kGemmRows);
    gemm_sm90_kernel<BN, kEpi><<<grid, kThreads, kSmem, stream>>>(tm_x, tm_w, bias, res, y, M,
                                                                   N, K);
    return cudaGetLastError();
}

// y = epilogue(x @ w + bias) on the current stream; bn is the tile width
// (64, 128 or 192, dividing N). K % 64 == 0.
template <int kEpi>
inline cudaError_t launch_gemm(const bf16* x, const bf16* w, const float* bias, const bf16* res,
                               bf16* y, int M, int N, int K, int bn, cudaStream_t stream) {
    CUtensorMap tm_x, tm_w;
    if (!make_tmap(&tm_x, x, M, K, kGemmRows) || !make_tmap(&tm_w, w, K, N, kBox))
        return cudaErrorInvalidValue;
    switch (bn) {
        case 64:
            return launch_gemm_bn<64, kEpi>(tm_x, tm_w, bias, res, y, M, N, K, stream);
        case 128:
            return launch_gemm_bn<128, kEpi>(tm_x, tm_w, bias, res, y, M, N, K, stream);
        case 192:
            return launch_gemm_bn<192, kEpi>(tm_x, tm_w, bias, res, y, M, N, K, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace sm90
}  // namespace clipx
