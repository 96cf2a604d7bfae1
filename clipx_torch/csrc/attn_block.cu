// fused_attn_block for Hopper (sm_90a): the whole ViT attention sublayer
// between LayerNorm and the residual add.
//
// Replaces clipx/ops/packed_sdpa.py::fused_attn_block (`_attn_block_kernel`,
// :187, and `_attn_block_core`, :220; pallas_call at :344):
//
//     qkv = bf16(x @ [Wq|Wk|Wv] + b_qkv)                 (f32 accumulate)
//     o_h = bf16(softmax(q_h k_h^T / 8, keys >= S masked) @ v_h)   per head
//     out = bf16(o @ Wo + b_o)                           (f32 accumulate)
//
// On the TPU one program held the weights in VMEM and packed two batch rows
// per 128x128 MXU tile. Here the sublayer is three hand-written kernels on
// one stream, launched by one C call: a bf16 tensor-core GEMM with an f32
// bias epilogue for the qkv projection, the short-SDPA kernel of
// short_sdpa.cuh over the packed (B*S, 3W) projection output, and the same
// GEMM for the out-projection. The bf16 rounding points are those of the
// Pallas kernel: qkv, the probabilities, the per-head outputs and the result.
//
// What bounds it on this card: at ViT-B/32, batch 128 (S = 50, W = 768) the
// call does ~31 GFLOP (22.6 qkv, 7.6 out-projection, 1.0 attention) against
// ~24 MB of compulsory traffic, so it is bound by operations: ~32 us at the
// 989 TFLOP/s bf16 peak. The GEMM tiles a 64x64 output block per 128-thread
// block (each warp a 32x32 quarter) and runs mma.sync m16n8k16 bf16 -> f32
// on tiles staged through shared memory; weights (4.7 MB) stay in the 50 MB
// L2 across blocks. The qkv intermediate (29 MB at batch 128) makes one
// round trip through L2/HBM, which the TPU kernel kept on chip: that, the
// lack of a load pipeline and mma.sync instead of wgmma are what a later,
// faster version removes.
//
// C interface for ctypes; returns cudaGetLastError() after the launches.

#include "short_sdpa.cuh"

namespace clipx {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 128;
constexpr int kTilePitch = kBK + 8;  // bf16; 80-byte rows keep 16-byte alignment

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// y[M, N] = bf16(x[M, K] @ w[K, N] + bias[N]); all row-major and contiguous.
// Needs K % 32 == 0 and N % 64 == 0 (the wrapper checks); rows past M are
// zero-filled on load and not stored.
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int M, int N,
                 int K) {
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

    // epilogue: f32 accumulator + f32 bias, rounded once to bf16
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int row = m0 + wm + mi * 16 + g;
            const int col = n0 + wn + ni * 8 + 2 * t;
            const float b0 = bias[col];
            const float b1 = bias[col + 1];
            if (row < M)
                *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
                    __floats2bfloat162_rn(acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
            if (row + 8 < M)
                *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(row + 8) * N + col) =
                    __floats2bfloat162_rn(acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
        }
    }
}

inline void launch_gemm_bias(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const float* bias, __nv_bfloat16* y, int M, int N, int K,
                             cudaStream_t stream) {
    const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
    gemm_bias_kernel<<<grid, kGemmThreads, 0, stream>>>(x, w, bias, y, M, N, K);
}

}  // namespace clipx

// x: (B, S, W) bf16; wqkv: (W, 3W) bf16; bqkv: (3W,) f32; wo: (W, W) bf16;
// bo: (W,) f32; qkv_buf: (B*S, 3W) bf16 scratch; attn_buf: (B*S, W) bf16
// scratch; out: (B, S, W) bf16. S <= 64, W = heads * 64.
extern "C" int clipx_fused_attn_block(const void* x, const void* wqkv, const void* bqkv,
                                      const void* wo, const void* bo, void* qkv_buf,
                                      void* attn_buf, void* out, int batch, int seq,
                                      int width, int heads, void* stream) {
    using bf16 = __nv_bfloat16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows = batch * seq;
    bf16* qkv = static_cast<bf16*>(qkv_buf);
    bf16* attn = static_cast<bf16*>(attn_buf);
    clipx::launch_gemm_bias(static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
                            static_cast<const float*>(bqkv), qkv, rows, 3 * width, width,
                            st);
    clipx::launch_short_sdpa(qkv, qkv + width, qkv + 2 * width, attn, batch, seq, heads,
                             3 * width, width, st);
    clipx::launch_gemm_bias(attn, static_cast<const bf16*>(wo),
                            static_cast<const float*>(bo), static_cast<bf16*>(out), rows,
                            width, width, st);
    return static_cast<int>(cudaGetLastError());
}
