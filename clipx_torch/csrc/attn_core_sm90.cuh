// The core of fused_attn_block for Hopper (sm_90a): the qkv projection and
// the per-head attention of two batch rows in one kernel, with q, k and v
// kept on chip, as the TPU kernel kept them in VMEM.
//
// Replaces the projection and SDPA steps of the Pallas kernels
// clipx/ops/packed_sdpa.py::fused_attn_block (:312; `_attn_block_core`,
// :220-252) and ::fused_attn_sublayer (:261), with their rounding points:
//
//     [q_h | k_h | v_h] = bf16(x @ Wqkv[:, cols of head h] + b)   (f32 acc)
//     o_h = bf16(bf16(softmax(q_h k_h^T * 0.125, keys >= S at -1e30)) @ v_h)
//
// The out projection follows in gemm_sm90.cuh's GEMM.
//
// What bounds it on this card: at ViT-B/32, batch 128 (S = 50, W = 768,
// 12 heads) the projection is 22.6 GFLOP and the attention 1.0, against
// ~14 MB of compulsory traffic (x, Wqkv, the head outputs): bound by
// operations, ~24 us at the 989 TFLOP/s bf16 peak. The split design
// (projection GEMM, then an SDPA kernel over the packed (B*S, 3W) result)
// adds a 29.5 MB round trip of qkv through L2 and HBM and a launch.
//
// Design: a block owns two batch rows and one head (grid ceil(B/2) x
// heads, so every block reads the same 192 columns of Wqkv as its
// neighbours in the L2). One producer thread streams, per 64-wide K step,
// a 64-row TMA box of x for each batch row (rows b*S .. b*S+63 of the
// (B*S, W) view: rows >= S belong to the next batch row, or are TMA's zero
// fill past the end, and are masked as keys and never stored) and the
// three 64 x 64 boxes of Wqkv that hold q_h, k_h and v_h, 40 KB a stage
// in a ring of four. Each of two consumer warpgroups accumulates its batch
// row's 64 x 192 block [q_h | k_h | v_h] with wgmma m64n192k16 (96 f32
// registers a thread), Wqkv read MN-major through the transpose bit. The
// epilogue adds the bias and rounds to bf16: q stays in registers as the A
// fragments of S = q k^T, k and v go to the warpgroup's own 16 KB of
// shared memory in the swizzled layout wgmma reads. S (wgmma m64n64k16, k
// K-major) is scaled, masked and soft-maxed in registers (a row lives in
// the four threads of a quad), normalised before its bf16 rounding (IEEE
// division), and P @ v (P from registers, v MN-major) gives the head
// output, stored for rows < S. Padding M from S = 50 to 64 costs 1.28x the
// projection's FLOPs; keeping qkv on chip saves its round trip.

#pragma once

#include "gemm_sm90.cuh"

namespace clipx {
namespace sm90 {

constexpr int kCoreStageBytes = 5 * kBoxBytes;  // x of two batch rows, Wqkv of one head
constexpr int kKVBytes = 2 * kBoxBytes;         // k and v of one batch row
constexpr int kCoreTileBytes = kStages * kCoreStageBytes + kConsumers * kKVBytes;
constexpr float kNegMask = -1e30f;

// attn[b*S + i, h*64 + d] = o_h[b, i, d] for i < S. tm_x: x as (B*S, W) in
// (64, 64) boxes; tm_w: wqkv (W, 3W) in (64, 64) boxes. S <= 64, W % 64 ==
// 0. Grid: (ceil(B/2), heads); kThreads threads.
__global__ void __launch_bounds__(kThreads, 1)
attn_core_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bqkv,
                      bf16* __restrict__ attn, int batch, int seq, int width) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t kv_base = base + kStages * kCoreStageBytes;
    const uint32_t full = kv_base + kConsumers * kKVBytes;
    const uint32_t empty = full + kStages * 8;
    const int wg = threadIdx.x / 128;
    const int h = blockIdx.y;
    const int ktiles = width / kBK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, kConsumers * 4);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == kConsumers) {
        regs_dec<kProducerRegs>();
        if (threadIdx.x == kConsumers * 128) {
            // an odd batch's last block reloads row B-1 for its second
            // warpgroup, which stores nothing
            const int b0 = 2 * blockIdx.x;
            const int b1 = b0 + 1 < batch ? b0 + 1 : b0;
            for (int kt = 0; kt < ktiles; ++kt) {
                const int s = kt % kStages;
                mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
                const uint32_t stage = base + s * kCoreStageBytes;
                const uint32_t bar = full + 8 * s;
                mbar_expect_tx(bar, kCoreStageBytes);
                tma_load(stage, &tm_x, bar, kt * kBK, b0 * seq);
                tma_load(stage + kBoxBytes, &tm_x, bar, kt * kBK, b1 * seq);
#pragma unroll
                for (int sec = 0; sec < 3; ++sec)
                    tma_load(stage + (2 + sec) * kBoxBytes, &tm_w, bar, sec * width + h * 64,
                             kt * kBK);
            }
        }
    } else {
        regs_inc<kConsumerRegs>();
        const int b = 2 * blockIdx.x + wg;
        const int warp = (threadIdx.x / 32) % 4;
        const int g = (threadIdx.x & 31) >> 2;
        const int t = threadIdx.x & 3;

        // [q | k | v] = x @ Wqkv[:, head h]: register 4j + 2r + e holds row
        // 16 * warp + g + 8r, column 8j + 2t + e of the 64 x 192 block
        float acc[96];
#pragma unroll
        for (int i = 0; i < 96; ++i) acc[i] = 0.f;
        for (int kt = 0; kt < ktiles; ++kt) {
            const int s = kt % kStages;
            mbar_wait(full + 8 * s, (kt / kStages) & 1);
            const uint32_t stage = base + s * kCoreStageBytes;
            const uint32_t a = stage + wg * kBoxBytes;
            const uint32_t w = stage + 2 * kBoxBytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
                wgmma_ss<192>(acc, desc_sw128(a + 32 * kk, 16),
                              desc_sw128(w + 2048 * kk, kBoxBytes));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(acc);
            __syncwarp();
            if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
        }

        // bias and the bf16 rounding of qkv; q into the A fragments of
        // q k^T (fragment kk covers head dims 16kk .. 16kk+15), k and v into
        // shared memory, row r at r * 128 bytes, 16-byte chunk c at c ^ (r % 8)
        const uint32_t kv = kv_base + wg * kKVBytes;
        const int r0 = warp * 16 + g;  // and r0 + 8; both are g mod 8
        uint32_t qa[4][4];
#pragma unroll
        for (int j = 0; j < 24; ++j) {
            const int sec = j / 8;
            const int jj = j % 8;
            const float2 bb =
                *reinterpret_cast<const float2*>(bqkv + sec * width + h * 64 + 8 * jj + 2 * t);
            const uint32_t lo = pack_bf16(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
            const uint32_t hi = pack_bf16(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
            if (sec == 0) {
                qa[jj / 2][(jj % 2) * 2] = lo;
                qa[jj / 2][(jj % 2) * 2 + 1] = hi;
            } else {
                const uint32_t at = kv + (sec - 1) * kBoxBytes + ((jj ^ g) * 16) + 4 * t;
                st_shared_u32(at + r0 * 128, lo);
                st_shared_u32(at + (r0 + 8) * 128, hi);
            }
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);

        // S = q k^T (B = k, K-major: head dims contiguous in each key's row)
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs64<0>(sc, qa[kk], desc_sw128(kv + 32 * kk, 16));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // softmax over keys, f32, rows g (r = 0) and g + 8 (r = 1); register
        // 4j + 2r + e holds key 8j + 2t + e
        float mx[2] = {kNegMask, kNegMask};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float& v = sc[4 * j + 2 * r + e];
                    v = 8 * j + 2 * t + e < seq ? v * 0.125f : kNegMask;
                    mx[r] = fmaxf(mx[r], v);
                }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float& v = sc[4 * j + 2 * r + e];
                    v = expf(v - mx[r]);
                    sum[r] += v;
                }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        }
        // P, normalised then rounded, as the A fragments of P @ v
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j] / sum[0], sc[4 * j + 1] / sum[0]);
            pa[j / 2][(j % 2) * 2 + 1] =
                pack_bf16(sc[4 * j + 2] / sum[1], sc[4 * j + 3] / sum[1]);
        }

        // o = P @ v (B = v, MN-major: head dims contiguous in each key's row)
        float o[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_rs64<1>(o, pa[kk], desc_sw128(kv + kBoxBytes + 2048 * kk, kBoxBytes));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);

        if (b < batch) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = r0 + 8 * r;
                if (row >= seq) continue;
                bf16* dst = attn + (static_cast<size_t>(b) * seq + row) * width + h * 64 + 2 * t;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                        pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
            }
        }
    }
}

// The attention core on the current stream: x (B*S, W) bf16, wqkv (W, 3W)
// bf16, bqkv (3W,) f32 -> attn (B*S, W) bf16.
inline cudaError_t launch_attn_core(const bf16* x, const bf16* wqkv, const float* bqkv,
                                    bf16* attn, int batch, int seq, int width, int heads,
                                    cudaStream_t stream) {
    CUtensorMap tm_x, tm_w;
    if (!make_tmap(&tm_x, x, static_cast<uint64_t>(batch) * seq, width, kBox) ||
        !make_tmap(&tm_w, wqkv, width, 3 * width, kBox))
        return cudaErrorInvalidValue;
    constexpr int kSmem = smem_bytes(kCoreTileBytes);
    const cudaError_t e = cudaFuncSetAttribute(
        attn_core_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((batch + 1) / 2, heads);
    attn_core_sm90_kernel<<<grid, kThreads, kSmem, stream>>>(tm_x, tm_w, bqkv, attn, batch,
                                                             seq, width);
    return cudaGetLastError();
}

}  // namespace sm90
}  // namespace clipx
