// Long-sequence scaled dot-product attention for Hopper (sm_90a): one
// strided kernel behind fused_sdpa_long, flash_attention and
// fused_sdpa_long_qkv.
//
// Replaces, in clipx:
// - ops/packed_sdpa.py::fused_sdpa_long (`_long_kernel`, :587; pallas_call
//   at :649): SDPA for any S on (B, S, H*D), optional causal mask;
// - ops/flash_attention.py::flash_attention (`_attn_kernel`, :29; :84): the
//   same function on (B, H, S, D) (D padded to 128 on the TPU; here the
//   real D is kept);
// - ops/packed_sdpa.py::fused_sdpa_long_qkv (`_long_qkv_kernel`, :670;
//   :742): the same SDPA reading q, k, v out of one packed (B, S, 3W)
//   projection, then the out projection and its bias on gemm_sm90.cuh's
//   TMA + wgmma GEMM.
// The kernel takes batch, head and row strides, so one body reads all
// three layouts.
//
// Numerics, the Pallas kernels' rounding points: scores accumulate in f32
// and are scaled by 1/sqrt(D); keys at positions >= S, and keys after the
// query when causal, are set to -1e30; the softmax is f32 and
// max-subtracted and its probabilities are normalized before they are
// rounded to bf16; probs @ V accumulates in f32 and is stored bf16.
// Exponentials use the SFU (__expf, relative error ~1e-6 over the
// softmax's range) and normalization multiplies by 1/l: both far below the
// bf16 rounding of the probabilities that follows. A one-pass online
// softmax (rescaling an accumulator of unnormalized bf16 probabilities) is
// a different function at the bf16 level and is not used.
//
// Design. One block of 8 warps takes one (batch row, head, 128-row query
// tile); each warp owns 16 query rows, their Q fragments held in
// registers. Keys stream through shared memory in 64-key tiles of
// 64 x (D + 8) bf16, two K and two V tiles (37 KB at D = 64, 70 KB at
// D = 128, in dynamic shared memory): cp.async fills the next tile while
// the warps use the current one, so any S fits and no tile of scores ever
// leaves registers. Two passes over K: pass 1 computes each row's max and
// sum (the sum rescaled when the max grows, in f32); pass 2 recomputes the
// scores, writes p = exp(s - m) / l as bf16 A fragments straight from the
// score accumulators, and runs P @ V. K fragments come in with ldmatrix,
// V fragments with ldmatrix.trans. QK^T and P @ V use mma.sync m16n8k16
// (bf16 in, f32 accumulate): 1.5x the attention's FLOPs. Only the tiles
// that hold keys past S (or, causal, after the block's first row) are
// masked; a causal block skips the key tiles after its last query row.
//
// What bounds it on this card: at ViT-L/14@336 (S = 577, D = 64, 16 heads)
// and batch 128 the call moves 604 MB (q, k, v read once, o written once)
// for 175 GFLOP of attention, ~290 FLOP per byte, at the H100's ridge
// (~295): bound by both, 0.18 ms. This version reads each K and V tile
// from L2 once per query tile and pass, recomputes QK^T in pass 2, has
// every warp read whole K and V tiles out of shared memory for its 16
// rows, and uses mma.sync rather than wgmma; those, and the exp/normalize
// ALU work around the tensor cores, are what a faster version removes.
//
// fused_sdpa_long_qkv adds the out projection: at ViT-L/14@336px and batch
// 128 a 73,856 x 1024 x 1024 GEMM, 155 GFLOP against ~305 MB, bound by
// operations (0.157 ms at the bf16 peak). It runs on gemm_sm90.cuh's
// warp-specialised TMA + wgmma GEMM with the bias epilogue, at the tile
// width the wrapper picks; the head outputs make one bf16 round trip
// through attn_buf between the two launches.
//
// C interface for ctypes; each entry returns cudaGetLastError() after its
// launches.

#include <limits.h>

#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace clipx {

constexpr int kLongQ = 128;     // query rows per block: 8 warps x 16 rows
constexpr int kLongKeys = 64;   // keys per K/V tile
constexpr int kLongThreads = 256;
constexpr float kLongNeg = -1e30f;

// element strides of the batch, head and sequence dimensions
struct Strides {
    long long b, h, s;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 bf16 matrices from shared memory into registers; lane l gives the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// 16 bytes global -> shared without passing through registers; with
// fill = true the 16 bytes are zeros instead (nothing is read from src)
__device__ __forceinline__ void cp_async16(void* smem, const void* src, bool fill) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const int bytes = fill ? 0 : 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int D>
using Tile = __nv_bfloat16[kLongKeys][D + 8];

// start copying rows [k0, k0 + kLongKeys) of one head into tile; rows at or
// past seq are zero-filled (masked keys must not meet garbage in V)
template <int D>
__device__ __forceinline__ void load_tile_async(Tile<D>& tile,
                                                const __nv_bfloat16* __restrict__ src,
                                                long long stride_s, int k0, int seq) {
    constexpr int kVecs = D / 8;
    for (int i = threadIdx.x; i < kLongKeys * kVecs; i += kLongThreads) {
        const int r = i / kVecs;
        const int c = (i % kVecs) * 8;
        const bool past = k0 + r >= seq;
        cp_async16(&tile[r][c], past ? src : src + (long long)(k0 + r) * stride_s + c, past);
    }
}

// s = mask(scale * Q K^T) for this warp's 16 rows against one 64-key tile;
// the mask is applied only where masked says a key of the tile may need it.
// Accumulator layout (mma m16n8): s[n][0..1] row0, keys k0 + 8n + 2t + {0,1};
// s[n][2..3] the same keys for row0 + 8.
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const uint32_t (&qa)[D / 16][4],
                                            const Tile<D>& ks, int k0, int row0, int seq,
                                            bool causal, bool masked, float scale, int g,
                                            int t, int lane) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[n][r] = 0.f;
    // ldmatrix: matrices (keys 8n.., d 16kk + 0..7), (keys 8n.., d + 8..15),
    // then the same for keys 8(n + 1)..: the B fragments of n and n + 1
    const int krow = (lane >> 4) * 8 + (lane & 7);
    const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
            uint32_t b[4];
            ldmatrix_x4(b, &ks[n * 8 + krow][kk * 16 + kcol]);
            const uint32_t b0[2] = {b[0], b[1]};
            const uint32_t b1[2] = {b[2], b[3]};
            mma_bf16_16816(s[n], qa[kk], b0);
            mma_bf16_16816(s[n + 1], qa[kk], b1);
        }
    }
    if (!masked) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) s[n][r] *= scale;
        return;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int key = k0 + n * 8 + 2 * t + (r & 1);
            const int row = row0 + (r >> 1) * 8;
            const float v = s[n][r] * scale;
            s[n][r] = (key >= seq || (causal && key > row)) ? kLongNeg : v;
        }
    }
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// K and V tiles, two of each (the one in use and the one in flight)
template <int D>
constexpr int long_smem_bytes() {
    return 4 * static_cast<int>(sizeof(Tile<D>));
}

// Grid: batch * heads * ceil(seq / kLongQ) blocks of kLongThreads, with
// long_smem_bytes<D>() of dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(kLongThreads, (D > 64) ? 1 : 2)
long_sdpa_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int heads, int seq, int q_tiles, Strides in, Strides out, int causal_flag,
                 float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    Tile<D>* ks = reinterpret_cast<Tile<D>*>(smem);  // ks[2]
    Tile<D>* vs = ks + 2;                            // vs[2]

    const int tile = blockIdx.x % q_tiles;
    const int bh = blockIdx.x / q_tiles;
    const int h = bh % heads;
    const int b = bh / heads;
    const bool causal = causal_flag != 0;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int q0 = tile * kLongQ;
    const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

    const long long in_off = b * in.b + h * in.h;
    const __nv_bfloat16* qh = q + in_off;
    const __nv_bfloat16* kh = k + in_off;
    const __nv_bfloat16* vh = v + in_off;

    int n_tiles = (seq + kLongKeys - 1) / kLongKeys;
    if (causal) n_tiles = min(n_tiles, (q0 + kLongQ + kLongKeys - 1) / kLongKeys);
    // a tile needs the mask where it holds keys past seq or, causal, keys
    // after the block's first query row
    auto masked = [&](int k0) {
        return k0 + kLongKeys > seq || (causal && k0 + kLongKeys - 1 > q0);
    };

    load_tile_async<D>(ks[0], kh, in.s, 0, seq);
    cp_async_commit();

    // Q fragments (m16n8k16 A layout), rows past seq zero
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = row0 + (r & 1) * 8;
            const int col = kk * 16 + 2 * t + (r >> 1) * 8;
            qa[kk][r] = row < seq
                            ? *reinterpret_cast<const uint32_t*>(qh + row * in.s + col)
                            : 0u;
        }
    }

    // pass 1: row max m and sum l of exp(s - m); the next K tile loads
    // while this one is used
    float m[2] = {kLongNeg, kLongNeg};
    float l[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * kLongKeys;
        if (kt + 1 < n_tiles)
            load_tile_async<D>(ks[(kt + 1) & 1], kh, in.s, k0 + kLongKeys, seq);
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        float s[8][4];
        tile_scores<D>(s, qa, ks[kt & 1], k0, row0, seq, causal, masked(k0), scale, g, t,
                       lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float mx = kLongNeg;
#pragma unroll
            for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
            const float mn = fmaxf(m[i], quad_max(mx));
            float sum = l[i] * __expf(m[i] - mn);
#pragma unroll
            for (int n = 0; n < 8; ++n)
                sum += __expf(s[n][2 * i] - mn) + __expf(s[n][2 * i + 1] - mn);
            m[i] = mn;
            l[i] = sum;
        }
        __syncthreads();
    }

    load_tile_async<D>(ks[0], kh, in.s, 0, seq);
    load_tile_async<D>(vs[0], vh, in.s, 0, seq);
    cp_async_commit();
    float inv_l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) inv_l[i] = 1.f / quad_sum(l[i]);

    // pass 2: p = bf16(exp(s - m) / l), o = p @ V
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
    const int mat = lane >> 3;  // ldmatrix: the 8x8 matrix this lane addresses
    const int mrow = lane & 7;
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * kLongKeys;
        if (kt + 1 < n_tiles) {
            load_tile_async<D>(ks[(kt + 1) & 1], kh, in.s, k0 + kLongKeys, seq);
            load_tile_async<D>(vs[(kt + 1) & 1], vh, in.s, k0 + kLongKeys, seq);
        }
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        const Tile<D>& vt = vs[kt & 1];
        float s[8][4];
        tile_scores<D>(s, qa, ks[kt & 1], k0, row0, seq, causal, masked(k0), scale, g, t,
                       lane);
#pragma unroll
        for (int kc = 0; kc < kLongKeys / 16; ++kc) {
            // the score accumulators of keys [16kc, 16kc + 16) are an A fragment
            uint32_t pa[4];
            pa[0] = pack_bf16x2(__expf(s[2 * kc][0] - m[0]) * inv_l[0],
                                __expf(s[2 * kc][1] - m[0]) * inv_l[0]);
            pa[1] = pack_bf16x2(__expf(s[2 * kc][2] - m[1]) * inv_l[1],
                                __expf(s[2 * kc][3] - m[1]) * inv_l[1]);
            pa[2] = pack_bf16x2(__expf(s[2 * kc + 1][0] - m[0]) * inv_l[0],
                                __expf(s[2 * kc + 1][1] - m[0]) * inv_l[0]);
            pa[3] = pack_bf16x2(__expf(s[2 * kc + 1][2] - m[1]) * inv_l[1],
                                __expf(s[2 * kc + 1][3] - m[1]) * inv_l[1]);
#pragma unroll
            for (int dn = 0; dn < D / 16; ++dn) {
                // matrices: keys 16kc + {0-7, 8-15} x d 16dn + {0-7, 8-15}
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, &vt[kc * 16 + (mat & 1) * 8 + mrow][dn * 16 + (mat >> 1) * 8]);
                const uint32_t b0[2] = {bv[0], bv[1]};
                const uint32_t b1[2] = {bv[2], bv[3]};
                mma_bf16_16816(acc[2 * dn], pa, b0);
                mma_bf16_16816(acc[2 * dn + 1], pa, b1);
            }
        }
        __syncthreads();
    }

    __nv_bfloat16* oh = o + b * out.b + h * out.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (row0 < seq)
            *reinterpret_cast<__nv_bfloat162*>(oh + row0 * out.s + col) =
                __floats2bfloat162_rn(acc[n][0], acc[n][1]);
        if (row0 + 8 < seq)
            *reinterpret_cast<__nv_bfloat162*>(oh + (row0 + 8) * out.s + col) =
                __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
}

template <int D>
int launch_long_sdpa_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, __nv_bfloat16* o, int batch, int heads,
                       int seq, Strides in, Strides out, int causal, cudaStream_t stream) {
    const int q_tiles = (seq + kLongQ - 1) / kLongQ;
    const long long blocks = (long long)batch * heads * q_tiles;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (blocks == 0) return 0;
    const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
    constexpr int smem = long_smem_bytes<D>();
    if (smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            long_sdpa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    long_sdpa_kernel<D><<<static_cast<unsigned>(blocks), kLongThreads, smem, stream>>>(
        q, k, v, o, heads, seq, q_tiles, in, out, causal, scale);
    return static_cast<int>(cudaGetLastError());
}

inline int launch_long_sdpa(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, __nv_bfloat16* o, int batch, int heads,
                            int seq, int head_dim, Strides in, Strides out, int causal,
                            cudaStream_t stream) {
    switch (head_dim) {
        case 32:
            return launch_long_sdpa_d<32>(q, k, v, o, batch, heads, seq, in, out, causal, stream);
        case 64:
            return launch_long_sdpa_d<64>(q, k, v, o, batch, heads, seq, in, out, causal, stream);
        case 128:
            return launch_long_sdpa_d<128>(q, k, v, o, batch, heads, seq, in, out, causal, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace clipx

// q, k, v, o: bf16; element (b, h, s, d) at ptr[b * s_b + h * s_h + s * s_s + d]
// (inputs share one set of strides, the output has its own). head_dim is 32,
// 64 or 128; strides and pointers keep 16-byte rows aligned (the wrappers
// check). fused_sdpa_long passes (B, S, H*D) strides, flash_attention
// (B, H, S, D) ones.
extern "C" int clipx_long_sdpa(const void* q, const void* k, const void* v, void* o,
                               int batch, int heads, int seq, int head_dim, long long in_b,
                               long long in_h, long long in_s, long long out_b,
                               long long out_h, long long out_s, int causal, void* stream) {
    using bf16 = __nv_bfloat16;
    return clipx::launch_long_sdpa(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), batch, heads, seq, head_dim, clipx::Strides{in_b, in_h, in_s},
        clipx::Strides{out_b, out_h, out_s}, causal, static_cast<cudaStream_t>(stream));
}

// fused_sdpa_long_qkv. qkv: (B, S, 3W) bf16, lanes [q | k | v]; wo: (W, W)
// bf16; bo: (W,) f32; attn_buf: (B*S, W) bf16 scratch; out: (B, S, W) bf16.
// W = heads * head_dim, W % 64 == 0; bn: the out projection's tile width
// (64, 128 or 192, dividing W). The attention writes bf16 head outputs
// (the Pallas kernel's rounding of o_h) into attn_buf; the GEMM then sums
// o_h @ wo_h over all heads in one f32 accumulator and adds bo, which is
// the Pallas kernel's head-by-head f32 sum up to summation order.
extern "C" int clipx_fused_sdpa_long_qkv(const void* qkv, const void* wo, const void* bo,
                                         void* attn_buf, void* out, int batch, int seq,
                                         int width, int heads, int causal, int bn,
                                         void* stream) {
    namespace sm = clipx::sm90;
    using bf16 = __nv_bfloat16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* t = static_cast<const bf16*>(qkv);
    bf16* attn = static_cast<bf16*>(attn_buf);
    const int head_dim = width / heads;
    const long long w3 = 3LL * width;
    const int rc = clipx::launch_long_sdpa(
        t, t + width, t + 2 * width, attn, batch, heads, seq, head_dim,
        clipx::Strides{seq * w3, head_dim, w3},
        clipx::Strides{(long long)seq * width, head_dim, width}, causal, st);
    if (rc != 0) return rc;
    return static_cast<int>(sm::launch_gemm<sm::kEpiBias>(
        attn, static_cast<const bf16*>(wo), static_cast<const float*>(bo), nullptr,
        static_cast<bf16*>(out), batch * seq, width, width, bn, st));
}
