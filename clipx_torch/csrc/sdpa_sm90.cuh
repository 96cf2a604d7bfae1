// Scaled dot-product attention for Hopper (sm_90a): one warp-specialised
// TMA + wgmma kernel behind every SDPA of the port that is not fused into
// a projection.
//
// Replaces, in clipx/ops/packed_sdpa.py and clipx/ops/flash_attention.py:
// - packed_sdpa (`_kernel`, :35; pallas_call :784), packed_sdpa_rows
//   (`_rows_kernel`, :75; :567) and packed_sdpa_qkv (`_rows_qkv_kernel`,
//   :110; :170): SDPA at S <= 64, D = 64, on (B, S, H*D) or on one packed
//   (B, S, 3W) projection. The Pallas kernels pack two heads or two batch
//   rows into one 128 x 128 MXU tile; that TPU tiling is not carried over.
// - fused_sdpa_long (`_long_kernel`, :587; :649) and flash_attention
//   (`_attn_kernel`, :29; :84): SDPA for any S on (B, S, H*D) or
//   (B, H, S, D), D in {32, 64, 72, 128}, optional causal mask;
// - the attention step of fused_sdpa_long_qkv (`_long_qkv_kernel`, :670;
//   :742), whose out projection follows on gemm_sm90.cuh's GEMM.
//
// Numerics, the Pallas kernels' rounding points: scores accumulate in f32
// and are scaled by 1/sqrt(D); keys at positions >= S, and keys after the
// query when causal, are set to -1e30; the softmax is f32 and
// max-subtracted; the probabilities are normalised before they are rounded
// to bf16; P @ V accumulates in f32 and is stored bf16. Exponentials run on
// the SFU (ex2.approx, with 1/sqrt(D) * log2(e) folded into one FMA) and
// normalisation multiplies by 1/l: relative errors ~1e-7, far below the
// bf16 rounding of P that follows. A one-pass online softmax would round
// unnormalised P to bf16, a different function at the bf16 level, so S > 64
// makes two passes over the keys.
//
// What bounds it on this card: at ViT-L/14@336px (S = 577, D = 64, 16
// heads) and batch 128 the call moves 604 MB (q, k, v read once, o written
// once) for 175 GFLOP of attention: 0.18 ms by bytes, at the H100's ridge.
// Two passes cost 1.5x the attention FLOPs (262 GFLOP, 0.27 ms of tensor
// cores; 322 with the padding of S to whole tiles) and two exponentials a
// score (~1.7 G ex2, ~0.45 ms of SFU at 16 a clock an SM), and K is read
// from L2 twice. At S <= 64 (ViT-B/32, S = 50) a call is ~25 FLOP a byte
// and bound by bytes, at batch 1 by the launch.
//
// Design. A block has one TMA producer warp (of a warpgroup that gives its
// registers away) and two consumer warpgroups of 64 query rows each.
// Tensor maps view q, k and v as 4-D (d, s, h, b) with the caller's
// element strides, sorted by stride for the map, so one kernel reads
// (B, S, H*D), the packed (B, S, 3W) projection and (B, H, S, D). Rows >= S
// are TMA's zero fill inside the same (b, h), never the next batch row. A
// tile's rows are 128-byte-swizzled 64-column boxes at D = 64 (two boxes
// side by side at D = 128), one 64-byte-swizzled 32-column box at D = 32.
// D = 72 (SigLIP so400m: 1152 wide, 16 heads) is not a multiple of the k16
// step of a bf16 wgmma: its tiles are five 32-byte-swizzled 16-column boxes
// side by side, 80 columns, and the tensor map's head dim stays 72, so TMA
// zero-fills columns 72..79 of the last box. Q K^T runs five k16 steps
// (the zero columns add nothing), P @ V one n80 wgmma whose columns 72..79
// are never stored. Nothing is padded in memory.
// Q is read once into registers (ldmatrix) as the A fragments of S = Q K^T
// (wgmma, K read K-major); P @ V takes P from registers too (the score
// accumulators, normalised and rounded, are its A fragments) and V
// MN-major.
// - S <= 64: one key tile, one pass, the scores never leave registers. A
//   warpgroup owns one (batch row, head); a block two, so ceil(B*H/2)
//   blocks. B2, B3 and B4 run the same arithmetic: bitwise equal.
// - S > 64: a block owns one (b, h) and 128 query rows. The producer loads
//   each warpgroup's Q tile once, then streams key tiles of kLongKeys (128
//   at D <= 72, 64 at D = 128, so that the registers fit) into a ring that
//   both warpgroups read: K alone for pass 1, K and V for pass 2. Pass 1
//   keeps each row's max and sum online (the sum rescaled in f32); pass 2
//   recomputes S and runs P @ V with p = bf16(exp(s - m) * (1/l)). In pass
//   1 the next tile's Q K^T runs on the tensor cores while this tile's
//   exponentials run; in pass 2 this tile's P @ V runs while the next
//   tile's exponentials do. The two warpgroups overlap each other's
//   softmax and products without further scheduling: turn-taking on named
//   barriers (ping-pong) was tried and measured no faster. A causal block stops at its last query row's tile, a warpgroup skips
//   the tiles past its own rows, and only the tiles that hold keys past S
//   or after a row are masked. Any S and any D fit in fixed shared memory.

#pragma once

#include <limits.h>
#include <math.h>

#include "gemm_sm90.cuh"

namespace clipx {
namespace sm90 {

constexpr int kRows = 64;        // query rows a warpgroup; keys of the one-tile path
constexpr int kSdpaQRows = kRows * kConsumers;  // query rows a block, S > 64
constexpr float kSdpaNeg = -1e30f;
constexpr double kLog2e = 1.4426950408889634;

// The shared-memory geometry at head dim D.
template <int D>
struct SdpaTile {
    static_assert(D == 32 || D == 64 || D == 72 || D == 128, "head dims 32, 64, 72, 128");
    static constexpr int kPadD = (D + 15) / 16 * 16;        // columns in shared memory
    static constexpr int kLongKeys = D == 128 ? 64 : 128;   // keys a tile, S > 64
    static constexpr int kBoxCols = D == 72 ? 16 : (D < 64 ? D : 64);  // columns of a TMA box
    static constexpr int kBoxes = kPadD / kBoxCols;         // boxes side by side
    static constexpr int kRowBytes = kBoxCols * 2;          // the swizzle span
    static constexpr int kQBoxBytes = kRows * kRowBytes;
    static constexpr int kQBytes = kBoxes * kQBoxBytes;     // a Q tile: 64 rows
    static constexpr int kKVBoxBytes = kLongKeys * kRowBytes;
    static constexpr int kKVBytes = kBoxes * kKVBoxBytes;   // a K or V tile
    static constexpr int kAtomBytes = 8 * kRowBytes;        // the swizzle repeats every 8 rows
    // wgmma descriptor: 128B (1), 64B (2) or 32B (3) swizzle
    static constexpr int kLayout = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
    static constexpr int kChunkCols = D == 72 ? 80 : (D < 64 ? 32 : 64);  // P @ V columns a wgmma
    static constexpr int kChunks = kPadD / kChunkCols;
    static constexpr int kStageBytes = 2 * kKVBytes;        // K and V
    static constexpr int kStages = D == 128 ? 5 : 4;        // ring stages
    static constexpr int kSmem = 1024 + kConsumers * kQBytes + kStages * kStageBytes +
                                 (kConsumers + 2 * kStages) * 8;
};

// What the kernel needs besides the tensor maps. pos_s, pos_h, pos_b: the
// map dimension (1..3) of s, h and b; o_*: the output's element strides.
struct SdpaArgs {
    int batch, heads, seq, q_tiles, causal;
    int pos_s, pos_h, pos_b;
    long long o_b, o_h, o_s;
    float scale_log2;  // log2(e) / sqrt(D)
};

// ---------------------------------------------------------------------------
// PTX helpers beyond gemm_sm90.cuh's
// ---------------------------------------------------------------------------

// One 4-D TMA box into shared memory, completion counted on the mbarrier.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// waits until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint64_t sdpa_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
           (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
           (static_cast<uint64_t>(layout) << 62);
}

// A K tile as the K-major B of Q K^T (head dims contiguous in each key's
// row) at k16 step kk over the head dims: 32 bytes a step inside a box.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
    using T = SdpaTile<D>;
    constexpr int kSteps = T::kBoxCols / 16;  // k16 steps a box
    return sdpa_desc(tile + (kk / kSteps) * T::kKVBoxBytes + 32 * (kk % kSteps), 16,
                     T::kAtomBytes, T::kLayout);
}

// A V tile as the MN-major B of P @ V, at k16 step kk over the keys (16
// rows) and column chunk c.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk, int c) {
    using T = SdpaTile<D>;
    return sdpa_desc(tile + c * T::kKVBoxBytes + kk * 16 * T::kRowBytes, T::kKVBoxBytes,
                     T::kAtomBytes, T::kLayout);
}

#define SDPA_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define SDPA_R32                                                                      \
    SDPA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
             "%30, %31"
#define SDPA_R64                                                                      \
    SDPA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
             "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
             "%61, %62, %63"
#define SDPA_R40                                                                      \
    SDPA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define SDPA_D8(i)                                                                    \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SDPA_D32 SDPA_D8(0), SDPA_D8(8), SDPA_D8(16), SDPA_D8(24)

// d[64 x N] = A[64 x 16] @ B[16 x N] (+ d where accumulate is set): A from
// registers (warp w holds rows 16w .. 16w + 15 in the mma.sync m16n8k16
// fragment layout), B from shared memory, K-major (kTnspB = 0) or MN-major
// (kTnspB = 1).
template <int N, int kTnspB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<32, 1>(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" SDPA_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : SDPA_D8(0), SDPA_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" SDPA_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : SDPA_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" SDPA_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SDPA_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<80, 1>(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{" SDPA_R40 "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : SDPA_D32, SDPA_D8(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, 0>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" SDPA_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : SDPA_D32, SDPA_D8(32), SDPA_D8(40), SDPA_D8(48), SDPA_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef SDPA_D32
#undef SDPA_D8
#undef SDPA_R64
#undef SDPA_R40
#undef SDPA_R32
#undef SDPA_R16

// ---------------------------------------------------------------------------
// the consumer's steps. A tile of N keys is N / 2 f32 scores a thread:
// register 4j + 2r + e holds row 16 * warp + g + 8r, key 8j + 2t + e
// ---------------------------------------------------------------------------

// Q's A fragments for every k16 step over the head dims, read from the
// swizzled tile with ldmatrix: lane l addresses row l % 8 of 8 x 8 matrix
// l / 8 (rows +8 for odd matrices, columns +8 for the last two)
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[SdpaTile<D>::kPadD / 16][4], uint32_t q,
                                       int warp, int lane) {
    using T = SdpaTile<D>;
    constexpr int kSteps = T::kBoxCols / 16;
    const int mat = lane >> 3;
    const int row = warp * 16 + (lane & 7) + (mat & 1) * 8;
    const int swz = T::kRowBytes == 128 ? (row & 7)
                                        : (T::kRowBytes == 64 ? ((row >> 1) & 3) : ((row >> 2) & 1));
#pragma unroll
    for (int kk = 0; kk < T::kPadD / 16; ++kk) {
        const int chunk = (kk % kSteps) * 2 + (mat >> 1);  // 16-byte chunk of the row
        const uint32_t addr =
            q + (kk / kSteps) * T::kQBoxBytes + row * T::kRowBytes + ((chunk ^ swz) << 4);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(qa[kk][0]), "=r"(qa[kk][1]), "=r"(qa[kk][2]), "=r"(qa[kk][3])
                     : "r"(addr));
    }
}

// starts s = Q K^T for the warpgroup's 64 rows against the first N keys of
// a K tile (raw f32) as one committed wgmma group
template <int D, int N>
__device__ __forceinline__ void qk_issue(float (&s)[N / 2],
                                         const uint32_t (&qa)[SdpaTile<D>::kPadD / 16][4],
                                         uint32_t k) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SdpaTile<D>::kPadD / 16; ++kk)
        wgmma_rs<N, 0>(s, qa[kk], desc_k_major<D>(k, kk), kk > 0);
    wgmma_commit();
}

// starts o += P @ V over the first N keys of a V tile as one committed
// wgmma group
template <int D, int N>
__device__ __forceinline__ void pv_issue(
    float (&o)[SdpaTile<D>::kChunks][SdpaTile<D>::kChunkCols / 2], const uint32_t (&pa)[N / 16][4],
    uint32_t v) {
    using T = SdpaTile<D>;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
            wgmma_rs<T::kChunkCols, 1>(o[c], pa[kk], desc_mn_major<D>(v, kk, c), 1);
    wgmma_commit();
}

template <int D>
__device__ __forceinline__ void fence_acc(
    float (&o)[SdpaTile<D>::kChunks][SdpaTile<D>::kChunkCols / 2]) {
#pragma unroll
    for (int c = 0; c < SdpaTile<D>::kChunks; ++c) fence_regs(o[c]);
}

// Where one thread's scores of a tile sit: keys k0 + 8j + 2t + e, rows
// row0 + 8r. Scores are masked as they are read, never written back: the
// registers are wgmma accumulators, and ptxas serialises every wgmma of a
// kernel that writes one while a wgmma is in flight.
struct TileMask {
    int k0, row0, seq, t;
    bool causal;
};

// s[i] with the mask applied when kMask: keys at or past seq, and (causal)
// keys after the row, read -1e30
template <bool kMask, int R>
__device__ __forceinline__ float score(const float (&s)[R], int i, const TileMask& mk) {
    if (!kMask) return s[i];
    const int key = mk.k0 + 8 * (i / 4) + 2 * mk.t + (i & 1);
    const int row = mk.row0 + 8 * ((i / 2) & 1);
    return (key >= mk.seq || (mk.causal && key > row)) ? kSdpaNeg : s[i];
}

// the row maxima of raw scores, in the scaled log2 domain
template <bool kMask, int R>
__device__ __forceinline__ void row_max(const float (&s)[R], float (&mx)[2], float c,
                                        const TileMask& mk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float v = kSdpaNeg;
#pragma unroll
        for (int j = 0; j < R / 4; ++j)
            v = fmaxf(v, fmaxf(score<kMask>(s, 4 * j + 2 * r, mk),
                               score<kMask>(s, 4 * j + 2 * r + 1, mk)));
        v = quad_max(v);
        mx[r] = v == kSdpaNeg ? kSdpaNeg : v * c;  // a masked maximum stays -1e30
    }
}

// this thread's share of sum exp2(s * c - m) in row r
template <bool kMask, int R>
__device__ __forceinline__ float row_sum(const float (&s)[R], int r, float m, float c,
                                         const TileMask& mk) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
        sum += ex2(fmaf(score<kMask>(s, 4 * j + 2 * r, mk), c, -m)) +
               ex2(fmaf(score<kMask>(s, 4 * j + 2 * r + 1, mk), c, -m));
    return sum;
}

// pass 1 over one tile: the running max m and this thread's share of l,
// rescaled in f32 as m grows
template <bool kMask, int R>
__device__ __forceinline__ void tile_stats(const float (&s)[R], float (&m)[2], float (&l)[2],
                                           float c, const TileMask& mk) {
    float mx[2];
    row_max<kMask>(s, mx, c, mk);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], mx[r]);
        l[r] = l[r] * ex2(m[r] - mn) + row_sum<kMask>(s, r, mn, c, mk);
        m[r] = mn;
    }
}

// P = bf16(exp(s - m) * inv_l) as the A fragments of P @ V (fragment kk
// covers keys 16kk .. 16kk + 15)
template <bool kMask, int R>
__device__ __forceinline__ void probs(const float (&s)[R], const float (&m)[2],
                                      const float (&inv_l)[2], float c,
                                      uint32_t (&pa)[R / 8][4], const TileMask& mk) {
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
            pa[j / 2][(j % 2) * 2 + r] =
                pack_bf16(ex2(fmaf(score<kMask>(s, 4 * j + 2 * r, mk), c, -m[r])) * inv_l[r],
                          ex2(fmaf(score<kMask>(s, 4 * j + 2 * r + 1, mk), c, -m[r])) *
                              inv_l[r]);
}

// o's rows < seq and columns < D into out (the (b, h) slice's first
// element), bf16
template <int D>
__device__ __forceinline__ void store_rows(
    const float (&o)[SdpaTile<D>::kChunks][SdpaTile<D>::kChunkCols / 2], bf16* out,
    long long o_s, int row0, int seq, int t) {
    using T = SdpaTile<D>;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= seq) continue;
        bf16* dst = out + row * o_s + 2 * t;
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
            for (int j = 0; j < T::kChunkCols / 8; ++j)
                if (c * T::kChunkCols + 8 * j < D)
                    *reinterpret_cast<uint32_t*>(dst + c * T::kChunkCols + 8 * j) =
                        pack_bf16(o[c][4 * j + 2 * r], o[c][4 * j + 2 * r + 1]);
    }
}

// one tile (rows row .. row + box rows - 1 of head h, batch row b) into dst
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, int box_bytes, const CUtensorMap* map,
                                          uint32_t bar, int row, int h, int b,
                                          const SdpaArgs& a) {
    using T = SdpaTile<D>;
    auto coord = [&](int pos) { return pos == a.pos_s ? row : (pos == a.pos_h ? h : b); };
#pragma unroll
    for (int i = 0; i < T::kBoxes; ++i)
        tma_load4(dst + i * box_bytes, map, bar, i * T::kBoxCols, coord(1), coord(2), coord(3));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Grid: ceil(B*H / 2) blocks when S <= 64, else B * H * q_tiles (a block
// per 128 query rows, the tiles of one (b, h) adjacent); kThreads threads
// and SdpaTile<D>::kSmem bytes of dynamic shared memory. tm_q reads 64-row
// boxes, tm_k and tm_v kLongKeys-row ones.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sdpa_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                 const SdpaArgs a) {
    using T = SdpaTile<D>;
    constexpr int N = T::kLongKeys;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t q_tiles = base;                               // one Q tile a warpgroup
    const uint32_t ring = base + kConsumers * T::kQBytes;        // stages of [K | V]
    const uint32_t q_full = ring + T::kStages * T::kStageBytes;
    const uint32_t full = q_full + kConsumers * 8;
    const uint32_t empty = full + T::kStages * 8;
    // the warpgroup, broadcast from lane 0 so that the compiler sees it
    // warp-uniform: the branches on it (and on the rows it owns) are then
    // not divergent, and ptxas keeps wgmma asynchronous across them
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
    const bool one_tile = a.seq <= kRows;
    const bool causal = a.causal != 0;
    const int pairs = a.batch * a.heads;

    // S > 64: this block's (b, h) and first query row, and the key tiles
    // it needs (a causal block none past its last row)
    const int bh = blockIdx.x / a.q_tiles;
    const int hh = bh % a.heads;
    const int bb = bh / a.heads;
    const int q0 = (blockIdx.x % a.q_tiles) * kSdpaQRows;
    int n_tiles = (a.seq + N - 1) / N;
    if (causal) n_tiles = min(n_tiles, (q0 + kSdpaQRows + N - 1) / N);

    if (threadIdx.x == 0) {
        for (int w = 0; w < kConsumers; ++w) mbar_init(q_full + 8 * w, 1);
        for (int s = 0; s < T::kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, kConsumers * 4);  // one arrival a consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == kConsumers) {
        regs_dec<kProducerRegs>();
        if (threadIdx.x != kConsumers * 128) return;
        if (one_tile) {
            // Q, K and V of each warpgroup's (b, h) pair at once; an odd
            // pair count's last warpgroup reloads the last pair and stores
            // nothing
            for (int w = 0; w < kConsumers; ++w) {
                const int p = min(2 * static_cast<int>(blockIdx.x) + w, pairs - 1);
                const int b = p / a.heads, h = p % a.heads;
                const uint32_t bar = q_full + 8 * w;
                const uint32_t kv = ring + w * T::kStageBytes;
                mbar_expect_tx(bar, T::kQBytes + T::kStageBytes);
                load_tile<D>(q_tiles + w * T::kQBytes, T::kQBoxBytes, &tm_q, bar, 0, h, b, a);
                load_tile<D>(kv, T::kKVBoxBytes, &tm_k, bar, 0, h, b, a);
                load_tile<D>(kv + T::kKVBytes, T::kKVBoxBytes, &tm_v, bar, 0, h, b, a);
            }
            return;
        }
        for (int w = 0; w < kConsumers; ++w) {
            // a warpgroup whose rows all lie past S loads rows 0.. and
            // stores nothing
            const int row = q0 + w * kRows < a.seq ? q0 + w * kRows : 0;
            mbar_expect_tx(q_full + 8 * w, T::kQBytes);
            load_tile<D>(q_tiles + w * T::kQBytes, T::kQBoxBytes, &tm_q, q_full + 8 * w, row,
                         hh, bb, a);
        }
        int it = 0;
        for (int pass = 0; pass < 2; ++pass) {
            for (int kt = 0; kt < n_tiles; ++kt, ++it) {
                const int s = it % T::kStages;
                mbar_wait(empty + 8 * s, ((it / T::kStages) & 1) ^ 1);
                const uint32_t stage = ring + s * T::kStageBytes;
                const uint32_t bar = full + 8 * s;
                mbar_expect_tx(bar, (pass + 1) * T::kKVBytes);
                load_tile<D>(stage, T::kKVBoxBytes, &tm_k, bar, kt * N, hh, bb, a);
                if (pass)
                    load_tile<D>(stage + T::kKVBytes, T::kKVBoxBytes, &tm_v, bar, kt * N, hh,
                                 bb, a);
            }
        }
        return;
    }

    regs_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
    const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8 of the 64
    const float c = a.scale_log2;
    const uint32_t q = q_tiles + wg * T::kQBytes;
    float o[T::kChunks][T::kChunkCols / 2];
#pragma unroll
    for (int i = 0; i < T::kChunks; ++i)
#pragma unroll
        for (int j = 0; j < T::kChunkCols / 2; ++j) o[i][j] = 0.f;
    uint32_t qa[T::kPadD / 16][4];

    if (one_tile) {
        // 64 keys: the first 64 rows of the K and V tiles
        const int p = 2 * blockIdx.x + wg;
        mbar_wait(q_full + 8 * wg, 0);
        if (p >= pairs) return;
        load_q<D>(qa, q, warp, threadIdx.x & 31);
        const uint32_t kv = ring + wg * T::kStageBytes;
        float s[kRows / 2] = {};
        uint32_t pa[kRows / 16][4];
        qk_issue<D, kRows>(s, qa, kv);
        wgmma_wait<0>();
        fence_regs(s);
        const TileMask mk{0, r0, a.seq, t, causal};
        float m[2], l[2];
        row_max<true>(s, m, c, mk);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = 1.f / quad_sum(row_sum<true>(s, r, m[r], c, mk));
        probs<true>(s, m, l, c, pa, mk);
        pv_issue<D, kRows>(o, pa, kv + T::kKVBytes);
        wgmma_wait<0>();
        fence_acc<D>(o);
        const int b = p / a.heads, h = p % a.heads;
        store_rows<D>(o, out + b * a.o_b + h * a.o_h, a.o_s, r0, a.seq, t);
        return;
    }

    const int qw = q0 + wg * kRows;  // the warpgroup's first query row
    const int row0 = qw + r0;
    // a tile is masked when it holds a key past S or after the warpgroup's
    // first row
    auto masked = [&](int kt) {
        return (kt + 1) * N > a.seq || (causal && (kt + 1) * N - 1 > qw);
    };
    // ring item i (pass 1: tile i; pass 2: tile i - n_tiles) lives in stage
    // i % kStages; every consumer warp waits for and releases every item
    auto stage_of = [&](int i) { return ring + (i % T::kStages) * T::kStageBytes; };
    auto wait_item = [&](int i) {
        mbar_wait(full + 8 * (i % T::kStages), (i / T::kStages) & 1);
    };
    auto release = [&](int i) {
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * (i % T::kStages));
    };
    // the tiles this warpgroup computes, a prefix; it waits for and
    // releases the others. Inside the prefix every wgmma is issued
    // unconditionally: a wgmma behind a branch leaves ptxas unsure which
    // group a partial wait retires, and it then serialises every wgmma.
    const int na = causal ? min(n_tiles, (qw + kRows - 1) / N + 1) : n_tiles;
    auto skip = [&](int i) {
        wait_item(i);
        release(i);
    };
    mbar_wait(q_full + 8 * wg, 0);
    load_q<D>(qa, q, warp, threadIdx.x & 31);

    // pass 1: each row's max m (scaled log2 domain, quad-wide) and this
    // thread's share of l = sum exp2(s * c - m), rescaled as m grows
    float m[2] = {kSdpaNeg, kSdpaNeg};
    float l[2] = {0.f, 0.f};
    float sa[N / 2], sb[N / 2];  // one tile in the softmax, the next on the tensor cores
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sa[i] = sb[i] = 0.f;
    auto stats_of = [&](const float (&cur)[N / 2], int kt) {
        const TileMask mk{kt * N, row0, a.seq, t, causal};
        if (masked(kt))
            tile_stats<true>(cur, m, l, c, mk);
        else
            tile_stats<false>(cur, m, l, c, mk);
    };
    auto stats = [&](float (&cur)[N / 2], float (&nxt)[N / 2], int kt) {
        release(kt);  // Q K^T of tile kt is done: its K is no longer read
        wait_item(kt + 1);
        qk_issue<D, N>(nxt, qa, stage_of(kt + 1));
        stats_of(cur, kt);
        wgmma_wait<0>();
        fence_regs(nxt);
    };
    wait_item(0);
    qk_issue<D, N>(sa, qa, stage_of(0));
    wgmma_wait<0>();
    fence_regs(sa);
    int kt = 0;
    for (; kt + 2 < na; kt += 2) {
        stats(sa, sb, kt);
        stats(sb, sa, kt + 1);
    }
    if (kt + 1 < na) stats(sa, sb, kt++);
    release(kt);  // the last computed tile, its scores in sa when kt is even
    if (kt & 1)
        stats_of(sb, kt);
    else
        stats_of(sa, kt);
    for (++kt; kt < n_tiles; ++kt) skip(kt);
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l[r]);

    // pass 2: p = bf16(exp(s - m) / l), o += p @ V. Tile kt + 1's Q K^T and
    // tile kt's P @ V are issued back to back; tile kt + 1's probabilities
    // are computed while tile kt's P @ V runs, into the other set of A
    // fragments
    const int n = n_tiles;
    uint32_t pa[N / 16][4], pb[N / 16][4];
    auto probs_of = [&](const float (&cur)[N / 2], uint32_t (&p)[N / 16][4], int kt) {
        const TileMask mk{kt * N, row0, a.seq, t, causal};
        if (masked(kt))
            probs<true>(cur, m, inv_l, c, p, mk);
        else
            probs<false>(cur, m, inv_l, c, p, mk);
    };
    auto step = [&](uint32_t (&p)[N / 16][4], uint32_t (&p_nxt)[N / 16][4], int kt) {
        wait_item(n + kt + 1);
        qk_issue<D, N>(sa, qa, stage_of(n + kt + 1));
        pv_issue<D, N>(o, p, stage_of(n + kt) + T::kKVBytes);
        wgmma_wait<1>();  // the Q K^T; the P @ V, the newest group, may run on
        fence_regs(sa);
        probs_of(sa, p_nxt, kt + 1);
        wgmma_wait<0>();
        release(n + kt);
    };
    wait_item(n);
    qk_issue<D, N>(sa, qa, stage_of(n));
    wgmma_wait<0>();
    fence_regs(sa);
    probs_of(sa, pa, 0);
    kt = 0;
    for (; kt + 2 < na; kt += 2) {
        step(pa, pb, kt);
        step(pb, pa, kt + 1);
    }
    if (kt + 1 < na) step(pa, pb, kt++);
    // the last computed tile, its probabilities in pa when kt is even
    if (kt & 1)
        pv_issue<D, N>(o, pb, stage_of(n + kt) + T::kKVBytes);
    else
        pv_issue<D, N>(o, pa, stage_of(n + kt) + T::kKVBytes);
    wgmma_wait<0>();
    release(n + kt);
    for (++kt; kt < n; ++kt) skip(n + kt);
    fence_acc<D>(o);
    store_rows<D>(o, out + bb * a.o_b + hh * a.o_h, a.o_s, row0, a.seq, t);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// q, k or v as a 4-D (d, s, h, b) tensor map in tiles of box_rows rows: in[]
// holds the element strides of s, h and b, sorted by stride into map
// dimensions 1..3 (order[i] names the one in dimension i + 1). Needs a
// 16-byte aligned base and strides that are multiples of 8 elements. The
// map's head dim is D: a box past it (columns 72..79 at D = 72) is TMA's
// zero fill.
template <int D>
inline bool make_sdpa_tmap(CUtensorMap* map, const void* ptr, const long long (&in)[3],
                           const int (&n)[3], const int (&order)[3], int box_rows) {
    using T = SdpaTile<D>;
    const EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return false;
    cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
    cuuint64_t strides[3];
    cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBoxCols), 1, 1, 1};
    for (int i = 0; i < 3; ++i) {
        const int dim = order[i];  // 0 = s, 1 = h, 2 = b
        dims[i + 1] = static_cast<cuuint64_t>(n[dim]);
        strides[i] = static_cast<cuuint64_t>(in[dim]) * sizeof(bf16);
        if (dim == 0) box[i + 1] = static_cast<cuuint32_t>(box_rows);
    }
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
              box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
              T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : (T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                        : CU_TENSOR_MAP_SWIZZLE_32B),
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
inline cudaError_t launch_sdpa_d(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                 int batch, int heads, int seq, const long long (&in)[3],
                                 const long long (&out)[3], int causal, cudaStream_t stream) {
    using T = SdpaTile<D>;
    const int n[3] = {seq, heads, batch};
    int order[3] = {0, 1, 2};  // s, h, b sorted by stride (stable)
    for (int i = 1; i < 3; ++i)
        for (int j = i; j > 0 && in[order[j]] < in[order[j - 1]]; --j) {
            const int x = order[j];
            order[j] = order[j - 1];
            order[j - 1] = x;
        }
    SdpaArgs a;
    a.batch = batch;
    a.heads = heads;
    a.seq = seq;
    a.q_tiles = (seq + kSdpaQRows - 1) / kSdpaQRows;
    a.causal = causal;
    for (int i = 0; i < 3; ++i) {
        if (order[i] == 0) a.pos_s = i + 1;
        if (order[i] == 1) a.pos_h = i + 1;
        if (order[i] == 2) a.pos_b = i + 1;
    }
    a.o_b = out[2];
    a.o_h = out[1];
    a.o_s = out[0];
    a.scale_log2 = static_cast<float>(kLog2e / sqrt(static_cast<double>(D)));
    const long long pairs = static_cast<long long>(batch) * heads;
    const long long blocks =
        seq == 0 ? 0 : (seq <= kRows ? (pairs + 1) / 2 : pairs * a.q_tiles);
    if (blocks > INT_MAX || pairs > INT_MAX) return cudaErrorInvalidValue;
    if (blocks == 0) return cudaSuccess;
    CUtensorMap tq, tk, tv;
    if (!make_sdpa_tmap<D>(&tq, q, in, n, order, kRows) ||
        !make_sdpa_tmap<D>(&tk, k, in, n, order, T::kLongKeys) ||
        !make_sdpa_tmap<D>(&tv, v, in, n, order, T::kLongKeys))
        return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        sdpa_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    sdpa_sm90_kernel<D><<<static_cast<unsigned>(blocks), kThreads, T::kSmem, stream>>>(
        tq, tk, tv, o, a);
    return cudaGetLastError();
}

// SDPA on the current stream. Element (b, h, s, d) of q, k and v at
// ptr[b * in[2] + h * in[1] + s * in[0] + d], of o at the same with out[].
// head_dim 32, 64, 72 or 128; 16-byte aligned bases, in[] multiples of 8 and
// out[] even (the wrappers check).
inline cudaError_t launch_sdpa(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch,
                               int heads, int seq, int head_dim, const long long (&in)[3],
                               const long long (&out)[3], int causal, cudaStream_t stream) {
    switch (head_dim) {
        case 32:
            return launch_sdpa_d<32>(q, k, v, o, batch, heads, seq, in, out, causal, stream);
        case 64:
            return launch_sdpa_d<64>(q, k, v, o, batch, heads, seq, in, out, causal, stream);
        case 72:
            return launch_sdpa_d<72>(q, k, v, o, batch, heads, seq, in, out, causal, stream);
        case 128:
            return launch_sdpa_d<128>(q, k, v, o, batch, heads, seq, in, out, causal, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace sm90
}  // namespace clipx
