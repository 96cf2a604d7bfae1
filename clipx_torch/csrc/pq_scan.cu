// pq_scan_scores for Hopper (sm_90a): the PQ asymmetric-distance scan as a
// one-hot product on the tensor cores.
//
// Replaces clipx/ops/pq_scan.py::pq_scan_scores (kernel `_kernel`, :46,
// pallas_call at :124). For every code row n and query q
//
//     out[q, n] = sum_m lut[m * 16 + code(n, m), q]        (exact int32 sum)
//
// where a row holds M = 2 * half 4-bit codes in the SPLIT layout: byte j
// carries subspace j in its low nibble and subspace j + half in its high
// nibble. The Pallas kernel ran the lookup as a one-hot (rows, M*16) x
// (M*16, Q) product on the MXU with the one-hot kept in VMEM. This kernel
// runs the same product on the tensor cores, with the one-hot built in
// registers and never stored:
//
// - Product: mma.sync m16n8k32 s8 x s8 -> s32, A (the one-hot, 0/1 bytes)
//   and B (the LUT) from registers; one n8 block of queries for Q <= 8, two
//   for Q <= 16, zero-padded. |sum| <= 127 * M < 2^24, so the f32 scores
//   are exact integers, bitwise those of the plain version and of clipx.
// - One-hot: one byte permute (prmt) makes a whole A register. prmt's
//   selector holds four 4-bit byte indices, and its low 16 bits are exactly
//   the four nibbles of two code bytes: j, j + half, j + 1, j + 1 + half.
//   Against the 8-byte table {0, 1 << 8t} (or {1 << 8t, 0}) byte i of the
//   result is [nibble i == t] (or [== 4 + t]); a selector of 8 or more
//   reads the sign of a table byte, 0. Flipping bit 3 of every nibble (one
//   XOR a code word) gives values 8 + t and 12 + t. So K is ordered by
//   (subspace, value) as the selector lays them out: the k32 step of a code
//   byte pair and value half (0-7 or 8-15) gives lane 4g + t the values t
//   (k 4t..4t+3) and 4 + t (k 16+4t..), each for the four subspaces. A
//   register costs one prmt, plus a shift and an XOR shared by 4 registers
//   of a code word. Two designs built before this one were slower: a 1
//   shifted into place (shift, LOP3, clamped shl: 3 integer ops a
//   register), and wgmma m64n16k32 with A from registers and the LUT
//   K-major in shared memory, whose fixed cost a wgmma did not shrink with
//   N and whose one-hot building did not overlap it (PERF.md §6).
// - LUT: staged once per block, by the block itself, from lut_t straight
//   into the B fragment layout of that K order: 32 lanes x 16 bytes a k32
//   step (queries g and 8 + g), one conflict-free shared load a step, which
//   serves the warp's 4 row blocks (64 rows, 4 or 8 mma.sync). Steps past
//   the row's code bytes have zero LUT bytes: they add 0 whatever their
//   one-hot. At half = 256 the LUT takes 128 KB.
// - Codes: each warp owns 64-row tiles of a persistent grid (one 12-warp
//   block an SM) and reads its rows' code bytes straight from global
//   memory, 8 a load, one batch ahead of the one it multiplies. Rows are
//   `pitch` bytes apart, a multiple of 8; the wrapper pads a half that is
//   not one with zero bytes. Rows past N read the tile's last row and are
//   not stored.
// - Output: (Q, N) f32, row-contiguous per query, stored from the
//   accumulator layout: each store instruction of a warp writes 8
//   consecutive rows of 4 queries, four full 32-byte sectors.
//
// What bounds it on this card: at N = 2^20, M = 256, Q = 16 the call must
// move 128 MiB of codes, 64 KiB of LUT and 64 MiB of scores: ~0.060 ms at
// 3.35 TB/s. The one-hot product is 2 N M 16 Q = 137 G int8 operations,
// ~0.069 ms at the 1,979 TOP/s peak, which mma.sync does not reach. The
// byte permutes issue at half rate (16 lanes a clock a scheduler), and
// their issue and the mma.sync stream overlap only in part: the kernel is
// bound by instruction issue, several times the byte bound (PERF.md §6).
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace clipx {
namespace pq {

constexpr int kRowBlocks = 4;                 // m16 row blocks a warp tile
constexpr int kTile = 16 * kRowBlocks;        // code rows a warp tile
constexpr int kWarps = 12;                    // warps a block, one block an SM
constexpr int kThreads = 32 * kWarps;
constexpr int kQPad = 16;                     // two n8 blocks: queries, zero-padded
constexpr int kBatch = 8;                     // code bytes (k32 steps) an 8-byte load
constexpr int kStepBytes = 32 * 16;           // one k32 step's B fragments
constexpr int kSmemMax = 232448;              // a block's shared memory on an H100

// k32 steps: code bytes a row, padded to a batch
__host__ __device__ constexpr int steps_pad(int half) {
    return (half + kBatch - 1) / kBatch * kBatch;
}

// c += a (16x32 s8, row-major fragment) * b (32x8 s8, column-major)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four one-hot bytes in one byte permute: byte i of the result is table
// byte (nibble i of sel), or the sign of table byte (nibble i - 8) for a
// nibble of 8 or more; prmt reads only sel's low 16 bits.
__device__ __forceinline__ uint32_t onehot4(uint32_t lo, uint32_t hi, uint32_t sel) {
    uint32_t r;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
    return r;
}

// The selector of k32 step s (0-3) of code word w: the nibbles of its bytes
// 0, 1 (s = 0, 1) or 2, 3 (s = 2, 3) in bits 0-15, as they are (values 0-7)
// or with bit 3 flipped (values 8-15).
__device__ __forceinline__ uint32_t selector(uint32_t w, int s) {
    const uint32_t x = s & 1 ? w ^ 0x88888888u : w;
    return s & 2 ? x >> 16 : x;
}

// One batch of kBatch k32 steps on the 8 code bytes c of each of this
// thread's rows (16 rb + g and 16 rb + g + 8), against the B fragments of
// those steps (lut_v).
template <int kNB>
__device__ __forceinline__ void scan_batch(int (&acc)[kRowBlocks][kNB][4],
                                           const uint2 (&c)[kRowBlocks][2], const uint4* lut_v,
                                           int lane, uint32_t one_t) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const uint4 b = lut_v[(4 * i + s) * 32 + lane];
#pragma unroll
            for (int rb = 0; rb < kRowBlocks; ++rb) {
                const uint32_t s0 = selector(i ? c[rb][0].y : c[rb][0].x, s);
                const uint32_t s1 = selector(i ? c[rb][1].y : c[rb][1].x, s);
                const uint32_t a[4] = {onehot4(one_t, 0u, s0), onehot4(one_t, 0u, s1),
                                       onehot4(0u, one_t, s0), onehot4(0u, one_t, s1)};
                mma_s8(acc[rb][0], a, b.x, b.y);
                if constexpr (kNB == 2) mma_s8(acc[rb][1], a, b.z, b.w);
            }
        }
}

// codes: (n, pitch) bytes, 16-byte aligned, pitch % 8 == 0, the first half
// bytes of a row its codes and the rest 0; lut: (2 * half * 16, q) int8, row
// m * 16 + c; out: (q, n) f32. 1 <= q <= 8 * kNB. Grid: persistent, one
// block an SM, kThreads threads and steps_pad(half) * kStepBytes bytes of
// dynamic shared memory.
template <int kNB>
__global__ void __launch_bounds__(kThreads, 1)
pq_scan_onehot_kernel(const uint8_t* __restrict__ codes, const int8_t* __restrict__ lut,
                      float* __restrict__ out, int n, int half, int pitch, int q) {
    extern __shared__ __align__(16) uint4 lut_s[];  // [step][lane]: 4 B-fragment words
    const int spad = steps_pad(half);
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;

    // the LUT in fragment order. Step S covers code bytes j = 2 (S / 2) and
    // j + 1, values 8 (S % 2) + 0..7: byte i of word 2 nb + f of (S, lane
    // 4 g' + t') is lut[sub_i * 16 + 8 (S % 2) + 4 f + t', 8 nb + g'] for the
    // subspaces sub_i = j, j + half, j + 1, j + 1 + half of the selector's
    // nibbles; 0 past half or q
    for (int i = threadIdx.x; i < spad * 32; i += kThreads) {
        const int step = i >> 5;
        const int gl = (i & 31) >> 2;
        const int tl = i & 3;
        const int j = step & ~1;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
            const int query = 8 * (f >> 1) + gl;
            const int value = 8 * (step & 1) + 4 * (f & 1) + tl;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int byte = j + (b >> 1);
                if (query >= q || byte >= half) continue;
                const int sub = byte + (b & 1) * half;
                const int8_t v = lut[(static_cast<size_t>(sub) * 16 + value) * q + query];
                w[f] |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * b);
            }
        }
        lut_s[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();

    const uint32_t one_t = 1u << (8 * t);  // table byte t: value t (lo) or 4 + t (hi)
    const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
    const long long warps = static_cast<long long>(gridDim.x) * kWarps;
    for (long long tile = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
         tile < tiles; tile += warps) {
        const uint8_t* base = codes + tile * kTile * pitch;
        const int last = static_cast<int>(min(static_cast<long long>(kTile - 1),
                                              n - 1 - tile * kTile));
        // 8 code bytes from v of this thread's rows (the tile's last row for
        // rows past n); 0 from the last batch on
        auto load = [&](uint2 (&c)[kRowBlocks][2], int v) {
#pragma unroll
            for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = min(16 * rb + g + 8 * h, last);
                    c[rb][h] = v < spad ? __ldg(reinterpret_cast<const uint2*>(
                                              base + static_cast<size_t>(r) * pitch + v))
                                        : make_uint2(0u, 0u);
                }
        };
        int acc[kRowBlocks][kNB][4];
#pragma unroll
        for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
            for (int e = 0; e < 4 * kNB; ++e) acc[rb][e / 4][e % 4] = 0;
        // two batches of code words: one multiplied while the other loads
        uint2 c0[kRowBlocks][2], c1[kRowBlocks][2];
        load(c0, 0);
        for (int v = 0; v < spad; v += 2 * kBatch) {
            load(c1, v + kBatch);
            scan_batch<kNB>(acc, c0, lut_s + v * 32, lane, one_t);
            if (v + kBatch >= spad) break;
            load(c0, v + 2 * kBatch);
            scan_batch<kNB>(acc, c1, lut_s + (v + kBatch) * 32, lane, one_t);
        }

        // acc[rb][nb][2 h + e]: row 16 rb + g + 8 h, query 8 nb + 2 t + e
#pragma unroll
        for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
            for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = 8 * nb + 2 * t + e;
                        const long long row = tile * kTile + 16 * rb + g + 8 * h;
                        if (col < q && row < n)
                            out[static_cast<size_t>(col) * n + row] =
                                static_cast<float>(acc[rb][nb][2 * h + e]);
                    }
    }
}

template <int kNB>
int launch_pq_scan(const uint8_t* codes, const int8_t* lut, float* out, int n, int half,
                   int pitch, int q, cudaStream_t stream) {
    const int smem = steps_pad(half) * kStepBytes;
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);  // LUT too large
    auto kernel = pq_scan_onehot_kernel<kNB>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
    const long long blocks = (tiles + kWarps - 1) / kWarps;
    const int grid = static_cast<int>(blocks < sms ? blocks : sms);
    kernel<<<grid, kThreads, smem, stream>>>(codes, lut, out, n, half, pitch, q);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace pq
}  // namespace clipx

// codes: (n, pitch) bytes, pitch >= half a multiple of 8 with zero bytes
// past half (the wrapper pads); see pq_scan_onehot_kernel.
extern "C" int clipx_pq_scan(const void* codes, const void* lut, void* out, int n, int half,
                             int pitch, int q, void* stream) {
    if (n < 0 || half < 1 || pitch < half || pitch % clipx::pq::kBatch || q < 1 ||
        q > clipx::pq::kQPad)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const auto* c = static_cast<const uint8_t*>(codes);
    const auto* l = static_cast<const int8_t*>(lut);
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    return q > 8 ? clipx::pq::launch_pq_scan<2>(c, l, o, n, half, pitch, q, s)
                 : clipx::pq::launch_pq_scan<1>(c, l, o, n, half, pitch, q, s);
}
