// pq_scan_scores for Hopper (sm_90a): the PQ asymmetric-distance scan.
//
// Replaces clipx/ops/pq_scan.py::pq_scan_scores (kernel `_kernel`, :46,
// pallas_call at :124; `permute_lut`, :92). For every code row n and query q
//
//     out[q, n] = sum_m lut[m * 16 + code(n, m), q]        (exact int32 sum)
//
// where a row holds M 4-bit codes packed two per byte in the SPLIT layout:
// byte j carries subspace j in its low nibble and subspace j + M/2 in its
// high nibble. The TPU kernel recast the table lookup as a one-hot matmul
// (the TPU has no lane shuffle) and permuted the LUT to keep Mosaic's shapes
// 2-D; neither carries over. Here the lookup is a lookup.
//
// Design: the whole (M, 16, Q) LUT is staged once per block in shared memory,
// biased to unsigned bytes (v + 128) and with Q padded to a multiple of 4, so
// one 32-bit shared load brings one code's entries for 4 queries. Each thread
// owns one row: it reads its M/2 code bytes with 16-byte loads and, per
// nibble, adds the masked even and odd bytes of each LUT word into two
// 32-bit words that hold two 16-bit lanes each (queries 4g, 4g+2 and 4g+1,
// 4g+3). Biased bytes are <= 255, so 256 of them sum to <= 65,280 and never
// carry into the next lane; every 256 subspaces the lanes are widened into
// int32 totals and the bias is taken off. Scores are therefore exact integer
// sums, bitwise equal to the plain one-hot product and to clipx's kernel.
// Blocks stride over 256-row tiles (grid = resident blocks), so the LUT is
// staged once per block, not once per tile. The (Q, N) f32 output is written
// row-contiguous per query: coalesced across the threads of a tile.
//
// What bounds it on this card: at N = 2^20, M = 256, Q = 16 the call must
// move 128 MiB of codes, 64 KiB of LUT and 64 MiB of scores: ~0.060 ms at
// 3.35 TB/s. The kernel does ~24 integer and shared-memory operations per
// (row, subspace), ~6.4 G in all, so this first version is bound by instruction
// throughput and shared-memory bandwidth (16 bytes per row and subspace, 2-4-way
// bank conflicts on random codes), several times the byte bound. A faster
// version would split a row's subspaces across lanes or go back to a
// tensor-core one-hot product with the expansion kept in registers.
//
// C interface for ctypes; returns a cudaError_t code (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace clipx {

constexpr int kRows = 256;   // rows per tile = threads per block
constexpr int kFlush = 256;  // subspaces summed in 16-bit lanes before widening

// Adds the biased LUT entries of (subspace m, code c) for 4*QW queries.
template <int QW>
__device__ __forceinline__ void add_entry(const uint32_t* __restrict__ lut, int m, int c,
                                          uint32_t (&ev)[QW], uint32_t (&od)[QW]) {
    const uint32_t* p = lut + (m * 16 + c) * QW;
    uint32_t w[QW];
    if constexpr (QW == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
    } else if constexpr (QW == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x;
        w[1] = v.y;
    } else {
#pragma unroll
        for (int g = 0; g < QW; ++g) w[g] = p[g];
    }
#pragma unroll
    for (int g = 0; g < QW; ++g) {
        ev[g] += w[g] & 0x00FF00FFu;
        od[g] += (w[g] >> 8) & 0x00FF00FFu;
    }
}

// Widens the 16-bit lanes into the int32 totals; `cnt` entries were summed
// into each lane since the last flush, each carrying a bias of 128.
template <int QW>
__device__ __forceinline__ void flush(uint32_t (&ev)[QW], uint32_t (&od)[QW],
                                      int (&tot)[4 * QW], int cnt) {
    const int bias = 128 * cnt;
#pragma unroll
    for (int g = 0; g < QW; ++g) {
        tot[4 * g + 0] += static_cast<int>(ev[g] & 0xFFFFu) - bias;
        tot[4 * g + 2] += static_cast<int>(ev[g] >> 16) - bias;
        tot[4 * g + 1] += static_cast<int>(od[g] & 0xFFFFu) - bias;
        tot[4 * g + 3] += static_cast<int>(od[g] >> 16) - bias;
        ev[g] = 0;
        od[g] = 0;
    }
}

// codes: (n, half) bytes; lut: (2 * half * 16, q) int8, row m * 16 + c;
// out: (q, n) f32. Needs 1 <= q <= 4 * QW.
template <int QW>
__global__ void __launch_bounds__(kRows)
pq_scan_kernel(const uint8_t* __restrict__ codes, const int8_t* __restrict__ lut,
               float* __restrict__ out, int n, int half, int q) {
    extern __shared__ __align__(16) uint32_t lut_s[];  // [2*half*16][QW] words
    constexpr int qp = 4 * QW;
    uint8_t* lut_b = reinterpret_cast<uint8_t*>(lut_s);
    const int entries = 2 * half * 16;
    for (int i = threadIdx.x; i < entries * qp; i += kRows) {
        const int e = i / qp;
        const int qq = i - e * qp;
        const int v = qq < q ? static_cast<int>(lut[e * q + qq]) : 0;
        lut_b[i] = static_cast<uint8_t>(v + 128);
    }
    __syncthreads();

    for (long long tile = blockIdx.x; tile * kRows < n; tile += gridDim.x) {
        const long long row = tile * kRows + threadIdx.x;
        if (row >= n) continue;
        uint32_t ev[QW], od[QW];
        int tot[4 * QW];
#pragma unroll
        for (int g = 0; g < QW; ++g) ev[g] = od[g] = 0;
#pragma unroll
        for (int i = 0; i < 4 * QW; ++i) tot[i] = 0;
        int cnt = 0;
        const uint8_t* rp = codes + row * half;
        if (half % 16 == 0) {
            for (int v = 0; v < half; v += 16) {
                const uint4 c = __ldg(reinterpret_cast<const uint4*>(rp + v));
                const uint32_t w4[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
                for (int k = 0; k < 4; ++k) {
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const uint32_t byte = (w4[k] >> (8 * b)) & 0xFFu;
                        const int j = v + 4 * k + b;
                        add_entry<QW>(lut_s, j, byte & 0xF, ev, od);
                        add_entry<QW>(lut_s, j + half, byte >> 4, ev, od);
                    }
                }
                cnt += 32;
                if (cnt == kFlush) {
                    flush<QW>(ev, od, tot, cnt);
                    cnt = 0;
                }
            }
        } else {
            for (int j = 0; j < half; ++j) {
                const uint32_t byte = __ldg(rp + j);
                add_entry<QW>(lut_s, j, byte & 0xF, ev, od);
                add_entry<QW>(lut_s, j + half, byte >> 4, ev, od);
                cnt += 2;
                if (cnt == kFlush) {
                    flush<QW>(ev, od, tot, cnt);
                    cnt = 0;
                }
            }
        }
        flush<QW>(ev, od, tot, cnt);
#pragma unroll
        for (int qq = 0; qq < 4 * QW; ++qq) {
            if (qq < q) out[static_cast<size_t>(qq) * n + row] = static_cast<float>(tot[qq]);
        }
    }
}

template <int QW>
int launch_pq_scan(const uint8_t* codes, const int8_t* lut, float* out, int n, int half, int q,
                   cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(2) * half * 16 * 4 * QW;
    auto kernel = pq_scan_kernel<QW>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRows, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long tiles = (static_cast<long long>(n) + kRows - 1) / kRows;
    const long long resident = static_cast<long long>(sms) * per_sm;
    const int grid = static_cast<int>(tiles < resident ? tiles : resident);
    kernel<<<grid, kRows, smem, stream>>>(codes, lut, out, n, half, q);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace clipx

extern "C" int clipx_pq_scan(const void* codes, const void* lut, void* out, int n, int half,
                             int q, void* stream) {
    if (n < 0 || half < 1 || q < 1 || q > 16) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const auto* c = static_cast<const uint8_t*>(codes);
    const auto* l = static_cast<const int8_t*>(lut);
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch ((q + 3) / 4) {
        case 1: return clipx::launch_pq_scan<1>(c, l, o, n, half, q, s);
        case 2: return clipx::launch_pq_scan<2>(c, l, o, n, half, q, s);
        case 3: return clipx::launch_pq_scan<3>(c, l, o, n, half, q, s);
        default: return clipx::launch_pq_scan<4>(c, l, o, n, half, q, s);
    }
}
