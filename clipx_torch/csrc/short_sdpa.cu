// packed_sdpa, packed_sdpa_rows and packed_sdpa_qkv for Hopper (sm_90a):
// one short-SDPA kernel behind all three.
//
// Replaces clipx/ops/packed_sdpa.py::packed_sdpa (`_kernel`, :35, called at
// :784) and ::packed_sdpa_rows (`_rows_kernel`, :75, called at :567). The two
// Pallas kernels compute the same function and differ only in how they pack
// 128-row MXU tiles (head pairs vs batch-row pairs); on Hopper one kernel
// serves both, and the Python wrappers keep their own shape rules (even
// heads for packed_sdpa, even batch for packed_sdpa_rows).
//
// packed_sdpa_qkv (clipx/ops/packed_sdpa.py:144, `_rows_qkv_kernel` :110)
// reads q, k and v out of one packed (B, S, 3W) projection [q | k | v]: the
// same kernel with k = qkv + W, v = qkv + 2W and a 3W row stride. Its
// arithmetic is packed_sdpa's to the bit: only the addresses differ.
//
// Bound and design: see short_sdpa.cuh. At batch 1 (the encoder's bucket 1,
// the main-path caller of packed_sdpa) the whole call is ~0.3 MB and
// ~8 MFLOP, so launch latency, not bytes or operations, sets its time.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include "short_sdpa.cuh"

extern "C" int clipx_short_sdpa(const void* q, const void* k, const void* v, void* o,
                                int batch, int seq, int heads, int ld_in, int ld_out,
                                void* stream) {
    clipx::launch_short_sdpa(static_cast<const __nv_bfloat16*>(q),
                             static_cast<const __nv_bfloat16*>(k),
                             static_cast<const __nv_bfloat16*>(v),
                             static_cast<__nv_bfloat16*>(o), batch, seq, heads, ld_in,
                             ld_out, static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
}

// qkv: (B, S, 3W) bf16, lanes [q | k | v]; o: (B, S, W) bf16. S <= 64,
// W = heads * 64.
extern "C" int clipx_packed_sdpa_qkv(const void* qkv, void* o, int batch, int seq,
                                     int heads, int width, void* stream) {
    const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(qkv);
    clipx::launch_short_sdpa(t, t + width, t + 2 * width, static_cast<__nv_bfloat16*>(o),
                             batch, seq, heads, 3 * width, width,
                             static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
}
