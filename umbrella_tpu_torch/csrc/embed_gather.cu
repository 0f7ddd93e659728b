// Embedding row gather: out[s, :] = table[ids[s], :].
//
// Replaces the TPU kernel umbrella_tpu/ops/pallas/embed_gather.py::embed_gather
// (_gather_kernel), which DMAs the 8-row tile holding each token's row from HBM
// and picks the row out with a one-hot sum (Mosaic cannot slice one row at a
// dynamic sublane offset).
//
// Bound on this card: bytes. It moves S rows of H elements in and out (S*H*2*2
// bytes for bf16, 2 MB at S=127, H=4096) and does no arithmetic; at that size
// the launch itself dominates. Design: one block per token row, each thread
// copying 16-byte vectors with neighbouring threads on neighbouring addresses,
// so every row is read once in full coalesced transactions. Rows whose byte
// width or base address is not 16-byte aligned take a byte-wise loop. An id
// outside [0, V) writes a zero row instead of reading out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_rows_v16(const int4* __restrict__ table, const int* __restrict__ ids,
                                int4* __restrict__ out, int V, long long n16) {
    const int s = blockIdx.x;
    const int id = ids[s];
    int4* dst = out + (long long)s * n16;
    if (id < 0 || id >= V) {
        for (long long i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = make_int4(0, 0, 0, 0);
        return;
    }
    const int4* src = table + (long long)id * n16;
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = src[i];
}

__global__ void gather_rows_bytes(const uint8_t* __restrict__ table, const int* __restrict__ ids,
                                  uint8_t* __restrict__ out, int V, long long row_bytes) {
    const int s = blockIdx.x;
    const int id = ids[s];
    uint8_t* dst = out + (long long)s * row_bytes;
    if (id < 0 || id >= V) {
        for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x) dst[i] = 0;
        return;
    }
    const uint8_t* src = table + (long long)id * row_bytes;
    for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x) dst[i] = src[i];
}

extern "C" int embed_gather(const void* table, const void* ids, void* out, int S, int V,
                            long long row_bytes, void* stream) {
    if (S <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const bool aligned = (row_bytes % 16 == 0) && ((uintptr_t)table % 16 == 0) &&
                         ((uintptr_t)out % 16 == 0);
    if (aligned) {
        const long long n16 = row_bytes / 16;
        int threads = n16 >= 256 ? 256 : (int)((n16 + 31) / 32 * 32);
        gather_rows_v16<<<S, threads, 0, st>>>((const int4*)table, (const int*)ids, (int4*)out,
                                                V, n16);
    } else {
        gather_rows_bytes<<<S, 256, 0, st>>>((const uint8_t*)table, (const int*)ids,
                                             (uint8_t*)out, V, row_bytes);
    }
    return (int)cudaGetLastError();
}
