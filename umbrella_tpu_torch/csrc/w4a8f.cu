// Int4F matmul: int8 activations x split-halves 4-bit weights, full-K int32 dot.
//   acc[s, n] = xq[s, :K/2] . lo[:, n] + xq[s, K/2:] . hi[:, n]      (int32)
//   y[s, n]   = float(acc[s, n] - 8 * rowsum[s]) * sx[s] * b[n]
// xq int8 [S, K] (x * a quantized per row outside the kernel), sx fp32 [S],
// rowsum int32 [S], w8 [K/2, N] bytes (low nibble = row r, high = row r + K/2,
// both in [0, 15] with zero-point 8), b fp32 [N], y [S, N] in fp32 or bf16.
//
// Replaces the TPU kernel umbrella_tpu/ops/pallas/w4a8f.py::w4a8f_matmul
// (_w4a8f_kernel). The integer part is exact (so equal to the plain version,
// w4a8f_matmul_ref, bit for bit, in any summation order); the -8 zero-point is
// folded through the row sum in int32 before the one conversion to float, so
// the epilogue is (acc * sx) * b exactly as in the plain version.
//
// Bound on this card: bytes at decode sizes. At S=24 the 8B lm_head
// [4096, 128256] streams 263 MB of packed weights for 25 GOP; at the int8
// tensor-core rate (1,979 TOP/s) that is 13 us, the stream 78 us. Design: a
// BM x 64 output tile per block of 8 warps computed with WMMA s8 16x16x16
// fragments and int32 accumulators; BM is 32 for draft-sized S (8 warps as
// 2 x 4, one fragment each) and 128 above (4 x 2 warps, 2 x 2 fragments), so a
// small batch wastes no tensor work and the weight bytes are read once per
// pass of up to BM rows. The K loop walks w8 in chunks of 32 packed rows; each
// chunk is read with 4-byte vector loads and unpacked into its low and high
// nibbles as int8 tiles in shared memory, beside the matching slices of xq
// (16-byte loads). The next chunk's loads are issued into registers before the
// current chunk's products, so their latency overlaps the tensor work. Every
// 16 x 16 operand tile has its own 32-byte-aligned slot, as WMMA requires.
// Matrices with few column tiles split K over `splits` blocks (chosen from N
// and K only); each writes an int32 partial tile, and a second
// kernel adds the partials (exact) and applies the epilogue. Ragged S and N are
// masked. Not yet: TMA and wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBN = 64, kBR = 32;
constexpr int kSlot = 32;  // bytes per staged 16-wide operand row (16 data + 16 pad)
constexpr int kCLD = kBN + 4;
constexpr int kThreads = 256;

template <int BM>
struct Tiles {
    int8_t x[2][2][BM][kSlot];         // [half][k sub-block][row][16 k values + pad]
    int8_t w[2][kBN / 16][kBR][kSlot];  // [half][16-column group][k][16 columns + pad]
};
template <int BM>
union __align__(32) Smem {
    Tiles<BM> t;
    int c[BM * kCLD];
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <typename TO>
__device__ __forceinline__ TO epilogue(int acc, int rowsum, float sx, float b) {
    return from_f<TO>((float)(acc - 8 * rowsum) * sx * b);
}

template <int BM, typename TO>
__global__ void __launch_bounds__(kThreads)
w4a8f_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
             const int* __restrict__ rowsum, const uint8_t* __restrict__ w8,
             const float* __restrict__ b, TO* __restrict__ out, int* __restrict__ partial,
             int S, int K2, int N, int chunks_per_split) {
    constexpr int WM = BM == 128 ? 4 : 2, WN = 8 / WM;
    constexpr int FM = BM / WM / 16, FN = kBN / WN / 16;
    constexpr int XV = (4 * BM + kThreads - 1) / kThreads;  // 16-byte x vectors per thread
    __shared__ Smem<BM> sm;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int wm = warp / WN, wn = warp % WN;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM, kz = blockIdx.z;
    const long long K = 2LL * K2;
    const int n_chunks = K2 / kBR;
    const int c_begin = kz * chunks_per_split;
    const int c_end = min(n_chunks, c_begin + chunks_per_split);
    const int cg = tid & 15, rr = tid >> 4;  // columns n0+4cg..+3, rows rr and rr+16
    const int ncol = n0 + 4 * cg;
    const bool vec_ok = (N & 3) == 0 && ncol + 3 < N;

    uint4 xr[XV];
    uint32_t wr[2];
    auto load = [&](int ch) {  // chunk ch -> registers
        const int r0 = ch * kBR;
#pragma unroll
        for (int v = 0; v < XV; ++v) {
            const int i = tid + v * kThreads;
            xr[v] = make_uint4(0, 0, 0, 0);
            if (i < 4 * BM) {
                const int half = i / (2 * BM), rem = i % (2 * BM);
                const int row = rem >> 1, sub = rem & 1, srow = m0 + row;
                if (srow < S)
                    xr[v] = *reinterpret_cast<const uint4*>(
                        xq + (long long)srow * K + (long long)half * K2 + r0 + 16 * sub);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint8_t* src = w8 + (long long)(r0 + rr + 16 * h) * N + ncol;
            uint32_t bytes = 0;
            if (vec_ok) {
                bytes = *reinterpret_cast<const uint32_t*>(src);
            } else {
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (ncol + c < N) bytes |= (uint32_t)src[c] << (8 * c);
            }
            wr[h] = bytes;
        }
    };
    auto stage = [&]() {  // registers -> shared tiles
#pragma unroll
        for (int v = 0; v < XV; ++v) {
            const int i = tid + v * kThreads;
            if (i < 4 * BM) {
                const int half = i / (2 * BM), rem = i % (2 * BM);
                *reinterpret_cast<uint4*>(&sm.t.x[half][rem & 1][rem >> 1][0]) = xr[v];
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = rr + 16 * h;
            *reinterpret_cast<uint32_t*>(&sm.t.w[0][cg >> 2][row][4 * (cg & 3)]) =
                wr[h] & 0x0F0F0F0Fu;
            *reinterpret_cast<uint32_t*>(&sm.t.w[1][cg >> 2][row][4 * (cg & 3)]) =
                (wr[h] >> 4) & 0x0F0F0F0Fu;
        }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

    if (c_begin < c_end) load(c_begin);
    for (int ch = c_begin; ch < c_end; ++ch) {
        stage();
        __syncthreads();
        if (ch + 1 < c_end) load(ch + 1);  // in flight during this chunk's products
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int sub = 0; sub < 2; ++sub) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[FM];
                wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf[FN];
#pragma unroll
                for (int i = 0; i < FM; ++i)
                    wmma::load_matrix_sync(
                        a[i], reinterpret_cast<const signed char*>(
                                  &sm.t.x[half][sub][(wm * FM + i) * 16][0]), kSlot);
#pragma unroll
                for (int j = 0; j < FN; ++j)
                    wmma::load_matrix_sync(
                        bf[j], reinterpret_cast<const signed char*>(
                                   &sm.t.w[half][wn * FN + j][sub * 16][0]), kSlot);
#pragma unroll
                for (int i = 0; i < FM; ++i)
#pragma unroll
                    for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
            wmma::store_matrix_sync(sm.c + (wm * FM + i) * 16 * kCLD + (wn * FN + j) * 16,
                                    acc[i][j], kCLD, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < BM * kBN; i += kThreads) {
        const int row = i / kBN, col = i % kBN, s = m0 + row, n = n0 + col;
        if (s >= S || n >= N) continue;
        const long long o = (long long)s * N + n;
        if (partial != nullptr)
            partial[(long long)kz * S * N + o] = sm.c[row * kCLD + col];
        else
            out[o] = epilogue<TO>(sm.c[row * kCLD + col], rowsum[s], sx[s], b[n]);
    }
}

template <typename TO>
__global__ void sum_partials(const int* __restrict__ partial, const float* __restrict__ sx,
                             const int* __restrict__ rowsum, const float* __restrict__ b,
                             TO* __restrict__ out, int S, int N, int splits) {
    const long long count = (long long)S * N;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
         i += (long long)gridDim.x * blockDim.x) {
        int acc = 0;
        for (int z = 0; z < splits; ++z) acc += partial[(long long)z * count + i];
        const int s = (int)(i / N), n = (int)(i % N);
        out[i] = epilogue<TO>(acc, rowsum[s], sx[s], b[n]);
    }
}

template <int BM, typename TO>
void launch_main(const void* xq, const void* sx, const void* rowsum, const void* w8,
                 const void* b, void* out, void* partial, int S, int K2, int N, int splits,
                 int per, cudaStream_t st) {
    dim3 grid((N + kBN - 1) / kBN, (S + BM - 1) / BM, splits);
    w4a8f_kernel<BM, TO><<<grid, kThreads, 0, st>>>(
        (const int8_t*)xq, (const float*)sx, (const int*)rowsum, (const uint8_t*)w8,
        (const float*)b, (TO*)out, splits > 1 ? (int*)partial : nullptr, S, K2, N, per);
}

template <typename TO>
int launch(const void* xq, const void* sx, const void* rowsum, const void* w8, const void* b,
           void* out, void* partial, int S, int K2, int N, int splits, cudaStream_t st) {
    const int n_chunks = K2 / kBR;
    const int per = (n_chunks + splits - 1) / splits;
    if (S <= 32)
        launch_main<32, TO>(xq, sx, rowsum, w8, b, out, partial, S, K2, N, splits, per, st);
    else
        launch_main<128, TO>(xq, sx, rowsum, w8, b, out, partial, S, K2, N, splits, per, st);
    if (splits > 1) {
        const long long count = (long long)S * N;
        const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
        sum_partials<TO><<<blocks, 256, 0, st>>>((const int*)partial, (const float*)sx,
                                                 (const int*)rowsum, (const float*)b, (TO*)out,
                                                 S, N, splits);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// All contiguous; xq 16-byte aligned; K2 a multiple of 32; partial int32
// [splits, S, N] scratch when splits > 1.
extern "C" int w4a8f_matmul(const void* xq, const void* sx, const void* rowsum, const void* w8,
                            const void* b, void* out, void* partial, int S, int K2, int N,
                            int splits, int out_bf16, void* stream) {
    if (S <= 0 || N <= 0) return 0;
    if (K2 % kBR != 0 || splits < 1 || (splits > 1 && partial == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (out_bf16)
        return launch<__nv_bfloat16>(xq, sx, rowsum, w8, b, out, partial, S, K2, N, splits, st);
    return launch<float>(xq, sx, rowsum, w8, b, out, partial, S, K2, N, splits, st);
}
