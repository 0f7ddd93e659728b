// AWQ W4A8 matmul: per-row int8 activations x split-halves 4-bit AWQ weights,
// one int32 dot per K group and an fp32 scale/zero fix-up after each group:
//   p_g[s, n] = xq[s, group g] . nib_g[:, n]                         (int32)
//   acc[s, n] += (float(p_g) - float(rowsum_g[s]) * z_g[n]) * s_g[n]   (fp32)
//   y[s, n]   = acc[s, n] * sx[s]
// xq int8 [S, K] (x quantized per row outside the kernel), sx fp32 [S],
// rowsum int32 [S, G] (the sum of each row's int8 values in each group),
// w8 [K/2, N] bytes (low nibble = logical row r, high nibble = row r + K/2,
// raw values 0..15), scales/zeros [G, N] (fp32 or bf16), y [S, N].
//
// Replaces the TPU kernel umbrella_tpu/ops/pallas/w4a8.py::w4a8_matmul
// (_w4a8_kernel). As there, the zero point is folded in after the integer
// product (xq . (w - z) = xq . w - rowsum * z), so the raw nibbles are the
// non-negative int8 tensor-core operand; a group's int32 sum is exact (at most
// 128 * 127 * 15 for a group of 128) and so is the fix-up's subtrahend, so the
// one rounding per group is the multiply by the scale. Groups are visited in
// order, the low half's group before the high half's, each multiply and add
// rounded on its own (no fused multiply-add), so the plain version
// (ops/kernels/w4a8.py::w4a8_matmul_ref) repeats the same operations.
//
// Bound on this card: bytes at decode sizes. At S=127 the 8B gate_up matrix
// [4096, 28672] streams 58.7 MB of packed weights and 3.7 MB of bf16 scales and
// zeros for 29.8 GOP; at the int8 tensor-core rate (1,979 TOP/s) that is 15 us,
// the stream about 20 us. Design: w4a8f.cu's tiling -- a BM x 64 output tile
// per block of 8 warps, WMMA s8 16x16x16 fragments with int32 accumulators,
// BM 32 for draft-sized S and 128 above, the K loop over chunks of 32 packed
// rows, each chunk unpacked into low- and high-nibble int8 tiles beside the
// matching xq slices, the next chunk's loads in flight during the current
// chunk's products -- with two int32 accumulator sets (low and high half). When
// a chunk closes a group, each set goes through shared memory to the fix-up:
// a thread owns one output column and BM/4 rows of the tile, whose fp32 sums
// stay in its registers for the whole K loop. Matrices with few column tiles
// split K over `splits` blocks at group boundaries (the wrapper picks splits
// from N and K only, never from S); each writes an fp32 partial tile and a
// second kernel adds the partials in order and applies sx. A row's operations
// are the same whatever rows share its call, so the result is row-invariant.
// Ragged S and N are masked. Not yet: TMA and wgmma.
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <int BM, typename TS, typename TO>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int* __restrict__ rowsum, const uint8_t* __restrict__ w8,
            const TS* __restrict__ scales, const TS* __restrict__ zeros, TO* __restrict__ out,
            float* __restrict__ partial, int S, int K2, int N, int group_size,
            int chunks_per_split) {
    constexpr int WM = BM == 128 ? 4 : 2, WN = 8 / WM;
    constexpr int FM = BM / WM / 16, FN = kBN / WN / 16;
    constexpr int XV = (4 * BM + kThreads - 1) / kThreads;  // 16-byte x vectors per thread
    constexpr int E = BM * kBN / kThreads;                  // fix-up elements per thread
    __shared__ Smem<BM> sm;
    __shared__ int rs[BM];
    const int tid = threadIdx.x, warp = tid >> 5;
    const int wm = warp / WN, wn = warp % WN;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM, kz = blockIdx.z;
    const long long K = 2LL * K2;
    const int G = (int)(K / group_size), per_group = group_size / kBR;
    const int n_chunks = K2 / kBR;
    const int c_begin = kz * chunks_per_split;
    const int c_end = min(n_chunks, c_begin + chunks_per_split);
    const int cg = tid & 15, rr = tid >> 4;  // columns n0+4cg..+3, rows rr and rr+16
    const int ncol = n0 + 4 * cg;
    const bool vec_ok = (N & 3) == 0 && ncol + 3 < N;
    // the fix-up's element e is tile row (tid / 64) + 4e, tile column tid % 64
    const int fcol = tid % kBN, frow = tid / kBN, n = n0 + fcol;

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

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][FM][FN];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[h][i][j], 0);
    float accf[E];
#pragma unroll
    for (int e = 0; e < E; ++e) accf[e] = 0.f;

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
                    for (int j = 0; j < FN; ++j)
                        wmma::mma_sync(acc[half][i][j], a[i], bf[j], acc[half][i][j]);
            }
        }
        __syncthreads();
        if ((ch + 1) % per_group != 0) continue;
        // the chunk closed packed group pg: logical groups pg (low half) and
        // G/2 + pg (high half), in that order
        const int pg = ch / per_group;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int g = half * (G / 2) + pg;
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j) {
                    wmma::store_matrix_sync(sm.c + (wm * FM + i) * 16 * kCLD + (wn * FN + j) * 16,
                                            acc[half][i][j], kCLD, wmma::mem_row_major);
                    wmma::fill_fragment(acc[half][i][j], 0);
                }
            if (tid < BM) rs[tid] = m0 + tid < S ? rowsum[(long long)(m0 + tid) * G + g] : 0;
            const float sc = n < N ? to_f(scales[(long long)g * N + n]) : 0.f;
            const float zc = n < N ? to_f(zeros[(long long)g * N + n]) : 0.f;
            __syncthreads();
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int row = frow + 4 * e;
                const float pf = __fsub_rn((float)sm.c[row * kCLD + fcol],
                                           __fmul_rn((float)rs[row], zc));
                accf[e] = __fadd_rn(accf[e], __fmul_rn(pf, sc));
            }
            __syncthreads();  // the tiles and rs are rewritten next
        }
    }

    if (n >= N) return;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int s = m0 + frow + 4 * e;
        if (s >= S) continue;
        const long long o = (long long)s * N + n;
        if (partial != nullptr)
            partial[(long long)kz * S * N + o] = accf[e];
        else
            out[o] = from_f<TO>(__fmul_rn(accf[e], sx[s]));
    }
}

template <typename TO>
__global__ void sum_partials(const float* __restrict__ partial, const float* __restrict__ sx,
                             TO* __restrict__ out, int S, int N, int splits) {
    const long long count = (long long)S * N;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
         i += (long long)gridDim.x * blockDim.x) {
        float acc = 0.f;
        for (int z = 0; z < splits; ++z) acc = __fadd_rn(acc, partial[(long long)z * count + i]);
        out[i] = from_f<TO>(__fmul_rn(acc, sx[i / N]));
    }
}

template <int BM, typename TS, typename TO>
void launch_main(const void* xq, const void* sx, const void* rowsum, const void* w8,
                 const void* scales, const void* zeros, void* out, void* partial, int S, int K2,
                 int N, int group_size, int splits, int per, cudaStream_t st) {
    dim3 grid((N + kBN - 1) / kBN, (S + BM - 1) / BM, splits);
    w4a8_kernel<BM, TS, TO><<<grid, kThreads, 0, st>>>(
        (const int8_t*)xq, (const float*)sx, (const int*)rowsum, (const uint8_t*)w8,
        (const TS*)scales, (const TS*)zeros, (TO*)out, splits > 1 ? (float*)partial : nullptr, S,
        K2, N, group_size, per);
}

template <typename TS, typename TO>
int launch(const void* xq, const void* sx, const void* rowsum, const void* w8, const void* scales,
           const void* zeros, void* out, void* partial, int S, int K2, int N, int group_size,
           int splits, cudaStream_t st) {
    // whole groups per split, so every block's K range ends where a group does
    const int n_groups = K2 / group_size;
    const int per = (n_groups + splits - 1) / splits * (group_size / kBR);
    // the row tile changes which rows share a block, never a row's operations
    if (S <= 32)
        launch_main<32, TS, TO>(xq, sx, rowsum, w8, scales, zeros, out, partial, S, K2, N,
                                group_size, splits, per, st);
    else
        launch_main<128, TS, TO>(xq, sx, rowsum, w8, scales, zeros, out, partial, S, K2, N,
                                 group_size, splits, per, st);
    if (splits > 1) {
        const long long count = (long long)S * N;
        const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
        sum_partials<TO><<<blocks, 256, 0, st>>>((const float*)partial, (const float*)sx,
                                                 (TO*)out, S, N, splits);
    }
    return (int)cudaGetLastError();
}

template <typename TS>
int dispatch_out(int out_bf16, const void* xq, const void* sx, const void* rowsum, const void* w8,
                 const void* s, const void* z, void* out, void* partial, int S, int K2, int N,
                 int gs, int splits, cudaStream_t st) {
    if (out_bf16)
        return launch<TS, __nv_bfloat16>(xq, sx, rowsum, w8, s, z, out, partial, S, K2, N, gs,
                                         splits, st);
    return launch<TS, float>(xq, sx, rowsum, w8, s, z, out, partial, S, K2, N, gs, splits, st);
}

}  // namespace

// All contiguous; xq 16-byte aligned; group_size a multiple of 32 and K2 a
// multiple of group_size; scales/zeros fp32 or bf16 (one dtype); out fp32 or
// bf16; partial fp32 [splits, S, N] scratch when splits > 1, where splits
// divides the K2 / group_size groups into runs of whole groups.
extern "C" int w4a8_matmul(const void* xq, const void* sx, const void* rowsum, const void* w8,
                           const void* scales, const void* zeros, void* out, void* partial, int S,
                           int K2, int N, int group_size, int splits, int s_bf16, int out_bf16,
                           void* stream) {
    if (S <= 0 || N <= 0) return 0;
    if (group_size % kBR != 0 || K2 % group_size != 0 || splits < 1 ||
        splits > K2 / group_size || (splits > 1 && partial == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (s_bf16)
        return dispatch_out<__nv_bfloat16>(out_bf16, xq, sx, rowsum, w8, scales, zeros, out,
                                           partial, S, K2, N, group_size, splits, st);
    return dispatch_out<float>(out_bf16, xq, sx, rowsum, w8, scales, zeros, out, partial, S, K2,
                               N, group_size, splits, st);
}
