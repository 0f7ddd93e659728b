// W4A16 matmul over split-halves packed AWQ weights:
//   y = x[:, :K/2] @ ((lo - z) * s) + x[:, K/2:] @ ((hi - z) * s)
// w8 [K/2, N] bytes (low nibble = logical row r, high nibble = row r + K/2),
// scales/zeros [K/g, N] per group along the logical K, x [S, K], y [S, N].
// And the fused MLP input projection over a packed gate|up weight [K, 2I]
// (gate columns [0, I), up columns [I, 2I)):
//   y = silu(x @ W_gate) * (x @ W_up)                                  [S, I]
//
// Replaces the TPU kernels umbrella_tpu/ops/pallas/w4a16.py::w4a16_matmul
// (_w4a16_kernel, plain and layered mode) and ::w4a16_gate_up_silu
// (_w4a16_gusilu_kernel).
// Numerics kept from them: the weight is dequantized as (nibble - z) * s in
// fp32 and rounded to bf16, x is rounded to bf16, the products accumulate in
// fp32; the plain product writes its output in its own dtype, the fused one
// applies g * sigmoid(g) * u to the fp32 sums and rounds once.
//
// Bound on this card: at S=127 the 8B gate_up matrix [4096, 28672] is 58.7 MB
// of packed weights and 29.8 GFLOP, i.e. ~508 FLOP per weight byte: the bf16
// tensor cores (989 TFLOP/s) need 30 us, the weight stream at 3.35 TB/s 18 us,
// so the two are close; at draft-sized S the weight stream alone bounds it.
// Design: a BM x 64 output tile per block of 8 warps with WMMA bf16 16x16x16
// fragments and fp32 accumulators; BM is 32 for draft-sized S (2 x 4 warps,
// one fragment each) and 128 above (4 x 2 warps, 2 x 2 fragments), so a verify
// pass's 127 rows read each weight byte once. The K loop walks w8 in chunks of
// 32 packed rows; each chunk is read once with 4-byte vector loads and
// dequantized into TWO bf16 shared-memory tiles (its low-nibble rows and its
// high-nibble rows) beside the matching BM x 32 x tiles (16-byte vector
// loads); a thread keeps its four columns' scales and zeros in registers until
// the group changes. The next chunk's loads are issued into registers before
// the current chunk's products, so their latency overlaps the tensor work.
// The fused gate-up-SiLU form (NW = 2 weight column ranges) gives one block a
// gate tile and the matching up tile: both are staged from the same K chunk,
// share the x fragments, and keep two accumulator sets; the epilogue reads the
// gate sums into registers and then combines them with the up sums.
// Matrices with few column tiles split K over `splits` blocks (the wrapper
// picks splits from N and K only, never from S, so a row's summation order
// does not depend on the batch): each writes an fp32 partial tile and a
// second kernel sums the partials in a fixed order -- for the fused form the
// SiLU epilogue runs there, on the full-K sums.
// No atomics, so results are deterministic. Ragged S and N are masked.
// Layered mode (w4a16_matmul_layered, the TPU kernel's scalar-prefetch form):
// w8/scales/zeros are stacks [n_layers, ...] and the layer index is an int32
// on the device. Thread 0 of each block reads it once, traps on an index
// outside [0, n_layers) (no read outside the stack), and the block offsets its
// three weight pointers by the layer strides; the rest is the plain mode's
// code, so layer i's result equals the plain mode on stack[i] bit for bit. The
// host never reads the index, so the launch can be captured in a CUDA graph.
// Not yet: TMA and wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBN = 64, kBR = 32;
constexpr int kXLD = kBR + 8;  // bf16 elements per staged x row (multiple of 8)
constexpr int kWLD = kBN + 8;  // bf16 elements per staged w row
constexpr int kCLD = kBN + 4;  // floats per staged output row
constexpr int kThreads = 256;

// bf16 tiles are held as raw 16-bit words so the union stays trivial
template <int BM, int NW>
struct Tiles {
    uint16_t x[2][BM * kXLD];
    uint16_t w[NW][2][kBR * kWLD];
};
template <int BM, int NW>
union __align__(32) Smem {
    Tiles<BM, NW> t;
    float c[BM * kCLD];
};

__device__ __forceinline__ __nv_bfloat16* bf(uint16_t* p) {
    return reinterpret_cast<__nv_bfloat16*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
    return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// g * sigmoid(g) * u in fp32, in that order (the TPU kernel's epilogue)
__device__ __forceinline__ float silu_mul(float g, float u) {
    return __fmul_rn(__fmul_rn(g, 1.0f / (1.0f + expf(-g))), u);
}

// 8 consecutive x values held in registers between their load and their
// staging as 8 bf16 (16 bytes) in shared memory
template <typename TX> struct X8;
template <> struct X8<__nv_bfloat16> {
    uint4 v;
    __device__ __forceinline__ void zero() { v = make_uint4(0, 0, 0, 0); }
    __device__ __forceinline__ void load(const __nv_bfloat16* src) {
        v = *reinterpret_cast<const uint4*>(src);
    }
    __device__ __forceinline__ uint4 bf16() const { return v; }
};
template <> struct X8<float> {
    float4 a, b;
    __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ __forceinline__ void load(const float* src) {
        a = *reinterpret_cast<const float4*>(src);
        b = *reinterpret_cast<const float4*>(src + 4);
    }
    __device__ __forceinline__ uint4 bf16() const {
        return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                          pack_bf16x2(b.z, b.w));
    }
};

// NW weight column ranges of width N each, range r starting at column r * N of
// the [K/2, ldw] packed matrix: NW = 1 is the plain product (ldw = N), NW = 2
// the fused gate (r = 0) and up (r = 1) product (ldw = 2N).
template <int BM, int NW, typename TX, typename TS, typename TO>
__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w8,
             const TS* __restrict__ scales, const TS* __restrict__ zeros, TO* __restrict__ out,
             float* __restrict__ partial, int S, int K2, int N, int ldw, int group_size,
             int chunks_per_split, const int* __restrict__ layer_idx, int n_layers) {
    constexpr int WM = BM == 128 ? 4 : 2, WN = 8 / WM;
    constexpr int FM = BM / WM / 16, FN = kBN / WN / 16;
    constexpr int XV = (8 * BM + kThreads - 1) / kThreads;  // x vectors per thread
    constexpr int E = BM * kBN / kThreads;                  // epilogue elements per thread
    __shared__ Smem<BM, NW> sm;
    __shared__ int layer;
    const int tid = threadIdx.x, warp = tid >> 5;
    if (layer_idx != nullptr) {  // layered mode: select this block's layer of the stacks
        if (tid == 0) {
            const int li = *layer_idx;
            if (li < 0 || li >= n_layers) __trap();
            layer = li;
        }
        __syncthreads();
        const long long groups = 2LL * K2 / group_size;
        w8 += (long long)layer * K2 * ldw;
        scales += (long long)layer * groups * ldw;
        zeros += (long long)layer * groups * ldw;
    }
    const int wm = warp / WN, wn = warp % WN;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM, kz = blockIdx.z;
    const long long K = 2LL * K2;
    const int n_chunks = K2 / kBR;
    const int c_begin = kz * chunks_per_split;
    const int c_end = min(n_chunks, c_begin + chunks_per_split);

    // this thread's weight columns and rows within a chunk
    const int cg = tid & 15, rr = tid >> 4;  // columns n0+4cg..+3, rows rr and rr+16
    const int ncol = n0 + 4 * cg;
    const bool vec_ok = (N & 3) == 0 && (ldw & 3) == 0 && ncol + 3 < N;

    X8<TX> xr[XV];
    uint32_t wr[NW][2];
    // scales/zeros of the staged chunk's groups, and of the loaded chunk's
    float s_lo[NW][4], z_lo[NW][4], s_hi[NW][4], z_hi[NW][4];
    float ns_lo[NW][4], nz_lo[NW][4], ns_hi[NW][4], nz_hi[NW][4];
    int loaded_group = -1;

    auto load = [&](int ch) {  // chunk ch -> registers
        const int r0 = ch * kBR;
#pragma unroll
        for (int v = 0; v < XV; ++v) {
            const int i = tid + v * kThreads;
            xr[v].zero();
            if (i < 8 * BM) {
                const int half = i / (4 * BM), rem = i % (4 * BM);
                const int row = rem >> 2, seg = rem & 3, srow = m0 + row;
                if (srow < S)
                    xr[v].load(x + (long long)srow * K + (long long)half * K2 + r0 + 8 * seg);
            }
        }
#pragma unroll
        for (int r = 0; r < NW; ++r) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint8_t* src =
                    w8 + (long long)(r0 + rr + 16 * h) * ldw + (long long)r * N + ncol;
                uint32_t bytes = 0;
                if (vec_ok) {
                    bytes = *reinterpret_cast<const uint32_t*>(src);
                } else {
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        if (ncol + c < N) bytes |= (uint32_t)src[c] << (8 * c);
                }
                wr[r][h] = bytes;
            }
        }
        const int group = r0 / group_size;  // a chunk never straddles a group
        if (group != loaded_group) {
            loaded_group = group;
            const int g_hi = (K2 + r0) / group_size;
#pragma unroll
            for (int r = 0; r < NW; ++r) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const bool ok = ncol + c < N;
                    const long long col = (long long)r * N + ncol + c;
                    ns_lo[r][c] = ok ? to_f(scales[(long long)group * ldw + col]) : 0.f;
                    nz_lo[r][c] = ok ? to_f(zeros[(long long)group * ldw + col]) : 0.f;
                    ns_hi[r][c] = ok ? to_f(scales[(long long)g_hi * ldw + col]) : 0.f;
                    nz_hi[r][c] = ok ? to_f(zeros[(long long)g_hi * ldw + col]) : 0.f;
                }
            }
        }
    };
    auto stage = [&]() {  // registers -> shared tiles, dequantizing the weights
#pragma unroll
        for (int v = 0; v < XV; ++v) {
            const int i = tid + v * kThreads;
            if (i < 8 * BM) {
                const int half = i / (4 * BM), rem = i % (4 * BM);
                *reinterpret_cast<uint4*>(sm.t.x[half] + (rem >> 2) * kXLD + 8 * (rem & 3)) =
                    xr[v].bf16();
            }
        }
#pragma unroll
        for (int r = 0; r < NW; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                s_lo[r][c] = ns_lo[r][c];
                z_lo[r][c] = nz_lo[r][c];
                s_hi[r][c] = ns_hi[r][c];
                z_hi[r][c] = nz_hi[r][c];
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = rr + 16 * h;
                float lo[4], hi[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t b = (wr[r][h] >> (8 * c)) & 0xFFu;
                    lo[c] = ((float)(b & 0xFu) - z_lo[r][c]) * s_lo[r][c];
                    hi[c] = ((float)(b >> 4) - z_hi[r][c]) * s_hi[r][c];
                }
                *reinterpret_cast<uint2*>(sm.t.w[r][0] + row * kWLD + 4 * cg) =
                    make_uint2(pack_bf16x2(lo[0], lo[1]), pack_bf16x2(lo[2], lo[3]));
                *reinterpret_cast<uint2*>(sm.t.w[r][1] + row * kWLD + 4 * cg) =
                    make_uint2(pack_bf16x2(hi[0], hi[1]), pack_bf16x2(hi[2], hi[3]));
            }
        }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW][FM][FN];
#pragma unroll
    for (int r = 0; r < NW; ++r)
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[r][i][j], 0.f);

    if (c_begin < c_end) load(c_begin);
    for (int ch = c_begin; ch < c_end; ++ch) {
        stage();
        __syncthreads();
        if (ch + 1 < c_end) load(ch + 1);  // in flight during this chunk's products
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int kk = 0; kk < kBR; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
#pragma unroll
                for (int i = 0; i < FM; ++i)
                    wmma::load_matrix_sync(a[i], bf(sm.t.x[half]) + (wm * FM + i) * 16 * kXLD + kk,
                                           kXLD);
#pragma unroll
                for (int r = 0; r < NW; ++r) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
                        b[FN];
#pragma unroll
                    for (int j = 0; j < FN; ++j)
                        wmma::load_matrix_sync(
                            b[j], bf(sm.t.w[r][half]) + kk * kWLD + (wn * FN + j) * 16, kWLD);
#pragma unroll
                    for (int i = 0; i < FM; ++i)
#pragma unroll
                        for (int j = 0; j < FN; ++j)
                            wmma::mma_sync(acc[r][i][j], a[i], b[j], acc[r][i][j]);
                }
            }
        }
        __syncthreads();
    }

    float gate[NW == 2 ? E : 1];  // the fused form's gate sums, held for the up pass
#pragma unroll
    for (int r = 0; r < NW; ++r) {
        if (r > 0) __syncthreads();  // every thread has read the previous range's sums
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j)
                wmma::store_matrix_sync(sm.c + (wm * FM + i) * 16 * kCLD + (wn * FN + j) * 16,
                                        acc[r][i][j], kCLD, wmma::mem_row_major);
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int i = tid + e * kThreads;
            const int row = i / kBN, col = i % kBN;
            const float v = sm.c[row * kCLD + col];
            if (m0 + row >= S || n0 + col >= N) continue;
            const long long o = (long long)(m0 + row) * N + n0 + col;
            if (partial != nullptr)
                partial[(long long)(kz * NW + r) * S * N + o] = v;
            else if (NW == 1)
                out[o] = from_f<TO>(v);
            else if (r == 0)
                gate[NW == 2 ? e : 0] = v;
            else
                out[o] = from_f<TO>(silu_mul(gate[NW == 2 ? e : 0], v));
        }
    }
}

// partial [splits, NW, S, N]: sums over the splits in order, then the epilogue
template <int NW, typename TO>
__global__ void sum_partials(const float* __restrict__ partial, TO* __restrict__ out,
                             long long count, int splits) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
         i += (long long)gridDim.x * blockDim.x) {
        float s[NW];
#pragma unroll
        for (int r = 0; r < NW; ++r) s[r] = 0.f;
        for (int z = 0; z < splits; ++z)
#pragma unroll
            for (int r = 0; r < NW; ++r) s[r] += partial[(long long)(z * NW + r) * count + i];
        out[i] = from_f<TO>(NW == 1 ? s[0] : silu_mul(s[0], s[NW - 1]));
    }
}

// the layered mode's index and stack depth (nullptr, 0 in plain mode)
struct Layer {
    const int* idx;
    int n;
};

template <int BM, int NW, typename TX, typename TS, typename TO>
void launch_main(const void* x, const void* w8, const void* scales, const void* zeros, void* out,
                 void* partial, int S, int K2, int N, int group_size, int splits, int per,
                 Layer layer, cudaStream_t st) {
    dim3 grid((N + kBN - 1) / kBN, (S + BM - 1) / BM, splits);
    w4a16_kernel<BM, NW, TX, TS, TO><<<grid, kThreads, 0, st>>>(
        (const TX*)x, (const uint8_t*)w8, (const TS*)scales, (const TS*)zeros, (TO*)out,
        splits > 1 ? (float*)partial : nullptr, S, K2, N, NW * N, group_size, per, layer.idx,
        layer.n);
}

template <int NW, typename TX, typename TS, typename TO>
int launch(const void* x, const void* w8, const void* scales, const void* zeros, void* out,
           void* partial, int S, int K2, int N, int group_size, int splits, Layer layer,
           cudaStream_t st) {
    const int n_chunks = K2 / kBR;
    const int per = (n_chunks + splits - 1) / splits;
    // the row tile changes which rows share a block, never a row's summation order
    if (S <= 32)
        launch_main<32, NW, TX, TS, TO>(x, w8, scales, zeros, out, partial, S, K2, N, group_size,
                                        splits, per, layer, st);
    else
        launch_main<128, NW, TX, TS, TO>(x, w8, scales, zeros, out, partial, S, K2, N,
                                         group_size, splits, per, layer, st);
    if (splits > 1) {
        const long long count = (long long)S * N;
        const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
        sum_partials<NW, TO><<<blocks, 256, 0, st>>>((const float*)partial, (TO*)out, count,
                                                     splits);
    }
    return (int)cudaGetLastError();
}

template <int NW, typename TX, typename TS>
int dispatch_out(int out_bf16, const void* x, const void* w8, const void* s, const void* z,
                 void* out, void* partial, int S, int K2, int N, int gs, int splits, Layer layer,
                 cudaStream_t st) {
    if (out_bf16)
        return launch<NW, TX, TS, __nv_bfloat16>(x, w8, s, z, out, partial, S, K2, N, gs, splits,
                                                 layer, st);
    return launch<NW, TX, TS, float>(x, w8, s, z, out, partial, S, K2, N, gs, splits, layer, st);
}

template <int NW, typename TX>
int dispatch_scales(int s_bf16, int out_bf16, const void* x, const void* w8, const void* s,
                    const void* z, void* out, void* partial, int S, int K2, int N, int gs,
                    int splits, Layer layer, cudaStream_t st) {
    if (s_bf16)
        return dispatch_out<NW, TX, __nv_bfloat16>(out_bf16, x, w8, s, z, out, partial, S, K2, N,
                                                   gs, splits, layer, st);
    return dispatch_out<NW, TX, float>(out_bf16, x, w8, s, z, out, partial, S, K2, N, gs, splits,
                                       layer, st);
}

template <int NW>
int run(const void* x, const void* w8, const void* scales, const void* zeros, void* out,
        void* partial, int S, int K2, int N, int group_size, int splits, int x_bf16, int s_bf16,
        int out_bf16, Layer layer, void* stream) {
    if (S <= 0 || N <= 0) return 0;
    if (group_size % kBR != 0 || K2 % group_size != 0 || splits < 1 ||
        (splits > 1 && partial == nullptr) || (layer.idx != nullptr && layer.n < 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (x_bf16)
        return dispatch_scales<NW, __nv_bfloat16>(s_bf16, out_bf16, x, w8, scales, zeros, out,
                                                  partial, S, K2, N, group_size, splits, layer,
                                                  st);
    return dispatch_scales<NW, float>(s_bf16, out_bf16, x, w8, scales, zeros, out, partial, S,
                                      K2, N, group_size, splits, layer, st);
}

}  // namespace

// x [S, 2*K2] (fp32 or bf16), w8 [K2, N] uint8, scales/zeros [2*K2/group_size, N]
// (fp32 or bf16, one dtype), out [S, N] (fp32 or bf16), partial fp32
// [splits, S, N] scratch when splits > 1; all contiguous. group_size must be a
// multiple of 32 and K2 a multiple of group_size; x must be 16-byte aligned.
extern "C" int w4a16_matmul(const void* x, const void* w8, const void* scales, const void* zeros,
                            void* out, void* partial, int S, int K2, int N, int group_size,
                            int splits, int x_bf16, int s_bf16, int out_bf16, void* stream) {
    return run<1>(x, w8, scales, zeros, out, partial, S, K2, N, group_size, splits, x_bf16,
                  s_bf16, out_bf16, Layer{nullptr, 0}, stream);
}

// Layered mode: w8 [n_layers, K2, N], scales/zeros [n_layers, 2*K2/group_size, N]
// and layer_idx one int32 on the device, in [0, n_layers) (the kernel traps
// otherwise). Otherwise as w4a16_matmul, whose result on the selected layer
// this equals bit for bit.
extern "C" int w4a16_matmul_layered(const void* x, const void* w8, const void* scales,
                                    const void* zeros, void* out, void* partial, int S, int K2,
                                    int N, int group_size, int splits, int x_bf16, int s_bf16,
                                    int out_bf16, const void* layer_idx, int n_layers,
                                    void* stream) {
    if (layer_idx == nullptr) return (int)cudaErrorInvalidValue;
    return run<1>(x, w8, scales, zeros, out, partial, S, K2, N, group_size, splits, x_bf16,
                  s_bf16, out_bf16, Layer{(const int*)layer_idx, n_layers}, stream);
}

// The packed gate|up form: w8 [K2, 2*I], scales/zeros [2*K2/group_size, 2*I]
// (gate columns first), out [S, I] = silu(x @ W_gate) * (x @ W_up); partial
// fp32 [splits, 2, S, I] scratch when splits > 1. Otherwise as w4a16_matmul.
extern "C" int w4a16_gate_up_silu(const void* x, const void* w8, const void* scales,
                                  const void* zeros, void* out, void* partial, int S, int K2,
                                  int I, int group_size, int splits, int x_bf16, int s_bf16,
                                  int out_bf16, void* stream) {
    return run<2>(x, w8, scales, zeros, out, partial, S, K2, I, group_size, splits, x_bf16,
                  s_bf16, out_bf16, Layer{nullptr, 0}, stream);
}
