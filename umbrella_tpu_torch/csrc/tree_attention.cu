// Masked flash attention over a layered linear KV cache (tree / causal masks).
//
// Replaces the TPU kernel umbrella_tpu/ops/pallas/tree_attention.py::attend_flash
// (_flash_kernel, non-quantized, layered form). Semantics kept from it: GQA with
// `groups = H / KVH` query rows per kv head; only KV blocks below
// ceil(kv_limit / BK) are read; scores are scaled by `scale`, optionally
// soft-capped, masked to -1e30 where the bool [S, L] mask is false; an fp32
// online softmax; p is rounded to the cache dtype before the P.V product;
// the output is acc / max(l, 1e-30).
//
// Bound on this card: bytes at decode sizes. A verify pass (S=127, 32 heads,
// kv_limit ~ 300) does ~40 MFLOP per layer but reads kv_limit * KVH * D * 2
// values of K and V plus the [S, kv_limit] mask; a 512-token prefill does
// more arithmetic and is still far below the tensor-core line. Design: one
// block per (kv head, tile of 32 grouped query rows), so a verify pass's
// 127 * 4 = 508 rows per head make 16 tiles and 128 blocks over 8 heads. The
// block stages each 32-slot K/V block in shared memory once (fp32, rows padded
// to D+1 so lane j reads slot j without bank conflicts) and reuses it for its
// 32 query rows; each warp owns 4 rows, lane j scores slot j of the block, and
// lane c accumulates output columns c, c+32, ... in registers. The loop stops
// at the last block that holds a live slot, and slots past L are masked, so any
// L works (no L % block constraint).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBK = 32;           // kv slots per staged block (= warp size)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
    return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    return x;
}

template <typename T, int NDC>  // head dim D = 32 * NDC
__global__ void __launch_bounds__(kWarps * 32)
flash_attend_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ mask, T* __restrict__ out, int S, int H, int KVH,
                    int L, int layer, int n_blocks, float scale, float soft_cap, int groups) {
    constexpr int D = 32 * NDC;
    constexpr int DP = D + 1;
    extern __shared__ float smem[];
    float* q_s = smem;               // [kTQ][D]
    float* k_s = q_s + kTQ * D;      // [kBK][DP]
    float* v_s = k_s + kBK * DP;     // [kBK][DP]

    const int h = blockIdx.x;
    const int row0 = blockIdx.y * kTQ;
    const int SG = S * groups;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int i = tid; i < kTQ * D; i += blockDim.x) {
        const int r = i / D, d = i % D, gr = row0 + r;
        float val = 0.f;
        if (gr < SG) {
            const int s = gr / groups, g = gr % groups;
            val = to_f(q[((long long)s * H + h * groups + g) * D + d]);
        }
        q_s[i] = val;
    }

    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NDC];
    int my_s[kRowsPerWarp];
    bool valid[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int gr = row0 + warp * kRowsPerWarp + rr;
        valid[rr] = gr < SG;
        my_s[rr] = valid[rr] ? gr / groups : 0;
        m[rr] = kNegInf;
        l[rr] = 0.f;
#pragma unroll
        for (int c = 0; c < NDC; ++c) acc[rr][c] = 0.f;
    }

    const long long head_base = ((long long)layer * KVH + h) * L;  // first slot of this head
    const float* q_warp = q_s + warp * kRowsPerWarp * D;
    for (int jb = 0; jb < n_blocks; ++jb) {
        const int col0 = jb * kBK;
        __syncthreads();  // the previous block's K/V (and the q tile) are settled
        for (int i = tid; i < kBK * D; i += blockDim.x) {
            const int j = i / D, d = i % D, col = col0 + j;
            float kv = 0.f, vv = 0.f;
            if (col < L) {
                const long long off = (head_base + col) * D + d;
                kv = to_f(k[off]);
                vv = to_f(v[off]);
            }
            k_s[j * DP + d] = kv;
            v_s[j * DP + d] = vv;
        }
        __syncthreads();

        const int col = col0 + lane;
        float sc[kRowsPerWarp];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) sc[rr] = 0.f;
        const float* krow = k_s + lane * DP;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            const float kd = krow[d];
#pragma unroll
            for (int rr = 0; rr < kRowsPerWarp; ++rr) sc[rr] = fmaf(q_warp[rr * D + d], kd, sc[rr]);
        }

        float p[kRowsPerWarp];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
            float s = sc[rr] * scale;
            if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
            const bool ok = valid[rr] && col < L && mask[(long long)my_s[rr] * L + col] != 0;
            if (!ok) s = kNegInf;
            const float m_new = fmaxf(m[rr], warp_max(s));
            const float pe = expf(s - m_new);
            const float alpha = expf(m[rr] - m_new);
            l[rr] = l[rr] * alpha + warp_sum(pe);
#pragma unroll
            for (int c = 0; c < NDC; ++c) acc[rr][c] *= alpha;
            m[rr] = m_new;
            p[rr] = to_f(from_f<T>(pe));  // P.V runs on p in the cache dtype, as on the TPU
        }
#pragma unroll 4
        for (int j = 0; j < kBK; ++j) {
            const float* vrow = v_s + j * DP;
            float vv[NDC];
#pragma unroll
            for (int c = 0; c < NDC; ++c) vv[c] = vrow[lane + 32 * c];
#pragma unroll
            for (int rr = 0; rr < kRowsPerWarp; ++rr) {
                const float pj = __shfl_sync(kFull, p[rr], j);
#pragma unroll
                for (int c = 0; c < NDC; ++c) acc[rr][c] = fmaf(pj, vv[c], acc[rr][c]);
            }
        }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        if (!valid[rr]) continue;
        const int gr = row0 + warp * kRowsPerWarp + rr;
        const int s = gr / groups, g = gr % groups;
        T* orow = out + ((long long)s * H + h * groups + g) * D;
        const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
        for (int c = 0; c < NDC; ++c) orow[lane + 32 * c] = from_f<T>(acc[rr][c] * inv);
    }
}

template <typename T, int NDC>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int S, int H,
           int KVH, int L, int layer, int n_blocks, float scale, float soft_cap,
           cudaStream_t st) {
    constexpr int D = 32 * NDC;
    const int groups = H / KVH;
    const size_t smem = sizeof(float) * (size_t)(kTQ * D + 2 * kBK * (D + 1));
    cudaError_t err = cudaFuncSetAttribute(flash_attend_kernel<T, NDC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(KVH, (S * groups + kTQ - 1) / kTQ);
    flash_attend_kernel<T, NDC><<<grid, kWarps * 32, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)mask, (T*)out, S, H, KVH, L,
        layer, n_blocks, scale, soft_cap, groups);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* mask, void* out,
               int S, int H, int KVH, int L, int layer, int n_blocks, float scale,
               float soft_cap, cudaStream_t st) {
    switch (D) {
        case 32: return launch<T, 1>(q, k, v, mask, out, S, H, KVH, L, layer, n_blocks, scale, soft_cap, st);
        case 64: return launch<T, 2>(q, k, v, mask, out, S, H, KVH, L, layer, n_blocks, scale, soft_cap, st);
        case 128: return launch<T, 4>(q, k, v, mask, out, S, H, KVH, L, layer, n_blocks, scale, soft_cap, st);
        case 256: return launch<T, 8>(q, k, v, mask, out, S, H, KVH, L, layer, n_blocks, scale, soft_cap, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q [S, H, D], k/v [n_layers, KVH, L, D], mask [S, L] (bool bytes), out [S, H, D];
// all contiguous, q/k/v/out of one dtype (is_bf16 ? bf16 : fp32).
extern "C" int attend_flash(const void* q, const void* k, const void* v, const void* mask,
                            void* out, int S, int H, int KVH, int L, int D, int layer,
                            int kv_limit, float scale, float soft_cap, int is_bf16,
                            void* stream) {
    if (S <= 0) return 0;
    const int live = kv_limit < 0 ? 0 : (kv_limit > L ? L : kv_limit);
    const int n_blocks = (live + kBK - 1) / kBK;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_bf16)
        return dispatch_d<__nv_bfloat16>(D, q, k, v, mask, out, S, H, KVH, L, layer, n_blocks,
                                         scale, soft_cap, st);
    return dispatch_d<float>(D, q, k, v, mask, out, S, H, KVH, L, layer, n_blocks, scale,
                             soft_cap, st);
}
