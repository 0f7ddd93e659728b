// Masked flash attention over a layered linear KV cache (tree / causal masks):
// one kernel family for the four TPU kernels of
// umbrella_tpu/ops/pallas/tree_attention.py:
//   _flash_kernel     (attend_flash, bf16/fp32 KV)        single slot
//   _flash_kernel_q   (attend_flash, int8 KV + scales)    single slot
//   _flash_kernel_b   (attend_flash_batched, bf16/fp32)   B slots
//   _flash_kernel_bq  (attend_flash_batched, int8 KV)     B slots
// The single-slot forms are the batched form with B = Bc = 1 and a host
// kv_limit. Semantics kept from the TPU kernels: GQA with `groups = H / KVH`
// query rows per kv head; only KV blocks below ceil(kv_limit / BK) are read;
// scores are scaled by `scale` (times the slot's k scale for int8 KV, in score
// space: s = (q . k_int) * scale * ks[j]), optionally soft-capped, masked where
// the bool [B, S, L] mask is false; an fp32 online softmax; P.V runs on p
// rounded to q's dtype (p * vs[j] for int8 KV, so the int8 values are never
// dequantized in memory); the output is acc / max(l, 1e-30). Two choices the TPU
// kernels leave to their block size are fixed here: slots at or past the slot's
// kv_limit count as masked, and a masked slot adds exactly 0 to l and acc (the
// TPU kernels add exp(0) = 1 until a live slot resets the sum), so a row with
// no live slot gives 0. Rows with a live slot give the same result either way.
//
// Bound on this card: bytes. At the batched serving shape (B = 32 slots, 2x3
// tree so 7 rows x 4 grouped heads = 28 query rows per (slot, kv head),
// kv_limit 135-300) a launch reads ~20 MB of int8 K and V for ~0.3 GFLOP.
// Design: one block per (kv head, tile of 32 grouped query rows, slot); each
// block reads its slot's kv_limit and cache row from device int32 tensors
// (no host read per launch) and loops over 32-slot KV blocks. It stages each
// block in shared memory once (16-byte vector loads of bf16/fp32/int8 values,
// converted to fp32 rows padded to D+1 so lane j reads slot j without bank
// conflicts) and reuses it for its 32 query rows; each warp owns 4 rows, lane j
// scores slot j of the block, and lane c accumulates output columns c, c+32, ...
// in registers. Slots past L are masked, so any L works (no L % block rule).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// One 32-bit word of cache values -> fp32 (little endian: lowest bytes first).
template <typename T> struct Unpack;
template <> struct Unpack<float> {
    static constexpr int kPer = 1;
    __device__ static void run(uint32_t w, float* d) { d[0] = __uint_as_float(w); }
};
template <> struct Unpack<__nv_bfloat16> {
    static constexpr int kPer = 2;
    __device__ static void run(uint32_t w, float* d) {
        d[0] = __uint_as_float(w << 16);
        d[1] = __uint_as_float(w & 0xffff0000u);
    }
};
template <> struct Unpack<int8_t> {
    static constexpr int kPer = 4;
    __device__ static void run(uint32_t w, float* d) {
#pragma unroll
        for (int t = 0; t < 4; ++t) d[t] = (float)(int8_t)((w >> (8 * t)) & 0xffu);
    }
};

// 16 bytes of cache values at `src` (16-byte aligned) -> 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(src));
    constexpr int P = Unpack<T>::kPer;
    Unpack<T>::run(r.x, dst);
    Unpack<T>::run(r.y, dst + P);
    Unpack<T>::run(r.z, dst + 2 * P);
    Unpack<T>::run(r.w, dst + 3 * P);
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

struct Args {
    const void *q, *k, *v, *k_scale, *v_scale, *mask, *kv_limits, *slots;
    void* out;
    int B, S, H, KVH, L, D, Bc, layer, kv_limit;
    float scale, soft_cap;
};

// q/out [B, S, H, D] (TQ), k/v [n_layers, Bc, KVH, L, D] (TKV), scales
// [n_layers, Bc, KVH, L] fp32 (int8 KV only), mask [B, S, L] bool bytes,
// kv_limits/slots [B] int32 on the device (null: kv_limit for every slot, and
// slot b reads cache row b). Grid (KVH, row tiles, B).
template <typename TQ, typename TKV, int NDC>  // head dim D = 32 * NDC
__global__ void __launch_bounds__(kWarps * 32)
flash_attend_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const uint8_t* __restrict__ mask,
                    const int* __restrict__ kv_limits, const int* __restrict__ slots,
                    TQ* __restrict__ out, int S, int H, int KVH, int L, int Bc, int layer,
                    int kv_limit, float scale, float soft_cap, int groups) {
    constexpr int D = 32 * NDC;
    constexpr int DP = D + 1;
    constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
    constexpr int kVec = 16 / (int)sizeof(TKV);
    extern __shared__ float smem[];
    float* q_s = smem;               // [kTQ][D]
    float* k_s = q_s + kTQ * D;      // [kBK][DP]
    float* v_s = k_s + kBK * DP;     // [kBK][DP]
    float* ks_s = v_s + kBK * DP;    // [kBK] (int8 KV)
    float* vs_s = ks_s + kBK;        // [kBK]

    const int h = blockIdx.x;
    const int row0 = blockIdx.y * kTQ;
    const int b = blockIdx.z;
    const int SG = S * groups;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    int limit = kv_limits != nullptr ? kv_limits[b] : kv_limit;
    limit = limit < 0 ? 0 : (limit > L ? L : limit);
    const int slot = slots != nullptr ? slots[b] : b;
    const int n_blocks = (slot >= 0 && slot < Bc) ? (limit + kBK - 1) / kBK : 0;

    const TQ* q_b = q + (long long)b * S * H * D;
    for (int i = tid; i < kTQ * D; i += blockDim.x) {
        const int r = i / D, d = i % D, gr = row0 + r;
        float val = 0.f;
        if (gr < SG) {
            const int s = gr / groups, g = gr % groups;
            val = to_f(q_b[((long long)s * H + h * groups + g) * D + d]);
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

    const uint8_t* mask_b = mask + (long long)b * S * L;
    // first slot of this (layer, cache row, head); only dereferenced when n_blocks > 0
    const long long head_base = (((long long)layer * Bc + slot) * KVH + h) * L;
    const float* q_warp = q_s + warp * kRowsPerWarp * D;
    for (int jb = 0; jb < n_blocks; ++jb) {
        const int col0 = jb * kBK;
        __syncthreads();  // the previous block's K/V (and the q tile) are settled
        for (int i = tid; i < kBK * D / kVec; i += blockDim.x) {
            const int e = i * kVec, j = e / D, d = e % D, col = col0 + j;
            float* kd = k_s + j * DP + d;
            float* vd = v_s + j * DP + d;
            if (col < L) {
                const long long off = (head_base + col) * D + d;
                load16(k + off, kd);
                load16(v + off, vd);
            } else {
#pragma unroll
                for (int t = 0; t < kVec; ++t) kd[t] = vd[t] = 0.f;
            }
        }
        if (kQuant && tid < kBK) {
            const int col = col0 + tid;
            ks_s[tid] = col < L ? k_scale[head_base + col] : 0.f;
            vs_s[tid] = col < L ? v_scale[head_base + col] : 0.f;
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
            if (kQuant) s *= ks_s[lane];
            if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
            const bool ok = valid[rr] && col < limit && mask_b[(long long)my_s[rr] * L + col] != 0;
            const float m_new = fmaxf(m[rr], warp_max(ok ? s : kNegInf));
            const float pe = ok ? expf(s - m_new) : 0.f;
            const float alpha = expf(m[rr] - m_new);
            l[rr] = l[rr] * alpha + warp_sum(pe);
#pragma unroll
            for (int c = 0; c < NDC; ++c) acc[rr][c] *= alpha;
            m[rr] = m_new;
            // P.V runs on p (times the slot's v scale for int8 KV) in q's dtype, as on the TPU
            p[rr] = to_f(from_f<TQ>(kQuant ? pe * vs_s[lane] : pe));
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

    TQ* out_b = out + (long long)b * S * H * D;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        if (!valid[rr]) continue;
        const int gr = row0 + warp * kRowsPerWarp + rr;
        const int s = gr / groups, g = gr % groups;
        TQ* orow = out_b + ((long long)s * H + h * groups + g) * D;
        const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
        for (int c = 0; c < NDC; ++c) orow[lane + 32 * c] = from_f<TQ>(acc[rr][c] * inv);
    }
}

template <typename TQ, typename TKV, int NDC>
int launch(const Args& a, cudaStream_t st) {
    constexpr int D = 32 * NDC;
    const int groups = a.H / a.KVH;
    const size_t smem = sizeof(float) * (size_t)(kTQ * D + 2 * kBK * (D + 1) + 2 * kBK);
    void (*kern)(const TQ*, const TKV*, const TKV*, const float*, const float*, const uint8_t*,
                 const int*, const int*, TQ*, int, int, int, int, int, int, int, float, float,
                 int) = flash_attend_kernel<TQ, TKV, NDC>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.KVH, (a.S * groups + kTQ - 1) / kTQ, a.B);
    kern<<<grid, kWarps * 32, smem, st>>>(
        (const TQ*)a.q, (const TKV*)a.k, (const TKV*)a.v, (const float*)a.k_scale,
        (const float*)a.v_scale, (const uint8_t*)a.mask, (const int*)a.kv_limits,
        (const int*)a.slots, (TQ*)a.out, a.S, a.H, a.KVH, a.L, a.Bc, a.layer, a.kv_limit,
        a.scale, a.soft_cap, groups);
    return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_d(const Args& a, cudaStream_t st) {
    switch (a.D) {
        case 32: return launch<TQ, TKV, 1>(a, st);
        case 64: return launch<TQ, TKV, 2>(a, st);
        case 128: return launch<TQ, TKV, 4>(a, st);
        case 256: return launch<TQ, TKV, 8>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q/out [B, S, H, D] (bf16 if q_bf16 else fp32); k/v [n_layers, Bc, KVH, L, D] in q's
// dtype, or int8 with fp32 k_scale/v_scale [n_layers, Bc, KVH, L] when kv_int8;
// mask [B, S, L] bool bytes; kv_limits and slots [B] int32 on the device or NULL
// (then every slot's bound is kv_limit and slot b reads cache row b). All
// contiguous and 16-byte aligned.
extern "C" int attend_flash(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* mask, const void* kv_limits,
                            const void* slots, void* out, int B, int S, int H, int KVH, int L,
                            int D, int Bc, int layer, int kv_limit, float scale, float soft_cap,
                            int q_bf16, int kv_int8, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    const Args a{q, k, v, k_scale, v_scale, mask, kv_limits, slots, out, B, S, H, KVH, L, D,
                 Bc, layer, kv_limit, scale, soft_cap};
    cudaStream_t st = (cudaStream_t)stream;
    if (kv_int8)
        return q_bf16 ? dispatch_d<__nv_bfloat16, int8_t>(a, st) : dispatch_d<float, int8_t>(a, st);
    return q_bf16 ? dispatch_d<__nv_bfloat16, __nv_bfloat16>(a, st) : dispatch_d<float, float>(a, st);
}
