// Masked flash attention over a layered linear KV cache (tree / causal masks):
// one kernel family for the four TPU kernels of
// umbrella_tpu/ops/pallas/tree_attention.py:
//   _flash_kernel     (attend_flash, bf16/fp32 KV; pallas_call :449)       single slot
//   _flash_kernel_q   (attend_flash, int8 KV + scales; :438)               single slot
//   _flash_kernel_b   (attend_flash_batched, bf16/fp32; :349)              B slots
//   _flash_kernel_bq  (attend_flash_batched, int8 KV; :338)                B slots
// The single-slot forms are the batched form with B = Bc = 1 and a host
// kv_limit. Semantics kept from the TPU kernels: GQA with `groups = H / KVH`
// query rows per kv head; only KV blocks below ceil(kv_limit / BK) are read;
// scores are scaled by `scale` (times the slot's k scale for int8 KV, in score
// space: s = (q . k_int) * scale * ks[j]), optionally soft-capped, masked where
// the bool [B, S, L] mask is false; an fp32 online softmax (base 2 in the
// tensor-core kernel: exp(s - m) = 2^(s log2 e - m log2 e)); P.V runs on p
// rounded to q's dtype (p * vs[j] for int8 KV, so the int8 values are never
// dequantized in memory); the output is acc / max(l, 1e-30). Two choices the TPU
// kernels leave to their block size are fixed here: slots at or past the slot's
// kv_limit count as masked, and a masked slot adds exactly 0 to l and acc (the
// TPU kernels add exp(0) = 1 until a live slot resets the sum), so a row with
// no live slot gives 0. Rows with a live slot give the same result either way.
//
// Two kernels, chosen by the wrapper (ops/kernels/tree_attention._plan) from
// q's dtype and the head dim before the launch:
//
// flash_tc_kernel: bf16 q, head dim 64, 128 or 256, bf16 or int8 KV (every
// timed path). Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at a decode
// shape the bytes (B = 32 slots x 7 tree rows, int8 KV, kv_limit 135-300: ~19
// MB, 0.006 ms); at a verify or prefill shape the bytes too, since only live
// (mask-true, below kv_limit) pairs need their 4 H D operations: q [127, 32,
// 128] at kv_limit 428 is 0.64 GFLOP live, 0.0006 ms of tensor cores, beside
// 0.0012 ms of bytes; a [512]-token causal prefill 2.15 GFLOP live, 0.0022
// ms, beside 10.75 MB, 0.0032 ms. The kernel it replaces ran both
// products as scalar fp32 FMAs. What bounds this one is latency, not the
// tensor cores or the softmax: a block's start (the Q tile and the live
// flags, one round trip to device memory), its KV tiles one after another,
// and at 64 blocks (the 8B verify) about half the SMs (scripts/
// attention_breakdown.py; PERF.md). Design (Hopper: TMA, mbarriers,
// wgmma; sm_90a only):
// - One block per (kv head, tile of 64 grouped query rows, grid row b): the
//   rows are the S x groups (s, g) pairs of the kv head, so a K/V tile is read
//   once for all of its GQA heads. Two consumer warpgroups (one at D = 256,
//   registers) share the block's 64 rows: the first takes the even KV tiles,
//   the second the odd ones (fixed by the tile index alone); at the end the
//   second's m, l and acc join the first's through shared memory.
// - A producer warp starts TMA loads of 64-slot K and V tiles into a ring of
//   2-4 stages behind mbarriers; the tensor maps are 3-D [n Bc KVH rows, L,
//   D], the block computes its row from layer, slots[b] and the head on the
//   device, and TMA zero-fills past L, so any L works. With each tile come
//   the mask rows of the block's positions (a window of 80 bytes a position)
//   and, for int8 KV, the tile's fp32 k and v scales (a window of 68), all
//   through 1-D maps over the flattened tensors, each window read from the
//   16-byte boundary at or below its first element (one starting off a
//   16-byte boundary faulted at odd L); the parts past L meet only dead
//   slots. So the consumers read their live bits from shared memory and
//   never wait on device memory inside the tile loop.
// - S = Q K^T on wgmma (m64n64k16, bf16, fp32 sums): Q is stored once in a
//   128-byte-swizzled tile, the K tile (K-major, as the cache lies) is B.
//   int8 K and V are first widened to bf16 in a swizzled shared tile of the
//   warpgroup's own: exact, |k| <= 128 fits bf16's 8 significant bits (two
//   bytes become bf16x2 in one subtraction: 128 + low bits, minus 128 or 256).
// - The online softmax runs in registers on the accumulator fragment, in the
//   order of the header's semantics, in base 2 (scores times log2 e, one
//   MUFU.EX2 an exponential); a dead slot is an explicit select (0 to l and
//   acc, never the exponential of a sentinel). The running max is rounded up
//   to an integer, so every rescale (a tile's, the warpgroups' combine) is an
//   exact power of two and a P value rounds to bf16 alike whenever the max
//   moved: a row's P depends on its final max only, not on which tile or
//   warpgroup met the max first. A verify row (ancestors at tree slots) and
//   the AR row with the same keys at contiguous slots then round alike but
//   for the fp32 sums' grouping: with a float running max each warpgroup
//   rounded P against its own max, and 4.7% of such outputs differed in bf16,
//   the scalar kernel's 0.1-0.4% (scripts/attention_breakdown.py; PERF.md).
//   P, rounded to bf16 where the
//   plain versions round it, is the register A operand of P V (m64nDk16);
//   the V tile is B, MN-major (wgmma's transposed bf16 B).
// - KV tiles with no live slot for any row of the block (all masked, or at or
//   past the limit) are skipped, loads and products: a pre-pass over the
//   block's mask rows below the limit marks the live tiles (in the same round
//   trip as the Q tile), and producer and consumers walk the same list. Such
//   a tile leaves m, l and acc unchanged bit for bit (m_new = m, alpha =
//   2^0 = 1, P = 0), so skipping is exact, and so is running one: tile 0
//   always runs, its loads started before the live flags are known. A causal
//   prefill skips the tiles past each row tile's diagonal.
// - Row invariance: the row tile (64), the KV tile (64), the tile order, the
//   warpgroup each tile goes to, the combine and every instruction shape are
//   constants, and nothing is split by S or B, so a row's bits do not depend
//   on S, B, the other rows of its tile or its place there (chip_smoke.py
//   holds them bit for bit).
// - The row tiles run in reverse order, so a causal prefill starts the tiles
//   with the most live KV tiles first.
//
// flash_attend_kernel: the rest (fp32 q: the lossless checks' dtype; head dim
// 32), the scalar kernel: one block per (kv head, tile of 32 grouped
// query rows, slot); each block reads its slot's kv_limit and cache row from
// device int32 tensors (no host read per launch) and loops over 32-slot KV
// blocks. It stages each block in shared memory once (16-byte vector loads of
// bf16/fp32/int8 values, converted to fp32 rows padded to D+1 so lane j reads
// slot j without bank conflicts) and reuses it for its 32 query rows; each
// warp owns 4 rows, lane j scores slot j of the block, and lane c accumulates
// output columns c, c+32, ... in registers. Slots past L are masked, so any L
// works (no L % block rule).
#include "hopper.cuh"

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


// ------------------------------------------------ the tensor-core kernel (bf16 q)

constexpr int kTcRows = 64;  // grouped query rows a block
constexpr int kTcKV = 64;    // kv slots a tile
constexpr int kTcMaxStages = 4;
// consumer warpgroups a block, all on the block's 64 rows: two at D <= 128,
// the second taking the odd KV tiles; one at D = 256 (registers)
template <int D>
struct TcShape {
    static constexpr int kGroups = D <= 128 ? 2 : 1;
    static constexpr int kThreads = 128 * kGroups + 32;  // + one producer warp
};
constexpr int kSmemMax = 232448;
constexpr int kBox = 8192;  // a swizzled 64 x 64 bf16 box: 64 rows of 128 bytes
// a stage's meta area, after its K and V tiles: the tile's mask bytes, a
// window of kMaskWin bytes a position of the block, read by TMA from the
// 16-byte boundary at or below the position's first column of the tile (TMA
// reads global memory from one) into 128 bytes of its own (TMA writes shared
// memory from a 128-byte boundary); then for int8 KV the tile's fp32 k and v
// scales, each a window of kScaleWin read likewise (the tile's first scale
// sits 0-3 floats into it)
constexpr int kMaxPos = kTcRows;  // positions of a block's rows (groups >= 1)
constexpr int kMaskWin = kTcKV + 16;
constexpr int kScaleWin = kTcKV + 4;
constexpr int kKsOff = 128 * kMaxPos, kVsOff = kKsOff + 512;

// shared memory of one block, in this order: Q, the ring, the widened int8
// K and V (one pair a consumer warpgroup), the barriers, one live flag a KV
// tile (every tile 1024-aligned). The ring holds the second warpgroup's
// partial sums for the final combine (checked at launch).
template <int D, bool Q8>
struct TcSmem {
    static constexpr int kTile = kTcKV * D * 2;  // bf16 [64, D]: D / 64 boxes
    static constexpr int kQ = kTcRows * D * 2;
    static constexpr int kTile8 = kTcKV * D;     // int8 [64, D], rows of D bytes
    static constexpr int kMeta = Q8 ? kVsOff + 512 : kKsOff;  // mask (+ scale) windows
    static constexpr int kKV = Q8 ? 2 * kTile8 : 2 * kTile;  // K and V
    static constexpr int kStage = kKV + kMeta;
    static constexpr int kWide = Q8 ? 2 * kTile : 0;  // a warpgroup's
    static constexpr int kCombine = TcShape<D>::kGroups == 2 ? 128 * (D / 2 + 4) * 4 : 0;
    static int bytes(int stages, int L) {
        return 1024 + kQ + stages * kStage + TcShape<D>::kGroups * kWide + 16 * kTcMaxStages +
               (L + kTcKV - 1) / kTcKV;
    }
};

struct TcParams {
    const __nv_bfloat16* q;
    __nv_bfloat16* out;
    const uint8_t* mask;
    const int* kv_limits;
    const int* slots;
    int S, H, KVH, L, Bc, layer, kv_limit, groups, stages;
    int mask_vec;  // mask rows may be read 16 bytes at a time
    int mask_off;  // the mask's address mod 16: the mask map starts that many bytes early
    float scale, soft_cap;
};

// wgmma descriptor of an MN-major bf16 B tile in 64-column boxes of 128-byte
// rows with 128-byte swizzle: 8-row atoms 1024 bytes apart along K, boxes
// kBox bytes apart along N
__device__ __forceinline__ uint64_t desc_mn128(uint32_t saddr) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(kBox >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define TA_D4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TA_D16(d, i) TA_D4(d, i), TA_D4(d, i + 4), TA_D4(d, i + 8), TA_D4(d, i + 12)
#define TA_D32(d, i) TA_D16(d, i), TA_D16(d, i + 16)
#define TA_D64(d, i) TA_D32(d, i), TA_D32(d, i + 32)
#define TA_D128(d, i) TA_D64(d, i), TA_D64(d, i + 64)
// s[64 x 64 fp32] (+)= Q[64 x 16 bf16] * K[64 slots x 16 bf16]^T, both K-major
// tiles in shared memory; keep = 0 overwrites s. s[4i + 2h + e] holds row
// g + 8h (g = lane / 4 of the warp's 16 rows), column 8i + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t desc_q, uint64_t desc_k, int keep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : TA_D32(s, 0)
        : "l"(desc_q), "l"(desc_k), "r"(keep));
}
// o[64 x N fp32] += P[64 x 16 bf16, registers] * V[16 slots x N bf16], V an
// MN-major (transposed) tile in shared memory; o[4j + 2h + e] holds row g + 8h,
// column 8j + 2 (lane % 4) + e.
template <int N>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t desc_v);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float* o, const uint32_t* a, uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : TA_D32(o, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float* o, const uint32_t* a, uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : TA_D64(o, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float* o, const uint32_t* a, uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : TA_D128(o, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
// 2^x (MUFU.EX2): 2^0 = 1 exactly, 2^(-1e30) = 0
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}
constexpr float kLog2e = 1.4426950408889634f;
// 2^d for an integer-valued d <= 0, exactly (0 below the normal range)
__device__ __forceinline__ float exp2_int(float d) {
    return d < -126.f ? 0.f : __int_as_float((__float2int_rn(d) + 127) << 23);
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
// int8 bytes 2k and 2k + 1 of w as bf16x2, exactly: a byte b becomes the
// bf16 128 + (b & 0x7f) (exponent 7, b's low bits as the mantissa), minus
// 128, or 256 where b is negative, in one bf16x2 subtraction
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int k) {
    const uint32_t t = __byte_perm(w, 0u, k ? 0x4342u : 0x4140u);  // bytes in bits 0-7, 16-23
    const uint32_t v = (t & 0x007F007Fu) | 0x43004300u, c = (t & 0x00800080u) | 0x43004300u;
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               *reinterpret_cast<const __nv_bfloat162*>(&c));
    return *reinterpret_cast<uint32_t*>(&r);
}

// the stage's int8 K and V tiles ([64][D] bytes each) -> bf16 tiles in the
// swizzled box layout the bf16 wgmma reads (16-byte chunk c of a 128-byte row
// r at chunk c ^ (r % 8))
template <int D>
__device__ __forceinline__ void widen_kv(const uint8_t* st, uint8_t* wide, int tid) {
    constexpr int kChunks = kTcKV * D / 16;  // 16-byte int8 chunks a tile
#pragma unroll 4
    for (int i = tid; i < 2 * kChunks; i += 128) {
        const int tv = i / kChunks, ci = i % kChunks;
        const int slot = ci / (D / 16), d0 = 16 * (ci % (D / 16));
        const uint4 raw = *reinterpret_cast<const uint4*>(st + tv * kTcKV * D + slot * D + d0);
        const uint4 lo = make_uint4(i8x2_bf16(raw.x, 0), i8x2_bf16(raw.x, 1), i8x2_bf16(raw.y, 0),
                                    i8x2_bf16(raw.y, 1));
        const uint4 hi = make_uint4(i8x2_bf16(raw.z, 0), i8x2_bf16(raw.z, 1), i8x2_bf16(raw.w, 0),
                                    i8x2_bf16(raw.w, 1));
        uint8_t* row = wide + tv * kTcKV * D * 2 + (d0 / 64) * kBox + slot * 128;
        const int ch = (d0 % 64) / 8;
        *reinterpret_cast<uint4*>(row + ((ch ^ (slot & 7)) << 4)) = lo;
        *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (slot & 7)) << 4)) = hi;
    }
}

// q/out [B, S, H, D] bf16; k/v [n_layers, Bc, KVH, L, D] bf16 or int8 (Q8) with
// fp32 scales [n_layers, Bc, KVH, L]; mask [B, S, L]. Grid (KVH, row tiles, B).
template <int D, bool Q8>
__global__ void __launch_bounds__(TcShape<D>::kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_ks,
                const __grid_constant__ CUtensorMap tm_vs, const __grid_constant__ CUtensorMap tm_m,
                const TcParams p) {
    using M = TcSmem<D, Q8>;
    constexpr int NWG = TcShape<D>::kGroups, kWarps = TcShape<D>::kThreads / 32;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* ring = q_s + M::kQ;
    uint8_t* wide = ring + p.stages * M::kStage;
    uint64_t* full = reinterpret_cast<uint64_t*>(wide + NWG * M::kWide);
    uint64_t* empty = full + kTcMaxStages;
    uint8_t* live = reinterpret_cast<uint8_t*>(empty + kTcMaxStages);

    const int h = blockIdx.x, b = blockIdx.z;
    const int r0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // the longest causal spans first
    const int groups = p.groups, SG = p.S * groups, L = p.L;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    int limit = p.kv_limits != nullptr ? p.kv_limits[b] : p.kv_limit;
    limit = limit < 0 ? 0 : (limit > L ? L : limit);
    const int slot = p.slots != nullptr ? p.slots[b] : b;
    const int n_tiles = (slot >= 0 && slot < p.Bc) ? (limit + kTcKV - 1) / kTcKV : 0;
    const uint8_t* mask_b = p.mask + (long long)b * p.S * L;
    const int p0 = r0 / groups, p1 = (min(r0 + kTcRows, SG) - 1) / groups + 1;  // positions

    // the producer warp: the TMA loads of KV tile t into ring stage s (lane
    // 0 the K and V tiles and the scales, every lane the mask windows)
    const bool producer = warp == 4 * NWG;
    const int kv_row = (p.layer * p.Bc + slot) * p.KVH + h;  // outer TMA coordinate
    auto load_tile = [&](int t, int s) {
        const uint32_t sa = smem_u32(ring + s * M::kStage), bar = smem_u32(full + s);
        if (lane == 0) {
            mbar_expect_tx(bar, (Q8 ? 2 * M::kTile8 + 2 * kScaleWin * 4 : 2 * M::kTile) +
                                    (p1 - p0) * kMaskWin);
            if (Q8) {
                tma_3d(sa, &tm_k, bar, 0, t * kTcKV, kv_row);
                tma_3d(sa + M::kTile8, &tm_v, bar, 0, t * kTcKV, kv_row);
                const int c = (kv_row * L + t * kTcKV) & ~3;  // from a 16-byte boundary
                tma_1d(sa + M::kKV + kKsOff, &tm_ks, bar, c);
                tma_1d(sa + M::kKV + kVsOff, &tm_vs, bar, c);
            } else {
#pragma unroll
                for (int j = 0; j < D / 64; ++j) {
                    tma_3d(sa + j * kBox, &tm_k, bar, 64 * j, t * kTcKV, kv_row);
                    tma_3d(sa + M::kTile + j * kBox, &tm_v, bar, 64 * j, t * kTcKV, kv_row);
                }
            }
        }
        __syncwarp();  // the bytes are expected before any window can land
        for (int pi = lane; pi < p1 - p0; pi += 32) {
            const long long c = p.mask_off + ((long long)b * p.S + p0 + pi) * L + t * kTcKV;
            tma_1d(sa + M::kKV + 128 * pi, &tm_m, bar, (int)(c & ~15ll));
        }
    };
    // KV tile 0 counts as live whenever there is a tile (a tile with no live
    // slot is an exact no-op), so its loads start now, beside the Q tile's
    if (producer) {
        if (lane == 0) {
            for (int s = 0; s < p.stages; ++s) {
                mbar_init(smem_u32(full + s), 1);
                mbar_init(smem_u32(empty + s), 4);  // the consuming warpgroup's warps
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncwarp();
        if (n_tiles > 0) load_tile(0, 0);
    }
    // one round trip: the Q tile (rows (s, g) of kv head h, zero past S *
    // groups) and, a warp a KV tile, whether some row of the block has a live
    // slot in it (a mask byte set below the limit)
    const __nv_bfloat16* q_b = p.q + (long long)b * p.S * p.H * D;
    for (int i = tid; i < kTcRows * D / 8; i += kWarps * 32) {
        const int r = i / (D / 8), c = i % (D / 8), gr = r0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < SG) {
            const int s = gr / groups, g = gr % groups;
            const __nv_bfloat16* src = q_b + ((long long)s * p.H + h * groups + g) * D;
            v = __ldg(reinterpret_cast<const uint4*>(src) + c);
        }
        *reinterpret_cast<uint4*>(q_s + (c / 8) * kBox + r * 128 + (((c % 8) ^ (r % 8)) << 4)) = v;
    }
    for (int t = warp; t < n_tiles; t += kWarps) {
        uint32_t any = 0;
        for (int i = lane; i < (p1 - p0) * (kTcKV / 16); i += 32) {
            const int col = t * kTcKV + 16 * (i % (kTcKV / 16));
            if (col >= limit) continue;
            const uint8_t* src = mask_b + (long long)(p0 + i / (kTcKV / 16)) * L + col;
            if (p.mask_vec && col + 16 <= limit) {
                const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
                any |= v.x | v.y | v.z | v.w;
            } else {
                for (int e = 0; e < 16 && col + e < limit; ++e) any |= __ldg(src + e);
            }
        }
        any = __any_sync(kFull, any != 0u);
        if (lane == 0) live[t] = (uint8_t)(t == 0 || any);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // Q, as wgmma reads it
    __syncthreads();

    if (producer) {  // keeps the TMA ring full
        int s = 0, n = 0;
        uint32_t phase = 0;
        for (int t = 0; t < n_tiles; ++t) {
            if (!live[t]) continue;
            if (n > 0) {  // tile 0's loads are in flight
                if (lane == 0 && n >= p.stages) mbar_wait(smem_u32(empty + s), phase ^ 1);
                __syncwarp();
                load_tile(t, s);
            }
            ++n;
            if (++s == p.stages) {
                s = 0;
                phase ^= 1;
            }
        }
        return;
    }

    // consumer warpgroup wg takes the live tiles t with t % NWG == wg (fixed by
    // t alone: a row's split does not depend on the other rows); this thread
    // holds rows g and g + 8 (hh = 0, 1) of warp w's 16
    const int wg = warp >> 2, w = warp & 3, ctid = tid & 127;
    const int g4 = lane >> 2, c4 = lane & 3;
    // mw[hh]: the row's mask bytes in a stage's meta area, from its column 2 c4
    int row[2], mw[2];
    bool valid[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        row[hh] = r0 + 16 * w + g4 + 8 * hh;
        valid[hh] = row[hh] < SG;
        const int pos = valid[hh] ? row[hh] / groups : p0;
        mw[hh] = 128 * (pos - p0) + 2 * c4 +
                 (int)((p.mask_off + ((long long)b * p.S + pos) * L) & 15);
    }
    // moves t to this warpgroup's next live tile at or after t; k counts the
    // live tiles before it (the ring position)
    auto seek = [&](int& t, int& k) {
        for (; t < n_tiles; ++t) {
            if (!live[t]) continue;
            if (NWG == 1 || (t & 1) == wg) return;
            ++k;
        }
    };
    // the running max m is in base-2 units (the scores times log2 e), so each
    // exponential is one MUFU.EX2
    const float scale2 = p.scale * kLog2e;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // zeroed before the first wgmma.fence: a register write inside a wgmma
    // pipeline stage makes ptxas serialize every wgmma of the kernel
    float o[D / 2], sc[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
        o[i] = 0.f;
        fence_reg(o[i]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        sc[i] = 0.f;
        fence_reg(sc[i]);
    }
    const uint32_t q_addr = smem_u32(q_s);
    uint8_t* my_wide = wide + wg * M::kWide;
    // the tile's first scale in its window (kv_row * L + t * 64 = this mod 4)
    const int s_off = (((p.layer * p.Bc + slot) * p.KVH + h) * L) & 3;
    int t = 0, k = 0;
    seek(t, k);
    while (t < n_tiles) {
        const int s = k % p.stages;
        mbar_wait(smem_u32(full + s), (k / p.stages) & 1);
        const uint8_t* st = ring + s * M::kStage;
        uint32_t k_addr = smem_u32(st), v_addr = k_addr + M::kTile;
        const float* ks = reinterpret_cast<const float*>(st + M::kKV + kKsOff) + s_off;
        const float* vs = reinterpret_cast<const float*>(st + M::kKV + kVsOff) + s_off;
        // the live bits of this thread's columns: bit 2i + e of bits[hh] is
        // column 64 t + 8i + 2 c4 + e of row hh (a mask byte set, below the limit)
        uint32_t bits[2] = {0u, 0u};
        const int lim = limit - t * kTcKV - 2 * c4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
            if (valid[hh])
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        bits[hh] |=
                            (st[M::kKV + mw[hh] + 8 * i + e] != 0 && 8 * i + e < lim ? 1u : 0u)
                            << (2 * i + e);
        if (Q8) {
            warpgroup_sync(wg);  // its products of the last tile, which read `my_wide`, are done
            widen_kv<D>(st, my_wide, ctid);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            warpgroup_sync(wg);
            k_addr = smem_u32(my_wide);
            v_addr = k_addr + M::kTile;
        }
        // S = Q K^T, fp32
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_qk(sc, desc_sw128(q_addr + (kk / 4) * kBox) + 2 * (kk % 4),
                     desc_sw128(k_addr + (kk / 4) * kBox) + 2 * (kk % 4), kk);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(sc[i]);

        // the online softmax; sc[4i + 2hh + e] is row hh, column 64 t + 8i + 2 c4 + e
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            float mx = kNegInf;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kx = 4 * i + 2 * hh + e;
                    // the score in base-2 units: s * log2 e
                    float x;
                    if (p.soft_cap > 0.f) {
                        x = sc[kx] * p.scale;
                        if (Q8) x *= ks[8 * i + 2 * c4 + e];
                        x = p.soft_cap * tanhf(x / p.soft_cap) * kLog2e;
                    } else {
                        x = sc[kx] * scale2;
                        if (Q8) x *= ks[8 * i + 2 * c4 + e];
                    }
                    sc[kx] = x;
                    if ((bits[hh] >> (2 * i + e)) & 1u) mx = fmaxf(mx, x);
                }
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
            // an integer running max: every rescale is an exact power of two, and
            // bf16(2^(x - m)) 2^(m - m') = bf16(2^(x - m')), so P rounds alike
            // whenever the max moves (it depends on the row's final max only)
            const float m_new = fmaxf(m[hh], ceilf(mx));
            const float alpha = exp2_int(m[hh] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kx = 4 * i + 2 * hh + e;
                    const bool ok = (bits[hh] >> (2 * i + e)) & 1u;
                    const float pe = ok ? ex2(sc[kx] - m_new) : 0.f;
                    sum += pe;
                    // P.V runs on p (times the slot's v scale for int8 KV) in bf16
                    sc[kx] = Q8 ? (ok ? pe * vs[8 * i + 2 * c4 + e] : 0.f) : pe;
                }
            sum += __shfl_xor_sync(kFull, sum, 1);
            sum += __shfl_xor_sync(kFull, sum, 2);
            l[hh] = l[hh] * alpha + sum;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                o[4 * j + 2 * hh] *= alpha;
                o[4 * j + 2 * hh + 1] *= alpha;
            }
            m[hh] = m_new;
        }
        // P as the A fragments of four k16 steps: step j's columns 16j .. 16j + 15
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
                pa[j][r] = pack_bf16x2(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_pv<D>(o, pa[j], desc_mn128(v_addr + j * 16 * 128));
        wgmma_commit();
        int tn = t + 1, kn = k + 1;
        seek(tn, kn);
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) fence_reg(pa[j][r]);
        if (lane == 0) mbar_arrive(smem_u32(empty + s));  // the stage's products are done
        t = tn;
        k = kn;
    }

    if (NWG == 2) {  // the odd tiles' partial sums join the even tiles', in that order
        float* part = reinterpret_cast<float*>(ring);  // [D / 2 + 4][128]; the ring is idle
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
        if (wg == 1) {
#pragma unroll
            for (int i = 0; i < D / 2; ++i) part[i * 128 + ctid] = o[i];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                part[(D / 2 + hh) * 128 + ctid] = m[hh];
                part[(D / 2 + 2 + hh) * 128 + ctid] = l[hh];
            }
        }
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
        if (wg == 1) return;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const float m1 = part[(D / 2 + hh) * 128 + ctid];
            const float l1 = part[(D / 2 + 2 + hh) * 128 + ctid];
            const float mm = fmaxf(m[hh], m1);
            const float a0 = exp2_int(m[hh] - mm), a1 = exp2_int(m1 - mm);
            l[hh] = l[hh] * a0 + l1 * a1;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kx = 4 * j + 2 * hh + e;
                    o[kx] = o[kx] * a0 + part[kx * 128 + ctid] * a1;
                }
        }
    }

    __nv_bfloat16* out_b = p.out + (long long)b * p.S * p.H * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        if (!valid[hh]) continue;
        const int s_ = row[hh] / groups, g = row[hh] % groups;
        __nv_bfloat16* orow = out_b + ((long long)s_ * p.H + h * groups + g) * D;
        const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c4) =
                __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    }
}

// The caller's launch plan (tree_attention._plan) must agree with the
// kernel: its row tiles, consumer warpgroups and shared memory are checked
// against the kernel's own before anything is encoded.
struct TcPlan {
    int stages, row_tiles, warpgroups, smem;
};

template <int D, bool Q8>
int launch_tc(const Args& a, int n_layers, const TcPlan& plan, cudaStream_t st) {
    using M = TcSmem<D, Q8>;
    const int stages = plan.stages;
    const int smem = M::bytes(stages, a.L);
    const int row_tiles = (a.S * (a.H / a.KVH) + kTcRows - 1) / kTcRows;
    if (stages < 1 || stages > kTcMaxStages || smem > kSmemMax ||
        stages * M::kStage < M::kCombine || plan.smem != smem || plan.row_tiles != row_tiles ||
        plan.warpgroups != TcShape<D>::kGroups)
        return (int)cudaErrorInvalidValue;
    EncodeTiled encode = encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    // k/v [n_layers * Bc * KVH rows, L, D]: boxes of 64 d x 64 slots (bf16,
    // 128-byte swizzle: the wgmma layout) or D x 64 (int8, plain rows);
    // TMA zero-fills slots past L
    const cuuint64_t rows = (cuuint64_t)n_layers * a.Bc * a.KVH;
    const cuuint64_t es = Q8 ? 1 : 2;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)a.L, rows};
    const cuuint64_t strides[2] = {D * es, (cuuint64_t)a.L * D * es};
    const cuuint32_t box[3] = {(cuuint32_t)(Q8 ? D : 64), (cuuint32_t)kTcKV, 1};
    const cuuint32_t ones[3] = {1, 1, 1};
    CUtensorMap tm_k, tm_v, tm_ks, tm_vs, tm_m;
    for (int i = 0; i < 2; ++i)
        if (encode(i ? &tm_v : &tm_k,
                   Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(i ? a.v : a.k), dims, strides, box, ones,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   Q8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return (int)cudaErrorInvalidValue;
    tm_ks = tm_vs = tm_k;  // read by the int8 form only
    if (Q8) {  // the scales, flattened: windows of kScaleWin from a 16-byte boundary
        const cuuint64_t n[1] = {rows * a.L}, no_strides[1] = {0};
        const cuuint32_t sbox[1] = {(cuuint32_t)kScaleWin};
        for (int i = 0; i < 2; ++i)
            if (encode(i ? &tm_vs : &tm_ks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                       const_cast<void*>(i ? a.v_scale : a.k_scale), n, no_strides, sbox, ones,
                       CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                       CU_TENSOR_MAP_L2_PROMOTION_NONE,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
                return (int)cudaErrorInvalidValue;
    }
    // the mask, flattened, from the 16-byte boundary at or below its start:
    // windows of kMaskWin bytes
    const int mask_off = (int)(reinterpret_cast<uintptr_t>(a.mask) & 15);
    {
        const cuuint64_t n[1] = {(cuuint64_t)a.B * a.S * a.L + mask_off}, no_strides[1] = {0};
        const cuuint32_t mbox[1] = {(cuuint32_t)kMaskWin};
        if (n[0] + kMaskWin >= (1ull << 31) ||
            encode(&tm_m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                   const_cast<uint8_t*>(reinterpret_cast<const uint8_t*>(a.mask) - mask_off), n,
                   no_strides, mbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return (int)cudaErrorInvalidValue;
    }
    static unsigned configured = 0;  // one bit per device
    int dev = 0;
    cudaGetDevice(&dev);
    if (!(configured >> dev & 1u)) {
        cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<D, Q8>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (e != cudaSuccess) return (int)e;
        configured |= 1u << dev;
    }
    TcParams p;
    p.q = (const __nv_bfloat16*)a.q;
    p.out = (__nv_bfloat16*)a.out;
    p.mask = (const uint8_t*)a.mask;
    p.kv_limits = (const int*)a.kv_limits;
    p.slots = (const int*)a.slots;
    p.S = a.S;
    p.H = a.H;
    p.KVH = a.KVH;
    p.L = a.L;
    p.Bc = a.Bc;
    p.layer = a.layer;
    p.kv_limit = a.kv_limit;
    p.groups = a.H / a.KVH;
    p.stages = stages;
    p.mask_vec = a.L % 16 == 0 && mask_off == 0;
    p.mask_off = mask_off;
    p.scale = a.scale;
    p.soft_cap = a.soft_cap;
    dim3 grid(a.KVH, row_tiles, a.B);
    flash_tc_kernel<D, Q8><<<grid, TcShape<D>::kThreads, smem, st>>>(tm_k, tm_v, tm_ks, tm_vs,
                                                                      tm_m, p);
    return (int)cudaGetLastError();
}

template <bool Q8>
int dispatch_tc(const Args& a, int n_layers, const TcPlan& plan, cudaStream_t st) {
    switch (a.D) {
        case 64: return launch_tc<64, Q8>(a, n_layers, plan, st);
        case 128: return launch_tc<128, Q8>(a, n_layers, plan, st);
        case 256: return launch_tc<256, Q8>(a, n_layers, plan, st);
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

// The tensor-core kernel: bf16 q/out [B, S, H, D], D in {64, 128, 256}; k/v
// [n_layers, Bc, KVH, L, D] bf16, or int8 with fp32 k_scale/v_scale
// [n_layers, Bc, KVH, L] when kv_int8; mask [B, S, L] bool bytes; kv_limits
// and slots as attend_flash; `stages` K/V tiles in the TMA ring (1-4, and
// the block's shared memory within the card's); `row_tiles` (the grid's
// second axis), `warpgroups` (consumer warpgroups a block) and `smem`
// (dynamic shared memory bytes) as the plan has them, refused unless they are
// the kernel's. q, k, v and the scales contiguous and 16-byte aligned.
extern "C" int attend_flash_tc(const void* q, const void* k, const void* v, const void* k_scale,
                               const void* v_scale, const void* mask, const void* kv_limits,
                               const void* slots, void* out, int B, int S, int H, int KVH, int L,
                               int D, int Bc, int n_layers, int layer, int kv_limit, float scale,
                               float soft_cap, int kv_int8, int stages, int row_tiles,
                               int warpgroups, int smem, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if (KVH <= 0 || H % KVH != 0 || L <= 0 || layer < 0 || layer >= n_layers)
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, k_scale, v_scale, mask, kv_limits, slots, out, B, S, H, KVH, L, D,
                 Bc, layer, kv_limit, scale, soft_cap};
    cudaStream_t st = (cudaStream_t)stream;
    const TcPlan plan{stages, row_tiles, warpgroups, smem};
    return kv_int8 ? dispatch_tc<true>(a, n_layers, plan, st)
                   : dispatch_tc<false>(a, n_layers, plan, st);
}
