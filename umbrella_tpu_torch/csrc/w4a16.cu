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
// fp32 (__fsub_rn, then __fmul_rn: no FMA contraction) and rounded once to
// bf16, x is bf16 (the wrapper rounds fp32 x once), the products accumulate
// in fp32; the plain product writes its output in its own dtype, the fused one
// applies g * sigmoid(g) * u to the fp32 sums and rounds once.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): operations 2*S*K*N,
// bytes the packed weights (K*N/2) plus the g128 scales and zeros. 70B gate_up
// [8192, 57344]: 0.121 ms at S=127 (operations), 0.075 ms at S=24 (bytes);
// 70B wqkv / wo / down at S=127: 0.022 / 0.017 / 0.060 ms; 8B gate_up [4096,
// 28672]: 0.030 ms at S=127, 0.053 ms at S=224 (operations). So the weight
// stream bounds the draft's rows and the tensor cores bound a verify pass.
//
// Design (Hopper: TMA, mbarriers, wgmma; sm_90a only):
// - A and B swapped: the kernel computes Y^T = W^T x^T, so the output columns
//   run along wgmma's 64-row M and the tokens along its N. Each of two
//   consumer warpgroups owns 64 weight columns and dequantizes its weight
//   straight into the register A fragment of a dense bf16 wgmma.mma_async
//   (m64nNk16); x is the B operand, a K-major bf16 tile in shared memory (x's
//   own row-major layout). The weight never makes a shared-memory round trip
//   in bf16.
// - Token width: a block covers NT tokens, S rounded up to 32 (S <= 32, the
//   draft's levels) or to 64, at most 256, and issues one wgmma of width NT
//   on each dequantized fragment, so for S <= 256 (every decode path: 1-24
//   draft, 127 verify, 224 serve) each weight byte is read and dequantized
//   once. S > 256 (prefill) takes super-tiles of 256 rows along the grid's y.
//   A row's summation order (K split, steps, halves) never depends on S, and
//   a wgmma computes a token's column alike at every width (chip_smoke.py
//   holds rows of S = 1, 24, 127, 224 and 300 equal bit for bit): results
//   are row-invariant. One wide wgmma reads each A fragment once and
//   amortizes an instruction's fixed cost better than NT / 64 of width 64.
// - A TMA ring: one thread of a producer warpgroup keeps 3-8 stages in flight
//   (as many as shared memory holds at this NT); a stage holds two 64 x 64
//   packed-weight boxes (one per consumer warpgroup, 8 KB) and the two
//   matching x boxes, x[:, r0:r0+64] and x[:, K/2+r0:K/2+r0+64] (S rows
//   rounded up to 8, 128-byte swizzle; rows past S are zero-filled by TMA or
//   left stale, and feed only accumulators that are never stored). 24-64 KB
//   of weights are in flight per SM. Consumers wait on a stage's full
//   barrier, read its bytes (16 ld.shared a thread), and release its empty
//   barrier once the wgmma groups that read its x have completed. setmaxnreg
//   gives the consumers 232 registers and the producer 40.
// - Bank conflicts: a thread's A fragment needs packed rows 2c, 2c+1, 2c+8,
//   2c+9 of a 16-row step, which are 128 B apart in a 64-byte-wide box; the
//   weight boxes use CU_TENSOR_MAP_SWIZZLE_64B, which spreads those rows over
//   four 16-byte chunks (conflict-free reads). The fragment's M rows are
//   permuted so that a thread's two rows are adjacent columns: one 16-bit
//   shared load per packed row, and each thread stores column pairs, so every
//   32-byte sector of y is written whole without a transpose through shared
//   memory.
// - Dequantization: bf16 scales with integer zeros in [0, 127] (every AWQ
//   checkpoint) take a packed bf16x2 form, 5 instructions per 2 weights and
//   bit for bit the fp32 form (see deq2); other scales and zeros take the
//   fp32 form. chip_smoke.py holds eye(K) @ W equal to the plain version's
//   dequantized weight for both; scripts/w4a16_breakdown.py times the kernel
//   with the fp32 form alone. A group is whole stages (g64, g128) or half a
//   stage (g32: the second group starts half-way through the stage).
// - Layered mode by construction: the weight tensor map is 3-D [n_layers,
//   K/2, ldw]; thread 0 reads the int32 layer index once on the device, traps
//   outside [0, n_layers), and the producer passes it as the outermost TMA
//   coordinate (scales and zeros are offset by it). The plain mode is the
//   same code on a stack of one at index 0, so layer i equals the plain mode
//   on stack[i] bit for bit. The host never reads the index, so the launch
//   can be captured in a CUDA graph.
// - Fused gate-up-SiLU (NW = 2): warpgroup 0 takes a 64-column gate tile and
//   warpgroup 1 the matching up tile from the same stages' x; the up sums
//   pass to warpgroup 0 through shared memory for the epilogue.
// - Split K from the column tiles and K only (never S), fp32 partials summed
//   in a fixed order by w4a16_sum_partials (the fused form's SiLU runs
//   there). No atomics: results are deterministic.
// - The TMA descriptors are encoded on the host at each launch with
//   cuTensorMapEncodeTiled, fetched once through cudaGetDriverEntryPoint (no
//   -lcuda), and passed as __grid_constant__ kernel parameters.
// What bounds it now: scripts/w4a16_breakdown.py times the kernel without its
// MMA, without its dequantization, and with neither; PERF.md has the numbers.
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;    // packed rows (K/2 direction) per stage
constexpr int kCols = 64;    // weight columns per consumer warpgroup
constexpr int kMaxTok = 256;  // tokens a block: S <= 256 in one pass
constexpr int kConsumerThreads = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + a producer warpgroup (one thread issues)
// registers a thread: the producer gives most of its share to the consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWBox = kRows * kCols;             // bytes of one weight box
constexpr int kSmemMax = 232448;
constexpr int kMaxStages = 8;
// 16-row steps in one wgmma group (a wgmma.fence, commit and wait each)
constexpr int kStepsPerGroup = 2;

struct Params {
    const void* scales;
    const void* zeros;
    void* out;
    float* partial;  // [splits, NW, S, N] when the K range is split, else null
    const int* layer_idx;
    int n_layers, S, K2, N, ldw, group_size, n_chunks, chunks_per_split, stages, s_bf16,
        out_bf16;
    int x_rows;  // rows of an x box: S rounded up to 8, at most NT
};

// a 16-bit shared-memory load (a generic load of a shared address takes the
// slow path; the aligned dynamic-smem pointer no longer says it is shared)
__device__ __forceinline__ uint32_t lds_u16(const void* p) {
    uint16_t v;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(smem_u32(p)));
    return v;
}
__device__ __forceinline__ float lds_f32(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
    return v;
}
// the next dequantization's inputs: it cannot be hoisted above the last wait
// (ptxas serializes wgmma where a fragment is written inside a pipeline stage)
template <int J>
__device__ __forceinline__ void fence_bytes(uint32_t (&bs)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_reg(bs[j][i]);
}

// d[64 x NT fp32] += A[64 x 16 bf16, registers] * B[16 x NT bf16, shared]:
// one instruction for all NT tokens of a block (d[4i + 2h + e] holds M row
// g + 8h, token 8i + 2c + e, the n8 blocks of the wgmma accumulator layout)
#define W4A16_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define W4A16_D16(i) W4A16_D4(i), W4A16_D4(i + 4), W4A16_D4(i + 8), W4A16_D4(i + 12)
#define W4A16_D32(i) W4A16_D16(i), W4A16_D16(i + 16)
#define W4A16_D64(i) W4A16_D32(i), W4A16_D32(i + 32)
#define W4A16_D96(i) W4A16_D64(i), W4A16_D32(i + 64)
#define W4A16_D128(i) W4A16_D64(i), W4A16_D64(i + 64)
template <int NT>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : W4A16_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : W4A16_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : W4A16_D64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
        : W4A16_D96(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : W4A16_D128(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// (nibble - z) * s in fp32, rounded once; two values packed as bf16x2 (a low)
__device__ __forceinline__ float deq(uint32_t nib, float z, float s) {
    const float n = __fsub_rn(__uint_as_float(0x4B000000u | nib), 8388608.0f);  // exact
    return __fmul_rn(__fsub_rn(n, z), s);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
    return d;
}
// The packed form, for bf16 scales and integer zeros in [0, 127]: two nibbles
// (in bits 0-3 and 16-19 of w) become the bf16 values 128 + nibble, and
// ((128 + n) - (128 + z)) * s is computed in bf16x2. The difference is a small
// integer, exact in bf16, and the product of it with a bf16 scale is exact
// before its one rounding to bf16: the same bits as the fp32 form.
__device__ __forceinline__ uint32_t deq2(uint32_t w, uint32_t z128, uint32_t s) {
    const uint32_t v = (w & 0x000F000Fu) | 0x43004300u;
    __nv_bfloat162 r = __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                       *reinterpret_cast<const __nv_bfloat162*>(&z128)),
                               *reinterpret_cast<const __nv_bfloat162*>(&s));
    return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t bf16x2_of(float v) {  // v exact in bf16, in both halves
    return pack_bf16x2(v, v);
}

// g * sigmoid(g) * u in fp32, in that order (the TPU kernel's epilogue)
__device__ __forceinline__ float silu_mul(float g, float u) {
    return __fmul_rn(__fmul_rn(g, 1.0f / (1.0f + expf(-g))), u);
}

__device__ __forceinline__ void store2(void* out, long long o, float a, float b, int is_bf16) {
    if (is_bf16)
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + o) =
            __floats2bfloat162_rn(a, b);
    else
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(a, b);
}

// G32: the group size is 32 (else a multiple of 64).
// NW weight column ranges of width N, range r starting at column r * N of the
// [K/2, ldw] packed matrix: NW = 1 is the plain product (ldw = N; a block
// covers 128 columns, 64 per consumer warpgroup), NW = 2 the fused gate
// (r = 0) and up (r = 1) product (ldw = 2N; a block covers 64 output columns,
// warpgroup r the range r's).
template <int NT, int NW, bool G32>
__global__ void __launch_bounds__(kThreads, 1)
w4a16_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
             const Params p) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~uintptr_t(1023));
    constexpr int kXBox = NT * kRows * 2;          // one x half of a stage
    constexpr int kStage = 2 * kXBox + 2 * kWBox;  // multiple of 1024
    constexpr int kSteps = kRows / 16;             // k16 steps a stage
    const int stages = p.stages;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStage);
    uint64_t* empty = full + kMaxStages;
    int* layer_sm = reinterpret_cast<int*>(empty + kMaxStages);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    if (tid == 0) {
        int li = 0;
        if (p.layer_idx != nullptr) {  // layered mode: the stack's layer, read on the device
            li = *p.layer_idx;
            if (li < 0 || li >= p.n_layers) __trap();
        }
        *layer_sm = li;
        for (int s = 0; s < stages; ++s) {
            mbar_init(smem_u32(full + s), 1);
            mbar_init(smem_u32(empty + s), kConsumerThreads / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int layer = *layer_sm;
    const int bx = blockIdx.x, kz = blockIdx.z, s0 = blockIdx.y * kMaxTok;
    const int c_begin = kz * p.chunks_per_split;
    const int c_end = min(p.n_chunks, c_begin + p.chunks_per_split);
    // first weight column of consumer warpgroup r
    auto wcol = [&](int r) { return NW == 1 ? bx * 2 * kCols + r * kCols : r * p.N + bx * kCols; };

    if (warp >= kConsumerThreads / 32) {  // producer warpgroup: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (warp == kConsumerThreads / 32 && lane == 0) {
            const uint32_t bytes = 2 * p.x_rows * kRows * 2 + 2 * kWBox;
            int s = 0;
            uint32_t phase = 0;
            for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
                if (it >= stages) mbar_wait(smem_u32(empty + s), phase ^ 1);
                uint8_t* st = smem + s * kStage;
                const uint32_t bar = smem_u32(full + s);
                mbar_expect_tx(bar, bytes);
                tma_2d(smem_u32(st), &tm_x, bar, c * kRows, s0);
                tma_2d(smem_u32(st + kXBox), &tm_x, bar, p.K2 + c * kRows, s0);
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    tma_3d(smem_u32(st + 2 * kXBox + r * kWBox), &tm_w, bar, wcol(r), c * kRows,
                           layer);
                if (++s == stages) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

    // consumer warpgroup wg; in its 64 x 16 A fragment this thread holds M rows
    // g and g + 8 of warp w's 16, which stand for the adjacent weight columns
    // lc and lc + 1 (the permutation the epilogue undoes)
    const int wg = warp >> 2, w = warp & 3, c4 = lane & 3, g = lane >> 2;
    const int lc = 16 * w + 2 * g;
    const int col = wcol(wg) + lc;  // weight column in [0, ldw)
    const int out_col = (NW == 1 ? wcol(wg) : bx * kCols) + lc;
    const bool col_ok = out_col < p.N;
    // this thread's weight box in a stage; its two byte columns of row r are
    // at r * 64 + (lc ^ (((r / 2) % 4) << 4)) there (the 64-byte swizzle:
    // 16-byte chunk ^= (r / 2) % 4)
    const uint32_t wbox_off = wg * kWBox + 2 * kXBox;

    // zeroed before the first wgmma.fence: a register write inside a wgmma
    // pipeline stage makes ptxas serialize every wgmma of the kernel
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
        acc[i] = 0.f;
        fence_reg(acc[i]);
    }

    // scales and zeros of the two columns for the current group's low and
    // high halves: sz[lo s, lo z, hi s, hi z][column]; the packed form's
    // constants z2 (128 + z) and s2 as bf16x2, [half][column]. The next
    // group's raw bits are loaded a group early and converted when it starts.
    // chunks a group; group size 32 (two groups a chunk) starts the second
    // group half-way through the chunk. A template parameter: a run-time test
    // in the step loop slowed every group size.
    constexpr bool g32 = G32;
    const int cpg = g32 ? 1 : p.group_size / kRows;
    const long long sz_row = (long long)layer * 2 * p.K2 / p.group_size;  // the layer's first row
    const int hi_groups = p.K2 / p.group_size;
    uint32_t raw[4][2];
    auto load_raw = [&](int grp) {  // [lo s, lo z, hi s, hi z][column]
        const long long lo = (sz_row + grp) * p.ldw + col;
        const long long hi = (sz_row + hi_groups + grp) * p.ldw + col;
        if (!col_ok) {
#pragma unroll
            for (int i = 0; i < 4; ++i) raw[i][0] = raw[i][1] = 0u;
        } else if (p.s_bf16) {  // both columns' bf16 in one 32-bit load
            const uint32_t* sc = reinterpret_cast<const uint32_t*>(
                reinterpret_cast<const __nv_bfloat16*>(p.scales) + lo);
            const uint32_t* ze = reinterpret_cast<const uint32_t*>(
                reinterpret_cast<const __nv_bfloat16*>(p.zeros) + lo);
            const long long d = (hi - lo) / 2;
            raw[0][0] = __ldg(sc);
            raw[1][0] = __ldg(ze);
            raw[2][0] = __ldg(sc + d);
            raw[3][0] = __ldg(ze + d);
        } else {
            const float2 a = __ldg(reinterpret_cast<const float2*>(
                               reinterpret_cast<const float*>(p.scales) + lo)),
                         b = __ldg(reinterpret_cast<const float2*>(
                               reinterpret_cast<const float*>(p.zeros) + lo)),
                         c = __ldg(reinterpret_cast<const float2*>(
                               reinterpret_cast<const float*>(p.scales) + hi)),
                         d = __ldg(reinterpret_cast<const float2*>(
                               reinterpret_cast<const float*>(p.zeros) + hi));
            raw[0][0] = __float_as_uint(a.x), raw[0][1] = __float_as_uint(a.y);
            raw[1][0] = __float_as_uint(b.x), raw[1][1] = __float_as_uint(b.y);
            raw[2][0] = __float_as_uint(c.x), raw[2][1] = __float_as_uint(c.y);
            raw[3][0] = __float_as_uint(d.x), raw[3][1] = __float_as_uint(d.y);
        }
    };
    float sz[4][2];
    uint32_t z2[2][2], s2[2][2];
    bool packed = false;
    auto start_group = [&]() {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (p.s_bf16) {
                sz[i][0] = __uint_as_float(raw[i][0] << 16);
                sz[i][1] = __uint_as_float(raw[i][0] & 0xFFFF0000u);
            } else {
                sz[i][0] = __uint_as_float(raw[i][0]);
                sz[i][1] = __uint_as_float(raw[i][1]);
            }
        }
        packed = p.s_bf16 != 0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
                const float z = sz[2 * h + 1][cc];
                packed = packed && z == rintf(z) && z >= 0.f && z <= 127.f;
                z2[h][cc] = bf16x2_of(128.f + z);
                s2[h][cc] = bf16x2_of(sz[2 * h][cc]);
            }
    };
    int grp = g32 ? 2 * c_begin : c_begin / cpg, left = 0;
    if (c_begin < c_end) load_raw(grp);

    // the A fragments of a group of steps, double-buffered by group:
    // [buffer][step in the group][half][register]
    uint32_t frag[2][kStepsPerGroup][2][4];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int jj = 0; jj < kStepsPerGroup; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int i = 0; i < 4; ++i) frag[b][jj][h][i] = 0u;

    int s = 0, s_prev = 0, buf = 0;
    uint32_t phase = 0;
    for (int c = c_begin; c < c_end; ++c) {
        if (g32) {  // the chunk's first group; its second is loaded now
            if (c != c_begin) ++grp;
            start_group();
            load_raw(grp + 1);
        } else if (c == c_begin || left == 0) {  // a chunk never straddles a group
            if (c != c_begin) ++grp;
            left = c == c_begin ? cpg - (c_begin - grp * cpg) : cpg;
            start_group();
            if (c + left < c_end) load_raw(grp + 1);
        }
        --left;
        mbar_wait(smem_u32(full + s), phase);
        const uint8_t* st = smem + s * kStage;
        // the stage's bytes of this thread, all loaded at once: step j's packed
        // rows 16j + 2c4 + {0, 1, 8, 9}, columns lc and lc + 1
        uint32_t bs[kSteps][4];
#pragma unroll
        for (int j = 0; j < kSteps; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int row = 16 * j + 2 * c4 + (q & 1) + 8 * (q >> 1);
                bs[j][q] = lds_u16(st + wbox_off + row * kCols + (lc ^ (((row >> 1) & 3) << 4)));
            }
        const uint64_t d_lo = desc_sw128(smem_u32(st)), d_hi = desc_sw128(smem_u32(st + kXBox));
#pragma unroll
        for (int j0 = 0; j0 < kSteps; j0 += kStepsPerGroup) {
            if (g32 && j0 == kSteps / 2) {  // the chunk's second group
                ++grp;
                start_group();
                if (c + 1 < c_end) load_raw(grp + 1);
            }
            uint32_t(&fb)[kStepsPerGroup][2][4] = frag[buf];
            // the A fragments of both halves of each step (0: low nibbles,
            // x's first half; 1: high): a0 column lc, k 2c4..+1; a1 column
            // lc+1; a2, a3 the same at k + 8
#pragma unroll
            for (int jj = 0; jj < kStepsPerGroup; ++jj) {
                const uint32_t* b = bs[j0 + jj];
                if (packed) {
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int q = 0; q < 2; ++q) {  // column lc: bytes 0; lc + 1: bytes 1
                            const uint32_t r0 = b[2 * q], r1 = b[2 * q + 1];
                            fb[jj][h][2 * q] =
                                deq2(prmt(r0, r1, 0x6420u) >> (4 * h), z2[h][0], s2[h][0]);
                            fb[jj][h][2 * q + 1] =
                                deq2(prmt(r0, r1, 0x7531u) >> (4 * h), z2[h][1], s2[h][1]);
                        }
                } else {
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int q = 0; q < 2; ++q) {
                            const uint32_t r0 = b[2 * q], r1 = b[2 * q + 1];
                            const int sh = 4 * h;
                            const float z0 = sz[2 * h + 1][0], s0_ = sz[2 * h][0];
                            const float z1 = sz[2 * h + 1][1], s1_ = sz[2 * h][1];
                            fb[jj][h][2 * q] = pack_bf16x2(deq((r0 >> sh) & 0xFu, z0, s0_),
                                                           deq((r1 >> sh) & 0xFu, z0, s0_));
                            fb[jj][h][2 * q + 1] =
                                pack_bf16x2(deq((r0 >> (8 + sh)) & 0xFu, z1, s1_),
                                            deq((r1 >> (8 + sh)) & 0xFu, z1, s1_));
                        }
                }
            }
            // one wgmma group: each step's low half, then its high half, all
            // NT tokens each (the summation order of every output)
            wgmma_fence();
#pragma unroll
            for (int jj = 0; jj < kStepsPerGroup; ++jj) {
                const uint64_t k_off = 2 * (j0 + jj);
                wgmma_rs<NT>(acc, fb[jj][0], d_lo + k_off);
                wgmma_rs<NT>(acc, fb[jj][1], d_hi + k_off);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the previous group is done: its fragments are free
#pragma unroll
            for (int jj = 0; jj < kStepsPerGroup; ++jj)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int i = 0; i < 4; ++i) fence_reg(frag[buf ^ 1][jj][h][i]);
            fence_bytes(bs);
            buf ^= 1;
            if (j0 == 0 && c > c_begin && lane == 0)
                mbar_arrive(smem_u32(empty + s_prev));  // all the previous stage's groups are done
        }
        s_prev = s;
        if (++s == stages) {
            s = 0;
            phase ^= 1;
        }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) fence_reg(acc[i]);

    // acc[4i + 2h + e]: column out_col + h, token s0 + 8i + 2c4 + e
    const int S = p.S, N = p.N;
    if (p.partial != nullptr || NW == 1) {
        const int r = NW == 1 ? 0 : wg;
#pragma unroll
        for (int i = 0; i < NT / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int tok = s0 + 8 * i + 2 * c4 + e;
                if (tok >= S || !col_ok) continue;
                const long long o = (long long)tok * N + out_col;
                const float v0 = acc[4 * i + e], v1 = acc[4 * i + 2 + e];
                if (p.partial != nullptr)
                    store2(p.partial, (long long)(kz * NW + r) * S * N + o, v0, v1, 0);
                else
                    store2(p.out, o, v0, v1, p.out_bf16);
            }
        return;
    }
    // fused, unsplit: the up sums pass to warpgroup 0 through the (drained)
    // ring, as [accumulator][thread] floats
    const uint32_t up = smem_u32(smem) + 4 * (tid & 127);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    if (wg == 1) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i)
            asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(up + 512 * i), "f"(acc[i]) : "memory");
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int tok = s0 + 8 * i + 2 * c4 + e;
            if (tok >= S || !col_ok) continue;
            const int k0 = 4 * i + e, k1 = 4 * i + 2 + e;
            store2(p.out, (long long)tok * N + out_col, silu_mul(acc[k0], lds_f32(up + 512 * k0)),
                   silu_mul(acc[k1], lds_f32(up + 512 * k1)), p.out_bf16);
        }
}

// partial [splits, NW, S, N]: sums over the splits in order, then the epilogue
template <int NW>
__global__ void w4a16_sum_partials(const float* __restrict__ partial, void* __restrict__ out,
                             long long count, int splits, int out_bf16) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
         i += (long long)gridDim.x * blockDim.x) {
        float s[NW];
#pragma unroll
        for (int r = 0; r < NW; ++r) s[r] = 0.f;
        for (int z = 0; z < splits; ++z)
#pragma unroll
            for (int r = 0; r < NW; ++r) s[r] += partial[(long long)(z * NW + r) * count + i];
        const float v = NW == 1 ? s[0] : silu_mul(s[0], s[NW - 1]);
        if (out_bf16)
            reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
        else
            reinterpret_cast<float*>(out)[i] = v;
    }
}

// the layered mode's index and stack depth (nullptr, 1 in plain mode)
struct Layer {
    const int* idx;
    int n;
};

template <int NT, int NW, bool G32>
int launch(const void* x, const void* w8, Params p, int splits, cudaStream_t st) {
    constexpr int kStage = 2 * NT * kRows * 2 + 2 * kWBox;
    // rows past S in a stage's x tiles are left as they were: they feed only
    // the accumulators of tokens past S, which are never stored
    p.x_rows = p.S < NT ? (p.S + 7) / 8 * 8 : NT;
    EncodeTiled encode = encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap tm_x, tm_w;
    {  // x [S, K] bf16: boxes of 64 k x x_rows tokens, 128-byte swizzle (the wgmma B layout)
        const cuuint64_t dims[2] = {(cuuint64_t)2 * p.K2, (cuuint64_t)p.S};
        const cuuint64_t strides[1] = {(cuuint64_t)2 * p.K2 * 2};
        const cuuint32_t box[2] = {kRows, (cuuint32_t)p.x_rows}, es[2] = {1, 1};
        if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
                   strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
            CUDA_SUCCESS)
            return (int)cudaErrorInvalidValue;
    }
    {  // w8 [n_layers, K2, ldw] bytes: boxes of 64 columns x 64 packed rows x 1 layer
        const cuuint64_t dims[3] = {(cuuint64_t)p.ldw, (cuuint64_t)p.K2, (cuuint64_t)p.n_layers};
        const cuuint64_t strides[2] = {(cuuint64_t)p.ldw, (cuuint64_t)p.ldw * p.K2};
        const cuuint32_t box[3] = {kCols, kRows, 1}, es[3] = {1, 1, 1};
        if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w8), dims, strides,
                   box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
            CUDA_SUCCESS)
            return (int)cudaErrorInvalidValue;
    }
    p.stages = (kSmemMax - 1024 - 256) / kStage;
    if (p.stages > kMaxStages) p.stages = kMaxStages;
    const int smem = 1024 + p.stages * kStage + 256;
    static unsigned configured = 0;  // one bit per device
    int dev = 0;
    cudaGetDevice(&dev);
    if (!(configured >> dev & 1u)) {
        cudaError_t e = cudaFuncSetAttribute(w4a16_kernel<NT, NW, G32>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        configured |= 1u << dev;
    }
    const int col_tiles = NW == 1 ? (p.N + 2 * kCols - 1) / (2 * kCols) : (p.N + kCols - 1) / kCols;
    const int super_tiles = (p.S + kMaxTok - 1) / kMaxTok;
    dim3 grid(col_tiles, super_tiles, splits);
    w4a16_kernel<NT, NW, G32><<<grid, kThreads, smem, st>>>(tm_x, tm_w, p);
    if (splits > 1) {
        const long long count = (long long)p.S * p.N;
        const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
        w4a16_sum_partials<NW><<<blocks, 256, 0, st>>>(p.partial, p.out, count, splits, p.out_bf16);
    }
    return (int)cudaGetLastError();
}

// the block's token width: the rows rounded up to 32 (S <= 32, the draft's
// levels) or to 64, at most 256
template <int NW, bool G32>
int launch_rows(const void* x, const void* w8, const Params& p, int splits, cudaStream_t st) {
    const int rows = p.S < kMaxTok ? p.S : kMaxTok;
    if (rows <= 32) return launch<32, NW, G32>(x, w8, p, splits, st);
    if (rows <= 64) return launch<64, NW, G32>(x, w8, p, splits, st);
    if (rows <= 128) return launch<128, NW, G32>(x, w8, p, splits, st);
    if (rows <= 192) return launch<192, NW, G32>(x, w8, p, splits, st);
    return launch<256, NW, G32>(x, w8, p, splits, st);
}

template <int NW>
int run(const void* x, const void* w8, const void* scales, const void* zeros, void* out,
        void* partial, int S, int K2, int N, int group_size, int splits, int x_bf16, int s_bf16,
        int out_bf16, Layer layer, void* stream) {
    if (S <= 0 || N <= 0) return 0;
    // TMA: 16-byte aligned bases and row strides; K2 in whole chunks of 64
    // packed rows, and a group is half a chunk or whole chunks
    if (!x_bf16 || group_size <= 0 || (group_size != kRows / 2 && group_size % kRows != 0) ||
        K2 % group_size != 0 || K2 % kRows != 0 ||
        (NW * N) % 16 != 0 || splits < 1 || (splits > 1 && partial == nullptr) || layer.n < 1 ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w8)) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.scales = scales;
    p.zeros = zeros;
    p.out = out;
    p.partial = splits > 1 ? (float*)partial : nullptr;
    p.layer_idx = layer.idx;
    p.n_layers = layer.n;
    p.S = S;
    p.K2 = K2;
    p.N = N;
    p.ldw = NW * N;
    p.group_size = group_size;
    p.n_chunks = K2 / kRows;
    p.chunks_per_split = (p.n_chunks + splits - 1) / splits;
    p.stages = 0;
    p.s_bf16 = s_bf16;
    p.out_bf16 = out_bf16;
    cudaStream_t st = (cudaStream_t)stream;
    return group_size == kRows / 2 ? launch_rows<NW, true>(x, w8, p, splits, st)
                                   : launch_rows<NW, false>(x, w8, p, splits, st);
}

}  // namespace

// x [S, 2*K2] bf16 (the wrapper rounds fp32 x once), w8 [K2, N] uint8,
// scales/zeros [2*K2/group_size, N] (fp32 or bf16, one dtype), out [S, N]
// (fp32 or bf16), partial fp32 [splits, S, N] scratch when splits > 1; all
// contiguous. group_size must be 32 or a multiple of 64, K2 a multiple of 64
// and of group_size, N a multiple of 16, and x and w8 16-byte aligned.
extern "C" int w4a16_matmul(const void* x, const void* w8, const void* scales, const void* zeros,
                            void* out, void* partial, int S, int K2, int N, int group_size,
                            int splits, int x_bf16, int s_bf16, int out_bf16, void* stream) {
    return run<1>(x, w8, scales, zeros, out, partial, S, K2, N, group_size, splits, x_bf16,
                  s_bf16, out_bf16, Layer{nullptr, 1}, stream);
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
                  s_bf16, out_bf16, Layer{nullptr, 1}, stream);
}
