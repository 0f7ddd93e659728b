// The int8 W4 kernels: per-row int8 activations times split-halves packed
// 4-bit weights (w8 [K/2, N] bytes; low nibble = logical row r, high nibble =
// row r + K/2; raw values 0..15), on int8 tensor cores. Two products:
//
// Int4F (rank-1 scales a [K], b [N]; the zero point 8 outside):
//   acc[s, n] = xq[s, :K/2] . lo[:, n] + xq[s, K/2:] . hi[:, n]        (int32)
//   y[s, n]   = float(acc[s, n] - 8 * rowsum[s]) * sx[s] * b[n]
// with xq = round(x * a / sx) quantized per row;
// AWQ W4A8 (scales and zeros [G, N] per group along the logical K):
//   p_g[s, n] = xq[s, group g] . nib_g[:, n]                             (int32)
//   acc[s, n] += (float(p_g) - float(rowsum_g[s]) * z_g[n]) * s_g[n]      (fp32)
//   y[s, n]   = acc[s, n] * sx[s]
// with xq = round(x / sx) per row, groups in order, the low half's group
// before the high half's, each multiply and add rounded on its own.
// And the per-row quantizer both take their xq, sx and row sums from.
//
// Replaces the TPU kernels umbrella_tpu/ops/pallas/w4a8f.py::w4a8f_matmul
// (_w4a8f_kernel) and umbrella_tpu/ops/pallas/w4a8.py::w4a8_matmul
// (_w4a8_kernel), and the activation quantization their jitted wrappers run
// before the kernel (w4a8f.py:105 quantize_activations_int8; w4a8.py:100-102).
// The plain versions (ops/kernels/w4a8f.py::w4a8f_matmul_ref,
// ops/kernels/w4a8.py::w4a8_matmul_ref, quantize_activations_int8,
// quantize_activations_w4a8 + group_rowsums) repeat the same operations, so
// the results are equal bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 TOP/s int8): the packed weights at
// decode sizes. The 8B lm_head [4096, 128256] streams 263 MB: 0.078 ms;
// its 2*S*K*N operations take 0.013 ms at S=24 and 0.067 ms at S=127. The 8B
// gate_up [4096, 28672]: 58.7 MB (+3.7 MB of g128 scales and zeros for AWQ),
// 0.019 ms.
//
// Design (Hopper: TMA, mbarriers, wgmma; sm_90a only), the shape of
// csrc/w4a16.cu:
// - A and B swapped: Y^T = W^T x^T. 8-bit wgmma reads B from shared memory
//   only K-major, which x [S, K] is (its own row-major layout), so x is B and
//   the tokens run along wgmma's N (m64nNk32, .s32.s8.s8). The weight, N-major
//   in memory, is the A operand from registers: each of two consumer
//   warpgroups owns 64 weight columns. A thread's A register holds 4
//   consecutive k of one column, which lie in 4 packed rows: four 16-bit
//   shared loads (the column pair of each row), two byte permutes (prmt)
//   transpose them into one word per column, and `& 0x0F0F0F0F` and
//   `>> 4 & 0x0F0F0F0F` give the low half's and the high half's fragments
//   (nibbles 0..15 as s8). The low nibbles multiply x[:, :K/2], the high
//   nibbles x[:, K/2:]. The fragment's M rows g and g + 8 stand for the
//   adjacent columns lc and lc + 1, so each thread stores column pairs.
// - A TMA ring: one producer thread keeps up to 8 stages in flight; a stage
//   holds 64 packed rows (two k32 steps): two 64 x 64 weight boxes (one per
//   consumer warpgroup) and the two matching x boxes, x[:, r0:r0+64] and
//   x[:, K/2+r0:K/2+r0+64], each of S rows rounded up to 8 (at most NT), all
//   four with the 64-byte swizzle; for AWQ also the low and high halves'
//   scale and zero rows of the groups that start in the stage. A stage's
//   products are one wgmma group (cut where an AWQ group ends), in flight
//   while the next stage's fragments are formed (double-buffered by stage
//   parity). setmaxnreg gives the consumers 232 registers, the producer 40.
// - Token width NT: S rounded up to 32 or to 64, at most 256 (Int4F) or 64
//   (AWQ: its two int32 product sets and the fp32 sums take 3 NT / 2
//   registers a thread). S beyond that takes super-tiles along the grid's x,
//   the fastest grid index, so the blocks of one column tile run together and
//   the weight comes from L2 after its first read.
// - Int4F: one int32 accumulator set over the whole K range (low and high
//   halves alike: integer sums are exact in any order); the epilogue applies
//   the row sum, sx and b.
// - AWQ: two int32 product sets, the low half's and the high half's; the
//   first step of a group overwrites them (wgmma's scale-d off), so nothing
//   zeroes them; after a group's last step the warpgroup waits for its
//   products and folds them into the fp32 sums in the plain version's order
//   (__fsub_rn, __fmul_rn, __fadd_rn, no FMA). From 64 tokens, integer zeros
//   in [0, 15] (every AWQ checkpoint) go into the fragment bytes as nibble -
//   z, so the product is the plain version's float(p) - rs * z exactly and the
//   fix-up is a multiply and an add; other zeros, and 32 tokens, take the row
//   sums. The two consumer
//   warpgroups interleave, so one's fix-up runs beside the other's products.
//   Any group size that is a multiple of 32 (a k32 step) and divides K/2.
// - Split K from the column tiles and K only (never S; the wrapper's plan,
//   build.split_k), each split whole groups and whole stages; partials (int32
//   for Int4F, fp32 for AWQ) are summed in split order by a second kernel,
//   which applies the epilogue. Results are row-invariant: a token's column
//   is computed alike at every token width and super-tile.
// - The quantizer: one block a row, in one launch: sx from the row's
//   max |x (* a)| times the fp32 reciprocal of 127 (as XLA compiles the JAX
//   package's `/ 127.0`), xq = clip(rint(x / sx), -127, 127), and the int32
//   row sums (Int4F: the whole row; AWQ: per group).
// What bounds it now: scripts/w4a8_breakdown.py times the kernel without its
// MMA, without AWQ's fix-ups, and the TMA stream alone; PERF.md has the
// numbers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;  // packed rows (K/2 direction) a stage: two k32 steps
constexpr int kCols = 64;  // weight columns a consumer warpgroup
constexpr int kConsumerThreads = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + a producer warpgroup (one thread issues)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWBox = kRows * kCols;  // bytes of one weight box
constexpr int kSmemMax = 232448;
constexpr int kMaxStages = 8;
constexpr int kBlockCols = 2 * kCols;  // weight columns a block
// AWQ scale rows a stage: a stage's two k32 steps start at most two groups
constexpr int kSzRows = 2;
constexpr int kSzBox = kSzRows * kBlockCols * 4;  // bytes of one scale box (fp32 at most)
// the first group that starts at or after chunk c's first step
__device__ __forceinline__ int first_group(int c, int group_size) {
    const int spg = group_size / 32;
    return (2 * c + spg - 1) / spg;
}
// AWQ group sizes up to this fold integer zero points into the weight bytes:
// |xq . (nibble - z)| <= 127 * 15 * 2048 < 2^22 (small_int_to_float), and the
// plain version's float(p) - rs * z is then exact
constexpr int kFoldMaxGroup = 2048;
// ... at token widths from this up: at 32 tokens the row-sum fix-up was the
// faster (scripts/w4a8_breakdown.py, no-fold; PERF.md)
constexpr int kFoldMinTokens = 64;

enum Mode { kInt4F = 0, kAwq = 1 };
// tokens a block: S up to this in one pass, super-tiles above
template <int MODE>
constexpr int kMaxTok = MODE == kInt4F ? 256 : 64;

struct Params {
    const float* sx;     // [S]
    const int* rowsum;   // Int4F [S]; AWQ [S, G]
    const float* b;      // Int4F: column factor [N]
    const void* scales;  // AWQ: [G, N], fp32 or bf16
    const void* zeros;
    void* out;      // [S, N], fp32 or bf16
    void* partial;  // [splits, S, N] int32 (Int4F) or fp32 (AWQ) when K is split, else null
    int S, K2, N, n_steps, n_chunks, chunks_per_split, stages, x_rows, group_size, G, s_bf16,
        out_bf16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
    uint16_t v;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
    return v;
}
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}
__device__ __forceinline__ float lds_f32(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
    return v;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// wgmma descriptor of a K-major 8-bit tile with 64-byte rows, 64-byte swizzle
// (8-row atoms 512 bytes apart)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps a register's value where it is until this point (the async wgmma
// reads A fragments and writes accumulators behind the compiler's back)
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// d[64 x NT int32] (+)= A[64 x 32 s8, registers] * B[32 x NT s8, shared]; keep
// = 0 overwrites d. d[4i + 2h + e] holds M row g + 8h, token 8i + 2c + e.
#define W4A8_D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define W4A8_D16(i) W4A8_D4(i), W4A8_D4(i + 4), W4A8_D4(i + 8), W4A8_D4(i + 12)
#define W4A8_D32(i) W4A8_D16(i), W4A8_D16(i + 16)
#define W4A8_D64(i) W4A8_D32(i), W4A8_D32(i + 32)
#define W4A8_D96(i) W4A8_D64(i), W4A8_D32(i + 64)
#define W4A8_D128(i) W4A8_D64(i), W4A8_D64(i + 64)
template <int NT>
__device__ __forceinline__ void wgmma_s8(int* d, const uint32_t* a, uint64_t desc_b, int keep);
template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, const uint32_t* a, uint64_t desc_b, int keep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : W4A8_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, const uint32_t* a, uint64_t desc_b, int keep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : W4A8_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, const uint32_t* a, uint64_t desc_b, int keep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : W4A8_D64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int* d, const uint32_t* a, uint64_t desc_b, int keep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p;\n}\n"
        : W4A8_D96(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, const uint32_t* a, uint64_t desc_b, int keep) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
        "}, {%128, %129, %130, %131}, %132, p;\n}\n"
        : W4A8_D128(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(keep));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
    return d;
}
// four packed rows' column pairs (r[i] = bytes of columns lc, lc + 1 of row
// i) -> one word a column: k = row, low byte first
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t& col0, uint32_t& col1) {
    const uint32_t p01 = prmt(r[0], r[1], 0x5410u), p23 = prmt(r[2], r[3], 0x5410u);
    col0 = prmt(p01, p23, 0x6420u);
    col1 = prmt(p01, p23, 0x7531u);
}

template <typename T>
__device__ __forceinline__ void store2(void* out, long long o, T a, T b, int is_bf16);
template <>
__device__ __forceinline__ void store2<float>(void* out, long long o, float a, float b,
                                              int is_bf16) {
    if (is_bf16)
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + o) =
            __floats2bfloat162_rn(a, b);
    else
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<int>(void* out, long long o, int a, int b, int) {
    *reinterpret_cast<int2*>(reinterpret_cast<int*>(out) + o) = make_int2(a, b);
}

// Int4F's epilogue: float(acc - 8 * rowsum) * sx * b, each product rounded
__device__ __forceinline__ float int4f_out(int acc, int rowsum, float sx, float b) {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc - 8 * rowsum), sx), b);
}
// four bytes of nibbles (0..15) minus z (0..15) in each byte, as s8: offset
// by 128 so that no byte borrows from the next
__device__ __forceinline__ uint32_t sub_bytes(uint32_t nib, uint32_t zz) {
    return ((nib | 0x80808080u) - zz) ^ 0x80808080u;
}
// an int of magnitude below 2^22 as float, exactly: 1.5 * 2^23 + v, then less
// 1.5 * 2^23 (two full-rate operations where a conversion is quarter-rate)
__device__ __forceinline__ float small_int_to_float(int v) {
    return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f);
}
// AWQ's fix-up of one group's product: acc + (float(p) - rs * z) * s
__device__ __forceinline__ float awq_fix(float acc, int p, float rs, float z, float s) {
    return __fadd_rn(acc, __fmul_rn(__fsub_rn(__int2float_rn(p), __fmul_rn(rs, z)), s));
}

template <int NT, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
w4a8_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_s, const __grid_constant__ CUtensorMap tm_z,
            const Params p) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~uintptr_t(1023));
    constexpr int kXBox = NT * kRows;  // one x half of a stage
    // AWQ: the scale and zero rows of the groups that start in the stage
    constexpr int kSzBytes = MODE == kAwq ? 4 * kSzBox : 0;
    constexpr int kStage = 2 * kXBox + 2 * kWBox + kSzBytes;  // multiple of 1024
    constexpr int kAcc = NT / 2;                   // accumulators a thread
    const int stages = p.stages;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStage);
    uint64_t* empty = full + kMaxStages;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(smem_u32(full + s), 1);
            mbar_init(smem_u32(empty + s), kConsumerThreads / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int s0 = blockIdx.x * kMaxTok<MODE>, bx = blockIdx.y, kz = blockIdx.z;
    const int c_begin = kz * p.chunks_per_split;
    const int c_end = min(p.n_chunks, c_begin + p.chunks_per_split);

    if (warp >= kConsumerThreads / 32) {  // producer warpgroup: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (warp == kConsumerThreads / 32 && lane == 0) {
            const uint32_t bytes = 2 * p.x_rows * kRows + 2 * kWBox;
            const uint32_t sz_bytes = 4 * kSzRows * kBlockCols * (p.s_bf16 ? 2 : 4);
            int s = 0;
            uint32_t phase = 0;
            for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
                if (it >= stages) mbar_wait(smem_u32(empty + s), phase ^ 1);
                uint8_t* st = smem + s * kStage;
                const uint32_t bar = smem_u32(full + s);
                // AWQ: a group starts in this stage (step 2c or 2c + 1): its rows
                // (and the next one's) of the low and high scales and zeros
                const bool starts = MODE == kAwq && first_group(c, p.group_size) * (p.group_size / 32) <=
                                                        2 * c + 1;
                mbar_expect_tx(bar, bytes + (starts ? sz_bytes : 0));
                if (starts) {
                    const int g0 = first_group(c, p.group_size), col0 = bx * kBlockCols;
                    uint8_t* sz = st + 2 * kXBox + 2 * kWBox;
                    tma_2d(smem_u32(sz), &tm_s, bar, col0, g0);
                    tma_2d(smem_u32(sz + kSzBox), &tm_z, bar, col0, g0);
                    tma_2d(smem_u32(sz + 2 * kSzBox), &tm_s, bar, col0, p.G / 2 + g0);
                    tma_2d(smem_u32(sz + 3 * kSzBox), &tm_z, bar, col0, p.G / 2 + g0);
                }
                tma_2d(smem_u32(st), &tm_x, bar, c * kRows, s0);
                tma_2d(smem_u32(st + kXBox), &tm_x, bar, p.K2 + c * kRows, s0);
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    tma_2d(smem_u32(st + 2 * kXBox + r * kWBox), &tm_w, bar,
                           bx * 2 * kCols + r * kCols, c * kRows);
                if (++s == stages) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

    // consumer warpgroup wg; in its A fragment this thread holds M rows g and
    // g + 8 of warp w's 16, which stand for the adjacent weight columns lc and
    // lc + 1 (the permutation the epilogue undoes)
    const int wg = warp >> 2, w = warp & 3, c4 = lane & 3, g = lane >> 2;
    const int lc = 16 * w + 2 * g;
    const int col = bx * 2 * kCols + wg * kCols + lc;
    const bool col_ok = col < p.N;
    // this thread's two bytes of packed row r in its weight box: r * 64 + (lc
    // ^ (((r / 2) % 4) << 4)) (the 64-byte swizzle: 16-byte chunk ^= (r / 2) % 4)
    const uint32_t wbox = smem_u32(smem) + 2 * kXBox + wg * kWBox;

    // Int4F: acc is the int32 sum (zeroed before the first wgmma.fence: a
    // register write inside a wgmma pipeline stage makes ptxas serialize).
    // AWQ: plo/phi are the current group's int32 products, facc the fp32 sums.
    int acc[kAcc], phi[MODE == kAwq ? kAcc : 1];
    float facc[MODE == kAwq ? kAcc : 1];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
        acc[i] = 0;
        fence_reg(acc[i]);
    }
#pragma unroll
    for (int i = 0; i < (MODE == kAwq ? kAcc : 1); ++i) facc[i] = 0.f;
    int* plo = acc;

    // AWQ: the group of the first step and the steps left in it
    const int spg = p.group_size / 32, G2 = p.G / 2;
    int grp = (2 * c_begin) / (spg > 0 ? spg : 1), left = spg;
    // the scales and zeros of group gi, which starts in the stage at st, for
    // the thread's two columns as floats: sz[lo s, lo z, hi s, hi z][column]
    auto scales_of = [&](const uint8_t* st, int c, int gi, float(&sz)[4][2]) {
        const int e = (gi - first_group(c, p.group_size)) * kBlockCols + wg * kCols + lc;
        const uint32_t base = smem_u32(st + 2 * kXBox + 2 * kWBox);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // boxes: lo s, lo z, hi s, hi z
            if (p.s_bf16) {  // both columns' bf16 in one 32-bit load
                const uint32_t v = lds_u32(base + i * kSzBox + 2 * e);
                sz[i][0] = __uint_as_float(v << 16);
                sz[i][1] = __uint_as_float(v & 0xFFFF0000u);
            } else {
                sz[i][0] = lds_f32(base + i * kSzBox + 4 * e);
                sz[i][1] = lds_f32(base + i * kSzBox + 4 * e + 4);
            }
        }
    };
    // whether the group's zero points go into the A fragments (`fold`: both
    // columns' zeros of both halves are integers in [0, 15]), and then z in
    // each byte, zz[half][column] (0 without fold)
    struct Zeros {
        uint32_t zz[2][2];
        bool fold;
    };
    auto zeros_of = [&](const float(&sz)[4][2]) {
        Zeros z;
        z.fold = NT >= kFoldMinTokens && p.group_size <= kFoldMaxGroup;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
                const float v = sz[2 * h + 1][cc];
                z.fold = z.fold && v == rintf(v) && v >= 0.f && v <= 15.f;
            }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
                z.zz[h][cc] = z.fold ? (uint32_t)sz[2 * h + 1][cc] * 0x01010101u : 0u;
        return z;
    };
    Zeros zcur = {};       // the zeros of the group in progress
    float sz[4][2], sz_next[4][2];  // its scales and zeros, and the next group's
    // folds the group's products into facc: per output the low half's group,
    // then the high half's
    auto fix_up = [&](bool fold) {
        if (fold) {  // p = xq . (nib - z) = float(p) - rs * z, exactly
#pragma unroll
            for (int k = 0; k < kAcc; ++k) {
                const int h = (k >> 1) & 1;
                facc[k] = __fadd_rn(__fadd_rn(facc[k], __fmul_rn(small_int_to_float(plo[k]),
                                                                 sz[0][h])),
                                    __fmul_rn(small_int_to_float(phi[k]), sz[2][h]));
            }
            return;
        }
#pragma unroll
        for (int i = 0; i < NT / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                // tokens past S read row S - 1: their sums are never stored
                const int tok = min(s0 + 8 * i + 2 * c4 + e, p.S - 1);
                const int* rs = p.rowsum + (long long)tok * p.G + grp;
                const float rl = __int2float_rn(__ldg(rs)), rh = __int2float_rn(__ldg(rs + G2));
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int k = 4 * i + 2 * h + e;
                    facc[k] = awq_fix(awq_fix(facc[k], plo[k], rl, sz[1][h], sz[0][h]), phi[k], rh,
                                      sz[3][h], sz[2][h]);
                }
            }
    };

    // the A fragments of a stage's two steps, double-buffered by stage:
    // [stage parity][step][half][register]. The parity is a compile-time index
    // (the stage loop is unrolled by two): a run-time one would put the
    // fragments in local memory.
    uint32_t frag[2][2][2][4];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int i = 0; i < 4; ++i) frag[b][j][h][i] = 0u;

    const int t_end = min(p.n_steps, 2 * c_end);
    int s = 0, s_prev = 0;
    uint32_t phase = 0;
    // one stage: its products are one wgmma group (cut where an AWQ group
    // ends), in flight while the next stage's fragments are formed. Both
    // steps' fragments are formed before the group starts: ptxas serializes
    // wgmma where an input register is written inside a group.
    auto stage = [&](auto parity, int c) {
        constexpr int B = decltype(parity)::value;
        mbar_wait(smem_u32(full + s), phase);
        // the stage's words of this thread: [step][a register], each 4 k of one
        // column (a0: column lc, k 4c4..+3; a1: lc + 1; a2, a3: the same at k + 16)
        uint32_t wd[2][4];
        const uint32_t wst = wbox + s * kStage;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                uint32_t r[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int row = 32 * j + 16 * q + 4 * c4 + i;
                    r[i] = lds_u16(wst + row * kCols + (lc ^ (((row >> 1) & 3) << 4)));
                }
                transpose4(r, wd[j][2 * q], wd[j][2 * q + 1]);
            }
        const uint32_t xst = smem_u32(smem + s * kStage);
        const uint64_t d_lo = desc_sw64(xst), d_hi = desc_sw64(xst + kXBox);
        // both steps' fragments first (0: low nibbles, x's first half; 1: high),
        // the zero points of each step's group folded in (AWQ)
        Zeros zs[2];
        if (MODE == kAwq) {
            const uint8_t* st = smem + s * kStage;
            if (left == spg) {  // step 0 starts a group
                scales_of(st, c, grp, sz);
                zcur = zeros_of(sz);
            }
            zs[0] = zcur;
            if (left == 1 && 2 * c + 1 < t_end) {  // step 0 ends it: step 1 starts the next
                scales_of(st, c, grp + 1, sz_next);
                zs[1] = zeros_of(sz_next);
            } else {
                zs[1] = zcur;
            }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (MODE == kAwq) {  // nibble - z per byte (registers 0, 2: column lc)
                    frag[B][j][0][i] = sub_bytes(wd[j][i] & 0x0F0F0F0Fu, zs[j].zz[0][i & 1]);
                    frag[B][j][1][i] = sub_bytes((wd[j][i] >> 4) & 0x0F0F0F0Fu, zs[j].zz[1][i & 1]);
                } else {
                    frag[B][j][0][i] = wd[j][i] & 0x0F0F0F0Fu;
                    frag[B][j][1][i] = (wd[j][i] >> 4) & 0x0F0F0F0Fu;
                }
            }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            uint32_t(&f)[2][4] = frag[B][j];
            if (MODE == kInt4F) {
                wgmma_s8<NT>(acc, f[0], d_lo + 2 * j, 1);
                wgmma_s8<NT>(acc, f[1], d_hi + 2 * j, 1);
                continue;
            }
            if (2 * c + j >= t_end) continue;  // K/2 ends half-way through the stage
            const int keep = left != spg;       // a group's first step overwrites
            wgmma_s8<NT>(plo, f[0], d_lo + 2 * j, keep);
            wgmma_s8<NT>(phi, f[1], d_hi + 2 * j, keep);
            if (--left == 0) {  // the group's last step: fold its products in
                wgmma_commit();
                wgmma_wait<0>();
#pragma unroll
                for (int i = 0; i < kAcc; ++i) {
                    fence_reg(plo[i]);
                    fence_reg(phi[i]);
                }
                fix_up(zs[j].fold);
                ++grp;
                left = spg;
                if (j == 0) {  // the next group starts at step 1
#pragma unroll
                    for (int i = 0; i < 4; ++i) sz[i][0] = sz_next[i][0], sz[i][1] = sz_next[i][1];
                    zcur = zs[1];
                }
                wgmma_fence();
            }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: its fragments are free
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int i = 0; i < 4; ++i) fence_reg(frag[B ^ 1][j][h][i]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) fence_reg(wd[j][i]);
        if (c > c_begin && lane == 0) mbar_arrive(smem_u32(empty + s_prev));
        s_prev = s;
        if (++s == stages) {
            s = 0;
            phase ^= 1;
        }
    };
    // parity 0 always follows parity 1 (or nothing): with a conditional second
    // stage in the loop, ptxas could not tell the buffers apart and serialized
    int c = c_begin;
    for (; c + 1 < c_end; c += 2) {
        stage(std::integral_constant<int, 0>{}, c);
        stage(std::integral_constant<int, 1>{}, c + 1);
    }
    if (c < c_end) stage(std::integral_constant<int, 0>{}, c);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_reg(acc[i]);

    // acc[4i + 2h + e]: column col + h, token s0 + 8i + 2c4 + e
    const int S = p.S, N = p.N;
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int tok = s0 + 8 * i + 2 * c4 + e;
            if (tok >= S || !col_ok) continue;
            const long long o = (long long)tok * N + col;
            const int k0 = 4 * i + e, k1 = 4 * i + 2 + e;
            if (MODE == kInt4F) {
                if (p.partial != nullptr) {
                    store2<int>(p.partial, (long long)kz * S * N + o, acc[k0], acc[k1], 0);
                } else {
                    const int rs = p.rowsum[tok];
                    const float sx = p.sx[tok];
                    store2<float>(p.out, o, int4f_out(acc[k0], rs, sx, p.b[col]),
                                  int4f_out(acc[k1], rs, sx, p.b[col + 1]), p.out_bf16);
                }
            } else if (p.partial != nullptr) {
                store2<float>(p.partial, (long long)kz * S * N + o, facc[k0], facc[k1], 0);
            } else {
                const float sx = p.sx[tok];
                store2<float>(p.out, o, __fmul_rn(facc[k0], sx), __fmul_rn(facc[k1], sx),
                              p.out_bf16);
            }
        }
}

__device__ __forceinline__ void store1(void* out, long long i, float v, int out_bf16) {
    if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
    else
        reinterpret_cast<float*>(out)[i] = v;
}

// partial [splits, S, N]: sums over the splits in order, then the epilogue
template <int MODE>
__global__ void w4a8_sum_partials(const void* __restrict__ partial, Params p, int splits) {
    const long long count = (long long)p.S * p.N;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
         i += (long long)gridDim.x * blockDim.x) {
        const int tok = (int)(i / p.N), n = (int)(i % p.N);
        if (MODE == kInt4F) {
            const int* part = reinterpret_cast<const int*>(partial);
            int acc = 0;
            for (int z = 0; z < splits; ++z) acc += part[z * count + i];
            store1(p.out, i, int4f_out(acc, p.rowsum[tok], p.sx[tok], p.b[n]), p.out_bf16);
        } else {
            const float* part = reinterpret_cast<const float*>(partial);
            float acc = 0.f;
            for (int z = 0; z < splits; ++z) acc = __fadd_rn(acc, part[z * count + i]);
            store1(p.out, i, __fmul_rn(acc, p.sx[tok]), p.out_bf16);
        }
    }
}

// One block a row: sx = max(max |x (* a)|, 1e-8) * (1 / 127) in fp32, xq =
// clip(rint(x (* a) / sx), -127, 127), and the row's int32 sums of xq per group
// of group_size (G = K / group_size groups; Int4F: one group).
template <bool X_BF16, bool HAS_A>
__global__ void __launch_bounds__(256)
quantize_rows(const void* __restrict__ x, const float* __restrict__ a, int8_t* __restrict__ xq,
              float* __restrict__ sx, int* __restrict__ rowsum, int K, int group_size, int G) {
    extern __shared__ int gsum[];  // [G]
    __shared__ float red[8];
    const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long base = (long long)row * K;
    auto load = [&](int k) {
        const float v = X_BF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[base + k])
                               : reinterpret_cast<const float*>(x)[base + k];
        return HAS_A ? __fmul_rn(v, a[k]) : v;
    };
    float m = 0.f;
    for (int k = tid; k < K; k += 256) m = fmaxf(m, fabsf(load(k)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    if (lane == 0) red[warp] = m;
    for (int i = tid; i < G; i += 256) gsum[i] = 0;
    __syncthreads();
    m = red[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) m = fmaxf(m, red[i]);
    const float s = __fmul_rn(fmaxf(m, 1e-8f), 1.0f / 127.0f);
    if (tid == 0) sx[row] = s;
    // K is a multiple of 64, so a warp's 32 consecutive k lie in one group
    for (int k = tid; k < K; k += 256) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(load(k), s)), -127.f), 127.f);
        const int qi = (int)q;
        xq[base + k] = (int8_t)qi;
        const int sum = __reduce_add_sync(0xFFFFFFFFu, qi);
        if (lane == 0) atomicAdd(&gsum[(k - lane) / group_size], sum);
    }
    __syncthreads();
    for (int i = tid; i < G; i += 256) rowsum[(long long)row * G + i] = gsum[i];
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver that the runtime already loaded
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
    }
    return fn;
}

// a 2-D tensor [rows, cols] (row stride cols) of bytes (64-byte swizzle),
// bf16 or fp32 (no swizzle), boxes of box_cols x box_rows, zero fill out of
// bounds
bool encode_2d(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type, const void* base,
               int rows, int cols, int box_cols, int box_rows) {
    const int esize = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1
                      : type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 4;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, es[2] = {1, 1};
    return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, es,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  esize == 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT, int MODE>
int launch(const void* xq, const void* w8, Params p, int splits, cudaStream_t st) {
    constexpr int kStage = 2 * NT * kRows + 2 * kWBox + (MODE == kAwq ? 4 * kSzBox : 0);
    // rows past S in a stage's x tiles are left as they were: they feed only
    // the accumulators of tokens past S, which are never stored
    p.x_rows = p.S < NT ? (p.S + 7) / 8 * 8 : NT;
    EncodeTiled encode = encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    CUtensorMap tm_x, tm_w, tm_s, tm_z;
    if (!encode_2d(encode, &tm_x, u8, xq, p.S, 2 * p.K2, kRows, p.x_rows) ||
        !encode_2d(encode, &tm_w, u8, w8, p.K2, p.N, kCols, kRows))
        return (int)cudaErrorInvalidValue;
    if (MODE == kAwq) {  // scales and zeros [G, N]: boxes of a block's columns x kSzRows groups
        const CUtensorMapDataType t =
            p.s_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
        if (!encode_2d(encode, &tm_s, t, p.scales, p.G, p.N, kBlockCols, kSzRows) ||
            !encode_2d(encode, &tm_z, t, p.zeros, p.G, p.N, kBlockCols, kSzRows))
            return (int)cudaErrorInvalidValue;
    } else {
        tm_s = tm_z = tm_w;  // not read
    }
    p.stages = (kSmemMax - 1024 - 256) / kStage;
    if (p.stages > kMaxStages) p.stages = kMaxStages;
    const int smem = 1024 + p.stages * kStage + 256;
    static unsigned configured = 0;  // one bit per device
    int dev = 0;
    cudaGetDevice(&dev);
    if (!(configured >> dev & 1u)) {
        cudaError_t e = cudaFuncSetAttribute(w4a8_kernel<NT, MODE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        configured |= 1u << dev;
    }
    const int col_tiles = (p.N + kBlockCols - 1) / kBlockCols;
    const int super_tiles = (p.S + kMaxTok<MODE> - 1) / kMaxTok<MODE>;
    dim3 grid(super_tiles, col_tiles, splits);
    w4a8_kernel<NT, MODE><<<grid, kThreads, smem, st>>>(tm_x, tm_w, tm_s, tm_z, p);
    if (splits > 1) {
        const long long count = (long long)p.S * p.N;
        const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
        void* part = p.partial;
        p.partial = nullptr;
        w4a8_sum_partials<MODE><<<blocks, 256, 0, st>>>(part, p, splits);
    }
    return (int)cudaGetLastError();
}

// the block's token width: the rows rounded up to 32 (S <= 32, the draft's
// levels) or to 64, at most kMaxTok
template <int MODE>
int launch_rows(const void* xq, const void* w8, const Params& p, int splits, cudaStream_t st) {
    const int rows = p.S < kMaxTok<MODE> ? p.S : kMaxTok<MODE>;
    if (rows <= 32) return launch<32, MODE>(xq, w8, p, splits, st);
    if constexpr (MODE == kAwq) {
        return launch<64, MODE>(xq, w8, p, splits, st);
    } else {
        if (rows <= 64) return launch<64, MODE>(xq, w8, p, splits, st);
        if (rows <= 128) return launch<128, MODE>(xq, w8, p, splits, st);
        if (rows <= 192) return launch<192, MODE>(xq, w8, p, splits, st);
        return launch<256, MODE>(xq, w8, p, splits, st);
    }
}

template <int MODE>
int run(Params p, const void* xq, const void* w8, int splits, int chunks_per_split,
        void* stream) {
    if (p.S <= 0 || p.N <= 0) return 0;
    p.n_steps = p.K2 / 32;
    p.n_chunks = (p.K2 + kRows - 1) / kRows;
    p.chunks_per_split = chunks_per_split;
    // TMA: 16-byte aligned bases and row strides; K/2 in whole k32 steps; each
    // split whole stages (and, for AWQ, whole groups); the splits cover K
    if (p.K2 <= 0 || p.K2 % 32 != 0 || p.N % 16 != 0 || splits < 1 || chunks_per_split < 1 ||
        (long long)splits * chunks_per_split < p.n_chunks ||
        (long long)(splits - 1) * chunks_per_split >= p.n_chunks ||
        (splits > 1 && p.partial == nullptr) ||
        (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(w8)) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (MODE == kAwq && (p.group_size <= 0 || p.group_size % 32 != 0 || p.K2 % p.group_size != 0 ||
                         p.G != 2 * (p.K2 / p.group_size) ||
                         (2 * chunks_per_split) % (p.group_size / 32) != 0 ||
                         (reinterpret_cast<uintptr_t>(p.scales) |
                          reinterpret_cast<uintptr_t>(p.zeros)) % 16 != 0))
        return (int)cudaErrorInvalidValue;
    if (splits == 1) p.partial = nullptr;
    return launch_rows<MODE>(xq, w8, p, splits, (cudaStream_t)stream);
}

}  // namespace

// xq int8 [S, 2*K2] (16-byte aligned), sx fp32 [S], rowsum int32 [S] (from
// w4a8_quantize), w8 [K2, N] bytes (16-byte aligned), b fp32 [N], out [S, N]
// fp32 or bf16, partial int32 [splits, S, N] scratch when splits > 1; all
// contiguous. K2 a multiple of 32, N of 16; split z takes the stages of 64
// packed rows [z * chunks_per_split, (z + 1) * chunks_per_split).
extern "C" int w4a8f_matmul(const void* xq, const void* sx, const void* rowsum, const void* w8,
                            const void* b, void* out, void* partial, int S, int K2, int N,
                            int splits, int chunks_per_split, int out_bf16, void* stream) {
    Params p = {};
    p.sx = (const float*)sx;
    p.rowsum = (const int*)rowsum;
    p.b = (const float*)b;
    p.out = out;
    p.partial = partial;
    p.S = S;
    p.K2 = K2;
    p.N = N;
    p.group_size = 2 * K2;
    p.G = 1;
    p.out_bf16 = out_bf16;
    return run<kInt4F>(p, xq, w8, splits, chunks_per_split, stream);
}

// As w4a8f_matmul, with rowsum int32 [S, G] (per group of group_size along the
// logical K), scales and zeros [G, N] (fp32 or bf16, one dtype), partial fp32
// [splits, S, N]. group_size a multiple of 32 that divides K2; a split holds
// whole groups.
extern "C" int w4a8_matmul(const void* xq, const void* sx, const void* rowsum, const void* w8,
                           const void* scales, const void* zeros, void* out, void* partial, int S,
                           int K2, int N, int group_size, int splits, int chunks_per_split,
                           int s_bf16, int out_bf16, void* stream) {
    Params p = {};
    p.sx = (const float*)sx;
    p.rowsum = (const int*)rowsum;
    p.scales = scales;
    p.zeros = zeros;
    p.out = out;
    p.partial = partial;
    p.S = S;
    p.K2 = K2;
    p.N = N;
    p.group_size = group_size;
    p.G = group_size > 0 ? 2 * K2 / group_size : 0;
    p.s_bf16 = s_bf16;
    p.out_bf16 = out_bf16;
    return run<kAwq>(p, xq, w8, splits, chunks_per_split, stream);
}

// x [S, K] fp32 or bf16, a fp32 [K] or null (Int4F: x * a is quantized), xq
// int8 [S, K], sx fp32 [S], rowsum int32 [S, K / group_size]; K a multiple of
// 64, group_size a multiple of 32 that divides K.
extern "C" int w4a8_quantize(const void* x, const void* a, void* xq, void* sx, void* rowsum,
                             int S, int K, int group_size, int x_bf16, void* stream) {
    if (S <= 0) return 0;
    if (K <= 0 || K % 64 != 0 || group_size <= 0 || group_size % 32 != 0 || K % group_size != 0)
        return (int)cudaErrorInvalidValue;
    const int G = K / group_size;
    const size_t smem = (size_t)G * sizeof(int);
    cudaStream_t st = (cudaStream_t)stream;
    const float* af = (const float*)a;
    int8_t* q = (int8_t*)xq;
    if (x_bf16 && a != nullptr)
        quantize_rows<true, true><<<S, 256, smem, st>>>(x, af, q, (float*)sx, (int*)rowsum, K,
                                                         group_size, G);
    else if (x_bf16)
        quantize_rows<true, false><<<S, 256, smem, st>>>(x, af, q, (float*)sx, (int*)rowsum, K,
                                                          group_size, G);
    else if (a != nullptr)
        quantize_rows<false, true><<<S, 256, smem, st>>>(x, af, q, (float*)sx, (int*)rowsum, K,
                                                          group_size, G);
    else
        quantize_rows<false, false><<<S, 256, smem, st>>>(x, af, q, (float*)sx, (int*)rowsum, K,
                                                           group_size, G);
    return (int)cudaGetLastError();
}
