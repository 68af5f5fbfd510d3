// Sliding rangeBetween(-w, +wa) statistics on packed [K, L] series.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_window.py:_make_kernel
// over _window_math (through _call: range_stats_unrolled[_packed] and
// range_stats_stream[_packed]).  One kernel serves both the unrolled and
// the runtime-width forms: the row bounds (mb behind, ma ahead) and the
// key windows (w, wa) arrive as scalars.  One block per series row; the
// block reads the row's key plane once and walks the C packed columns.
// For each column it reduces the per-row centre, then one thread per
// output lane loops j = 1..mb behind and 1..ma ahead and reproduces
// _window_math's op sequence: validity folded into the s_lo / s_hi keys,
// the forward bound saturated at BIG-1, sums and min/max accumulated on
// centred values with the centre added back, and the `clipped` audit
// (reduced to one count per row and column).  The accumulator lines use
// round-to-nearest intrinsics (and the build passes -fmad=false), so no
// multiply-add is contracted: count and clipped are bitwise equal to the
// Pallas kernel, the rest differ only through the centre's summation
// order.
//
// Two forms, picked on the host by ops/stream.range_plan:
//
// * the row form (range_stats_kernel): each lane reads its neighbours
//   from global memory (through L1);
// * the staged form (range_stats_ring_kernel): the block walks
//   (column, lane tile) items; each tile of T lanes, with the halo of
//   mb + 1 lanes behind and ma + 1 ahead that its lanes and their clip
//   audit read, streams through ring.cuh's staging ring (keys, x, valid),
//   and the same per-lane code (range_lane) reads it from shared memory.
//   The centre is reduced from global memory at a column's first tile in
//   the row form's order, so both forms give the same bits.  Where the
//   halo makes no slot fit (row extents of about 12,600 rows and more),
//   the planner takes the row form.
//
// Bound on H100: bytes.  Each lane reads its key, value and validity once
// and writes seven f32 stat planes; the (mb + ma) neighbour reads per lane
// hit L1, and the arithmetic, ~10 flops per neighbour, stays far below
// the f32 rate at the windows the frame layer derives (tens of rows).
#include "common.cuh"
#include "ring.cuh"

#include <limits.h>

namespace {

constexpr int kStatsThreads = 256;

// Lanes of a row in global memory: lane p at index p.
struct RowLanes {
    const int32_t* s;
    const float* x;
    const uint8_t* v;
    __device__ __forceinline__ int32_t key(int p) const { return s[p]; }
    __device__ __forceinline__ float val(int p) const { return x[p]; }
    __device__ __forceinline__ bool ok(int p) const { return v[p] != 0; }
};

// Lanes [lo, hi) of a row staged in a ring slot: lane p at index p - lo.
struct SlotLanes {
    const int32_t* s;
    const float* x;
    const uint8_t* v;
    int lo;
    __device__ __forceinline__ int32_t key(int p) const { return s[p - lo]; }
    __device__ __forceinline__ float val(int p) const { return x[p - lo]; }
    __device__ __forceinline__ bool ok(int p) const { return v[p - lo] != 0; }
};

struct RangeParams {
    int w, wa, mb_loop, ma_loop, jb_behind, jb_ahead, L;
    size_t stat_plane;
};

__device__ __forceinline__ RangeParams range_params(int w, int wa, int mb, int ma, int C, int K,
                                                    int L) {
    // a bound >= L has no row beyond it
    return {w, wa, min(mb, L - 1), min(ma, L - 1), mb >= L - 1 ? L : mb + 1,
            ma >= L - 1 ? L : ma + 1, L, (size_t)C * K * L};
}

// The row's centre of column (x, valid) under `sc`: lane-strided sums over
// the block, then block_sum.
__device__ __forceinline__ float range_center(const float* xr, const uint8_t* vr, float sc,
                                              int L, float* shf) {
    float nv = 0.f, sx = 0.f;
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        if (vr[i]) {
            nv = __fadd_rn(nv, 1.f);
            sx = __fadd_rn(sx, __fmul_rn(xr[i], sc));
        }
    }
    nv = block_sum(nv, shf);
    sx = block_sum(sx, shf);
    return __fdiv_rn(sx, fmaxf(nv, 1.f));
}

// Lane i's seven stats, written at out[o + i] (+ s * stat_plane); returns
// its clip flag.
template <class Lanes>
__device__ __forceinline__ bool range_lane(const Lanes& in, int i, float sc, float center,
                                           const RangeParams& q, float* out, size_t o) {
    const int32_t BIG = INT_MAX;
    const float INF = __int_as_float(0x7f800000);
    const float NaN = tempo_nan();
    const int L = q.L;
    // centred value of row p: valid ? x*scale - center : 0
    auto centred = [&](int p) -> float {
        return in.ok(p) ? __fsub_rn(__fmul_rn(in.val(p), sc), center) : 0.f;
    };
    const int32_t si = in.key(i);
    const bool vi = in.ok(i);
    const float xi = __fmul_rn(in.val(i), sc);
    const int32_t lo = wrap_sub(si, q.w);
    const int32_t hi = min(wrap_add(si, min(q.wa, wrap_sub(BIG, si))), BIG - 1);

    const float xc = centred(i);
    float cnt = vi ? 1.f : 0.f;
    float s1 = xc;
    float s2 = __fmul_rn(xc, xc);
    float mn = vi ? xc : INF;
    float mx = vi ? xc : -INF;
    for (int j = 1; j <= q.mb_loop; ++j) {
        bool inw = false;
        float xj = 0.f;
        if (j <= i) {
            const int p = i - j;
            const int32_t s_lo = in.ok(p) ? in.key(p) : INT_MIN;
            inw = s_lo >= lo;
            xj = centred(p);
        }
        cnt = __fadd_rn(cnt, inw ? 1.f : 0.f);
        s1 = __fadd_rn(s1, inw ? xj : 0.f);
        s2 = __fadd_rn(s2, inw ? __fmul_rn(xj, xj) : 0.f);
        mn = min_nan(mn, inw ? xj : INF);
        mx = max_nan(mx, inw ? xj : -INF);
    }
    for (int j = 1; j <= q.ma_loop; ++j) {
        bool inw = false;
        float xj = 0.f;
        if (i < L - j) {
            const int p = i + j;
            const int32_t s_hi = in.ok(p) ? in.key(p) : BIG;
            inw = s_hi <= hi;
            xj = centred(p);
        }
        cnt = __fadd_rn(cnt, inw ? 1.f : 0.f);
        s1 = __fadd_rn(s1, inw ? xj : 0.f);
        s2 = __fadd_rn(s2, inw ? __fmul_rn(xj, xj) : 0.f);
        mn = min_nan(mn, inw ? xj : INF);
        mx = max_nan(mx, inw ? xj : -INF);
    }

    const float cnt1 = fmaxf(cnt, 1.f);
    const float mean = cnt > 0.f ? __fadd_rn(__fdiv_rn(s1, cnt1), center) : NaN;
    const float total = __fadd_rn(s1, __fmul_rn(cnt, center));
    const float var = cnt > 1.f
        ? __fdiv_rn(__fsub_rn(s2, __fdiv_rn(__fmul_rn(s1, s1), cnt1)),
                    fmaxf(__fsub_rn(cnt, 1.f), 1.f))
        : NaN;
    const float sd = cnt > 1.f ? __fsqrt_rn(max_nan(var, 0.f)) : NaN;
    const size_t at = o + i;
    const size_t sp = q.stat_plane;
    out[0 * sp + at] = mean;
    out[1 * sp + at] = cnt;
    out[2 * sp + at] = cnt > 0.f ? __fadd_rn(mn, center) : NaN;
    out[3 * sp + at] = cnt > 0.f ? __fadd_rn(mx, center) : NaN;
    out[4 * sp + at] = cnt > 0.f ? total : NaN;
    out[5 * sp + at] = sd;
    out[6 * sp + at] = vi ? __fdiv_rn(__fsub_rn(xi, mean), sd) : NaN;

    // truncation audit: the first row beyond either bound still in
    // the frame's key range, with either end valid
    bool clip = false;
    {
        int32_t sj = BIG;
        bool vj = false;
        if (i >= q.jb_behind) { sj = in.key(i - q.jb_behind); vj = in.ok(i - q.jb_behind); }
        clip |= (sj >= lo) && (sj <= hi) && (vi || vj);
    }
    {
        int32_t sj = BIG;
        bool vj = false;
        if (i < L - q.jb_ahead) { sj = in.key(i + q.jb_ahead); vj = in.ok(i + q.jb_ahead); }
        clip |= (sj >= lo) && (sj <= hi) && (vi || vj);
    }
    return clip;
}

__global__ void __launch_bounds__(kStatsThreads)
range_stats_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                   const uint8_t* __restrict__ valid, const float* __restrict__ scale,
                   float* __restrict__ out, float* __restrict__ clipped, int w, int wa,
                   int mb, int ma, int C, int K, int L) {
    __shared__ float shf[32];
    __shared__ int shi[32];
    const int k = blockIdx.x;
    const RangeParams q = range_params(w, wa, mb, ma, C, K, L);

    for (int c = 0; c < C; ++c) {
        const size_t crow = ((size_t)c * K + k) * L;
        const RowLanes in{secs + (size_t)k * L, x + crow, valid + crow};
        const float sc = scale[c];
        const float center = range_center(in.x, in.v, sc, L, shf);
        int nclip = 0;
        for (int i = threadIdx.x; i < L; i += blockDim.x)
            nclip += range_lane(in, i, sc, center, q, out, crow) ? 1 : 0;
        nclip = block_sum(nclip, shi);
        if (threadIdx.x == 0) clipped[(size_t)c * K + k] = (float)nclip;
    }
}

// Shared memory of the staged form, in bytes (ops/stream.range_ring_bytes
// mirrors the total): the ring's barriers, a reduction scratch, then
// `depth` slots of a tile's keys, x and valid over T lanes and the halo.
struct RangeRingLayout {
    int halo_b, halo_a;
    size_t span, key_plane, v_plane, slot, slots, total;
};

__host__ __device__ inline RangeRingLayout range_ring_layout(int mb, int ma, int L, int T,
                                                             int depth) {
    RangeRingLayout y;
    y.halo_b = mb >= L - 1 ? L : mb + 1;
    y.halo_a = ma >= L - 1 ? L : ma + 1;
    const long long span = (long long)T + y.halo_b + y.halo_a;
    y.span = (size_t)(span < L ? span : L);
    y.key_plane = ring::plane_bytes(4 * y.span);
    y.v_plane = ring::plane_bytes(y.span);
    y.slot = 2 * y.key_plane + y.v_plane;
    y.slots = 8 * ring::kMaxDepth + 32 * 4;
    y.total = y.slots + (size_t)depth * y.slot;
    return y;
}

__global__ void __launch_bounds__(kStatsThreads)
range_stats_ring_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                        const uint8_t* __restrict__ valid, const float* __restrict__ scale,
                        float* __restrict__ out, float* __restrict__ clipped, int w, int wa,
                        int mb, int ma, int C, int K, int L, int T, int depth) {
    extern __shared__ __align__(16) unsigned char sm[];
    const RangeRingLayout lay = range_ring_layout(mb, ma, L, T, depth);
    const ring::Ring r{(uint64_t*)sm, depth};
    float* shf = (float*)(sm + 8 * ring::kMaxDepth);
    int* shi = (int*)shf;
    const int k = blockIdx.x;
    const RangeParams q = range_params(w, wa, mb, ma, C, K, L);
    const int32_t* srow = secs + (size_t)k * L;
    const size_t n_all = (size_t)C * K * L;
    const int nt = (L + T - 1) / T;
    ring::init(r);

    // lanes [lo, hi) staged for tile t
    auto span_of = [&](int t, int* lo, int* hi) {
        const long long t0 = (long long)t * T;
        *lo = (int)(t0 > lay.halo_b ? t0 - lay.halo_b : 0);
        const long long e = t0 + T + lay.halo_a;
        *hi = (int)(e < L ? e : L);
    };
    auto slot_base = [&](int slot) { return sm + lay.slots + (size_t)slot * lay.slot; };
    auto load = [&](int i, int slot, uint64_t* bar) {
        const int c = i / nt;
        int lo, hi;
        span_of(i % nt, &lo, &hi);
        const size_t n = (size_t)(hi - lo);
        const size_t at = ((size_t)c * K + k) * L + lo;
        unsigned char* p = slot_base(slot);
        ring::stage(p, srow + lo, 4 * n, secs + (size_t)K * L, bar);
        ring::stage(p + lay.key_plane, x + at, 4 * n, x + n_all, bar);
        ring::stage(p + 2 * lay.key_plane, valid + at, n, valid + n_all, bar);
    };
    float sc = 0.f, center = 0.f;
    int nclip = 0;
    auto consume = [&](int i, int slot) {
        const int c = i / nt, t = i % nt;
        const size_t crow = ((size_t)c * K + k) * L;
        if (t == 0) {
            sc = scale[c];
            center = range_center(x + crow, valid + crow, sc, L, shf);
            nclip = 0;
        }
        int lo, hi;
        span_of(t, &lo, &hi);
        unsigned char* p = slot_base(slot);
        const SlotLanes in{
            (const int32_t*)(p + ((uintptr_t)(srow + lo) & 15)),
            (const float*)(p + lay.key_plane + ((uintptr_t)(x + crow + lo) & 15)),
            p + 2 * lay.key_plane + ((uintptr_t)(valid + crow + lo) & 15), lo};
        const int end = min(L, (t + 1) * T);
        for (int ii = t * T + threadIdx.x; ii < end; ii += blockDim.x)
            nclip += range_lane(in, ii, sc, center, q, out, crow) ? 1 : 0;
        if (t == nt - 1) {
            const int total = block_sum(nclip, shi);
            if (threadIdx.x == 0) clipped[(size_t)c * K + k] = (float)total;
        }
    };
    ring::run(r, C * nt, load, consume);
}

}  // namespace

extern "C" int tempo_range_stats(const void* secs, const void* x, const void* valid,
                                 const void* scale, void* out, void* clipped, int w, int wa,
                                 int mb, int ma, int C, int K, int L, void* stream) {
    range_stats_kernel<<<K, kStatsThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, (const float*)scale,
        (float*)out, (float*)clipped, w, wa, mb, ma, C, K, L);
    return (int)cudaGetLastError();
}

// Shared memory of the staged form, for the planner's check on the card.
extern "C" long long tempo_range_ring_smem(int mb, int ma, int L, int T, int depth) {
    return (long long)range_ring_layout(mb, ma, L, T, depth).total;
}

extern "C" int tempo_range_stats_ring(const void* secs, const void* x, const void* valid,
                                      const void* scale, void* out, void* clipped, int w,
                                      int wa, int mb, int ma, int C, int K, int L, int T,
                                      int depth, void* stream) {
    const size_t smem = range_ring_layout(mb, ma, L, T, depth).total;
    if (depth < 2 || depth > ring::kMaxDepth || T < kStatsThreads || T % kStatsThreads != 0 ||
        smem > (size_t)kEmaSmemLimit)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        range_stats_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    range_stats_ring_kernel<<<K, kStatsThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, (const float*)scale,
        (float*)out, (float*)clipped, w, wa, mb, ma, C, K, L, T, depth);
    return (int)cudaGetLastError();
}
