// Legacy shifted-window rangeBetween(-w, 0) statistics on packed [K, L] series.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_stats.py:_make_kernel
// (through _stats_call and range_stats_pallas; its XLA form,
// tempo_tpu/ops/sortmerge.py:_range_stats_shifted_xla, runs the same op
// sequence).  The TPU kernel unrolls one masked pass per shift j = -ma..mb
// over a VMEM block; its W <= 64 ceiling and L % 128 == 0 rule are VMEM
// limits that this kernel does not have.  The legacy semantics: for each
// output lane i, accumulators start at 0 and +-inf, and every shift j
// from -ma to mb (j = 0 included), i.e. the neighbour p = i - j running
// downward from i + ma to i - mb, adds lane p when it is valid and its key
// lies in [secs[i] - w, secs[i]]; sums take values centred on the row's
// mean, min and max the raw ones (NaN-propagating).  Neighbours outside
// the row add nothing.  The `clipped` audit (the first row beyond either
// bound, with either end valid; beyond the row: the largest key, not
// valid) is one count per row and column.  Every accumulator line rounds
// to nearest (and the build passes -fmad=false), so count, min, max and
// clipped are bitwise equal to the plain version, and the rest equal to
// it at the kernel's centres.
//
// Bound on H100: bytes.  Each lane reads its key once and, per column, its
// value and validity (4 + 4 + 1 B) and writes seven f32 stat planes, 37 B a
// lane for one column (0.144 ms at [1, 1024, 12760]); the ~10 operations
// a lane and shift stay below the f32 rate at the extents the legacy pick
// allows (at most 512 rows, tens at HHAR scale).  The first port (a block a
// row, a thread a lane re-reading its (mb + ma + 1) neighbours' key,
// validity and value from global memory) was bound by those loads and
// its serial lanes instead.  The design is range_stats.cu's walk in the
// legacy order:
//
//   (a) Centres: range_centres (window.cuh) into a [C, K] plane, a null
//       scale (x * 1 keeps x's bits).  This sums each row in another
//       order than the first port did, so mean, sum, stddev and zscore may
//       move in the last bits; count, min, max and clipped do not.
//   (b) A 256-thread block per (column, row, tile of 1024 outputs); each
//       lane's entry (c = x - centre or 0, c*c with the validity in its
//       sign, key, raw x) is formed once into a shared-memory window of
//       the tile and its halo (mb + 1 lanes behind, ma + 1 ahead: the
//       audit's lanes), window.cuh's layout (entry q at q + q / 8).
//   (c) Register blocking: a thread owns kLanes = 4 consecutive outputs
//       and walks the neighbour lanes downward, from its last output's
//       i + ma to its first output's i - mb, one shared load a step
//       feeding every output whose shift lies in -ma .. mb, so each
//       output still sees its shifts in the legacy order and keeps every
//       bit of its sums.  The head and tail triangles are unrolled.  A
//       step adds only where its neighbour is in the frame: the sums
//       start at +0.0 and so are never -0.0, and adding +0.0 (what the
//       legacy loop adds elsewhere) changes nothing.
//   (d) A halo wider than kLegacyWindow lanes is walked over several
//       windows, from the top down, each refilled from global memory.
//   (e) Clipped lanes are counted in integers (window.cuh's
//       count_clipped): `clipped` is the exact count rounded once.
//
// Min and max are over the raw x, so row 2's NaN rule (min and max from
// the sum of squares) does not carry over: a valid NaN makes the centre
// NaN, and then every c and sum of squares of the row, while a window of
// finite raw values must keep finite min and max.  They take sm_80's
// min.NaN / max.NaN instead: one instruction that returns NaN where
// either operand is one and fminf's min elsewhere (signed zeros
// included), i.e. min_nan / max_nan, so one walk serves every row; the
// canonical NaN is restored once at the end.  (Two walks in the kernel,
// fminf where the block's centre is finite and min_nan where not, were
// slower on the card.)
#include "common.cuh"
#include "window.cuh"

#include <limits.h>

namespace {

constexpr int kLanes = 4;                        // consecutive outputs a thread
constexpr int kLegacyThreads = 256;
constexpr int kLegacyTile = kLegacyThreads * kLanes;
constexpr int kLegacyWindow = 1536;              // lanes a window holds at most

struct LegacyParams {
    int w;
    int jb, ja;    // the shifts behind and ahead: the bounds clamped to L - 1
    int hb, ha;    // the audit's lanes i - hb, i + ha: the bounds + 1 clamped to L
    int L;
};

inline LegacyParams legacy_params(int w, int mb, int ma, int L) {
    // the wrapper caps mb and ma at L
    return {w, mb < L - 1 ? mb : L - 1, ma < L - 1 ? ma : L - 1, mb < L ? mb + 1 : L,
            ma < L ? ma + 1 : L, L};
}

// min_nan / max_nan but for the NaN's bits (the card's 0x7fffffff)
__device__ __forceinline__ float min_nan_any(float a, float b) {
    float d;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}
__device__ __forceinline__ float max_nan_any(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

// A thread's kLanes outputs i0 + e.
struct LegacyOutputs {
    float cnt[kLanes], s1[kLanes], s2[kLanes], mn[kLanes], mx[kLanes];
    int32_t lo[kLanes], si[kLanes];
    float xi[kLanes];
    unsigned vbits, clip;
    int i0;

    // the own lanes' key, x and validity (from global memory: a halo past
    // one window leaves them out of the first), and the audit's lanes that
    // lie outside the row
    __device__ __forceinline__ void own(const int32_t* srow, const float* xr, const uint8_t* vr,
                                        const LegacyParams& q, bool vec) {
        const int32_t BIG = INT_MAX;
        const float INF = f32_inf();
        int32_t kv[kLanes];
        bool ok[kLanes];
        if (vec && i0 + kLanes <= q.L) {
            const int4 k4 = *reinterpret_cast<const int4*>(srow + i0);
            const float4 x4 = *reinterpret_cast<const float4*>(xr + i0);
            const uchar4 u4 = *reinterpret_cast<const uchar4*>(vr + i0);
            kv[0] = k4.x, kv[1] = k4.y, kv[2] = k4.z, kv[3] = k4.w;
            xi[0] = x4.x, xi[1] = x4.y, xi[2] = x4.z, xi[3] = x4.w;
            ok[0] = u4.x != 0, ok[1] = u4.y != 0, ok[2] = u4.z != 0, ok[3] = u4.w != 0;
        } else {
#pragma unroll
            for (int e = 0; e < kLanes; ++e) {
                const int i = i0 + e;
                kv[e] = i < q.L ? srow[i] : BIG;
                xi[e] = i < q.L ? xr[i] : 0.f;
                ok[e] = i < q.L && vr[i] != 0;
            }
        }
        vbits = 0;
        clip = 0;
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            si[e] = kv[e];
            lo[e] = wrap_sub(kv[e], q.w);
            cnt[e] = 0.f, s1[e] = 0.f, s2[e] = 0.f, mn[e] = INF, mx[e] = -INF;
            vbits |= (ok[e] ? 1u : 0u) << e;
            const int i = i0 + e;
            const bool beyond = i - q.hb < 0 || i + q.ha >= q.L;
            clip |= (beyond && BIG >= lo[e] && BIG <= si[e] && ok[e] ? 1u : 0u) << e;
        }
    }

    // neighbour v into output e where it is in the frame
    __device__ __forceinline__ void take(int e, float4 v) {
        const int32_t sj = v_key(v);
        if (v_ok(v) && sj >= lo[e] && sj <= si[e]) {
            cnt[e] = __fadd_rn(cnt[e], 1.f);
            s1[e] = __fadd_rn(s1[e], v.x);
            s2[e] = __fadd_rn(s2[e], v.y);
            mn[e] = min_nan_any(mn[e], v.w);
            mx[e] = max_nan_any(mx[e], v.w);
        }
    }

    // the shifts at offsets d in [dl, dh] from i0 (neighbour i0 + d inside
    // the row), in descending order; output e takes d in [e - jb, e + ja]
    __device__ __forceinline__ void walk(const Win& win, int dl, int dh, const LegacyParams& q) {
        const int jb = q.jb, ja = q.ja, L = q.L;
        if (ja + jb >= kLanes - 1) {
#pragma unroll
            for (int s = 0; s < kLanes - 1; ++s) {          // head: outputs e >= E - 1 - s
                const int d = ja + kLanes - 1 - s;
                if (d >= dl && d <= dh && i0 + d < L) {
                    const float4 v = win.at(i0 + d);
#pragma unroll
                    for (int e = kLanes - 1 - s; e < kLanes; ++e) take(e, v);
                }
            }
            // all outputs: lanes i0 + min(dh, ja) down to i0 + max(dl,
            // E - 1 - jb), within the row (bounds taken as lanes)
            int p_top = i0 + ja;
            if (i0 + dh < p_top) p_top = i0 + dh;
            if (p_top > L - 1) p_top = L - 1;
            int p_bot = i0 + dl;
            if (i0 + kLanes - 1 - jb > p_bot) p_bot = i0 + kLanes - 1 - jb;
            if (p_bot < 0) p_bot = 0;
            for (int p = p_top; p >= p_bot; --p) {
                const float4 v = win.at(p);
#pragma unroll
                for (int e = 0; e < kLanes; ++e) take(e, v);
            }
#pragma unroll
            for (int s = 0; s < kLanes - 1; ++s) {          // tail: outputs e <= E - 2 - s
                const int d = kLanes - 2 - jb - s;
                if (d >= dl && d <= dh && i0 + d >= 0 && i0 + d < L) {
                    const float4 v = win.at(i0 + d);
#pragma unroll
                    for (int e = 0; e <= kLanes - 2 - s; ++e) take(e, v);
                }
            }
        } else {
            // bounds below E - 1 together: each step checks its outputs
            const int bot = max(dl, -jb);
            for (int d = min(dh, ja + kLanes - 1); d >= bot && i0 + d >= 0; --d) {
                if (i0 + d >= L) continue;
                const float4 v = win.at(i0 + d);
#pragma unroll
                for (int e = 0; e < kLanes; ++e)
                    if (d - ja <= e && e <= d + jb) take(e, v);
            }
        }
    }

    // the audit's lane at offset e + off (-hb or +ha) where it lies in the
    // row and in the window's offsets [dl, dh]
    __device__ __forceinline__ void clip_at(const Win& win, int off, int dl, int dh, int L) {
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            const int d = e + off;
            const int p = i0 + d;
            if (d >= dl && d <= dh && p >= 0 && p < L) {
                const float4 v = win.at(p);
                const int32_t sj = v_key(v);
                const bool hit =
                    sj >= lo[e] && sj <= si[e] && (((vbits >> e) & 1u) || v_ok(v));
                clip |= (hit ? 1u : 0u) << e;
            }
        }
    }

    // The seven stats of each output below L into out[o + i] (+ s * sp),
    // a plane at a time (16-byte stores where aligned), so the registers
    // of min and max are free before the spread's; returns how many of
    // the outputs clipped.
    __device__ __forceinline__ int finish(float center, float* out, size_t o, size_t sp, int L) {
        const float NaN = tempo_nan();
        const bool vec = ((L & 3) == 0) && ((sp & 3) == 0) && (((uintptr_t)out & 15) == 0) &&
                         i0 + kLanes <= L;
        auto store = [&](int s, const float (&r)[kLanes]) {
            float* dst = out + o + s * sp + i0;
            if (vec) {
                *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
            } else {
#pragma unroll
                for (int e = 0; e < kLanes; ++e)
                    if (i0 + e < L) dst[e] = r[e];
            }
        };
        float mean[kLanes], r[kLanes];
#pragma unroll
        for (int e = 0; e < kLanes; ++e) r[e] = cnt[e] > 0.f && mn[e] == mn[e] ? mn[e] : NaN;
        store(2, r);
#pragma unroll
        for (int e = 0; e < kLanes; ++e) r[e] = cnt[e] > 0.f && mx[e] == mx[e] ? mx[e] : NaN;
        store(3, r);
        store(1, cnt);
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            mean[e] = cnt[e] > 0.f
                ? __fadd_rn(__fdiv_rn(s1[e], fmaxf(cnt[e], 1.f)), center) : NaN;
            r[e] = cnt[e] > 0.f ? __fadd_rn(s1[e], __fmul_rn(cnt[e], center)) : NaN;
        }
        store(0, mean);
        store(4, r);
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            const float n = cnt[e], s = s1[e];
            const float var = n > 1.f
                ? __fdiv_rn(__fsub_rn(s2[e], __fdiv_rn(__fmul_rn(s, s), fmaxf(n, 1.f))),
                            fmaxf(__fsub_rn(n, 1.f), 1.f))
                : NaN;
            r[e] = n > 1.f ? __fsqrt_rn(max_nan(var, 0.f)) : NaN;
        }
        store(5, r);
        int nclip = 0;
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            r[e] = ((vbits >> e) & 1u) ? __fdiv_rn(__fsub_rn(xi[e], mean[e]), r[e]) : NaN;
            if (i0 + e < L && ((clip >> e) & 1u)) ++nclip;
        }
        store(6, r);
        return nclip;
    }
};

// A block per (column c, row k, tile of kLegacyTile outputs): windows of
// offsets [dl, dh] from the top down, each filled, walked and audited.
__global__ void __launch_bounds__(kLegacyThreads, 4)
legacy_rows(const int32_t* __restrict__ secs, const float* __restrict__ x,
            const uint8_t* __restrict__ valid, const float* __restrict__ centre,
            float* __restrict__ out, float* __restrict__ clipped, unsigned* __restrict__ tally,
            LegacyParams q, int C, int K, int nt, int cap) {
    extern __shared__ float4 win_sm[];
    const int L = q.L;
    const int tile = blockIdx.x % nt;
    const int ck = blockIdx.x / nt;
    const int k = ck % K;
    const int t0 = tile * kLegacyTile;
    const int32_t* srow = secs + (size_t)k * L;
    const float* xr = x + (size_t)ck * L;
    const uint8_t* vr = valid + (size_t)ck * L;
    const float center = centre[ck];
    const bool vec = rows_vectorise(secs, x, valid, L);

    LegacyOutputs t;
    t.i0 = t0 + kLanes * threadIdx.x;
    t.own(srow, xr, vr, q, vec);
    const int top = kLanes - 1 + q.ha, bottom = -q.hb;
    const int span = cap - (kLegacyTile - kLanes);
    for (int dh = top; dh >= bottom;) {
        const int dl = max(dh - span + 1, bottom);
        if (dh != top) __syncthreads();
        const Win win = fill_window(win_sm, t0 + dl, kLegacyTile - kLanes + dh - dl + 1, srow,
                                    xr, vr, 1.f, center, L, vec);
        __syncthreads();
        t.walk(win, dl, dh, q);
        t.clip_at(win, -q.hb, dl, dh, L);
        t.clip_at(win, q.ha, dl, dh, L);
        dh = dl - 1;
    }
    const int nclip = t.finish(center, out, (size_t)ck * L, (size_t)C * K * L, L);
    count_clipped(nclip, tally + ck, clipped + ck);
}

}  // namespace

// `centre` is a [C, K] float32 plane and `tally` a [C, K] uint32 scratch,
// both written by the centre pass.
extern "C" int tempo_legacy_stats(const void* secs, const void* x, const void* valid,
                                  void* out, void* clipped, void* centre, void* tally, int w,
                                  int mb, int ma, int C, int K, int L, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = launch_centres(x, valid, nullptr, centre, clipped, tally, C, K, L, st);
    if (err != cudaSuccess) return (int)err;
    const LegacyParams q = legacy_params(w, mb, ma, L);
    const int nt = (L + kLegacyTile - 1) / kLegacyTile;
    const long long want = (long long)kLegacyTile + q.hb + q.ha;
    const int cap = (int)(want < kLegacyWindow ? want : kLegacyWindow);
    legacy_rows<<<(unsigned)((size_t)C * K * nt), kLegacyThreads, 16 * (size_t)win_entries(cap),
                  st>>>((const int32_t*)secs, (const float*)x, (const uint8_t*)valid,
                        (const float*)centre, (float*)out, (float*)clipped, (unsigned*)tally, q,
                        C, K, nt, cap);
    return (int)cudaGetLastError();
}
