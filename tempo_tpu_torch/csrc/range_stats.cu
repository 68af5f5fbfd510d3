// Sliding rangeBetween(-w, +wa) statistics on packed [K, L] series.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_window.py:_make_kernel
// over _window_math (through _call: range_stats_unrolled[_packed] and
// range_stats_stream[_packed]).  One kernel serves both the unrolled and
// the runtime-width forms: the row bounds (mb behind, ma ahead) and the
// key windows (w, wa) arrive as scalars.  Each output lane i reproduces
// _window_math's op sequence: its centred value first, then j = 1 .. mb
// behind and j = 1 .. ma ahead, validity folded into the s_lo / s_hi
// keys, the forward bound saturated at BIG-1, sums and min/max taken on
// centred values with the centre added back, and the `clipped` audit.
// Every op is rounded (the __f*_rn intrinsics, -fmad=false).
//
// Bound on H100: bytes where the bounds are narrow, operations where they
// are wide.  The function reads a lane's key, value and validity and
// writes seven f32 planes (37 B a lane: 0.144 ms at [1, 1024, 12760] and
// 3.35 TB/s), and does ~10 operations a lane and neighbour (at phase F's
// six-hour bounds, 14,575 rows behind over [1, 128, 102056], 28 ms at 67
// TFLOP/s).  The instructions of the neighbour loop and of the epilogue
// (four rounded divisions and a square root an output) set the pace, so
// the design cuts them and keeps the card full:
//
//   (a) range_centres (window.cuh, shared with legacy_stats.cu): a block
//       per (column, row) (256 threads; 1024 past 32,768 lanes) sums its
//       row's valid x * scale in a fixed order (thread t: the groups of
//       four lanes t, t + T, ... lane by lane, 16-byte loads where
//       aligned; then block_sum) into a [C, K] plane, and zeroes the
//       row's clip tally.  Both forms read it.
//   (b) Each lane's values a walk needs are formed once, into a window
//       in shared memory (window.cuh): the centred value c (0 where
//       invalid), c*c with the validity in its sign bit (-0.0 where
//       invalid: a valid c*c is +0 or more, and a NaN the card computes is
//       0x7fffffff, positive), the raw key and x * scale.  These are the rounded values the old
//       per-step `centred(p)` recomputed, so the bits do not change.
//       Window entry q sits at q + q / 8 (16-byte entries): the threads'
//       stride-4 reads hit distinct banks.
//   (c) Register blocking: a thread owns kLanes = 4 consecutive outputs
//       (five accumulators each) and walks the neighbour offsets d from
//       its first output in descending order for the behind loop
//       (ascending ahead), one 16-byte shared load a step feeding every
//       output whose j lies in 1 .. mb.  Each output still sees j = 1, 2,
//       ... in order.  The triangles at both ends of the walk are unrolled
//       with their active outputs known at compile time.  (Eight outputs a
//       thread walk long halos faster but need 128 registers, which halves
//       the blocks an SM holds and loses where the bounds are narrow.)
//   (d) A step adds only where the neighbour is in the window: count, the
//       sum of squares and min/max under the predicate, the sum by
//       `inw ? c : 0` as before.  That keeps every bit: the count and the
//       sum of squares are never -0.0, so their +0.0 terms change
//       nothing; min/max skip NaN (fminf) and are set to the canonical
//       NaN at the end exactly where the sum of squares is NaN (c*c is
//       NaN iff c is); a step whose neighbour lies outside the row adds
//       +0.0 to the sum, and those steps are the last of their loop, so
//       they are one s1 + 0.0 at the end (it only turns -0.0 into +0.0).
//
// Two forms, picked on the host by ops/stream.range_plan; both run the
// same body on a window and are bitwise equal:
//
// * the row form (range_rows): a 256-thread block per (column, row, tile
//   of 1024 outputs), so that phase F's 128 rows fill the card.  Its
//   window of at most kRowWindow lanes holds the tile and its halo
//   (mb + 1 lanes behind, ma + 1 ahead) when they fit; a wider halo is
//   walked over several windows, each refilled from global memory with
//   16-byte loads.  A row's tiles count their clipped lanes in integers:
//   a warp that clipped adds its count to the row's uint32 tally and
//   raises the row's float `clipped` to the new total rounded once (an
//   atomicMax on its bits, whose order is the value's for floats >= 0),
//   so `clipped` ends as the exact count rounded once, whatever the order.
// * the staged form (range_ring_kernel): the card's resident blocks
//   (ops/stream.ring_runs: one contiguous run of the (column, row, lane
//   tile) items a block, so a row's tiles may span blocks) of T / kLanes
//   threads each walk their run; each item's keys, x and valid stream
//   through ring.cuh's staging ring, only the lanes its window lacks: a
//   tile that continues its row takes the halo it shares with the tile
//   before from the other of two windows.  Clipped lanes go to the row
//   form's integer tally, so any block may finish a row.  Where the
//   windows and slots do not fit, the planner takes the row form.
//
// A null `scale` means 1 (x * 1 keeps x's bits).
#include "common.cuh"
#include "ring.cuh"
#include "window.cuh"

#include <limits.h>

namespace {

constexpr int kLanes = 4;                  // consecutive outputs a thread
constexpr int kRowThreads = 256;           // the row form's block
constexpr int kRowTile = kRowThreads * kLanes;
constexpr int kRowWindow = 2048;           // lanes a row-form window holds at most

struct RangeParams {
    int w, wa;
    int mb, ma;      // loop counts: the bounds clamped to L - 1
    int hb, ha;      // the clip lanes i - hb, i + ha (hb = L: none)
    int L;
};

__host__ __device__ inline RangeParams range_params(int w, int wa, int mb, int ma, int L) {
    // a bound >= L has no row beyond it
    return {w, wa, mb < L - 1 ? mb : L - 1, ma < L - 1 ? ma : L - 1, mb >= L - 1 ? L : mb + 1,
            ma >= L - 1 ? L : ma + 1, L};
}

struct Acc {
    float cnt, s1, s2, mn, mx;
};

__device__ __forceinline__ void acc_step(Acc& a, float c, float c2, bool inw) {
    if (inw) {
        a.cnt = __fadd_rn(a.cnt, 1.f);
        a.s2 = __fadd_rn(a.s2, c2);
        a.mn = fminf(a.mn, c);
        a.mx = fmaxf(a.mx, c);
    }
    a.s1 = __fadd_rn(a.s1, inw ? c : 0.f);
}

// A thread's kLanes outputs i0 + e.
struct ThreadOutputs {
    Acc a[kLanes];
    int32_t lo[kLanes], hi[kLanes];
    float xs[kLanes];
    unsigned vbits, clip;
    int i0;

    template <class Wn>
    __device__ __forceinline__ void own(const Wn& win, const RangeParams& q) {
        const int32_t BIG = INT_MAX;
        const float INF = f32_inf();
        vbits = 0;
        clip = 0;
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            const float4 v = win.at(i0 + e);
            const bool vi = v_ok(v);
            const int32_t si = v_key(v);
            lo[e] = wrap_sub(si, q.w);
            hi[e] = min(wrap_add(si, min(q.wa, wrap_sub(BIG, si))), BIG - 1);
            const float xc = v.x;
            a[e] = {vi ? 1.f : 0.f, xc, __fmul_rn(xc, xc), vi ? xc : INF, vi ? xc : -INF};
            xs[e] = v.w;
            vbits |= (vi ? 1u : 0u) << e;
        }
    }

    // the clip audit's lane at offset `off` (-hb or +ha) where it lies in
    // the row and in the window's offsets [dl, dh]
    template <class Wn>
    __device__ __forceinline__ void clip_at(const Wn& win, int off, int dl, int dh, int L) {
#pragma unroll
        for (int e = 0; e < kLanes; ++e) {
            const int d = e + off;
            const int p = i0 + d;
            if (d >= dl && d <= dh && p >= 0 && p < L) {
                const float4 v = win.at(p);
                const int32_t sj = v_key(v);
                const bool hit = (sj >= lo[e]) && (sj <= hi[e]) && (((vbits >> e) & 1u) || v_ok(v));
                clip |= (hit ? 1u : 0u) << e;
            }
        }
    }

    // behind steps at offsets d in [dl, dh] (descending), neighbour i0 + d
    template <class Wn>
    __device__ __forceinline__ void behind(const Wn& win, int dl, int dh, int mb) {
        auto nb = [&](int d, int32_t* s) {
            const float4 v = win.at(i0 + d);
            *s = v_ok(v) ? v_key(v) : INT_MIN;
            return v;
        };
        if (mb >= kLanes - 1) {
#pragma unroll
            for (int s = 0; s < kLanes - 1; ++s) {          // head: outputs e > d
                const int d = kLanes - 2 - s;
                if (d >= dl && d <= dh) {
                    int32_t sl;
                    const float4 v = nb(d, &sl);
#pragma unroll
                    for (int e = 0; e < kLanes; ++e)
                        if (e > d) acc_step(a[e], v.x, v.y, sl >= lo[e]);
                }
            }
            // all outputs: neighbour lanes i0 + min(dh, -1) down to the
            // highest of i0 + dl, i0 + kLanes - 1 - mb and 0 (bounds taken
            // as lanes: written as max(max(dl, kLanes - 1 - mb), -i0) they
            // came out of the sm_90a build as -dl, and the loop never ran)
            const int p_top = i0 + min(dh, -1);
            int p_bot = i0 + dl;
            if (i0 + kLanes - 1 - mb > p_bot) p_bot = i0 + kLanes - 1 - mb;
            if (p_bot < 0) p_bot = 0;
            for (int p = p_top; p >= p_bot; --p) {
                const int d = p - i0;
                int32_t sl;
                const float4 v = nb(d, &sl);
#pragma unroll
                for (int e = 0; e < kLanes; ++e) acc_step(a[e], v.x, v.y, sl >= lo[e]);
            }
#pragma unroll
            for (int s = 0; s < kLanes - 1; ++s) {          // tail: outputs e <= E - 2 - s
                const int d = kLanes - 2 - mb - s;
                if (d >= dl && d <= dh && i0 + d >= 0) {
                    int32_t sl;
                    const float4 v = nb(d, &sl);
#pragma unroll
                    for (int e = 0; e < kLanes; ++e)
                        if (e <= kLanes - 2 - s) acc_step(a[e], v.x, v.y, sl >= lo[e]);
                }
            }
        } else if (mb > 0) {
            const int bot = max(dl, -mb);
            for (int d = min(dh, kLanes - 2); d >= bot && i0 + d >= 0; --d) {
                int32_t sl;
                const float4 v = nb(d, &sl);
#pragma unroll
                for (int e = 0; e < kLanes; ++e)
                    if (e - d >= 1 && e - d <= mb) acc_step(a[e], v.x, v.y, sl >= lo[e]);
            }
        }
    }

    // ahead steps at offsets d in [dl, dh] (ascending), neighbour i0 + d < L
    template <class Wn>
    __device__ __forceinline__ void ahead(const Wn& win, int dl, int dh, int ma, int L) {
        auto nb = [&](int d, int32_t* s) {
            const float4 v = win.at(i0 + d);
            *s = v_ok(v) ? v_key(v) : INT_MAX;
            return v;
        };
        if (ma >= kLanes - 1) {
#pragma unroll
            for (int s = 0; s < kLanes - 1; ++s) {          // head: outputs e < d
                const int d = s + 1;
                if (d >= dl && d <= dh && i0 + d < L) {
                    int32_t sh;
                    const float4 v = nb(d, &sh);
#pragma unroll
                    for (int e = 0; e < kLanes; ++e)
                        if (e < d) acc_step(a[e], v.x, v.y, sh <= hi[e]);
                }
            }
            const int bot = max(dl, kLanes);
            const int steps = min(min(dh, ma), L - 1 - i0) - bot + 1;
            for (int n = 0; n < steps; ++n) {                 // all outputs
                const int d = bot + n;
                int32_t sh;
                const float4 v = nb(d, &sh);
#pragma unroll
                for (int e = 0; e < kLanes; ++e) acc_step(a[e], v.x, v.y, sh <= hi[e]);
            }
#pragma unroll
            for (int s = 0; s < kLanes - 1; ++s) {          // tail: outputs e > s
                const int d = ma + 1 + s;
                if (d >= dl && d <= dh && i0 + d < L) {
                    int32_t sh;
                    const float4 v = nb(d, &sh);
#pragma unroll
                    for (int e = 0; e < kLanes; ++e)
                        if (e > s) acc_step(a[e], v.x, v.y, sh <= hi[e]);
                }
            }
        } else if (ma > 0) {
            const int top = min(dh, kLanes - 1 + ma);
            for (int d = max(dl, 1); d <= top && i0 + d < L; ++d) {
                int32_t sh;
                const float4 v = nb(d, &sh);
#pragma unroll
                for (int e = 0; e < kLanes; ++e)
                    if (d - e >= 1 && d - e <= ma) acc_step(a[e], v.x, v.y, sh <= hi[e]);
            }
        }
    }

    // The seven stats of each output below L into out[o + i] (+ s * sp),
    // four outputs at a time; returns how many of them clipped.
    __device__ __forceinline__ int finish(const RangeParams& q, float center, float* out,
                                          size_t o, size_t sp) {
        const float NaN = tempo_nan();
        const int L = q.L;
        int nclip = 0;
        const bool aligned = ((L & 3) == 0) && ((sp & 3) == 0) && (((uintptr_t)out & 15) == 0);
#pragma unroll
        for (int g = 0; g < kLanes; g += 4) {
            float r[7][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int e = g + u;
                const int i = i0 + e;
                Acc& z = a[e];
                // the skipped steps past either end of the row: one s1 + 0.0
                if (i < q.mb || i + q.ma >= L) z.s1 = __fadd_rn(z.s1, 0.f);
                if (q.mb + q.ma > 0 && z.s2 != z.s2) {
                    z.mn = NaN;
                    z.mx = NaN;
                }
                const bool vi = (vbits >> e) & 1u;
                const float cnt = z.cnt, s1 = z.s1;
                const float cnt1 = fmaxf(cnt, 1.f);
                const float mean = cnt > 0.f ? __fadd_rn(__fdiv_rn(s1, cnt1), center) : NaN;
                const float total = __fadd_rn(s1, __fmul_rn(cnt, center));
                const float var = cnt > 1.f
                    ? __fdiv_rn(__fsub_rn(z.s2, __fdiv_rn(__fmul_rn(s1, s1), cnt1)),
                                fmaxf(__fsub_rn(cnt, 1.f), 1.f))
                    : NaN;
                const float sd = cnt > 1.f ? __fsqrt_rn(max_nan(var, 0.f)) : NaN;
                r[0][u] = mean;
                r[1][u] = cnt;
                r[2][u] = cnt > 0.f ? __fadd_rn(z.mn, center) : NaN;
                r[3][u] = cnt > 0.f ? __fadd_rn(z.mx, center) : NaN;
                r[4][u] = cnt > 0.f ? total : NaN;
                r[5][u] = sd;
                r[6][u] = vi ? __fdiv_rn(__fsub_rn(xs[e], mean), sd) : NaN;
                if (i < L && ((clip >> e) & 1u)) ++nclip;
            }
            float* base = out + o + i0 + g;
            const bool vec = aligned && i0 + g + 4 <= L;
#pragma unroll
            for (int s = 0; s < 7; ++s) {
                float* dst = base + s * sp;
                if (vec) {
                    *reinterpret_cast<float4*>(dst) = make_float4(r[s][0], r[s][1], r[s][2], r[s][3]);
                } else {
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (i0 + g + u < L) dst[u] = r[s][u];
                }
            }
        }
        return nclip;
    }
};

// The walk of a tile whose window holds offsets [-hb, kLanes - 1 + ha]
// (one window: the staged form, and the row form where it fits).
template <class Wn>
__device__ __forceinline__ int range_tile(const Wn& win, int i0, const RangeParams& q,
                                          float center, float* out, size_t crow, size_t sp) {
    ThreadOutputs t;
    t.i0 = i0;
    const int dl = -q.hb, dh = kLanes - 1 + q.ha;
    t.own(win, q);
    t.behind(win, dl, dh, q.mb);
    t.clip_at(win, -q.hb, dl, dh, q.L);
    t.ahead(win, dl, dh, q.ma, q.L);
    t.clip_at(win, q.ha, dl, dh, q.L);
    return t.finish(q, center, out, crow, sp);
}

// Row form: a block per (column c, row k, tile of kRowTile outputs).
__global__ void __launch_bounds__(kRowThreads, 4)
range_rows(const int32_t* __restrict__ secs, const float* __restrict__ x,
           const uint8_t* __restrict__ valid, const float* __restrict__ scale,
           const float* __restrict__ centre, float* __restrict__ out,
           float* __restrict__ clipped, unsigned* __restrict__ tally, RangeParams q, int C,
           int K, int nt, int cap) {
    extern __shared__ float4 win_sm[];
    const int L = q.L;
    const int tile = blockIdx.x % nt;
    const int ck = blockIdx.x / nt;
    const int k = ck % K;
    const int t0 = tile * kRowTile;
    const int i0 = t0 + kLanes * threadIdx.x;
    const size_t crow = (size_t)ck * L;
    const int32_t* srow = secs + (size_t)k * L;
    const float* xr = x + crow;
    const uint8_t* vr = valid + crow;
    const float sc = scale_of(scale, ck / K), center = centre[ck];
    const size_t sp = (size_t)C * K * L;

    // window of offsets [dl, dh]: lanes [t0 + dl, t0 + kRowTile - kLanes + dh]
    const bool vec = rows_vectorise(secs, x, valid, L);
    auto fill = [&](int dl, int dh) {
        return fill_window(win_sm, t0 + dl, kRowTile - kLanes + dh - dl + 1, srow, xr, vr, sc,
                           center, L, vec);
    };

    int nclip;
    if (kRowTile + q.hb + q.ha <= cap) {
        const Win win = fill(-q.hb, kLanes - 1 + q.ha);
        __syncthreads();
        nclip = range_tile(win, i0, q, center, out, crow, sp);
    } else {
        // a halo wider than the window: the behind offsets [-hb, kLanes - 1]
        // in windows from the top down, then the ahead offsets [1, kLanes - 1
        // + ha] from the bottom up, each window refilled
        const int span = cap - (kRowTile - kLanes);
        ThreadOutputs t;
        t.i0 = i0;
        bool first = true;
        for (int dh = kLanes - 1; dh >= -q.hb;) {
            const int dl = max(dh - span + 1, -q.hb);
            if (!first) __syncthreads();
            const Win win = fill(dl, dh);
            __syncthreads();
            if (first) t.own(win, q);
            t.behind(win, dl, dh, q.mb);
            t.clip_at(win, -q.hb, dl, dh, L);
            first = false;
            dh = dl - 1;
        }
        for (int dl = 1; dl <= kLanes - 1 + q.ha;) {
            const int dh = min(dl + span - 1, kLanes - 1 + q.ha);
            __syncthreads();
            const Win win = fill(dl, dh);
            __syncthreads();
            t.ahead(win, dl, dh, q.ma, L);
            t.clip_at(win, q.ha, dl, dh, L);
            dl = dh + 1;
        }
        nclip = t.finish(q, center, out, crow, sp);
    }
    count_clipped(nclip, tally + ck, clipped + ck);
}

// Shared memory of the staged form, in bytes (ops/stream.range_ring_bytes
// mirrors the total): the ring's barriers, two windows of the tile and
// its halo (T + hb + ha lanes each), then `depth` slots of the keys, x
// and valid of the lanes an item stages (at most the tile and its halo,
// and the row).
struct RangeRingLayout {
    int hb, ha, win_lanes;
    size_t span, key_plane, v_plane, slot, win, slots, total;
};

__host__ __device__ inline RangeRingLayout range_ring_layout(int mb, int ma, int L, int T,
                                                             int depth) {
    RangeRingLayout y;
    y.hb = mb >= L - 1 ? L : mb + 1;
    y.ha = ma >= L - 1 ? L : ma + 1;
    const long long lanes = (long long)T + y.hb + y.ha;
    y.win_lanes = (int)(lanes < INT_MAX / 2 ? lanes : INT_MAX / 2);
    y.span = (size_t)(lanes < L ? lanes : L);
    y.key_plane = ring::plane_bytes(4 * y.span);
    y.v_plane = ring::plane_bytes(y.span);
    y.slot = 2 * y.key_plane + y.v_plane;
    y.win = 16 * (size_t)win_entries(y.win_lanes);
    y.slots = 8 * ring::kMaxDepth + 2 * y.win;
    y.total = y.slots + (size_t)depth * y.slot;
    return y;
}

// The staged form's window: as Win, read by its shared-memory address, so
// that every read is a shared-memory load (a pointer that lives through
// the ring's loop may reach the walk as a generic one).
struct SharedWin {
    uint32_t w;   // shared-memory address of entry 0
    int base;
    __device__ __forceinline__ float4 at(int p) const {
        const int q = p - base;
        float4 v;
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                     : "r"(w + 16u * (uint32_t)(q + (q >> 3))));
        return v;
    }
};

// Staged form: the grid's blocks split the n_items (column, row, tile)
// items, in that order, into contiguous runs (block b takes
// [b * n / B, (b + 1) * n / B)); a block of T / kLanes threads walks its
// run through the ring.  Item j's window (lanes [t0 - hb, t0 + T + ha))
// is window j % 2: where the item continues its row, it takes its first
// hb + ha lanes from the other window (the tile before's last ones) and
// stages and forms only the T lanes after them, [t0 + ha, t0 + T + ha);
// where it starts the run or a row it stages and forms them all.  One
// block barrier an item, after forming: a thread that forms item j + 1
// has passed item j's barrier, so every thread has finished item j - 1's
// walk, the last reader of the window it writes, and item j - 1's slot.
__global__ void __launch_bounds__(kRowThreads, 4)
range_ring_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                  const uint8_t* __restrict__ valid, const float* __restrict__ scale,
                  const float* __restrict__ centre, float* __restrict__ out,
                  float* __restrict__ clipped, unsigned* __restrict__ tally, RangeParams q,
                  int C, int K, int T, int depth, long long n_items) {
    extern __shared__ __align__(16) unsigned char sm[];
    const int L = q.L;
    const RangeRingLayout lay = range_ring_layout(q.mb, q.ma, L, T, depth);
    const ring::Ring r{(uint64_t*)sm, depth};
    float4* wins = (float4*)(sm + 8 * ring::kMaxDepth);
    const size_t win_stride = lay.win / 16;
    const size_t n_all = (size_t)C * K * L;
    const int nt = (L + T - 1) / T;
    const long long s0 = (long long)blockIdx.x * n_items / gridDim.x;
    const int n = (int)((long long)(blockIdx.x + 1) * n_items / gridDim.x - s0);
    const bool vec = rows_vectorise(secs, x, valid, L);
    ring::init(r);

    // the run's items in order: row ck = c * K + k, tile t (one cursor for
    // the loads, one for the walks, each advanced an item a call)
    struct Item {
        int c, k, t;
        __device__ __forceinline__ int ck(int K_) const { return c * K_ + k; }
    };
    auto next = [&](Item& it) {
        if (++it.t == nt) {
            it.t = 0;
            if (++it.k == K) {
                it.k = 0;
                ++it.c;
            }
        }
    };
    const int ck0 = (int)(s0 / nt);
    const Item start{ck0 / K, ck0 % K, (int)(s0 % nt)};
    // lanes [lo, hi) of the row item `it` stages (`first`: it starts the
    // run or its row)
    auto span_of = [&](const Item& it, bool first, int* lo, int* hi) {
        const long long t0 = (long long)it.t * T;
        const long long a = first ? t0 - q.hb : t0 + q.ha;
        const long long e = t0 + T + q.ha;
        *lo = (int)(a < 0 ? 0 : a < L ? a : L);
        *hi = (int)(e < *lo ? *lo : e < L ? e : L);
    };
    auto slot_base = [&](int slot) { return sm + lay.slots + (size_t)slot * lay.slot; };
    Item ld = start;   // the next item to load (thread 0)
    auto load = [&](int j, int slot, uint64_t* bar) {
        const Item it = ld;
        next(ld);
        int lo, hi;
        span_of(it, j == 0 || it.t == 0, &lo, &hi);
        if (hi == lo) return;
        const size_t nl = (size_t)(hi - lo);
        const size_t at = (size_t)it.ck(K) * L + lo;
        unsigned char* p = slot_base(slot);
        ring::stage(p, secs + (size_t)it.k * L + lo, 4 * nl, secs + (size_t)K * L, bar);
        ring::stage(p + lay.key_plane, x + at, 4 * nl, x + n_all, bar);
        ring::stage(p + 2 * lay.key_plane, valid + at, nl, valid + n_all, bar);
    };
    Item wk = start;   // the next item to walk, and its centre and scale
    float cen_next = centre[start.ck(K)], sc_next = scale_of(scale, start.c);
    int nclip = 0;
    auto consume = [&](int j, int slot) {
        const Item it = wk;
        const float sc = sc_next, center = cen_next;
        next(wk);
        if (j + 1 < n) {   // loaded a walk ahead of their use
            cen_next = centre[wk.ck(K)];
            sc_next = scale_of(scale, wk.c);
        }
        const bool first = j == 0 || it.t == 0;
        const int ck = it.ck(K);
        const size_t crow = (size_t)ck * L;
        int lo, hi;
        span_of(it, first, &lo, &hi);
        const unsigned char* p = slot_base(slot);
        const int32_t* ks =
            (const int32_t*)(p + ((uintptr_t)(secs + (size_t)it.k * L + lo) & 15)) - lo;
        const float* xs =
            (const float*)(p + lay.key_plane + ((uintptr_t)(x + crow + lo) & 15)) - lo;
        const uint8_t* vs = p + 2 * lay.key_plane + ((uintptr_t)(valid + crow + lo) & 15) - lo;
        const int t0 = it.t * T;
        const int base = t0 - q.hb;
        float4* w = wins + (size_t)(j & 1) * win_stride;
        if (!first) {
            // the tile before's last hb + ha lanes: entries T .. of the other window
            const float4* o = wins + (size_t)((j + 1) & 1) * win_stride;
            const int shift = T + (T >> 3);
            const int nc = min(q.hb + q.ha, L - base);   // the row's lanes only
            for (int e = threadIdx.x; e < nc; e += blockDim.x) {
                const int at = e + (e >> 3);
                w[at] = o[at + shift];
            }
        }
        // the staged lanes (16-byte slot loads where the row allows them),
        // and pads past the row in the last tile: a walk reads lanes
        // [0, max(L, t0 + T)) only
        const int end = hi < L ? hi : max(L, t0 + T);
        for (int pl = (lo & ~3) + 4 * (int)threadIdx.x; pl < end; pl += 4 * (int)blockDim.x) {
            float4 v4[4];
            if (vec && pl >= lo && pl + 4 <= hi) {
                const int4 k4 = *reinterpret_cast<const int4*>(ks + pl);
                const float4 x4 = *reinterpret_cast<const float4*>(xs + pl);
                const uchar4 u4 = *reinterpret_cast<const uchar4*>(vs + pl);
                v4[0] = lane_value(k4.x, x4.x, u4.x != 0, sc, center);
                v4[1] = lane_value(k4.y, x4.y, u4.y != 0, sc, center);
                v4[2] = lane_value(k4.z, x4.z, u4.z != 0, sc, center);
                v4[3] = lane_value(k4.w, x4.w, u4.w != 0, sc, center);
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int pu = pl + u;
                    v4[u] = pu >= lo && pu < hi
                        ? lane_value(ks[pu], xs[pu], vs[pu] != 0, sc, center)
                        : pad_value();
                }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int e = pl + u - base;
                if (pl + u >= lo && pl + u < end) w[e + (e >> 3)] = v4[u];
            }
        }
        __syncthreads();
        nclip += range_tile(SharedWin{ring::smem_addr(w), base}, t0 + kLanes * threadIdx.x, q,
                            center, out, crow, n_all);
        if (it.t == nt - 1 || j == n - 1) {
            count_clipped(nclip, tally + ck, clipped + ck);
            nclip = 0;
        }
    };
    ring::run_synced(r, n, load, consume);
}

}  // namespace

// Lanes a row-form window holds at most (the CPU mirror's window_cap).
extern "C" long long tempo_range_row_window() { return kRowWindow; }

// Shared memory of a row-form block at its widest window: the compiler's
// static bytes of the kernel and the dynamic window (admission's figure
// is checked against it on the card).  -1 when the card cannot be asked.
extern "C" long long tempo_range_row_smem() {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, range_rows) != cudaSuccess) return -1;
    return (long long)fa.sharedSizeBytes + 16LL * win_entries(kRowWindow);
}

// Longest row the kernel takes: a lane plus a bound (at most L) stays an
// int32.
extern "C" long long tempo_range_max_lanes() { return 1LL << 30; }

// The row form: `tally` is a [C, K] int32 scratch (zeroed by the centres).
extern "C" int tempo_range_stats(const void* secs, const void* x, const void* valid,
                                 const void* scale, void* out, void* clipped, void* centre,
                                 void* tally, int w, int wa, int mb, int ma, int C, int K,
                                 int L, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = launch_centres(x, valid, scale, centre, clipped, tally, C, K, L, st);
    if (err != cudaSuccess) return (int)err;
    const RangeParams q = range_params(w, wa, mb, ma, L);
    const int nt = (L + kRowTile - 1) / kRowTile;
    const long long want = (long long)kRowTile + q.hb + q.ha;
    const int cap = (int)(want < kRowWindow ? want : kRowWindow);
    const size_t smem = 16 * (size_t)win_entries(cap);
    range_rows<<<(unsigned)((size_t)C * K * nt), kRowThreads, smem, st>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, (const float*)scale,
        (const float*)centre, (float*)out, (float*)clipped, (unsigned*)tally, q, C, K, nt,
        cap);
    return (int)cudaGetLastError();
}

// The centre pass alone over [C, K] rows of L lanes (`tally` may be
// null), so that a run on the card can time it apart from the stats.
extern "C" int tempo_range_centres(const void* x, const void* valid, const void* scale,
                                   void* centre, void* clipped, void* tally, int C, int K, int L,
                                   void* stream) {
    return (int)launch_centres(x, valid, scale, centre, clipped, tally, C, K, L,
                               (cudaStream_t)stream);
}

// Shared memory of the staged form, for the planner's check on the card.
extern "C" long long tempo_range_ring_smem(int mb, int ma, int L, int T, int depth) {
    return (long long)range_ring_layout(mb, ma, L, T, depth).total;
}

// Blocks of the staged form an SM holds at T / kLanes threads and `smem`
// bytes of dynamic shared memory (the grid is the SM count times this);
// -1 when the card cannot be asked.
extern "C" long long tempo_range_ring_occupancy(int T, int smem) {
    if (cudaFuncSetAttribute(range_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
        return -1;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, range_ring_kernel, T / kLanes,
                                                      (size_t)smem) != cudaSuccess)
        return -1;
    return n;
}

// The staged form: `tally` is a [C, K] int32 scratch (zeroed by the
// centres), `blocks` the grid (at most the C * K * ceil(L / T) items).
extern "C" int tempo_range_stats_ring(const void* secs, const void* x, const void* valid,
                                      const void* scale, void* out, void* clipped, void* centre,
                                      void* tally, int w, int wa, int mb, int ma, int C, int K,
                                      int L, int T, int depth, int blocks, void* stream) {
    const size_t smem = range_ring_layout(mb, ma, L, T, depth).total;
    const long long items = (long long)C * K * ((L + T - 1) / T);
    if (depth < 2 || depth > ring::kMaxDepth || T < 32 * kLanes || T % (32 * kLanes) != 0 ||
        T > kRowTile || smem > (size_t)kEmaSmemLimit || blocks < 1 || blocks > items)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = launch_centres(x, valid, scale, centre, clipped, tally, C, K, L, st);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(range_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    range_ring_kernel<<<blocks, T / kLanes, smem, st>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, (const float*)scale,
        (const float*)centre, (float*)out, (float*)clipped, (unsigned*)tally,
        range_params(w, wa, mb, ma, L), C, K, T, depth, items);
    return (int)cudaGetLastError();
}
