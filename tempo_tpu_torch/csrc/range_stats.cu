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
// Bound on H100: bytes.  Each lane reads its key, value and validity once
// and writes seven f32 stat planes; the (mb + ma) neighbour reads per lane
// hit L1, and the arithmetic, ~10 flops per neighbour, stays far below
// the f32 rate at the windows the frame layer derives (tens of rows).
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kStatsThreads = 256;

__global__ void __launch_bounds__(kStatsThreads)
range_stats_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                   const uint8_t* __restrict__ valid, const float* __restrict__ scale,
                   float* __restrict__ out, float* __restrict__ clipped, int w, int wa,
                   int mb, int ma, int C, int K, int L) {
    __shared__ float shf[32];
    __shared__ int shi[32];
    const int k = blockIdx.x;
    const int32_t* s = secs + (size_t)k * L;
    const size_t stat_plane = (size_t)C * K * L;   // stride between output stats
    const int32_t BIG = INT_MAX;
    const float INF = __int_as_float(0x7f800000);
    const float NaN = tempo_nan();
    // a bound >= L has no row beyond it
    const int mb_loop = min(mb, L - 1), ma_loop = min(ma, L - 1);
    const int jb_behind = mb >= L - 1 ? L : mb + 1;
    const int jb_ahead = ma >= L - 1 ? L : ma + 1;

    for (int c = 0; c < C; ++c) {
        const size_t crow = ((size_t)c * K + k) * L;
        const float* xr = x + crow;
        const uint8_t* vr = valid + crow;
        const float sc = scale[c];

        float nv = 0.f, sx = 0.f;
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            if (vr[i]) {
                nv = __fadd_rn(nv, 1.f);
                sx = __fadd_rn(sx, __fmul_rn(xr[i], sc));
            }
        }
        nv = block_sum(nv, shf);
        sx = block_sum(sx, shf);
        const float center = __fdiv_rn(sx, fmaxf(nv, 1.f));
        // centred value of row p: valid ? x*scale - center : 0
        auto centred = [&](int p) -> float {
            return vr[p] ? __fsub_rn(__fmul_rn(xr[p], sc), center) : 0.f;
        };

        int nclip = 0;
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            const int32_t si = s[i];
            const bool vi = vr[i] != 0;
            const float xi = __fmul_rn(xr[i], sc);
            const int32_t lo = wrap_sub(si, w);
            const int32_t hi = min(wrap_add(si, min(wa, wrap_sub(BIG, si))), BIG - 1);

            const float xc = centred(i);
            float cnt = vi ? 1.f : 0.f;
            float s1 = xc;
            float s2 = __fmul_rn(xc, xc);
            float mn = vi ? xc : INF;
            float mx = vi ? xc : -INF;
            for (int j = 1; j <= mb_loop; ++j) {
                bool inw = false;
                float xj = 0.f;
                if (j <= i) {
                    const int p = i - j;
                    const int32_t s_lo = vr[p] ? s[p] : INT_MIN;
                    inw = s_lo >= lo;
                    xj = centred(p);
                }
                cnt = __fadd_rn(cnt, inw ? 1.f : 0.f);
                s1 = __fadd_rn(s1, inw ? xj : 0.f);
                s2 = __fadd_rn(s2, inw ? __fmul_rn(xj, xj) : 0.f);
                mn = min_nan(mn, inw ? xj : INF);
                mx = max_nan(mx, inw ? xj : -INF);
            }
            for (int j = 1; j <= ma_loop; ++j) {
                bool inw = false;
                float xj = 0.f;
                if (i < L - j) {
                    const int p = i + j;
                    const int32_t s_hi = vr[p] ? s[p] : BIG;
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
            const size_t at = crow + i;
            out[0 * stat_plane + at] = mean;
            out[1 * stat_plane + at] = cnt;
            out[2 * stat_plane + at] = cnt > 0.f ? __fadd_rn(mn, center) : NaN;
            out[3 * stat_plane + at] = cnt > 0.f ? __fadd_rn(mx, center) : NaN;
            out[4 * stat_plane + at] = cnt > 0.f ? total : NaN;
            out[5 * stat_plane + at] = sd;
            out[6 * stat_plane + at] = vi ? __fdiv_rn(__fsub_rn(xi, mean), sd) : NaN;

            // truncation audit: the first row beyond either bound still in
            // the frame's key range, with either end valid
            bool clip = false;
            {
                int32_t sj = BIG;
                bool vj = false;
                if (i >= jb_behind) { sj = s[i - jb_behind]; vj = vr[i - jb_behind] != 0; }
                clip |= (sj >= lo) && (sj <= hi) && (vi || vj);
            }
            {
                int32_t sj = BIG;
                bool vj = false;
                if (i < L - jb_ahead) { sj = s[i + jb_ahead]; vj = vr[i + jb_ahead] != 0; }
                clip |= (sj >= lo) && (sj <= hi) && (vi || vj);
            }
            nclip += clip ? 1 : 0;
        }
        nclip = block_sum(nclip, shi);
        if (threadIdx.x == 0) clipped[(size_t)c * K + k] = (float)nclip;
    }
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
