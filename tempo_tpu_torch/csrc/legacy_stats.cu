// Legacy shifted-window rangeBetween(-w, 0) statistics on packed [K, L] series.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_stats.py:_make_kernel
// (through _stats_call and range_stats_pallas; its XLA form,
// tempo_tpu/ops/sortmerge.py:_range_stats_shifted_xla, runs the same op
// sequence).  The TPU kernel unrolls one masked pass per shift j = -ma..mb
// over a VMEM block; its W <= 64 ceiling and L % 128 == 0 rule are VMEM
// limits that this kernel does not have.  The layout follows range_stats.cu:
// one block per series row reads the row's key plane once and walks the C
// packed columns.  For each column it block-reduces (n_valid, sum x) to the
// row's centre, then one thread per output lane runs the legacy loop:
// accumulators start at 0 and +-inf, every shift j from -ma to mb (j = 0
// included) adds the row i - j when it is valid and its key lies in
// [secs[i] - w, secs[i]], sums take centred values and min/max the raw
// ones.  Neighbours outside the row carry the largest key and no validity
// and add +0 and +-inf as the plain version's fill lanes do.  The
// `clipped` audit (the first row beyond either bound, with either end
// valid) is reduced to one count per row and column.  Every accumulator
// line rounds to nearest (and the build passes -fmad=false), so count,
// min, max and clipped are bitwise equal to the plain version, and the
// rest differ only through the centre's summation order.
//
// Bound on H100: bytes.  Each lane reads its key once and, per column, its
// value and validity (4 + 4 + 1 B) and writes seven f32 stat planes, 37 B a
// lane for one column; the (ma + mb) neighbour reads per lane hit L1, and
// the ~12 flops per neighbour stay far below the f32 rate at the extents
// the legacy pick allows (at most 512 rows, tens at HHAR scale).
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kLegacyThreads = 256;

__global__ void __launch_bounds__(kLegacyThreads)
legacy_stats_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                    const uint8_t* __restrict__ valid, float* __restrict__ out,
                    float* __restrict__ clipped, int w, int mb, int ma, int C, int K,
                    int L) {
    __shared__ float shf[32];
    __shared__ int shi[32];
    const int k = blockIdx.x;
    const int32_t* s = secs + (size_t)k * L;
    const size_t stat_plane = (size_t)C * K * L;   // stride between output stats
    const int32_t BIG = INT_MAX;
    const float INF = __int_as_float(0x7f800000);
    const float NaN = tempo_nan();
    // shifts of the row's length or more are all fill and change nothing;
    // the audit's shifts are clamped to the row length (the wrapper caps
    // mb and ma at L)
    const int j_behind = min(mb, L - 1), j_ahead = min(ma, L - 1);
    const int jb_behind = min(mb + 1, L), jb_ahead = min(ma + 1, L);

    for (int c = 0; c < C; ++c) {
        const size_t crow = ((size_t)c * K + k) * L;
        const float* xr = x + crow;
        const uint8_t* vr = valid + crow;

        float nv = 0.f, sx = 0.f;
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            if (vr[i]) {
                nv = __fadd_rn(nv, 1.f);
                sx = __fadd_rn(sx, xr[i]);
            }
        }
        nv = block_sum(nv, shf);
        sx = block_sum(sx, shf);
        const float center = __fdiv_rn(sx, fmaxf(nv, 1.f));

        int nclip = 0;
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            const int32_t si = s[i];
            const bool vi = vr[i] != 0;
            const float xi = xr[i];
            const int32_t lo = wrap_sub(si, w);

            float cnt = 0.f, s1 = 0.f, s2 = 0.f, mn = INF, mx = -INF;
            for (int j = -j_ahead; j <= j_behind; ++j) {
                const int p = i - j;
                const bool in = p >= 0 && p < L;
                const int32_t sj = in ? s[p] : BIG;
                const bool vj = in && vr[p] != 0;
                const bool inw = sj >= lo && sj <= si && vj;
                // the shifted centred plane (valid ? x - centre : 0) and the
                // shifted raw plane, both 0 off the row
                const float xj = vj ? __fsub_rn(xr[p], center) : 0.f;
                const float xraw = in ? xr[p] : 0.f;
                cnt = __fadd_rn(cnt, inw ? 1.f : 0.f);
                s1 = __fadd_rn(s1, inw ? xj : 0.f);
                s2 = __fadd_rn(s2, inw ? __fmul_rn(xj, xj) : 0.f);
                mn = min_nan(mn, inw ? xraw : INF);
                mx = max_nan(mx, inw ? xraw : -INF);
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
            out[2 * stat_plane + at] = cnt > 0.f ? mn : NaN;
            out[3 * stat_plane + at] = cnt > 0.f ? mx : NaN;
            out[4 * stat_plane + at] = cnt > 0.f ? total : NaN;
            out[5 * stat_plane + at] = sd;
            out[6 * stat_plane + at] = vi ? __fdiv_rn(__fsub_rn(xi, mean), sd) : NaN;

            // truncation audit: the first row beyond either bound still in
            // the frame's key range, with either end valid
            bool clip = false;
            {
                const int p = i - jb_behind;
                const int32_t sj = p >= 0 ? s[p] : BIG;
                const bool vj = p >= 0 && vr[p] != 0;
                clip |= sj >= lo && sj <= si && (vi || vj);
            }
            {
                const int p = i + jb_ahead;
                const int32_t sj = p < L ? s[p] : BIG;
                const bool vj = p < L && vr[p] != 0;
                clip |= sj >= lo && sj <= si && (vi || vj);
            }
            nclip += clip ? 1 : 0;
        }
        nclip = block_sum(nclip, shi);
        if (threadIdx.x == 0) clipped[(size_t)c * K + k] = (float)nclip;
    }
}

}  // namespace

extern "C" int tempo_legacy_stats(const void* secs, const void* x, const void* valid,
                                  void* out, void* clipped, int w, int mb, int ma, int C,
                                  int K, int L, void* stream) {
    legacy_stats_kernel<<<K, kLegacyThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, (float*)out,
        (float*)clipped, w, mb, ma, C, K, L);
    return (int)cudaGetLastError();
}
