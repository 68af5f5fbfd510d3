// Tumbling-bucket statistics on packed [K, L] series: mean, count, min,
// max, sum, stddev and zscore of each row's bucket, broadcast to every
// row of the bucket (resample mean/min/max, withGroupedStats and vwap of
// the distributed frame).
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_bucket.py:_make_bucket_kernel
// (through _bucket_stats_call and bucket_stats_pallas / bucket_stats_packed),
// which runs _bucket_math on a VMEM block:
//
//   centre = sum(valid ? x : 0) / max(n_valid, 1)          (the ROW's mean)
//   planes = count, centred sum, centred sum of squares, min x, max x
//   forward segmented inclusive scan over the head flags (the identity and
//     the flag 1 shifted in), then the reverse tail broadcast (0 shifted
//     in): every lane holds its bucket's totals
//   mean, sum, min, max NaN where count = 0, stddev NaN where count <= 1,
//   var = (s2 - s1*s1/max(cnt,1)) / max(cnt-1, 1) clamped at 0,
//   zscore = (x - mean) / std at valid lanes
//
// The head flags (bid changes) and tail flags are formed once per lane from
// the row's bucket ids, which all C columns of a launch share.  The ladders
// keep the TPU's Hillis-Steele association, so the sums round like the TPU
// kernel's and like the plain version's (ops/bucket.py:bucket_stats_plain);
// every add, product, quotient and root rounds to nearest (and the build
// passes -fmad=false), so count, min and max are bitwise equal to the plain
// version, and the rest differ only through the centre's summation order.
// A column's result is the same whether it runs alone or in a stack.
//
// One block per series row walks the C columns.  The five planes and the
// flag ping-pong between two sets (12 float planes, 48 bytes a lane): in
// dynamic shared memory up to 4,837 lanes, and past that in the block's
// slice of a global scratch of [K, 12, L] floats (common.cuh's ladder
// switch; cuda_lib.ladder_scratch makes the same decision).
//
// Bound on H100: bytes.  One read of the int32 bucket ids (4 B a lane) and,
// per column, of x and valid (5 B), one write of the seven f32 outputs
// (28 B): 4 + 33C bytes a lane.  The two ladders make 2 * ceil(log2 L)
// passes of about a dozen flops a lane; past the shared-memory limit each
// pass also reads and writes the scratch, which then bounds the time.  A
// per-bucket design that keeps the work out of device memory is left to a
// later performance change.
#include "common.cuh"

namespace {

constexpr int kPlanes = 6;                 // count, s1, s2, min, max, flag
constexpr int kSetPlanes = 2 * kPlanes;    // two ping-pong sets

__global__ void __launch_bounds__(kEmaThreads)
bucket_stats_kernel(const int32_t* __restrict__ bid, const float* __restrict__ x,
                    const uint8_t* __restrict__ valid, float* __restrict__ out,
                    float* __restrict__ scratch, int C, int K, int L) {
    extern __shared__ float smem[];
    __shared__ float shf[32];
    const int k = blockIdx.x;
    const int32_t* b = bid + (size_t)k * L;
    const size_t stat_plane = (size_t)C * K * L;   // stride between outputs
    const float INF = __int_as_float(0x7f800000);
    const float NaN = tempo_nan();
    float* base = ladder_row(smem, scratch, L, kSetPlanes);

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

        float* a[kPlanes];
        float* n[kPlanes];
        for (int p = 0; p < kPlanes; ++p) {
            a[p] = base + (size_t)p * L;
            n[p] = base + (size_t)(kPlanes + p) * L;
        }
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            const bool ok = vr[i] != 0;
            const float xi = xr[i];
            const float xc = ok ? __fsub_rn(xi, center) : 0.f;
            a[0][i] = ok ? 1.f : 0.f;
            a[1][i] = xc;
            a[2][i] = __fmul_rn(xc, xc);
            a[3][i] = ok ? xi : INF;
            a[4][i] = ok ? xi : -INF;
            a[5][i] = (i == 0 || b[i] != b[i - 1]) ? 1.f : 0.f;
        }
        __syncthreads();

        // forward segmented inclusive scan: a lane stops taking its
        // predecessor's partial once a head flag lies between them
        for (int span = 1; span < L; span <<= 1) {
            for (int i = threadIdx.x; i < L; i += blockDim.x) {
                const bool ok = i >= span;
                const float f = a[5][i];
                const bool head = f > 0.f;
                for (int p = 0; p < 3; ++p) {
                    const float prev = ok ? a[p][i - span] : 0.f;
                    n[p][i] = head ? a[p][i] : __fadd_rn(a[p][i], prev);
                }
                const float pmin = ok ? a[3][i - span] : INF;
                const float pmax = ok ? a[4][i - span] : -INF;
                n[3][i] = head ? a[3][i] : min_nan(a[3][i], pmin);
                n[4][i] = head ? a[4][i] : max_nan(a[4][i], pmax);
                n[5][i] = fmaxf(f, ok ? a[5][i - span] : 1.f);
            }
            __syncthreads();
            for (int p = 0; p < kPlanes; ++p) {
                float* t = a[p]; a[p] = n[p]; n[p] = t;
            }
        }

        // reverse tail broadcast: each lane takes the value at the first
        // tail at or after it, its own bucket's last lane
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            a[5][i] = (i == L - 1 || b[i] != b[i + 1]) ? 1.f : 0.f;
        }
        __syncthreads();
        for (int span = 1; span < L; span <<= 1) {
            for (int i = threadIdx.x; i < L; i += blockDim.x) {
                const bool ok = i < L - span;
                const float g = a[5][i];
                const bool tail = g > 0.f;
                for (int p = 0; p < 5; ++p) {
                    const float next = ok ? a[p][i + span] : 0.f;
                    n[p][i] = tail ? a[p][i] : next;
                }
                n[5][i] = fmaxf(g, ok ? a[5][i + span] : 0.f);
            }
            __syncthreads();
            for (int p = 0; p < kPlanes; ++p) {
                float* t = a[p]; a[p] = n[p]; n[p] = t;
            }
        }

        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            const float cnt = a[0][i], s1 = a[1][i], s2 = a[2][i];
            const float cnt1 = fmaxf(cnt, 1.f);
            const float mean = cnt > 0.f ? __fadd_rn(__fdiv_rn(s1, cnt1), center) : NaN;
            const float total = __fadd_rn(s1, __fmul_rn(cnt, center));
            const float var =
                cnt > 1.f ? __fdiv_rn(__fsub_rn(s2, __fdiv_rn(__fmul_rn(s1, s1), cnt1)),
                                      fmaxf(__fsub_rn(cnt, 1.f), 1.f))
                          : NaN;
            const float std = cnt > 1.f ? __fsqrt_rn(max_nan(var, 0.f)) : NaN;
            const size_t o = crow + i;
            out[o] = mean;
            out[stat_plane + o] = cnt;
            out[2 * stat_plane + o] = cnt > 0.f ? a[3][i] : NaN;
            out[3 * stat_plane + o] = cnt > 0.f ? a[4][i] : NaN;
            out[4 * stat_plane + o] = cnt > 0.f ? total : NaN;
            out[5 * stat_plane + o] = std;
            out[6 * stat_plane + o] =
                vr[i] ? __fdiv_rn(__fsub_rn(xr[i], mean), std) : NaN;
        }
        // the next column's first pass overwrites planes other threads
        // may still read here
        __syncthreads();
    }
}

}  // namespace

extern "C" int tempo_bucket_stats(const void* bid, const void* x, const void* valid,
                                  void* out, void* scratch, int C, int K, int L,
                                  void* stream) {
    size_t smem;
    cudaError_t err = ladder_smem(bucket_stats_kernel, scratch, L, kSetPlanes, &smem);
    if (err != cudaSuccess) return (int)err;
    bucket_stats_kernel<<<K, kEmaThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)bid, (const float*)x, (const uint8_t*)valid, (float*)out,
        (float*)scratch, C, K, L);
    return (int)cudaGetLastError();
}
