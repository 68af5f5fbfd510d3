// Inclusive prefix sums of masked x, masked x^2 and the valid count on
// packed [K, L] series: the prefix half of the windowed range engine.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_kernels.py:_cumsum3_kernel
// (through _cumsum3_call and cumsum3):
//
//   xz = valid ? x : 0;  s1 = xz;  s2 = xz * xz;  c = valid ? 1 : 0
//   for span = 1, 2, 4, ... < L:  s += shift(s, span)   (0 shifted in)
//
// The Hillis-Steele association is kept (xz * xz formed first, then the
// shift-adds), so the float32 sums round like the TPU kernel's: a
// sequential or decoupled-lookback scan would associate, and round,
// differently.  Every add is __fadd_rn and the square __fmul_rn (the
// build also passes -fmad=false), and 0 is added where the shift runs
// off the row, as the TPU kernel adds its identity.  One block per row;
// the three planes ping-pong (six planes, 24 bytes a lane) through
// shared memory up to 9,685 lanes and through a global scratch of
// [K, 6, L] floats beyond (common.cuh's ladder switch, shared with the
// EMA kernels).
//
// Bound on H100: bytes, one read of x and valid and one write of the
// three sums (17 bytes a lane).  The ladder's log2(L) passes (3 adds a
// lane each) run in shared memory or, for long rows, in L2-resident
// scratch.
#include "common.cuh"

namespace {

constexpr int kPlanes = 6;

__global__ void __launch_bounds__(kEmaThreads)
cumsum3_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
               float* __restrict__ s1, float* __restrict__ s2, float* __restrict__ cnt,
               float* __restrict__ scratch, int L) {
    extern __shared__ float smem[];
    const size_t row = (size_t)blockIdx.x * L;
    float* base = ladder_row(smem, scratch, L, kPlanes);
    float* a[3] = {base, base + (size_t)L, base + 2 * (size_t)L};
    float* b[3] = {base + 3 * (size_t)L, base + 4 * (size_t)L, base + 5 * (size_t)L};

    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const bool ok = valid[row + i] != 0;
        const float xz = ok ? x[row + i] : 0.f;
        a[0][i] = xz;
        a[1][i] = __fmul_rn(xz, xz);
        a[2][i] = ok ? 1.f : 0.f;
    }
    __syncthreads();
    for (int span = 1; span < L; span <<= 1) {
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            for (int p = 0; p < 3; ++p) {
                b[p][i] = __fadd_rn(a[p][i], i >= span ? a[p][i - span] : 0.f);
            }
        }
        __syncthreads();
        for (int p = 0; p < 3; ++p) {
            float* t = a[p]; a[p] = b[p]; b[p] = t;
        }
    }
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        s1[row + i] = a[0][i];
        s2[row + i] = a[1][i];
        cnt[row + i] = a[2][i];
    }
}

}  // namespace

extern "C" int tempo_cumsum3(const void* x, const void* valid, void* s1, void* s2, void* cnt,
                             void* scratch, int K, int L, void* stream) {
    size_t smem;
    cudaError_t err = ladder_smem(cumsum3_kernel, scratch, L, kPlanes, &smem);
    if (err != cudaSuccess) return (int)err;
    cumsum3_kernel<<<K, kEmaThreads, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const uint8_t*)valid, (float*)s1, (float*)s2, (float*)cnt,
        (float*)scratch, L);
    return (int)cudaGetLastError();
}
