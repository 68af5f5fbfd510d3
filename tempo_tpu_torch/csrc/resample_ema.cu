// Fused floor-resample + exact EMA on packed [K, L] series.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_bucket.py:
// _resample_ema_kernel (through _resample_ema_call and
// resample_ema_pallas; the op sequence is _resample_ema_math):
//
//   xs     = x * scale
//   bucket = floor(secs / step)                  (int32, floor division)
//   head   = (lane == 0 || bucket != bucket[lane - 1]) && valid
//   res    = head ? xs : NaN
//   ema    = the exact EMA over the head-masked samples: (d, v) =
//            (1 - alpha, alpha * xs) at heads, (1, 0) elsewhere, through
//            the ladder of common.cuh (the one ema_ladder.cu runs)
//
// JAX's // on int32 floors, and C's / truncates toward zero, so seconds
// before 1970 are floored explicitly.  Pad lanes carry seconds that
// wrapped in the int32 cast; they are never valid, so they are never
// heads, and the lane after them is a pad too.  One block per row, the
// ladder's planes in shared memory (16 bytes a lane) or, past 227 KB, in
// a global scratch the wrapper allocates.  Every float op rounds to
// nearest (and the build passes -fmad=false), so the result is bitwise
// the plain version's on the card.
//
// Bound on H100: bytes, one read of secs, x and valid and one write of
// res and ema (17 bytes a lane); the ladder's log2(L) passes run in
// shared memory.
#include "common.cuh"

namespace {

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {  // b >= 1
    const int32_t q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(kEmaThreads)
resample_ema_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                    const uint8_t* __restrict__ valid, int step, float alpha, float scale,
                    float* __restrict__ res, float* __restrict__ ema,
                    float* __restrict__ scratch, int L) {
    extern __shared__ float smem[];
    const size_t row = (size_t)blockIdx.x * L;
    const EmaPlanes p = ema_planes(smem, scratch, L);

    const float one_minus_a = __fsub_rn(1.f, alpha);
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const int32_t b = floor_div(secs[row + i], step);
        const bool head =
            valid[row + i] != 0 && (i == 0 || b != floor_div(secs[row + i - 1], step));
        const float xs = __fmul_rn(x[row + i], scale);
        res[row + i] = head ? xs : tempo_nan();
        p.d0[i] = head ? one_minus_a : 1.f;
        p.v0[i] = head ? __fmul_rn(alpha, xs) : 0.f;
    }
    __syncthreads();
    const float* y = ema_ladder(p, L);
    for (int i = threadIdx.x; i < L; i += blockDim.x) ema[row + i] = y[i];
}

}  // namespace

extern "C" int tempo_resample_ema(const void* secs, const void* x, const void* valid,
                                  int step, float alpha, float scale, void* res, void* ema,
                                  void* scratch, int K, int L, void* stream) {
    size_t smem;
    cudaError_t err = ema_ladder_smem(resample_ema_kernel, scratch, L, &smem);
    if (err != cudaSuccess) return (int)err;
    resample_ema_kernel<<<K, kEmaThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, step, alpha, scale,
        (float*)res, (float*)ema, (float*)scratch, L);
    return (int)cudaGetLastError();
}
