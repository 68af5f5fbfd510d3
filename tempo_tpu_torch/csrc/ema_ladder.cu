// Exact EMA y_t = (1-a) y_{t-1} + a x_t on packed [K, L] series; invalid
// rows carry the previous value forward.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_kernels.py:_ema_kernel
// (through _ema_call and ema_scan).  The recurrence is the linear map
// y_i = d_i * y_{i-1} + v_i with (d, v) = (1-a, a x) at valid rows and
// (1, 0) elsewhere, combined by the same Hillis-Steele ladder with the
// same association (v += d * v_prev, then d *= d_prev, for spans 1, 2,
// 4, ...), so the f32 rounding is the TPU kernel's: a decoupled-lookback
// or sequential scan would round differently.  One block per row; the
// ladder (common.cuh, shared with resample_ema.cu) ping-pongs between
// two (d, v) plane pairs in shared memory (16 bytes a lane: 204 KB at
// L = 12760, under the 227 KB a block may take after
// cudaFuncSetAttribute).  Longer rows ping-pong through a global scratch
// the wrapper allocates, inside the same kernel.
//
// Bound on H100: bytes, one read of x and valid and one write of y
// (9 bytes a lane).  The ladder's log2(L) passes run in shared memory,
// about 2 flops a lane a pass.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kEmaThreads)
ema_ladder_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                  float alpha, float* __restrict__ out, float* __restrict__ scratch,
                  int L) {
    extern __shared__ float smem[];
    const size_t row = (size_t)blockIdx.x * L;
    const EmaPlanes p = ema_planes(smem, scratch, L);

    const float one_minus_a = __fsub_rn(1.f, alpha);
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const bool ok = valid[row + i] != 0;
        p.d0[i] = ok ? one_minus_a : 1.f;
        p.v0[i] = ok ? __fmul_rn(alpha, x[row + i]) : 0.f;
    }
    __syncthreads();
    const float* y = ema_ladder(p, L);
    for (int i = threadIdx.x; i < L; i += blockDim.x) out[row + i] = y[i];
}

}  // namespace

extern "C" int tempo_ema_smem_limit() { return kEmaSmemLimit; }

extern "C" int tempo_ema_ladder(const void* x, const void* valid, float alpha, void* out,
                                void* scratch, int K, int L, void* stream) {
    size_t smem;
    cudaError_t err = ema_ladder_smem(ema_ladder_kernel, scratch, L, &smem);
    if (err != cudaSuccess) return (int)err;
    ema_ladder_kernel<<<K, kEmaThreads, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const uint8_t*)valid, alpha, (float*)out, (float*)scratch, L);
    return (int)cudaGetLastError();
}
