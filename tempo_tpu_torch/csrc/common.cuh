// Shared device helpers of the tempo_tpu_torch kernels.
//
// Every kernel launches on the caller's stream and allocates nothing:
// the Python wrappers allocate outputs and scratch.  Each C entry point
// returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TEMPO_FULL_MASK 0xffffffffu

// the canonical quiet NaN (the bit pattern of numpy/jax/torch nan)
__device__ __forceinline__ float tempo_nan() { return __int_as_float(0x7fc00000); }

// jnp.minimum / torch.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? tempo_nan() : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? tempo_nan() : fmaxf(a, b);
}

// int32 add/sub with two's-complement wrap (the TPU kernels' i32 lane
// arithmetic), written through unsigned so the compiler may not assume
// no overflow
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// Block-wide sum; blockDim.x must be a multiple of 32 (<= 1024).  The
// order is fixed by the launch shape, so results repeat run to run.
template <typename T>
__device__ T block_sum(T v, T* sh /* >= 32 */) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(TEMPO_FULL_MASK, v, o);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    __syncthreads();                       // sh may still be read by a previous call
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        v = lane < nw ? sh[lane] : T(0);
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(TEMPO_FULL_MASK, v, o);
        if (lane == 0) sh[0] = v;
    }
    __syncthreads();
    return sh[0];
}

// Block-wide inclusive running max over threadIdx order; *total gets
// the max of the whole block.  blockDim.x a multiple of 32.
__device__ __forceinline__ int block_scan_max(int v, int* sh /* >= 32 */, int* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(TEMPO_FULL_MASK, v, o);
        if (lane >= o) v = max(v, n);
    }
    __syncthreads();                       // sh may still be read by a previous call
    if (lane == 31) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        int t = lane < nw ? sh[lane] : -1;
        for (int o = 1; o < 32; o <<= 1) {
            const int n = __shfl_up_sync(TEMPO_FULL_MASK, t, o);
            if (lane >= o) t = max(t, n);
        }
        if (lane < nw) sh[lane] = t;
    }
    __syncthreads();
    if (wid > 0) v = max(v, sh[wid - 1]);
    *total = sh[nw - 1];
    return v;
}

// ---------------------------------------------------------------------
// The exact-EMA ladder shared by ema_ladder.cu and resample_ema.cu.
//
// The recurrence y_i = d_i * y_{i-1} + v_i is combined by the
// Hillis-Steele ladder of the TPU kernels (v += d * v_prev, then
// d *= d_prev, for spans 1, 2, 4, ...), one block per row, ping-ponging
// between two (d, v) plane pairs: in shared memory (16 bytes a lane,
// up to kEmaSmemLimit) or, for longer rows, in a global scratch of
// [K, 4, L] floats that the wrapper allocates.  Every product and sum
// rounds to nearest (and the build passes -fmad=false), so no
// multiply-add is contracted.
// ---------------------------------------------------------------------

constexpr int kEmaThreads = 1024;
// largest dynamic shared memory a block may take on sm_90 (227 KB)
constexpr int kEmaSmemLimit = 232448;

struct EmaPlanes {
    float* d0;
    float* v0;
    float* d1;
    float* v1;
};

// This block's row of planes: shared memory, or its slice of scratch.
__device__ __forceinline__ EmaPlanes ema_planes(float* smem, float* scratch, int L) {
    float* base = scratch ? scratch + (size_t)blockIdx.x * 4 * L : smem;
    return {base, base + L, base + 2 * (size_t)L, base + 3 * (size_t)L};
}

// Runs the ladder over d0/v0 (filled by the caller, then a
// __syncthreads()); returns the plane that holds the EMA.
__device__ __forceinline__ float* ema_ladder(EmaPlanes p, int L) {
    for (int span = 1; span < L; span <<= 1) {
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            const float d_prev = i >= span ? p.d0[i - span] : 1.f;
            const float v_prev = i >= span ? p.v0[i - span] : 0.f;
            const float d = p.d0[i];
            p.v1[i] = __fadd_rn(p.v0[i], __fmul_rn(d, v_prev));
            p.d1[i] = __fmul_rn(d, d_prev);
        }
        __syncthreads();
        float* t = p.d0; p.d0 = p.d1; p.d1 = t;
        t = p.v0; p.v0 = p.v1; p.v1 = t;
    }
    return p.v0;
}

// Dynamic shared memory of a ladder launch (0 when it runs in scratch),
// after raising the kernel's limit to it.
template <typename Kernel>
inline cudaError_t ema_ladder_smem(Kernel kernel, const void* scratch, int L, size_t* smem) {
    *smem = 0;
    if (scratch != nullptr) return cudaSuccess;
    *smem = (size_t)16 * L;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
}
