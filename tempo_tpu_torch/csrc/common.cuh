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
