// The centre pass and the shared-memory window of the two range-stats
// kernels: range_stats.cu (rangeBetween(-w, +wa), row 2) and
// legacy_stats.cu (the legacy shifted sweep, row 11).
//
// range_centres: a block per (column, row) sums its row's valid x * scale
// in a fixed order (thread t: the groups of four lanes t, t + T, ...
// lane by lane, 16-byte loads where aligned; then block_sum) into a
// [C, K] centre plane, and zeroes the row's `clipped` and clip tally.
//
// A window holds, for each lane a walk reads, its 16-byte entry: the
// centred value c (0 where invalid), c*c with the validity in its sign bit
// (-0.0 where invalid: a valid c*c is +0 or more, and a NaN the card
// computes is 0x7fffffff, positive), the raw key and x * scale.  Entry q
// sits at q + q / 8, so threads reading every fourth entry hit distinct
// banks.  A null `scale` means 1 (x * 1 keeps x's bits but a NaN's payload).
#pragma once

#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kCentreThreads = 1024;   // at most; 256 for rows up to 32,768 lanes

// shared-memory entries of a window of n lanes (entry q at q + q / 8)
__host__ __device__ inline int win_entries(int n) { return n + (n >> 3) + 1; }

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_zero() { return __int_as_float((int)0x80000000); }

// (c, c*c with validity in its sign, key, x * scale) of a lane
__device__ __forceinline__ float4 lane_value(int32_t key, float x, bool ok, float sc,
                                             float center) {
    const float xs = __fmul_rn(x, sc);
    const float c = ok ? __fsub_rn(xs, center) : 0.f;
    return make_float4(c, ok ? __fmul_rn(c, c) : neg_zero(), __int_as_float(key), xs);
}
// a lane outside the row (never read by a step that counts)
__device__ __forceinline__ float4 pad_value() {
    return make_float4(0.f, neg_zero(), __int_as_float(INT_MAX), 0.f);
}
__device__ __forceinline__ bool v_ok(float4 v) { return __float_as_int(v.y) >= 0; }
__device__ __forceinline__ int32_t v_key(float4 v) { return __float_as_int(v.z); }

// The row's centre of column (x, valid) under `sc`: thread t sums the
// groups of four lanes t, t + T, t + 2T, ... (T = blockDim.x) lane by lane,
// then the tail lanes past the last whole group, then block_sum.  The order
// depends on the lanes only; the loads are 16 bytes where aligned.
__device__ __forceinline__ float range_center(const float* xr, const uint8_t* vr, float sc,
                                              int L, float* shf) {
    float nv = 0.f, sx = 0.f;
    auto add = [&](bool ok, float xv) {
        if (ok) {
            nv = __fadd_rn(nv, 1.f);
            sx = __fadd_rn(sx, __fmul_rn(xv, sc));
        }
    };
    const int ng = L >> 2;
    const bool vec = (((uintptr_t)xr & 15) == 0) && (((uintptr_t)vr & 3) == 0);
#pragma unroll 4
    for (int g = threadIdx.x; g < ng; g += blockDim.x) {
        if (vec) {
            const float4 x4 = reinterpret_cast<const float4*>(xr)[g];
            const uchar4 v4 = reinterpret_cast<const uchar4*>(vr)[g];
            add(v4.x, x4.x);
            add(v4.y, x4.y);
            add(v4.z, x4.z);
            add(v4.w, x4.w);
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) add(vr[4 * g + u] != 0, xr[4 * g + u]);
        }
    }
    const int i = 4 * ng + threadIdx.x;
    if (i < L) add(vr[i] != 0, xr[i]);
    nv = block_sum(nv, shf);
    sx = block_sum(sx, shf);
    return __fdiv_rn(sx, fmaxf(nv, 1.f));
}

// the column's scale (1 where the caller gave none: x * 1 keeps x's bits)
__device__ __forceinline__ float scale_of(const float* scale, int c) {
    return scale != nullptr ? scale[c] : 1.f;
}

__global__ void __launch_bounds__(kCentreThreads)
range_centres(const float* __restrict__ x, const uint8_t* __restrict__ valid,
              const float* __restrict__ scale, float* __restrict__ centre,
              float* __restrict__ clipped, unsigned* __restrict__ tally, int K, int L) {
    __shared__ float shf[32];
    const size_t crow = (size_t)blockIdx.x * L;
    const float c = range_center(x + crow, valid + crow, scale_of(scale, blockIdx.x / K), L, shf);
    if (threadIdx.x == 0) {
        centre[blockIdx.x] = c;
        clipped[blockIdx.x] = 0.f;
        if (tally != nullptr) tally[blockIdx.x] = 0u;
    }
}

cudaError_t launch_centres(const void* x, const void* valid, const void* scale, void* centre,
                           void* clipped, void* tally, int C, int K, int L, cudaStream_t st) {
    range_centres<<<C * K, L > 32768 ? kCentreThreads : 256, 0, st>>>(
        (const float*)x, (const uint8_t*)valid, (const float*)scale, (float*)centre,
        (float*)clipped, (unsigned*)tally, K, L);
    return cudaGetLastError();
}

// A window: lanes [base, ...) at entries q + q / 8.
struct Win {
    const float4* w;
    int base;
    __device__ __forceinline__ float4 at(int p) const {
        const int q = p - base;
        return w[q + (q >> 3)];
    }
};

// Fill win_sm with the entries of lanes [base, base + n) of one (column,
// row) (keys srow, values xr, validity vr; pads outside [0, L)), four
// lanes a thread, 16-byte loads where `vec` says the row allows them.
__device__ __forceinline__ Win fill_window(float4* win_sm, int base, int n,
                                           const int32_t* srow, const float* xr,
                                           const uint8_t* vr, float sc, float center, int L,
                                           bool vec) {
    const int p0 = base & ~3;
    for (int p = p0 + 4 * (int)threadIdx.x; p < base + n; p += 4 * (int)blockDim.x) {
        float4 v4[4];
        if (vec && p >= 0 && p + 4 <= L) {
            const int4 k4 = *reinterpret_cast<const int4*>(srow + p);
            const float4 x4 = *reinterpret_cast<const float4*>(xr + p);
            const uchar4 u4 = *reinterpret_cast<const uchar4*>(vr + p);
            v4[0] = lane_value(k4.x, x4.x, u4.x != 0, sc, center);
            v4[1] = lane_value(k4.y, x4.y, u4.y != 0, sc, center);
            v4[2] = lane_value(k4.z, x4.z, u4.z != 0, sc, center);
            v4[3] = lane_value(k4.w, x4.w, u4.w != 0, sc, center);
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int pu = p + u;
                v4[u] = (pu >= 0 && pu < L) ? lane_value(srow[pu], xr[pu], vr[pu] != 0, sc, center)
                                            : pad_value();
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int j = p + u - base;
            if (j >= 0 && j < n) win_sm[j + (j >> 3)] = v4[u];
        }
    }
    return Win{win_sm, base};
}

// a row's 16-byte loads are aligned where L is a multiple of 4 and the
// planes start on 16 bytes (4 for the validity bytes)
__device__ __forceinline__ bool rows_vectorise(const int32_t* secs, const float* x,
                                               const uint8_t* valid, int L) {
    return ((L & 3) == 0) && (((uintptr_t)secs & 15) == 0) && (((uintptr_t)x & 15) == 0) &&
           (((uintptr_t)valid & 3) == 0);
}

// Add a warp's clipped lanes to the row's uint32 tally and raise the row's
// float `clipped` to the new total rounded once (an atomicMax on its bits,
// whose order is the value's for floats >= 0), so `clipped` ends as the
// exact count rounded once, whatever the order of the tiles.
__device__ __forceinline__ void count_clipped(int nclip, unsigned* tally, float* clipped) {
    for (int o = 16; o > 0; o >>= 1) nclip += __shfl_down_sync(TEMPO_FULL_MASK, nclip, o);
    if ((threadIdx.x & 31) == 0 && nclip) {
        const unsigned now = atomicAdd(tally, (unsigned)nclip) + (unsigned)nclip;
        atomicMax((int*)clipped, __float_as_int((float)now));
    }
}

}  // namespace
