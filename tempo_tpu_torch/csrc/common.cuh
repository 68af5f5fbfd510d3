// Shared device helpers of the tempo_tpu_torch kernels.
//
// Every kernel launches on the caller's stream and allocates nothing:
// the Python wrappers allocate outputs and scratch.  Each C entry point
// returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_pipeline.h>
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
// Hillis-Steele ladders, one block per row: resample_ema.cu (the
// exact-EMA ladder below) and bucket_stats.cu's row form (ema_ladder.cu
// and cumsum3.cu tile theirs).  A ladder ping-pongs between float planes
// of L lanes: in dynamic shared memory while they fit kEmaSmemLimit, else in the
// block's slice of a global scratch of [K, n_planes, L] floats that the
// wrapper allocates (cuda_lib.ladder_scratch makes the same decision).
//
// The EMA recurrence y_i = d_i * y_{i-1} + v_i is combined as the TPU
// kernels combine it (v += d * v_prev, then d *= d_prev, for spans 1, 2,
// 4, ...), between two (d, v) plane pairs (16 bytes a lane).  Every
// product and sum rounds to nearest (and the build passes -fmad=false),
// so no multiply-add is contracted.
// ---------------------------------------------------------------------

constexpr int kEmaThreads = 1024;
// largest dynamic shared memory a block may take on sm_90 (227 KB)
constexpr int kEmaSmemLimit = 232448;

// This block's row of n_planes planes: shared memory, or its slice of
// the scratch.
__device__ __forceinline__ float* ladder_row(float* smem, float* scratch, int L,
                                             int n_planes) {
    return scratch ? scratch + (size_t)blockIdx.x * n_planes * L : smem;
}

struct EmaPlanes {
    float* d0;
    float* v0;
    float* d1;
    float* v1;
};

__device__ __forceinline__ EmaPlanes ema_planes(float* smem, float* scratch, int L) {
    float* base = ladder_row(smem, scratch, L, 4);
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

// Dynamic shared memory of a ladder launch over n_planes planes (0 when
// it runs in scratch), after raising the kernel's limit to it.
template <typename Kernel>
inline cudaError_t ladder_smem(Kernel kernel, const void* scratch, int L, int n_planes,
                               size_t* smem) {
    *smem = 0;
    if (scratch != nullptr) return cudaSuccess;
    *smem = sizeof(float) * (size_t)n_planes * L;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
}

// ---------------------------------------------------------------------
// Stage 2 of a tiled Hillis-Steele ladder: cumsum3.cu (three sums) and
// ema_ladder.cu (the EMA's (d, v)).  By the lemma in cumsum3.cu's header,
// once a first stage has run the levels of spans < T = 2^kClassTileLog2,
// the levels of spans T, 2T, ... < L are a ladder along each residue
// class i mod T.  A block per (row, slab of R residue classes) copies its
// classes (asynchronous 4-byte copies, runs of R consecutive floats) into
// shared memory, runs those levels there two at a time where two remain
// (the same tree: (X o X[-s]) o (X[-2s] o X[-3s]), each partner the
// identity where it runs off the class), ping-ponging two buffers of P
// planes, and writes planes kFirstOut .. P-1 back in place.  R is the
// widest power of two <= T that keeps a slab at kClassSlab entries (one
// class at least) and the buffers within kEmaSmemLimit.
//
// Op gives kPlanes (P), kFirstOut, ident(p) (the identity's plane p) and
// combine(a, b) (a set to a after its partner b, every operation rounded
// as the first stage rounds it).
// ---------------------------------------------------------------------

constexpr int kClassTileLog2 = 10;     // T: residue classes mod 1024
constexpr int kClassThreads = 256;
constexpr size_t kClassSlab = 2048;    // entries a block (at least one class)

template <int P>
struct ClassPlanes {
    float* p[P];
};

template <class Op>
__global__ void __launch_bounds__(kClassThreads)
class_ladder(ClassPlanes<Op::kPlanes> planes, int L, int log_r, int M) {
    constexpr int P = Op::kPlanes;
    extern __shared__ float smem[];
    const int T = 1 << kClassTileLog2;
    const int R = 1 << log_r;
    const int n = M * R;
    const size_t row = (size_t)(blockIdx.x / (T / R)) * L;
    const int r0 = (int)(blockIdx.x % (T / R)) * R;
    float* cur = smem;                     // plane p at [p n, (p + 1) n)
    float* nxt = smem + P * (size_t)n;
    auto lane_of = [&](int e) {
        return r0 + (e & (R - 1)) + (long long)(e >> log_r) * T;
    };

    // asynchronous 4-byte copies, all in flight before the one wait
    for (int e = threadIdx.x; e < n; e += kClassThreads) {
        const long long i = lane_of(e);
#pragma unroll
        for (int p = 0; p < P; ++p) {
            if (i < L) __pipeline_memcpy_async(cur + p * n + e, planes.p[p] + row + i,
                                               sizeof(float));
            else cur[p * n + e] = Op::ident(p);
        }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // entry f of the buffer, or the identity where take is false
    auto entry = [&](const float* buf, bool take, int f, float out[P]) {
#pragma unroll
        for (int p = 0; p < P; ++p) out[p] = take ? buf[p * n + f] : Op::ident(p);
    };
    long long span = 1;
    while (span * T < L) {
        const bool two = 2 * span * T < L;
        const int m1 = (int)span;
        for (int e = threadIdx.x; e < n; e += kClassThreads) {
            const int m = e >> log_r;
            float a[P], b[P];
            entry(cur, true, e, a);
            entry(cur, m >= m1, e - m1 * R, b);
            Op::combine(a, b);
            if (two) {
                entry(cur, m >= 2 * m1, e - 2 * m1 * R, b);
                if (m >= 2 * m1) {
                    float c[P];
                    entry(cur, m >= 3 * m1, e - 3 * m1 * R, c);
                    Op::combine(b, c);
                }
                Op::combine(a, b);
            }
#pragma unroll
            for (int p = 0; p < P; ++p) nxt[p * n + e] = a[p];
        }
        __syncthreads();
        float* t = cur; cur = nxt; nxt = t;
        span <<= two ? 2 : 1;
    }
    for (int e = threadIdx.x; e < n; e += kClassThreads) {
        const long long i = lane_of(e);
        if (i < L) {
#pragma unroll
            for (int p = Op::kFirstOut; p < P; ++p) planes.p[p][row + i] = cur[p * n + e];
        }
    }
}

// longest row stage 2 takes over P planes (its classes at R = 1)
inline long long class_ladder_max_lanes(int P) {
    return (long long)(kEmaSmemLimit / (2 * P * sizeof(float))) << kClassTileLog2;
}

// Stage 2 over K rows of L > T lanes, on the stream after stage 1.
template <class Op>
inline cudaError_t launch_class_ladder(ClassPlanes<Op::kPlanes> planes, int K, int L,
                                       cudaStream_t st) {
    constexpr size_t kEntry = 2 * Op::kPlanes * sizeof(float);   // both buffers
    const int M = (L + (1 << kClassTileLog2) - 1) >> kClassTileLog2;
    int log_r = kClassTileLog2;
    while (log_r > 0 && (((size_t)M << log_r) > kClassSlab
                         || kEntry * ((size_t)M << log_r) > (size_t)kEmaSmemLimit))
        --log_r;
    const size_t smem = kEntry * ((size_t)M << log_r);
    if (smem > (size_t)kEmaSmemLimit) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(class_ladder<Op>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    class_ladder<Op><<<(unsigned)((size_t)K << (kClassTileLog2 - log_r)), kClassThreads, smem,
                       st>>>(planes, L, log_r, M);
    return cudaGetLastError();
}
