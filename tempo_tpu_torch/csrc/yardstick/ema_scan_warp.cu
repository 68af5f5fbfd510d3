// The sequential EMA's earlier form, a warp a block: the yardstick that
// chip_smoke.py phase B times the kernel of ../ema_scan.cu against, in
// turns in one run (the same function, the same bits).  It is not part of
// the kernel library and nothing in the package calls it; phase B builds
// it alone with the library's nvcc flags.
//
// A block is one warp over 32 rows, a thread a row, walking them in tiles
// of 32 lanes: a tile is loaded row by row (the warp on 32 consecutive
// lanes of one row) into shared-memory decay and input planes padded to
// 33 columns, each thread runs its row's 32 steps, and the outputs leave
// the way they came.  Nothing is in flight during a tile's scan, so the
// form is bound by memory latency ([2, 1024, 4096]: 64 blocks for 132
// SMs), and a long row runs one stalled thread.
#include "common.cuh"

namespace {

constexpr int kRows = 32;    // rows a block: one warp, a thread a row
constexpr int kLanes = 32;   // lanes a tile

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kRows)
ema_scan_warp_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid, T alpha,
                const T* __restrict__ y0, T* __restrict__ ys, T* __restrict__ y_end,
                int R, int L) {
    __shared__ T dt[kRows][kLanes + 1];
    __shared__ T it[kRows][kLanes + 1];
    const int t = threadIdx.x;
    const size_t row0 = (size_t)blockIdx.x * kRows;
    const int nrows = min(kRows, (int)(R - row0));
    const T one = T(1), zero = T(0);
    const T d_valid = sub_rn(one, alpha);
    T y = (t < nrows && y0 != nullptr) ? y0[row0 + t] : zero;
    for (int l0 = 0; l0 < L; l0 += kLanes) {
        const int n = min(kLanes, L - l0);
        if (t < n) {
#pragma unroll 8
            for (int r = 0; r < nrows; ++r) {
                const size_t off = (row0 + r) * (size_t)L + l0 + t;
                const bool v = valid[off];
                dt[r][t] = v ? d_valid : one;
                it[r][t] = v ? mul_rn(alpha, x[off]) : zero;
            }
        }
        __syncwarp();
        if (t < nrows) {
            for (int j = 0; j < n; ++j) {
                y = add_rn(mul_rn(dt[t][j], y), it[t][j]);
                it[t][j] = y;
            }
        }
        __syncwarp();
        if (t < n) {
#pragma unroll 8
            for (int r = 0; r < nrows; ++r) {
                ys[(row0 + r) * (size_t)L + l0 + t] = it[r][t];
            }
        }
        __syncwarp();
    }
    if (t < nrows) y_end[row0 + t] = y;
}

template <typename T>
int launch(const void* x, const void* valid, double alpha, const void* y0, void* ys,
           void* y_end, int R, int L, void* stream) {
    const int blocks = (R + kRows - 1) / kRows;
    ema_scan_warp_kernel<T><<<blocks, kRows, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const uint8_t*)valid, (T)alpha, (const T*)y0, (T*)ys, (T*)y_end, R,
        L);
    return (int)cudaGetLastError();
}

}  // namespace

// x, valid, ys: [R, L] row-major; y0 (may be NULL: the zero carry) and
// y_end: [R].  is_double picks float64 over float32.  R >= 1, L >= 1.
extern "C" int tempo_ema_scan_warp(const void* x, const void* valid, double alpha,
                                   const void* y0, void* ys, void* y_end, int R, int L,
                                   int is_double, void* stream) {
    return is_double ? launch<double>(x, valid, alpha, y0, ys, y_end, R, L, stream)
                     : launch<float>(x, valid, alpha, y0, ys, y_end, R, L, stream);
}
