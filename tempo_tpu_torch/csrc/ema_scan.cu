// The sequential EMA with an explicit carry, over rows of [R, L].
//
// Replaces no Pallas kernel: tempo_tpu/ops/rolling.py:ema_scan is a
// lax.scan, strictly left to right, and the serving steps
// (tempo_tpu/serve/state.py:_push_fn) run it on every push.  In PyTorch
// that scan is one launch a lane (three graph nodes a lane inside a CUDA
// graph), so it is written by hand here.
//
//   decay = valid ? 1 - a : 1      inp = valid ? a * x : 0
//   y[l]  = decay[l] * y[l - 1] + inp[l]      (y[-1] = y0, or 0)
//   ys = y, y_end = y[L - 1]
//
// Each step rounds twice (a multiply, then an add: the intrinsics below,
// and the library builds with -fmad=false), the plain version's two torch
// ops, so the result is bitwise that of ops/scan.py:ema_scan_plain and
// resuming from y_end at any split is bitwise one run over the whole row.
//
// Bound on H100: bytes (a read of x and valid and a write of ys, 9 B a
// float32 lane): [2, 1024, 4096] moves 75.5 MB, 0.023 ms at 3.35 TB/s.
// The recurrence is sequential in l, so the design is a thread a row:
// a block is one warp over 32 rows, walking them in tiles of 32 lanes.
// A tile is loaded row by row, the warp's 32 threads on 32 consecutive
// lanes of one row (coalesced), into shared memory as the decay and
// input planes (padded to 33 columns, so the transposed reads below hit
// 32 banks); each thread runs its own row's 32 steps from the tile, and
// the outputs leave the same way they came.  y0 is read and y_end
// written in the same launch.  A warp a block leaves few warps an SM to
// hide memory latency ([2, 1024, 4096] is 64 blocks for 132 SMs), and
// rows of one thread each make a long single row slow (2^20 lanes run
// one after another); PERF.md keeps both times.
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
ema_scan_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid, T alpha,
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
    ema_scan_kernel<T><<<blocks, kRows, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const uint8_t*)valid, (T)alpha, (const T*)y0, (T*)ys, (T*)y_end, R,
        L);
    return (int)cudaGetLastError();
}

}  // namespace

// x, valid, ys: [R, L] row-major; y0 (may be NULL: the zero carry) and
// y_end: [R].  is_double picks float64 over float32.  R >= 1, L >= 1.
extern "C" int tempo_ema_scan(const void* x, const void* valid, double alpha,
                              const void* y0, void* ys, void* y_end, int R, int L,
                              int is_double, void* stream) {
    return is_double ? launch<double>(x, valid, alpha, y0, ys, y_end, R, L, stream)
                     : launch<float>(x, valid, alpha, y0, ys, y_end, R, L, stream);
}
