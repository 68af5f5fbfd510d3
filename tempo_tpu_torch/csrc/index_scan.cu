// Valid-index scans and the forward fill on packed [K, L] series.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_kernels.py:_last_valid_index_kernel
// and its mirror _first_valid_index_kernel (through _index_scan_call,
// last_valid_index_scan and first_valid_index_scan), and
// _last_valid_kernel (through _last_valid_call and last_valid_scan).
//
//   last_valid_index   out[i] = max{ j <= i : valid[j] }, -1 where none
//   first_valid_index  out[i] = min{ j >= i : valid[j] },  L where none
//   last_valid_scan    val[i] = x[last_valid_index[i]] (0.0 where none),
//                      has[i] = last_valid_index[i] >= 0
//
// L is the tensor's padded width.  The TPU kernels run a log2(L) roll
// ladder over whole VMEM rows; here one block walks its row in tiles of
// kThreads * kItems lanes: each thread scans kItems consecutive lanes,
// a block-wide running max (common.cuh) combines the threads, and a
// carry joins the tiles, so any L works.  The reverse min is the
// running max of the negated lane, walked from the row's end.  Integer
// max is exact, so the result is the same as any other scan's; the
// forward fill only copies x, so it is bitwise too.
//
// Bound on H100: bytes.  The index scans read 1 byte and write 4 a lane;
// the fill reads 5 (x, valid) and writes 5 (value, has).  Each thread
// owning kItems consecutive lanes makes a warp's loads and stores stride
// kItems lanes apart, and a tile costs three __syncthreads: at the main
// path's shapes that keeps the kernel about 6x above the bound
// (PERF.md); a striped layout would coalesce them.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;

template <bool kReverse, bool kValues>
__global__ void __launch_bounds__(kThreads)
index_scan_kernel(const uint8_t* __restrict__ valid, const float* __restrict__ x,
                  int32_t* __restrict__ idx_out, float* __restrict__ val_out,
                  uint8_t* __restrict__ has_out, int L) {
    __shared__ int warp_sh[32];
    __shared__ int incl[kThreads];
    const size_t row = (size_t)blockIdx.x * L;
    // the scan is a running max of cand: the lane where valid (its
    // negation in reverse), `none` elsewhere
    const int none = kReverse ? -L : -1;
    int carry = none;                      // max over the tiles before
    for (int base = 0; base < L; base += kThreads * kItems) {
        const int r0 = base + threadIdx.x * kItems;
        int run[kItems];
        int m = none;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
            const int r = r0 + j;          // position in walk order
            if (r < L) {
                const int i = kReverse ? L - 1 - r : r;
                if (valid[row + i]) m = max(m, kReverse ? -i : i);
            }
            run[j] = m;
        }
        int total;
        incl[threadIdx.x] = block_scan_max(m, warp_sh, &total);
        __syncthreads();
        const int before = max(carry, threadIdx.x > 0 ? incl[threadIdx.x - 1] : none);
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
            const int r = r0 + j;
            if (r >= L) break;
            const int i = kReverse ? L - 1 - r : r;
            const int c = max(before, run[j]);
            if (kValues) {
                val_out[row + i] = c >= 0 ? x[row + c] : 0.f;
                has_out[row + i] = c >= 0;
            } else {
                idx_out[row + i] = kReverse ? -c : c;
            }
        }
        carry = max(carry, total);
        __syncthreads();                   // incl is rewritten next tile
    }
}

template <bool kReverse, bool kValues>
int launch(const void* valid, const void* x, void* idx, void* val, void* has, int K,
           int L, void* stream) {
    index_scan_kernel<kReverse, kValues><<<K, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)valid, (const float*)x, (int32_t*)idx, (float*)val,
        (uint8_t*)has, L);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tempo_last_valid_index(const void* valid, void* out, int K, int L,
                                      void* stream) {
    return launch<false, false>(valid, nullptr, out, nullptr, nullptr, K, L, stream);
}

extern "C" int tempo_first_valid_index(const void* valid, void* out, int K, int L,
                                       void* stream) {
    return launch<true, false>(valid, nullptr, out, nullptr, nullptr, K, L, stream);
}

extern "C" int tempo_last_valid_scan(const void* x, const void* valid, void* val, void* has,
                                     int K, int L, void* stream) {
    return launch<false, true>(valid, x, nullptr, val, has, K, L, stream);
}
