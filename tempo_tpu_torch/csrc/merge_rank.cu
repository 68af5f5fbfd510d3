// Batched searchsorted on packed [K, L] rows: for each query of row k,
// the number of keys of row k before it (side left: keys < query; side
// right: keys <= query).  Both rows ascending.  int32 or int64 operands
// (the wrapper promotes both to one type); int64 ranks.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_merge.py:_make_rank_kernel
// (through _rank_call and merge_rank_pallas): a bitonic merge of the key
// and query streams, a prefix count of the key indicator and a
// recorded-mask unmerge.  That network exists because the TPU has no
// cheap gather.  On Hopper each query is one thread's binary search of
// its key row: log2(Lk) dependent loads that hit L1/L2 (a key row is
// ~400 KB at the windowed engine's [128, 102,056] shape), with the
// queries read and the ranks written coalesced.  The count is exact, so
// the result is the same as any other search's.
//
// Bound on H100: bytes, one read of the keys and queries and one write
// of the ranks (4 + 4 + 8 bytes a lane for int32 operands).
#include "common.cuh"

namespace {

constexpr int kRankThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRankThreads)
merge_rank_kernel(const T* __restrict__ keys, const T* __restrict__ queries,
                  int64_t* __restrict__ out, int K, int Lk, int Lq, int side_right) {
    const int64_t at = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (at >= (int64_t)K * Lq) return;
    const int64_t k = at / Lq;
    const T* row = keys + k * Lk;
    const T q = queries[at];
    int lo = 0, hi = Lk;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const T v = row[mid];
        if (side_right ? v <= q : v < q) lo = mid + 1; else hi = mid;
    }
    out[at] = lo;
}

}  // namespace

extern "C" int tempo_merge_rank(const void* keys, const void* queries, void* out, int K,
                                int Lk, int Lq, int side_right, int is_int64, void* stream) {
    const int64_t n = (int64_t)K * Lq;
    const int blocks = (int)((n + kRankThreads - 1) / kRankThreads);
    if (is_int64) {
        merge_rank_kernel<int64_t><<<blocks, kRankThreads, 0, (cudaStream_t)stream>>>(
            (const int64_t*)keys, (const int64_t*)queries, (int64_t*)out, K, Lk, Lq,
            side_right);
    } else {
        merge_rank_kernel<int32_t><<<blocks, kRankThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)keys, (const int32_t*)queries, (int64_t*)out, K, Lk, Lq,
            side_right);
    }
    return (int)cudaGetLastError();
}
