// Batched searchsorted on packed [K, L] rows: for each query of row k,
// the number of keys of row k before it (side left: keys < query; side
// right: keys <= query).  Both rows ascending.  int32 or int64 operands
// (the wrapper promotes both to one type); int64 ranks.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_merge.py:_make_rank_kernel
// (through _rank_call and merge_rank_pallas): a bitonic merge of the key
// and query streams, a prefix count of the key indicator and a
// recorded-mask unmerge.  Both operands are sorted, and on Hopper that
// means a merge-path split rather than a network: in the merge that takes
// a key before a query iff key < query (side right: key <= query), the
// keys merged before a query are exactly its rank.
//
// Bound on H100: bytes, one read of the keys and queries and one write
// of the ranks (4 + 4 + 8 bytes a lane for int32 operands).  A binary
// search a query (the first port) was bound by latency instead: ~17
// dependent loads into a row of ~400 KB, the last ~8 of them scattered
// sector reads, so each key was read ~8 times.  The design:
//
//   (a) A 256-thread block per (row, tile of kRankTile = 2048 merged
//       positions).  A merge-path tile holds exactly kRankTile keys and
//       queries together whatever their lengths, skew or ties, so no tile
//       overflows, and phase F's 128 rows of 204,112 positions give
//       12,800 blocks.
//   (b) A split pass first gives every tile diagonal its co-rank: a thread
//       a (row, diagonal), a binary search in global memory, into a
//       [K, tiles + 1] plane the wrapper allocates.  Two other forms lost
//       on the card: the tile's block searching its own two diagonals
//       (the search's latency then sits before every tile's loads), and
//       a warp a diagonal probing 32 points a round (~4 dependent rounds
//       instead of ~17, but 32 times the threads).
//   (c) The tile's key slice and query slice are copied into shared
//       memory in 16-byte words (each slice at its own offset within a
//       word, so every word load is aligned); each key and query is read
//       once.
//   (d) Each thread co-ranks its own diagonal (8 positions apart) in
//       shared memory, then merges its 8 positions in order, recording
//       for each query it passes the tile's keys taken so far.
//   (e) A tile's queries are contiguous: their counts are staged in
//       shared memory and written coalesced as int64 ranks, each plus the
//       row's keys before the tile.
#include "common.cuh"

namespace {

constexpr int kRankThreads = 256;
constexpr int kRankPer = 8;                          // merged positions a thread
constexpr int kRankTile = kRankThreads * kRankPer;   // merged positions a block

// key goes before query in the merge
template <typename T>
__device__ __forceinline__ bool key_first(T key, T q, bool right) {
    return right ? key <= q : key < q;
}

// Copy src[0, n) into dst in 16-byte words: the slice lands at its offset
// within a word (dst is 16-byte aligned), so every load is an aligned
// word that holds a byte of the slice.  Returns the slice's start in dst.
template <typename T>
__device__ __forceinline__ const T* stage_slice(T* dst, const T* src, int n) {
    constexpr int kPer = 16 / sizeof(T);
    const int off = (int)(((uintptr_t)src & 15) / sizeof(T));
    const int words = n > 0 ? (off + n + kPer - 1) / kPer : 0;
    const int4* s4 = reinterpret_cast<const int4*>(src - off);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int w = threadIdx.x; w < words; w += kRankThreads) d4[w] = s4[w];
    return dst + off;
}

// Split pass: thread g = (row k, diagonal t * kRankTile) writes the keys
// among the row's first d merged positions (d's co-rank) to cuts[g]: the
// first m in [max(0, d - Lq), min(d, Lk)) whose key does not go before
// query d - 1 - m (nt + 1 diagonals a row, the last at Lk + Lq).
template <typename T>
__global__ void __launch_bounds__(kRankThreads)
rank_split_kernel(const T* __restrict__ keys, const T* __restrict__ queries,
                  int* __restrict__ cuts, int K, int Lk, int Lq, int nt, int side_right) {
    const long long g = (long long)blockIdx.x * kRankThreads + threadIdx.x;
    if (g >= (long long)K * (nt + 1)) return;
    const int k = (int)(g / (nt + 1)), t = (int)(g % (nt + 1));
    const T* krow = keys + (size_t)k * Lk;
    const T* qrow = queries + (size_t)k * Lq;
    const long long d = min((long long)t * kRankTile, (long long)Lk + Lq);
    const bool right = side_right != 0;
    cuts[g] = first_false((int)max(0LL, d - Lq), (int)min(d, (long long)Lk), [&](int m) {
        return key_first(krow[m], qrow[d - 1 - m], right);
    });
}

template <typename T>
__global__ void __launch_bounds__(kRankThreads)
merge_rank_kernel(const int* __restrict__ cuts, const T* __restrict__ keys,
                  const T* __restrict__ queries, int64_t* __restrict__ out, int Lk, int Lq,
                  int nt, int side_right) {
    constexpr int kPad = 16 / sizeof(T);
    __shared__ __align__(16) T ks[kRankTile + 2 * kPad];
    __shared__ __align__(16) T qs[kRankTile + 2 * kPad];
    __shared__ int taken[kRankTile];     // a query's keys before it within the tile
    const bool right = side_right != 0;
    const int k = blockIdx.x / nt, t = blockIdx.x % nt;
    const T* krow = keys + (size_t)k * Lk;
    const T* qrow = queries + (size_t)k * Lq;
    const long long d0 = (long long)t * kRankTile;
    const long long d1 = min(d0 + kRankTile, (long long)Lk + Lq);
    const int i0 = cuts[(size_t)k * (nt + 1) + t], i1 = cuts[(size_t)k * (nt + 1) + t + 1];
    const int j0 = (int)(d0 - i0);
    const int nk = i1 - i0, nq = (int)(d1 - i1) - j0;
    const T* kk = stage_slice(ks, krow + i0, nk);
    const T* qq = stage_slice(qs, qrow + j0, nq);
    __syncthreads();

    const int p = kRankPer * threadIdx.x;    // this thread's positions [p, p + kRankPer)
    if (p < nk + nq) {
        int ki = first_false(max(0, p - nq), min(p, nk), [&](int m) {
            return key_first(kk[m], qq[p - 1 - m], right);
        });
        int qi = p - ki;
#pragma unroll
        for (int s = 0; s < kRankPer; ++s) {
            if (ki < nk && (qi >= nq || key_first(kk[ki], qq[qi], right))) {
                ++ki;
            } else if (qi < nq) {
                taken[qi++] = ki;
            }
        }
    }
    __syncthreads();
    int64_t* orow = out + (size_t)k * Lq + j0;
    for (int j = threadIdx.x; j < nq; j += kRankThreads) orow[j] = (int64_t)i0 + taken[j];
}

template <typename T>
cudaError_t launch_rank(const void* keys, const void* queries, void* out, void* cuts, int K,
                        int Lk, int Lq, int nt, int side_right, cudaStream_t st) {
    const long long ncut = (long long)K * (nt + 1);
    rank_split_kernel<T><<<(unsigned)((ncut + kRankThreads - 1) / kRankThreads),
                           kRankThreads, 0, st>>>((const T*)keys, (const T*)queries, (int*)cuts,
                                                  K, Lk, Lq, nt, side_right);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    merge_rank_kernel<T><<<(unsigned)((long long)nt * K), kRankThreads, 0, st>>>(
        (const int*)cuts, (const T*)keys, (const T*)queries, (int64_t*)out, Lk, Lq, nt,
        side_right);
    return cudaGetLastError();
}

}  // namespace

// `cuts` is an int32 [K, ncuts] scratch, ncuts = ceil((Lk + Lq) / 2048) + 1.
extern "C" int tempo_merge_rank(const void* keys, const void* queries, void* out, void* cuts,
                                int K, int Lk, int Lq, int ncuts, int side_right, int is_int64,
                                void* stream) {
    const long long nt = ((long long)Lk + Lq + kRankTile - 1) / kRankTile;
    if (ncuts != nt + 1 || (nt + 1) * K > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(is_int64
                     ? launch_rank<int64_t>(keys, queries, out, cuts, K, Lk, Lq, (int)nt,
                                            side_right, st)
                     : launch_rank<int32_t>(keys, queries, out, cuts, K, Lk, Lq, (int)nt,
                                            side_right, st));
}
