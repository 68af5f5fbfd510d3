// AS-OF merge join on packed [K, L] series: the plain join, one block per
// series row (asof_merge_kernel), and the join capped by maxLookback, a
// block per (row, tile of merged positions) (the lookback_* kernels).
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_merge.py:_make_kernel
// (through _merge_call, asof_merge_values_pallas and
// asof_merge_indices_pallas): a bitonic merge of [left asc | reversed
// right] under (sid?, ts hi/lo, seq?, side, pos), a NaN-encoded
// forward-fill ladder, and a recorded-mask unmerge.  That network exists
// because the TPU has no cheap gather; on Hopper the same function is a
// merge-path search.  For each left lane, a binary search of the (sorted)
// right row counts the right rows that are <= its key under the kernel's
// total order (sid?, ts, seq?), right winning full ties; that count minus
// one is the last right row.  For skipNulls=True a block-wide running-max
// scan of where(valid_c, lane, -1) over each right column (into scratch)
// gives every column's last valid row at or before any position.
// Bin-packed rows fence both by sid: a candidate of another series is no
// match.  Timestamps and sequence keys compare as int64 (the wrapper maps
// float sequences to order-preserving integers), so the TPU's hi/lo i32
// split is not needed.  Outputs are selections, bitwise equal to the
// Pallas kernel's.
//
// Bound on H100: bytes.  The kernel reads each key plane, validity and
// value plane once and writes the index and value planes once; its work
// is Ll * log2(Lr) compares a row, far below the card's integer rate.
// The binary searches re-read the key rows from L1/L2 (a row is ~100 KB
// at the HHAR shape); the scan scratch adds one write and a read of an
// int32 plane per right column.  One block per row leaves SMs idle when
// K is small.
//
// Also replaces the Pallas kernel tempo_tpu/ops/pallas_merge.py:
// _make_chunked_kernel (through _chunked_call, asof_merge_values_chunked
// and asof_merge_indices_chunked): the same join gridded over
// merged-lane chunks, with the fill state carried in sequence from chunk
// to chunk and Scala's maxLookback horizon in global merged positions.
// A left row i sits at merged position i + lo (lo right rows at or
// before it), a right row j at j + (left rows strictly before it); a
// candidate j (the column's last valid row, or the last row for
// skipNulls=False) more than max_lookback positions behind the left row
// becomes -1, which is exact for last-valid fills (every earlier
// candidate lies further back).  max_lookback = 0 turns the horizon off
// (the join equals asof_merge_kernel's).
//
// Here the chunks run in parallel and the carry becomes a look-back over
// tile aggregates: a merge-path join over tiles of `tile` (<= 1024)
// merged positions, a block per (row, tile), in three launches on the
// caller's stream:
//
//   lookback_split_kernel, a thread per (row, diagonal): the tile's split
//     (left rows among its first d merged positions) by a co-rank binary
//     search with the ranking's own comparator, so neighbouring tiles
//     agree; with a horizon, also the merged position of the last right
//     row before the tile (a binary search of the left rows before it).
//   lookback_aggregate_kernel (skipNulls only), a warp per (row, tile):
//     each column's last valid right row among the tile's right rows.
//   lookback_carry_kernel (skipNulls only), a block per (column, row): an
//     exclusive running max of those aggregates over the tiles, in place,
//     every tile's carry-in (a max of indices is exact in any order);
//     with a horizon, also each carry's merged position.
//   lookback_join_kernel, a block of 256 threads per (row, tile): copies
//     the tile's key slices (at most `tile` rows of both sides together)
//     into shared memory and merges them there, each thread 4 merged
//     positions from its own co-rank, so every left row's count of right
//     rows before it and every right row's merged position come from the
//     tile.  Per column, a block scan of the tile's valid right rows from
//     the carry gives each left row its last valid row.  The horizon, the
//     sid fence and the outputs follow join_row's rules, bitwise.
//
// Bound on H100 for the lookback join: bytes, the same as the merge
// join's.  Keys are read once, coalesced, over K * (Ll + Lr) / tile
// blocks (one long series fills every SM); validity and values are read
// once more by the aggregates for skipNulls; the splits and aggregates
// are a few ints a tile.
#include "common.cuh"

namespace {

constexpr int kMergeThreads = 512;

// a series row's key planes, offset to the row (sid/seq null when absent)
struct Keys {
    const int64_t* ts;
    const int32_t* sid;
    const int64_t* seq;
};

__device__ __forceinline__ Keys row_keys(const int64_t* ts, const int32_t* sid,
                                         const int64_t* seq, size_t row) {
    return {ts + row, sid ? sid + row : nullptr, seq ? seq + row : nullptr};
}

// first m in [lo, hi) with pred(m) false (pred true on a prefix)
template <typename Pred>
__device__ __forceinline__ int first_false(int lo, int hi, Pred pred) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pred(mid)) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// count of rows m < n of a sorted row with before(m) true (a prefix)
template <typename Before>
__device__ __forceinline__ int count_before(int n, Before before) {
    return first_false(0, n, before);
}

// right rows at or before the key (sid, ts, sq): right wins full ties
__device__ __forceinline__ int right_at_or_before(const Keys& r, int Lr, int32_t sid,
                                                  int64_t ts, int64_t sq) {
    return count_before(Lr, [&](int m) {
        if (r.sid && r.sid[m] != sid) return r.sid[m] < sid;
        if (r.ts[m] != ts) return r.ts[m] < ts;
        return r.seq ? r.seq[m] <= sq : true;
    });
}

// a right row counts as valid for column c when its validity bit is set
// and its value is not NaN (the Pallas payload is NaN-encoded)
__device__ __forceinline__ bool right_valid(const uint8_t* r_valid, const float* r_values,
                                            size_t at) {
    return r_valid[at] && (r_values == nullptr || !isnan(r_values[at]));
}

// scan[c][j] = the last valid row of column c at or before j (-1 none),
// for this block's row; ends with a __syncthreads()
__device__ void last_valid_rows(const uint8_t* r_valid, const float* r_values,
                                int32_t* scan, size_t rrow, size_t rplane, int Lr, int C,
                                int* sh) {
    for (int c = 0; c < C; ++c) {
        int carry = -1;
        for (int base = 0; base < Lr; base += blockDim.x) {
            const int j = base + threadIdx.x;
            int v = (j < Lr && right_valid(r_valid, r_values, c * rplane + rrow + j)) ? j : -1;
            int total;
            v = max(block_scan_max(v, sh, &total), carry);
            if (j < Lr) scan[c * rplane + rrow + j] = v;
            carry = max(carry, total);
        }
    }
    __syncthreads();   // scan rows are read by other threads
}

struct JoinArgs {
    const int64_t* l_ts;
    const int64_t* r_ts;
    const int32_t* l_sid;
    const int32_t* r_sid;
    const int64_t* l_seq;
    const int64_t* r_seq;
    const uint8_t* r_valid;
    const float* r_values;
    int32_t* scan;
    int32_t* last_idx;
    int32_t* col_idx;
    float* vals;
    int K, Ll, Lr, C, skip_nulls;
};

// the join of this block's row; rpos (merged positions of the right
// rows) and max_lookback > 0 apply the horizon
__device__ void join_row(const JoinArgs& a, const int32_t* rpos, int max_lookback) {
    const size_t lrow = (size_t)blockIdx.x * a.Ll;
    const size_t rrow = (size_t)blockIdx.x * a.Lr;
    const size_t lplane = (size_t)a.K * a.Ll;
    const size_t rplane = (size_t)a.K * a.Lr;
    const Keys l = row_keys(a.l_ts, a.l_sid, a.l_seq, lrow);
    const Keys r = row_keys(a.r_ts, a.r_sid, a.r_seq, rrow);

    for (int i = threadIdx.x; i < a.Ll; i += blockDim.x) {
        const int32_t sid = l.sid ? l.sid[i] : 0;
        const int lo = right_at_or_before(r, a.Lr, sid, l.ts[i], l.seq ? l.seq[i] : 0);
        const int pos = i + lo;
        auto stale = [&](int j) { return rpos && pos - rpos[j] > max_lookback; };
        auto other_series = [&](int j) { return l.sid && r.sid[j] != sid; };
        int base = lo - 1;
        if (base >= 0 && other_series(base)) base = -1;
        const int last = (base >= 0 && stale(base)) ? -1 : base;
        a.last_idx[lrow + i] = last;
        for (int c = 0; c < a.C; ++c) {
            int j = -1;
            if (a.skip_nulls) {
                if (base >= 0) j = a.scan[c * rplane + rrow + base];
                if (j >= 0 && (other_series(j) || stale(j))) j = -1;
            } else if (last >= 0 && right_valid(a.r_valid, a.r_values, c * rplane + rrow + last)) {
                j = last;
            }
            a.col_idx[c * lplane + lrow + i] = j;
            if (a.vals) a.vals[c * lplane + lrow + i] = j >= 0 ? a.r_values[c * rplane + rrow + j] : tempo_nan();
        }
    }
}

__global__ void __launch_bounds__(kMergeThreads) asof_merge_kernel(JoinArgs a) {
    __shared__ int sh[32];
    if (a.skip_nulls)
        last_valid_rows(a.r_valid, a.r_values, a.scan, (size_t)blockIdx.x * a.Lr,
                        (size_t)a.K * a.Lr, a.Lr, a.C, sh);
    join_row(a, nullptr, 0);
}

// ---------------------------------------------------------------------
// The maxLookback join, a block per (row, tile of merged positions)
// ---------------------------------------------------------------------

constexpr int kTileMax = 1024;          // merged positions a tile at most
constexpr int kTileThreads = 256;
constexpr int kPerThread = kTileMax / kTileThreads;
constexpr int kCarryThreads = 1024;

struct Key {
    int32_t sid;
    int64_t ts;
    int64_t sq;
};

__device__ __forceinline__ Key key_at(const Keys& k, int m) {
    return {k.sid ? k.sid[m] : 0, k.ts[m], k.seq ? k.seq[m] : 0};
}

// right row r comes before left row l in the merged order (sid?, ts,
// seq?): right wins full ties.  The splits, the ranks inside a tile and
// the positions of earlier right rows all use this one comparator.
__device__ __forceinline__ bool right_first(const Key& r, const Key& l, bool sid, bool seq) {
    if (sid && r.sid != l.sid) return r.sid < l.sid;
    if (r.ts != l.ts) return r.ts < l.ts;
    return seq ? r.sq <= l.sq : true;
}

// merged position of right row j of a row: j + the left rows strictly
// before it, which lie among the first i_max
__device__ __forceinline__ int right_position(const Keys& l, const Keys& r, int j, int i_max) {
    const bool sid = l.sid != nullptr, seq = l.seq != nullptr;
    const Key kr = key_at(r, j);
    return j + first_false(0, i_max, [&](int m) {
        return !right_first(kr, key_at(l, m), sid, seq);
    });
}

// Thread per (row, diagonal d = t * tile): split[k, t] = the left rows
// among the first d merged positions (the co-rank search); with a
// horizon, pos[k, t] = the merged position of right row d - split - 1,
// the last right row before the tile (0 if none).
__global__ void __launch_bounds__(kTileThreads)
lookback_split_kernel(JoinArgs a, int32_t* __restrict__ split, int32_t* __restrict__ pos,
                      int tile, int ntiles) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)a.K * (ntiles + 1)) return;
    const int k = (int)(g / (ntiles + 1)), t = (int)(g % (ntiles + 1));
    const Keys l = row_keys(a.l_ts, a.l_sid, a.l_seq, (size_t)k * a.Ll);
    const Keys r = row_keys(a.r_ts, a.r_sid, a.r_seq, (size_t)k * a.Lr);
    const bool sid = l.sid != nullptr, seq = l.seq != nullptr;
    const int d = (int)min((long long)t * tile, (long long)a.Ll + a.Lr);
    const int i = first_false(max(0, d - a.Lr), min(d, a.Ll), [&](int m) {
        return !right_first(key_at(r, d - 1 - m), key_at(l, m), sid, seq);
    });
    split[g] = i;
    if (pos) pos[g] = d - i > 0 ? right_position(l, r, d - i - 1, i) : 0;
}

// Warp per (row, tile): each column's last valid right row among the
// tile's right rows (-1 none) into agg [C, K, ntiles].
__global__ void __launch_bounds__(kTileThreads)
lookback_aggregate_kernel(JoinArgs a, const int32_t* __restrict__ split,
                          int32_t* __restrict__ agg, int tile, int ntiles) {
    const long long item = (long long)blockIdx.x * (kTileThreads / 32) + (threadIdx.x >> 5);
    if (item >= (long long)a.K * ntiles) return;
    const int k = (int)(item / ntiles), t = (int)(item % ntiles);
    const int32_t* sp = split + (size_t)k * (ntiles + 1) + t;
    const int d0 = t * tile, d1 = min(d0 + tile, a.Ll + a.Lr);
    const int j_lo = d0 - sp[0], j_hi = d1 - sp[1];
    const size_t rrow = (size_t)k * a.Lr, rplane = (size_t)a.K * a.Lr;
    for (int c = 0; c < a.C; ++c) {
        int v = -1;
        for (int j = j_lo + (threadIdx.x & 31); j < j_hi; j += 32)
            if (right_valid(a.r_valid, a.r_values, c * rplane + rrow + j)) v = j;
        for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(TEMPO_FULL_MASK, v, o));
        if ((threadIdx.x & 31) == 0) agg[((size_t)c * a.K + k) * ntiles + t] = v;
    }
}

// Block per (column, row): agg[c, k, :] becomes its exclusive running
// max, each tile's carry-in (a max of indices: exact in any order); with
// a horizon, pos[c, k, t] = the carry's merged position.
__global__ void __launch_bounds__(kCarryThreads)
lookback_carry_kernel(JoinArgs a, const int32_t* __restrict__ split, int32_t* __restrict__ agg,
                      int32_t* __restrict__ pos, int ntiles) {
    __shared__ int sh[32];
    __shared__ int incl[kCarryThreads];
    const int k = blockIdx.x % a.K;
    int32_t* row = agg + (size_t)blockIdx.x * ntiles;
    const Keys l = row_keys(a.l_ts, a.l_sid, a.l_seq, (size_t)k * a.Ll);
    const Keys r = row_keys(a.r_ts, a.r_sid, a.r_seq, (size_t)k * a.Lr);
    int carry = -1;
    for (int base = 0; base < ntiles; base += blockDim.x) {
        const int t = base + threadIdx.x;
        const int v = t < ntiles ? row[t] : -1;
        int total;
        incl[threadIdx.x] = block_scan_max(v, sh, &total);
        __syncthreads();
        const int ex = max(carry, threadIdx.x ? incl[threadIdx.x - 1] : -1);
        if (t < ntiles) {
            row[t] = ex;
            if (pos) {
                const int i_lo = split[(size_t)k * (ntiles + 1) + t];
                pos[(size_t)blockIdx.x * ntiles + t] = ex >= 0 ? right_position(l, r, ex, i_lo) : 0;
            }
        }
        carry = max(carry, total);
        __syncthreads();
    }
}

// Block per (row, tile): the join of the tile's left rows.
__global__ void __launch_bounds__(kTileThreads)
lookback_join_kernel(JoinArgs a, const int32_t* __restrict__ split,
                     const int32_t* __restrict__ jpos, const int32_t* __restrict__ carry,
                     const int32_t* __restrict__ cpos, int tile, int ntiles, int max_lookback) {
    __shared__ int64_t ts_s[kTileMax];
    __shared__ int64_t seq_s[kTileMax];
    __shared__ int32_t sid_s[kTileMax];
    __shared__ int32_t lo_s[kTileMax];     // right rows before each left row of the tile
    __shared__ int32_t rpos_s[kTileMax];   // merged positions of the tile's right rows
    __shared__ int32_t lv_s[kTileMax];     // a column's last valid row at or before each
    __shared__ int incl[kTileThreads];
    __shared__ int sh[32];

    const int k = blockIdx.x / ntiles, t = blockIdx.x % ntiles;
    const size_t tk = (size_t)k * (ntiles + 1) + t;
    const int d0 = t * tile, n = min(d0 + tile, a.Ll + a.Lr) - d0;
    const int i_lo = split[tk], nl = split[tk + 1] - i_lo;
    const int j_lo = d0 - i_lo, nr = n - nl;
    const size_t lrow = (size_t)k * a.Ll, rrow = (size_t)k * a.Lr;
    const size_t lplane = (size_t)a.K * a.Ll, rplane = (size_t)a.K * a.Lr;
    const bool has_sid = a.l_sid != nullptr, has_seq = a.l_seq != nullptr;
    const int pos_jc = jpos ? jpos[tk] : 0;   // position of right row j_lo - 1

    // skipNulls: a column's carry-in (and its position) and whether each of
    // this thread's kPerThread right rows is valid, loaded one column ahead
    struct ColIn {
        uint32_t ok;
        int cv, pos_cv;
    };
    auto col_load = [&](int c) -> ColIn {
        ColIn in{0u, -1, 0};
        if (!a.skip_nulls || c >= a.C) return in;
        const size_t ct = ((size_t)c * a.K + k) * ntiles + t;
        in.cv = carry[ct];
        if (cpos) in.pos_cv = cpos[ct];
        const size_t rc = c * rplane + rrow + j_lo;
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
            const int m = threadIdx.x * kPerThread + q;
            const size_t at = rc + min(m, max(nr - 1, 0));
            const uint8_t vb = nr ? a.r_valid[at] : 0;
            const float xv = a.r_values && nr ? a.r_values[at] : 0.f;
            if (m < nr && vb && !isnan(xv)) in.ok |= 1u << q;
        }
        return in;
    };
    ColIn next = col_load(0);

    // the tile's key slices: left rows at [0, nl), right rows at [nl, n)
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const bool left = e < nl;
        const size_t m = left ? lrow + i_lo + e : rrow + j_lo + e - nl;
        ts_s[e] = left ? a.l_ts[m] : a.r_ts[m];
        if (has_sid) sid_s[e] = left ? a.l_sid[m] : a.r_sid[m];
        if (has_seq) seq_s[e] = left ? a.l_seq[m] : a.r_seq[m];
    }
    __syncthreads();
    auto key_s = [&](int e) -> Key {
        return {has_sid ? sid_s[e] : 0, ts_s[e], has_seq ? seq_s[e] : 0};
    };
    auto right_before = [&](int rj, int li) {
        return right_first(key_s(nl + rj), key_s(li), has_sid, has_seq);
    };

    // merge path inside the tile: each thread takes kPerThread merged
    // positions from its own co-rank, ranking each row it passes
    {
        const int start = min(threadIdx.x * kPerThread, n);
        int li = first_false(max(0, start - nr), min(start, nl), [&](int m) {
            return !right_before(start - 1 - m, m);
        });
        int rj = start - li;
        for (int q = 0; q < kPerThread && start + q < n; ++q) {
            if (rj < nr && (li >= nl || right_before(rj, li))) {
                rpos_s[rj++] = d0 + start + q;
            } else {
                lo_s[li++] = j_lo + rj;
            }
        }
    }
    __syncthreads();
    auto r_sid = [&](int j) {
        return j >= j_lo ? sid_s[nl + j - j_lo] : a.r_sid[rrow + j];
    };
    auto stale = [&](int p, int pj) { return max_lookback > 0 && p - pj > max_lookback; };

    // each left row's last right row, fenced by sid and capped
    int pos[kPerThread], base[kPerThread], last[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
        const int e = threadIdx.x + q * kTileThreads;
        if (e >= nl) break;
        const int lo = lo_s[e];
        pos[q] = i_lo + e + lo;
        base[q] = lo - 1;
        if (base[q] >= 0 && has_sid && r_sid(base[q]) != sid_s[e]) base[q] = -1;
        const int pb = base[q] >= j_lo ? rpos_s[base[q] - j_lo] : pos_jc;
        last[q] = (base[q] >= 0 && stale(pos[q], pb)) ? -1 : base[q];
        a.last_idx[lrow + i_lo + e] = last[q];
    }

    for (int c = 0; c < a.C; ++c) {
        const size_t rc = c * rplane + rrow;
        const ColIn col = next;
        next = col_load(c + 1);
        const int cv = col.cv, pos_cv = col.pos_cv;
        if (a.skip_nulls) {
            // the column's last valid row at or before each right row of
            // the tile, from the tile's carry-in
            int run[kPerThread], v = -1;
#pragma unroll
            for (int q = 0; q < kPerThread; ++q) {
                if ((col.ok >> q) & 1u) v = j_lo + threadIdx.x * kPerThread + q;
                run[q] = v;
            }
            int total;
            incl[threadIdx.x] = block_scan_max(v, sh, &total);
            __syncthreads();
            const int ex = max(cv, threadIdx.x ? incl[threadIdx.x - 1] : -1);
#pragma unroll
            for (int q = 0; q < kPerThread; ++q) {
                const int m = threadIdx.x * kPerThread + q;
                if (m < nr) lv_s[m] = max(ex, run[q]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
            const int e = threadIdx.x + q * kTileThreads;
            if (e >= nl) break;
            int j = -1;
            if (a.skip_nulls) {
                if (base[q] >= 0) j = base[q] >= j_lo ? lv_s[base[q] - j_lo] : cv;
                if (j >= 0) {
                    const int pj = j >= j_lo ? rpos_s[j - j_lo] : pos_cv;
                    if ((has_sid && r_sid(j) != sid_s[e]) || stale(pos[q], pj)) j = -1;
                }
            } else if (last[q] >= 0 && right_valid(a.r_valid, a.r_values, rc + last[q])) {
                j = last[q];
            }
            const size_t at = c * lplane + lrow + i_lo + e;
            a.col_idx[at] = j;
            if (a.vals) a.vals[at] = j >= 0 ? a.r_values[rc + j] : tempo_nan();
        }
        __syncthreads();   // lv_s is rewritten by the next column
    }
}

JoinArgs join_args(const void* l_ts, const void* r_ts, const void* l_sid, const void* r_sid,
                   const void* l_seq, const void* r_seq, const void* r_valid,
                   const void* r_values, void* scan, void* last_idx, void* col_idx,
                   void* vals, int K, int Ll, int Lr, int C, int skip_nulls) {
    return {(const int64_t*)l_ts, (const int64_t*)r_ts, (const int32_t*)l_sid,
            (const int32_t*)r_sid, (const int64_t*)l_seq, (const int64_t*)r_seq,
            (const uint8_t*)r_valid, (const float*)r_values, (int32_t*)scan,
            (int32_t*)last_idx, (int32_t*)col_idx, (float*)vals, K, Ll, Lr, C, skip_nulls};
}

}  // namespace

extern "C" int tempo_asof_merge(const void* l_ts, const void* r_ts, const void* l_sid,
                                const void* r_sid, const void* l_seq, const void* r_seq,
                                const void* r_valid, const void* r_values, void* scan,
                                void* last_idx, void* col_idx, void* vals, int K, int Ll,
                                int Lr, int C, int skip_nulls, void* stream) {
    asof_merge_kernel<<<K, kMergeThreads, 0, (cudaStream_t)stream>>>(
        join_args(l_ts, r_ts, l_sid, r_sid, l_seq, r_seq, r_valid, r_values, scan, last_idx,
                  col_idx, vals, K, Ll, Lr, C, skip_nulls));
    return (int)cudaGetLastError();
}

extern "C" int tempo_asof_merge_lookback(const void* l_ts, const void* r_ts, const void* l_sid,
                                         const void* r_sid, const void* l_seq,
                                         const void* r_seq, const void* r_valid,
                                         const void* r_values, void* split, void* carry,
                                         void* last_idx, void* col_idx, void* vals, int K,
                                         int Ll, int Lr, int C, int skip_nulls,
                                         int max_lookback, int tile, void* stream) {
    // split: [2, K, ntiles + 1] (splits, then positions of the right row
    // before each tile); carry: [2, C, K, ntiles] for skipNulls (carries,
    // then their positions); the positions only with a horizon
    if (tile < 1 || tile > kTileMax) return (int)cudaErrorInvalidValue;
    const int ntiles = (int)(((long long)Ll + Lr + tile - 1) / tile);
    const size_t nsplit = (size_t)K * (ntiles + 1), ncarry = (size_t)C * K * ntiles;
    const JoinArgs a = join_args(l_ts, r_ts, l_sid, r_sid, l_seq, r_seq, r_valid, r_values,
                                 nullptr, last_idx, col_idx, vals, K, Ll, Lr, C, skip_nulls);
    int32_t* sp = (int32_t*)split;
    int32_t* jpos = max_lookback > 0 ? sp + nsplit : nullptr;
    int32_t* agg = (skip_nulls && C) ? (int32_t*)carry : nullptr;
    int32_t* cpos = (agg && max_lookback > 0) ? agg + ncarry : nullptr;
    cudaStream_t st = (cudaStream_t)stream;
    lookback_split_kernel<<<(unsigned)((nsplit + kTileThreads - 1) / kTileThreads), kTileThreads,
                            0, st>>>(a, sp, jpos, tile, ntiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((size_t)K * ntiles);
    if (agg) {
        const unsigned warps = kTileThreads / 32;
        lookback_aggregate_kernel<<<(blocks + warps - 1) / warps, kTileThreads, 0, st>>>(
            a, sp, agg, tile, ntiles);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        lookback_carry_kernel<<<(unsigned)((size_t)C * K), kCarryThreads, 0, st>>>(a, sp, agg,
                                                                                   cpos, ntiles);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    lookback_join_kernel<<<blocks, kTileThreads, 0, st>>>(a, sp, jpos, agg, cpos, tile, ntiles,
                                                          max_lookback);
    return (int)cudaGetLastError();
}

extern "C" const char* tempo_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
