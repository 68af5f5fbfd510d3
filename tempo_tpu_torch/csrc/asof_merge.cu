// AS-OF merge join on packed [K, L] series: the plain join, a block per
// series row walking its merged stream (asof_walk_kernel), and the join
// capped by maxLookback, a block per (row, tile of merged positions)
// (the lookback_* kernels).
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_merge.py:_make_kernel
// (through _merge_call, asof_merge_values_pallas and
// asof_merge_indices_pallas): a bitonic merge of [left asc | reversed
// right] under (sid?, ts hi/lo, seq?, side, pos), a NaN-encoded
// forward-fill ladder, and a recorded-mask unmerge.  That network exists
// because the TPU has no cheap gather; on Hopper both sides are sorted,
// so the join is one linear merge.  Each left row's last right row is
// the count of right rows before it in the kernel's total order (sid?,
// ts, seq?), right winning full ties, minus one; for skipNulls=True each
// column's last valid right row at or before that one is a running max
// of where(valid_c, row, -1) along the merged stream.  Bin-packed rows
// fence both by sid: a candidate of another series is no match.
// Timestamps and sequence keys compare as int64 (the wrapper maps float
// sequences to order-preserving integers), so the TPU's hi/lo i32 split
// is not needed.  Outputs are selections, bitwise equal to the Pallas
// kernel's.
//
// Bound on H100: bytes.  The join reads each key plane, validity and
// value plane once and writes the index and value planes once (about 30
// bytes a left lane at the HHAR shape, C = 2); its compares are a few a
// merged position.
//
// asof_walk_kernel, a block of 128 threads per row (8 blocks an SM, so
// 1056 rows walk at once), walks the row's merged stream in steps of 1024
// positions.  A step's positions lie among the next 1024 rows of each
// side, which a ring in shared memory holds: each step's keys reach the
// slots of the rows the step before consumed by asynchronous copies
// issued as soon as its split is known, so no key is read twice and the
// copies overlap the step's columns.  Each thread takes 8 positions from
// its own co-rank (a binary search in shared memory), ranking the left
// rows it passes, and the thread that ends the step gives its split.
// Each column's validity of the step's right rows becomes bit words by
// warp ballots (coalesced byte loads, two columns at a time); a left
// row's last valid row is the highest set bit at or below its last right
// row, else the last valid row before its 256-row segment (the column's
// carry from step to step, max the segments before: a max of indices is
// exact in any order).  Three barriers a step whatever C; the outputs
// leave by coalesced stores.  No search runs in global memory and no scan
// plane is written.  The walk stops with the last left row.  Its cost is
// the steps' chain (ranking about 11 dependent shared-memory probes a
// thread, the validity loads, the barriers), not bytes.  A row walk
// leaves SMs idle when K is small, so the wrapper sends calls of fewer
// than three rows an SM to the lookback kernels at max_lookback = 0,
// which tile every row (bitwise the same join).
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
// (the join equals asof_walk_kernel's).
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
//     the carry gives each left row its last valid row.  The sid fence
//     and the outputs follow the walk's rules, bitwise.
//
// Bound on H100 for the lookback join: bytes, the same as the merge
// join's.  Keys are read once, coalesced, over K * (Ll + Lr) / tile
// blocks (one long series fills every SM); validity and values are read
// once more by the aggregates for skipNulls; the splits and aggregates
// are a few ints a tile.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

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

// a right row counts as valid for column c when its validity bit is set
// and its value is not NaN (the Pallas payload is NaN-encoded)
__device__ __forceinline__ bool right_valid(const uint8_t* r_valid, const float* r_values,
                                            size_t at) {
    return r_valid[at] && (r_values == nullptr || !isnan(r_values[at]));
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
    int32_t* last_idx;
    int32_t* col_idx;
    float* vals;
    int K, Ll, Lr, C, skip_nulls;
};

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

// ---------------------------------------------------------------------
// The merge join, a block per series row walking its merged stream
// ---------------------------------------------------------------------

constexpr int kWalkThreads = 128;
constexpr int kWalkBlocks = 8;                         // blocks an SM: 64 registers a thread
constexpr int kWalkRun = 8;                            // merged positions a thread a step
constexpr int kWalkStep = kWalkThreads * kWalkRun;     // merged positions a step
constexpr int kWalkCols = 32;                          // right columns the walk takes

// dynamic shared memory of the walk: a ring of kWalkStep rows a side (ts,
// then seq and sid where present) and the step's left rows' ranks
__host__ __device__ inline size_t walk_smem(bool sid, bool seq) {
    return (size_t)2 * kWalkStep * (sizeof(int64_t) * (1 + seq) + sizeof(int32_t) * sid)
           + (size_t)kWalkStep * sizeof(int32_t);
}

// Block per row: steps of kWalkStep merged positions from (i_lo, j_lo),
// the left and right rows before it, while left rows remain.  A step's
// positions lie among the next kWalkStep rows of each side, which a ring
// in shared memory holds (row i in slot i mod kWalkStep).  Each thread
// ranks kWalkRun positions from its own co-rank in the ring; the thread
// whose positions end the step gives its split, and the next step's rows
// are fetched into the consumed slots at once.  Each column's validity
// of the step's right rows is a bit word per 32 rows; its last valid row
// before the step is carried from step to step.  SID and SEQ: whether the
// sid and sequence planes exist.
template <bool SID, bool SEQ>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocks)
asof_walk_kernel(JoinArgs a) {
    extern __shared__ int64_t walk_buf[];
    constexpr int T = kWalkStep;
    constexpr int kMask = T - 1;
    constexpr int kSegs = kWalkThreads / 32;           // a warp's segment of a step's right rows
    __shared__ uint32_t bits_s[kWalkCols][kSegs * kWalkRun];   // validity bits, 32 rows a word
    __shared__ int seg_last[kWalkCols][kSegs];         // a segment's last valid row (-1 none)
    __shared__ int seg_pref[kWalkCols][kSegs];         // the last valid row before a segment
    __shared__ int carry_s[kWalkCols];                 // the last valid row before the step
    __shared__ int nl_sh;
    int64_t* ts_s = walk_buf;                          // left slots [0, T), right [T, 2T)
    int64_t* seq_s = ts_s + 2 * T;                     // (SEQ)
    int32_t* sid_s = (int32_t*)(ts_s + 2 * T * (1 + SEQ));   // (SID)
    int32_t* lo_s = sid_s + (SID ? 2 * T : 0);         // right rows before each left row

    const int k = blockIdx.x;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const size_t lrow = (size_t)k * a.Ll, rrow = (size_t)k * a.Lr;
    const size_t lplane = (size_t)a.K * a.Ll, rplane = (size_t)a.K * a.Lr;
    auto ls = [&](int i) { return i & kMask; };
    auto rs = [&](int j) { return T + (j & kMask); };
    auto key_s = [&](int e) -> Key {
        return {SID ? sid_s[e] : 0, ts_s[e], SEQ ? seq_s[e] : 0};
    };
    // the validity of column c at right row j_lo + m, m < nr, of the
    // step: in its segment's words, else before the segment
    auto last_valid = [&](int c, int j_lo, int m) {
        const int seg = (m >> 5) / kWalkRun;
        int word = m >> 5;
        uint32_t x = bits_s[c][word] & (0xffffffffu >> (31 - (m & 31)));
        while (x == 0 && word > seg * kWalkRun) x = bits_s[c][--word];
        return x ? j_lo + (word << 5) + 31 - __clz(x) : seg_pref[c][seg];
    };

    // Rows [l_have, l_to) and [r_have, r_to) into the ring: keys by
    // asynchronous copies (waited for before the next ranking), sids by
    // loads kept in registers until store_sids (their slots are read
    // until the step's end)
    int32_t sv[kWalkRun];
    int sid_slot[kWalkRun];
    auto fetch = [&](int f0, int l_from, int nl_in, int r_from, int n_in) {
#pragma unroll
        for (int q = 0; q < kWalkRun; ++q) {
            const int e = f0 + threadIdx.x + q * kWalkThreads;
            sid_slot[q] = -1;
            if (e >= n_in) continue;
            const bool left = e < nl_in;
            const int m = left ? l_from + e : r_from + e - nl_in;
            const size_t at = left ? lrow + m : rrow + m;
            const int sl = left ? ls(m) : rs(m);
            __pipeline_memcpy_async(ts_s + sl, (left ? a.l_ts : a.r_ts) + at, sizeof(int64_t));
            if (SEQ)
                __pipeline_memcpy_async(seq_s + sl, (left ? a.l_seq : a.r_seq) + at,
                                        sizeof(int64_t));
            if (SID) {
                sv[q] = (left ? a.l_sid : a.r_sid)[at];
                sid_slot[q] = sl;
            }
        }
        __pipeline_commit();
    };
    auto store_sids = [&]() {
#pragma unroll
        for (int q = 0; q < kWalkRun; ++q)
            if (SID && sid_slot[q] >= 0) sid_s[sid_slot[q]] = sv[q];
    };

    if (threadIdx.x < kWalkCols) carry_s[threadIdx.x] = -1;
    // the first step's windows, two passes
    int l_have = min(T, a.Ll), r_have = min(T, a.Lr);
    for (int f0 = 0; f0 < l_have + r_have; f0 += kWalkRun * kWalkThreads) {
        fetch(f0, 0, l_have, 0, l_have + r_have);
        store_sids();
    }
    int i_lo = 0, j_lo = 0;
    while (i_lo < a.Ll) {
        const int l_end = l_have, r_end = r_have;
        __pipeline_wait_prior(0);
        __syncthreads();

        // merge path: kWalkRun positions from this thread's co-rank
        const int nla = l_end - i_lo, nra = r_end - j_lo;
        const int n = min(T, nla + nra);
        auto right_before = [&](int rj, int li) {
            return right_first(key_s(rs(j_lo + rj)), key_s(ls(i_lo + li)), SID, SEQ);
        };
        {
            const int start = min((int)threadIdx.x * kWalkRun, n);
            int li = first_false(max(0, start - nra), min(start, nla), [&](int m) {
                return !right_before(start - 1 - m, m);
            });
            int rj = start - li;
            for (int q = 0; q < kWalkRun && start + q < n; ++q) {
                if (rj < nra && (li >= nla || right_before(rj, li))) ++rj;
                else lo_s[li++] = j_lo + rj;
            }
            if (start < n && start + kWalkRun >= n) nl_sh = li;
        }
        __syncthreads();
        const int nl = nl_sh, nr = n - nl;
        // the next step's rows (one pass: this step consumed n <= T rows)
        // into the consumed slots, whose keys nothing reads any more
        const int l_to = min(i_lo + nl + T, a.Ll), r_to = min(j_lo + nr + T, a.Lr);
        fetch(0, l_have, l_to - l_have, r_have, l_to - l_have + r_to - r_have);
        l_have = l_to;
        r_have = r_to;

        // each column's validity of the step's right rows as bit words:
        // warp w holds rows [32 kWalkRun w, 32 kWalkRun (w + 1)), a ballot
        // per 32, two columns' loads at a time
        for (int c0 = 0; c0 < a.C; c0 += 2) {
            const int c1 = min(c0 + 1, a.C - 1);
            uint8_t v0[kWalkRun], v1[kWalkRun];
            float x0[kWalkRun], x1[kWalkRun];
#pragma unroll
            for (int q = 0; q < kWalkRun; ++q) {
                const int m = min(((w * kWalkRun + q) << 5) + lane, max(nr - 1, 0));
                const size_t at = rrow + j_lo + m;
                v0[q] = nr ? a.r_valid[c0 * rplane + at] : 0;
                v1[q] = nr ? a.r_valid[c1 * rplane + at] : 0;
                x0[q] = a.r_values && nr ? a.r_values[c0 * rplane + at] : 0.f;
                x1[q] = a.r_values && nr ? a.r_values[c1 * rplane + at] : 0.f;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = c0 + h;
                if (c >= a.C) break;
                int last = -1;
#pragma unroll
                for (int q = 0; q < kWalkRun; ++q) {
                    const int m = ((w * kWalkRun + q) << 5) + lane;
                    const bool ok = m < nr && (h ? v1[q] && !isnan(x1[q])
                                                 : v0[q] && !isnan(x0[q]));
                    const uint32_t word = __ballot_sync(TEMPO_FULL_MASK, ok);
                    if (lane == 0) bits_s[c][w * kWalkRun + q] = word;
                    if (word) last = j_lo + ((w * kWalkRun + q) << 5) + 31 - __clz(word);
                }
                if (lane == 0) seg_last[c][w] = last;
            }
        }
        __syncthreads();
        // the last valid row before each segment, from the carry
        int step_last = -1;
        if (threadIdx.x < a.C * kSegs) {
            const int c = threadIdx.x / kSegs, s = threadIdx.x % kSegs;
            int p = carry_s[c];
            for (int t = 0; t < s; ++t) p = max(p, seg_last[c][t]);
            seg_pref[c][s] = p;
            step_last = max(p, seg_last[c][s]);   // kept by the last segment's thread
        }
        __syncthreads();
        auto r_sid = [&](int j) { return j >= j_lo ? sid_s[rs(j)] : a.r_sid[rrow + j]; };

#pragma unroll
        for (int q = 0; q < kWalkRun; ++q) {
            const int e = threadIdx.x + q * kWalkThreads;
            if (e >= nl) break;
            int base = lo_s[e] - 1;
            const int l_sid = SID ? sid_s[ls(i_lo + e)] : 0;
            // the last right row, fenced by sid
            if (SID && base >= 0 && r_sid(base) != l_sid) base = -1;
            a.last_idx[lrow + i_lo + e] = base;
            for (int c = 0; c < a.C; ++c) {
                const size_t rc = c * rplane + rrow;
                int j = -1;
                if (a.skip_nulls) {
                    if (base >= 0) j = base >= j_lo ? last_valid(c, j_lo, base - j_lo) : carry_s[c];
                    if (SID && j >= 0 && r_sid(j) != l_sid) j = -1;
                } else if (base >= 0) {
                    const int m = base - j_lo;
                    const bool valid = m >= 0
                        ? (bits_s[c][m >> 5] >> (m & 31)) & 1u
                        : right_valid(a.r_valid, a.r_values, rc + base);
                    if (valid) j = base;
                }
                const size_t at = c * lplane + lrow + i_lo + e;
                a.col_idx[at] = j;
                if (a.vals) a.vals[at] = j >= 0 ? a.r_values[rc + j] : tempo_nan();
            }
        }
        i_lo += nl;
        j_lo += nr;
        __syncthreads();   // the consumed sid slots, lo_s and the bits are rewritten next
        store_sids();
        if (threadIdx.x < a.C * kSegs && threadIdx.x % kSegs == kSegs - 1)
            carry_s[threadIdx.x / kSegs] = step_last;
    }
    __pipeline_wait_prior(0);   // no copy outlives the block
}

JoinArgs join_args(const void* l_ts, const void* r_ts, const void* l_sid, const void* r_sid,
                   const void* l_seq, const void* r_seq, const void* r_valid,
                   const void* r_values, void* last_idx, void* col_idx,
                   void* vals, int K, int Ll, int Lr, int C, int skip_nulls) {
    return {(const int64_t*)l_ts, (const int64_t*)r_ts, (const int32_t*)l_sid,
            (const int32_t*)r_sid, (const int64_t*)l_seq, (const int64_t*)r_seq,
            (const uint8_t*)r_valid, (const float*)r_values,
            (int32_t*)last_idx, (int32_t*)col_idx, (float*)vals, K, Ll, Lr, C, skip_nulls};
}

}  // namespace

// merged positions a step of the walk, and the right columns it takes
extern "C" long long tempo_asof_walk_step() { return kWalkStep; }
extern "C" long long tempo_asof_walk_cols() { return kWalkCols; }

// Shared memory of a block of the walk with the sid and sequence planes
// (static and dynamic) and of the lookback kernels' tile join (static):
// admission's figures are checked against them on the card.  -1 when the
// card cannot be asked.
extern "C" long long tempo_asof_walk_smem() {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, asof_walk_kernel<true, true>) != cudaSuccess) return -1;
    return (long long)fa.sharedSizeBytes + (long long)walk_smem(true, true);
}
extern "C" long long tempo_asof_tile_smem() {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, lookback_join_kernel) != cudaSuccess) return -1;
    return (long long)fa.sharedSizeBytes;
}

extern "C" int tempo_asof_merge(const void* l_ts, const void* r_ts, const void* l_sid,
                                const void* r_sid, const void* l_seq, const void* r_seq,
                                const void* r_valid, const void* r_values, void* last_idx,
                                void* col_idx, void* vals, int K, int Ll, int Lr, int C,
                                int skip_nulls, void* stream) {
    if (C > kWalkCols) return (int)cudaErrorInvalidValue;
    const bool sid = l_sid != nullptr, seq = l_seq != nullptr;
    auto kernel = sid ? (seq ? asof_walk_kernel<true, true> : asof_walk_kernel<true, false>)
                      : (seq ? asof_walk_kernel<false, true> : asof_walk_kernel<false, false>);
    const size_t smem = walk_smem(sid, seq);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<K, kWalkThreads, smem, (cudaStream_t)stream>>>(
        join_args(l_ts, r_ts, l_sid, r_sid, l_seq, r_seq, r_valid, r_values, last_idx, col_idx,
                  vals, K, Ll, Lr, C, skip_nulls));
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
                                 last_idx, col_idx, vals, K, Ll, Lr, C, skip_nulls);
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
