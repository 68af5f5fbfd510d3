// AS-OF merge join on packed [K, L] series, one block per series row:
// the plain join (asof_merge_kernel) and the join capped by maxLookback
// (asof_merge_lookback_kernel).
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
// Bound on H100: bytes.  The kernels read each key plane, validity and
// value plane once and write the index and value planes once; their work
// is Ll * log2(Lr) (+ Lr * log2(Ll) for the horizon) compares a row, far
// below the card's integer rate.  The binary searches re-read the key
// rows from L1/L2 (a row is ~100 KB at the HHAR shape, ~800 KB at the
// 128-series shape); the scan and position scratch add one write and a
// read of int32 planes per right column.  One block per row leaves SMs
// idle when K is small (a single long series runs on one SM).
//
// Also replaces the Pallas kernel tempo_tpu/ops/pallas_merge.py:
// _make_chunked_kernel (through _chunked_call, asof_merge_values_chunked
// and asof_merge_indices_chunked): the same join gridded over
// merged-lane chunks, with the fill state carried from chunk to chunk and
// Scala's maxLookback horizon in global merged positions.  The chunks
// exist because a TPU row must fit VMEM; the per-lane search here has no
// width limit, so there is no chunk plan and no carry.  What is left is
// the horizon: a left row i sits at merged position i + lo (lo right rows
// at or before it), a right row j at j + (left rows strictly before it),
// found by a binary search of the left row and kept in an int32 scratch
// plane.  A candidate j (the column's last valid row, or the last row for
// skipNulls=False) whose position is more than max_lookback behind the
// left row's becomes -1.  That is exact for last-valid fills: every
// earlier candidate lies further back.  max_lookback = 0 turns the
// horizon off (the join equals asof_merge_kernel's).
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

// count of rows m < n of a sorted row with before(m) true (a prefix)
template <typename Before>
__device__ __forceinline__ int count_before(int n, Before before) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(mid)) lo = mid + 1; else hi = mid;
    }
    return lo;
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

// left rows strictly before the key (sid, ts, sq): the complement order
__device__ __forceinline__ int left_before(const Keys& l, int Ll, int32_t sid, int64_t ts,
                                           int64_t sq) {
    return count_before(Ll, [&](int m) {
        if (l.sid && l.sid[m] != sid) return l.sid[m] < sid;
        if (l.ts[m] != ts) return l.ts[m] < ts;
        return l.seq ? l.seq[m] < sq : false;
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

__global__ void __launch_bounds__(kMergeThreads)
asof_merge_lookback_kernel(JoinArgs a, int32_t* __restrict__ rpos, int max_lookback) {
    __shared__ int sh[32];
    const size_t rrow = (size_t)blockIdx.x * a.Lr;
    if (a.skip_nulls)
        last_valid_rows(a.r_valid, a.r_values, a.scan, rrow, (size_t)a.K * a.Lr, a.Lr, a.C, sh);
    if (max_lookback <= 0) {
        join_row(a, nullptr, 0);
        return;
    }
    const Keys l = row_keys(a.l_ts, a.l_sid, a.l_seq, (size_t)blockIdx.x * a.Ll);
    const Keys r = row_keys(a.r_ts, a.r_sid, a.r_seq, rrow);
    int32_t* row_pos = rpos + rrow;
    for (int j = threadIdx.x; j < a.Lr; j += blockDim.x) {
        row_pos[j] = j + left_before(l, a.Ll, r.sid ? r.sid[j] : 0, r.ts[j],
                                     r.seq ? r.seq[j] : 0);
    }
    __syncthreads();   // positions are read by other threads
    join_row(a, row_pos, max_lookback);
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
                                         const void* r_values, void* scan, void* rpos,
                                         void* last_idx, void* col_idx, void* vals, int K,
                                         int Ll, int Lr, int C, int skip_nulls,
                                         int max_lookback, void* stream) {
    asof_merge_lookback_kernel<<<K, kMergeThreads, 0, (cudaStream_t)stream>>>(
        join_args(l_ts, r_ts, l_sid, r_sid, l_seq, r_seq, r_valid, r_values, scan, last_idx,
                  col_idx, vals, K, Ll, Lr, C, skip_nulls),
        (int32_t*)rpos, max_lookback);
    return (int)cudaGetLastError();
}

extern "C" const char* tempo_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
