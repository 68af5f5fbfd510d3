// AS-OF merge join on packed [K, L] series, one block per series row.
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
// value plane once and writes the index and value planes once; its work is
// Ll * log2(Lr) compares a row, far below the card's integer rate.  The
// binary search re-reads the right key row from L1/L2 (a row is ~100 KB
// at the HHAR shape); the scan scratch adds one write and a read of
// int32 planes per right column.
#include "common.cuh"

namespace {

constexpr int kMergeThreads = 512;

__global__ void __launch_bounds__(kMergeThreads)
asof_merge_kernel(const int64_t* __restrict__ l_ts, const int64_t* __restrict__ r_ts,
                  const int32_t* __restrict__ l_sid, const int32_t* __restrict__ r_sid,
                  const int64_t* __restrict__ l_seq, const int64_t* __restrict__ r_seq,
                  const uint8_t* __restrict__ r_valid, const float* __restrict__ r_values,
                  int32_t* __restrict__ scan, int32_t* __restrict__ last_idx,
                  int32_t* __restrict__ col_idx, float* __restrict__ vals,
                  int K, int Ll, int Lr, int C, int skip_nulls) {
    __shared__ int sh[32];
    const int k = blockIdx.x;
    const size_t lrow = (size_t)k * Ll;
    const size_t rrow = (size_t)k * Lr;
    const size_t lplane = (size_t)K * Ll;
    const size_t rplane = (size_t)K * Lr;

    // a right row counts as valid for column c when its validity bit is
    // set and its value is not NaN (the Pallas payload is NaN-encoded)
    auto right_valid = [&](int c, int j) -> bool {
        const size_t at = c * rplane + rrow + j;
        return r_valid[at] && (r_values == nullptr || !isnan(r_values[at]));
    };

    if (skip_nulls) {
        for (int c = 0; c < C; ++c) {
            int carry = -1;
            for (int base = 0; base < Lr; base += blockDim.x) {
                const int j = base + threadIdx.x;
                int v = (j < Lr && right_valid(c, j)) ? j : -1;
                int total;
                v = max(block_scan_max(v, sh, &total), carry);
                if (j < Lr) scan[c * rplane + rrow + j] = v;
                carry = max(carry, total);
            }
        }
        __syncthreads();   // scan rows are read by other threads below
    }

    for (int i = threadIdx.x; i < Ll; i += blockDim.x) {
        const int64_t ts = l_ts[lrow + i];
        const int32_t sid = l_sid ? l_sid[lrow + i] : 0;
        const int64_t sq = l_seq ? l_seq[lrow + i] : 0;
        // count of right rows <= this left row (right wins full ties)
        int lo = 0, hi = Lr;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            const size_t m = rrow + mid;
            bool le;
            if (l_sid && r_sid[m] != sid) le = r_sid[m] < sid;
            else if (r_ts[m] != ts) le = r_ts[m] < ts;
            else le = l_seq ? (r_seq[m] <= sq) : true;
            if (le) lo = mid + 1; else hi = mid;
        }
        int last = lo - 1;
        if (l_sid && last >= 0 && r_sid[rrow + last] != sid) last = -1;
        last_idx[lrow + i] = last;
        for (int c = 0; c < C; ++c) {
            int j = -1;
            if (skip_nulls) {
                if (last >= 0) j = scan[c * rplane + rrow + last];
                if (l_sid && j >= 0 && r_sid[rrow + j] != sid) j = -1;
            } else if (last >= 0 && right_valid(c, last)) {
                j = last;
            }
            col_idx[c * lplane + lrow + i] = j;
            if (vals) vals[c * lplane + lrow + i] = j >= 0 ? r_values[c * rplane + rrow + j] : tempo_nan();
        }
    }
}

}  // namespace

extern "C" int tempo_asof_merge(const void* l_ts, const void* r_ts, const void* l_sid,
                                const void* r_sid, const void* l_seq, const void* r_seq,
                                const void* r_valid, const void* r_values, void* scan,
                                void* last_idx, void* col_idx, void* vals, int K, int Ll,
                                int Lr, int C, int skip_nulls, void* stream) {
    asof_merge_kernel<<<K, kMergeThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)l_ts, (const int64_t*)r_ts, (const int32_t*)l_sid,
        (const int32_t*)r_sid, (const int64_t*)l_seq, (const int64_t*)r_seq,
        (const uint8_t*)r_valid, (const float*)r_values, (int32_t*)scan,
        (int32_t*)last_idx, (int32_t*)col_idx, (float*)vals, K, Ll, Lr, C, skip_nulls);
    return (int)cudaGetLastError();
}

extern "C" const char* tempo_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
