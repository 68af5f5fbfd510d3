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
// Bound on H100: bytes.  The index scans read 1 byte and write 4 a lane;
// the fill reads 5 (x, valid) and writes 5 (value, has): 0.030 and 0.039
// ms at the main path's [1024, 19304] and [1024, 12760] at 3.35 TB/s.
// The TPU kernels run a log2(L) roll ladder over whole VMEM rows; here a
// block of 128 threads walks its row in tiles of 2048 lanes, and the
// design keeps every global access coalesced and the tile's barriers to
// two:
//
// * Each thread takes a 16-lane segment whose validity bytes are one
//   aligned 16-byte load.  Segments are cut on the address: a row starts
//   at any byte (L = 19,304 leaves every other row 8 bytes into a 16-byte
//   word), so the row's first segment holds the lanes up to the first
//   16-byte boundary and the partial segments at either end load byte by
//   byte.  The next tile's loads are issued before this tile's stores.
// * The thread scans its 16 lanes in registers, then a warp scan by
//   shuffles (__shfl_up_sync; __shfl_down_sync for the reverse scan), then
//   the block's four warp totals through shared memory after one
//   __syncthreads, then the carry of the earlier tiles, held in a
//   register.  Integer max / min is exact, so the result is that of any
//   other scan.  The reverse scan walks the tiles from the row's end and
//   takes suffix minima at each level.
// * The fill carries the pair (last valid index, its value) through the
//   same levels instead of gathering x at the index: the value is a copy,
//   so it is bitwise.  Its x loads are 16-byte loads where aligned.
// * Outputs go through shared memory (double-buffered, so the second
//   __syncthreads is the tile's last) and leave by coalesced stores:
//   consecutive threads write consecutive lanes.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSeg = 16;                    // lanes a thread
constexpr int kTile = kThreads * kSeg;      // 2048 lanes a tile
constexpr int kWarps = kThreads / 32;

template <bool kReverse, bool kValues>
__global__ void __launch_bounds__(kThreads)
index_scan_kernel(const uint8_t* __restrict__ valid, const float* __restrict__ x,
                  int32_t* __restrict__ idx_out, float* __restrict__ val_out,
                  uint8_t* __restrict__ has_out, int L) {
    __shared__ __align__(16) int32_t stage[2][kTile];
    __shared__ __align__(16) uint8_t has_st[2][kValues ? kTile : 16];
    __shared__ int wtot[2][kWarps];
    __shared__ int wval[2][kWarps];
    const size_t row = (size_t)blockIdx.x * L;
    const uint8_t* vr = valid + row;
    const float* xr = kValues ? x + row : nullptr;
    // virtual lane v = i + off: segments [16 m, 16 m + 16) are 16-byte words
    const int off = (int)((uintptr_t)vr & 15);
    const int nt = (L + off + kTile - 1) / kTile;
    const int none = kReverse ? L : -1;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;

    uint8_t fl[kSeg];                      // this thread's segment of the tile
    int xb[kSeg];                          // its x, as bits (the fill)
    auto load = [&](int s) {
        const int i_start = s * kTile + kSeg * (int)threadIdx.x - off;
        if (i_start >= 0 && i_start + kSeg <= L) {
            const uint4 u = *reinterpret_cast<const uint4*>(vr + i_start);
            const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int j = 0; j < kSeg; ++j) fl[j] = (uint8_t)(w4[j >> 2] >> (8 * (j & 3)));
        } else {
#pragma unroll
            for (int j = 0; j < kSeg; ++j) {
                const int i = i_start + j;
                fl[j] = (i >= 0 && i < L) ? vr[i] : 0;
            }
        }
        if constexpr (kValues) {
            if (i_start >= 0 && i_start + kSeg <= L && (((uintptr_t)(xr + i_start)) & 15) == 0) {
#pragma unroll
                for (int j = 0; j < kSeg; j += 4) {
                    const int4 q = *reinterpret_cast<const int4*>(xr + i_start + j);
                    xb[j] = q.x;
                    xb[j + 1] = q.y;
                    xb[j + 2] = q.z;
                    xb[j + 3] = q.w;
                }
            } else {
#pragma unroll
                for (int j = 0; j < kSeg; ++j) {
                    const int i = i_start + j;
                    xb[j] = (i >= 0 && i < L && fl[j]) ? __float_as_int(xr[i]) : 0;
                }
            }
        }
    };

    int carry = none, carry_v = 0;         // over the tiles before
    load(kReverse ? nt - 1 : 0);
    for (int it = 0; it < nt; ++it) {
        const int s = kReverse ? nt - 1 - it : it;
        const int buf = it & 1;
        const int i_start = s * kTile + kSeg * (int)threadIdx.x - off;

        // the segment's own scan: index (and value) of its valid lanes
        int run[kSeg], rv[kSeg];
        int m = none, mv = 0;
#pragma unroll
        for (int jj = 0; jj < kSeg; ++jj) {
            const int j = kReverse ? kSeg - 1 - jj : jj;
            if (fl[j]) {
                m = i_start + j;
                if constexpr (kValues) mv = xb[j];
            }
            run[j] = m;
            if constexpr (kValues) rv[j] = mv;
        }
        // the warp's inclusive scan (suffix in reverse), then exclusive
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int n = kReverse ? __shfl_down_sync(TEMPO_FULL_MASK, m, o)
                                   : __shfl_up_sync(TEMPO_FULL_MASK, m, o);
            const int nv = kValues ? (kReverse ? __shfl_down_sync(TEMPO_FULL_MASK, mv, o)
                                               : __shfl_up_sync(TEMPO_FULL_MASK, mv, o))
                                   : 0;
            const bool in = kReverse ? lane + o < 32 : lane >= o;
            if (in && (kReverse ? n < m : n > m)) {
                m = n;
                mv = nv;
            }
        }
        int ex = kReverse ? __shfl_down_sync(TEMPO_FULL_MASK, m, 1)
                          : __shfl_up_sync(TEMPO_FULL_MASK, m, 1);
        int exv = kValues ? __shfl_up_sync(TEMPO_FULL_MASK, mv, 1) : 0;
        if (kReverse ? lane == 31 : lane == 0) {
            ex = none;
            exv = 0;
        }
        if (lane == (kReverse ? 0 : 31)) {
            wtot[buf][wid] = m;
            wval[buf][wid] = mv;
        }
        __syncthreads();
        // before = the carry, the warps before this one, the lanes before
        int before = carry, bv = carry_v, tot = carry, tv = carry_v;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int ww = kReverse ? kWarps - 1 - w : w;
            const int t = wtot[buf][ww];
            if (kReverse ? t < tot : t > tot) {
                tot = t;
                tv = wval[buf][ww];
            }
            if (kReverse ? ww > wid : ww < wid) {
                before = tot;
                bv = tv;
            }
        }
        if (kReverse ? ex < before : ex > before) {
            before = ex;
            bv = exv;
        }
        // outputs into this tile's stage
        int outv[kSeg];
        uint8_t hs[kSeg];
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
            if constexpr (kValues) {
                const bool own = run[j] != none;
                const int c = own ? run[j] : before;
                outv[j] = c >= 0 ? (own ? rv[j] : bv) : 0;
                hs[j] = c >= 0;
            } else {
                outv[j] = kReverse ? min(before, run[j]) : max(before, run[j]);
            }
        }
        int4* st4 = reinterpret_cast<int4*>(&stage[buf][kSeg * threadIdx.x]);
#pragma unroll
        for (int j = 0; j < kSeg; j += 4) st4[j >> 2] = make_int4(outv[j], outv[j + 1], outv[j + 2], outv[j + 3]);
        if constexpr (kValues) {
            uint32_t hw[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                hw[q] = hs[4 * q] | (hs[4 * q + 1] << 8) | (hs[4 * q + 2] << 16) |
                        ((uint32_t)hs[4 * q + 3] << 24);
            *reinterpret_cast<uint4*>(&has_st[buf][kSeg * threadIdx.x]) =
                make_uint4(hw[0], hw[1], hw[2], hw[3]);
        }
        carry = tot;
        carry_v = tv;
        __syncthreads();
        if (it + 1 < nt) load(kReverse ? s - 1 : s + 1);
        // coalesced stores of the tile's lanes
        const int v0 = s * kTile - off;
#pragma unroll 4
        for (int e = threadIdx.x; e < kTile; e += kThreads) {
            const int i = v0 + e;
            if (i >= 0 && i < L) {
                if constexpr (kValues) {
                    val_out[row + i] = __int_as_float(stage[buf][e]);
                    has_out[row + i] = has_st[buf][e];
                } else {
                    idx_out[row + i] = stage[buf][e];
                }
            }
        }
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
