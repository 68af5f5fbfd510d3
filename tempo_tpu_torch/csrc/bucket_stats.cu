// Tumbling-bucket statistics on packed [K, L] series: mean, count, min,
// max, sum, stddev and zscore of each row's bucket, broadcast to every
// row of the bucket (resample mean/min/max, withGroupedStats and vwap of
// the distributed frame).
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_bucket.py:_make_bucket_kernel
// (through _bucket_stats_call and bucket_stats_pallas / bucket_stats_packed),
// which runs _bucket_math on a VMEM block:
//
//   centre = sum(valid ? x : 0) / max(n_valid, 1)          (the ROW's mean)
//   planes = count, centred sum, centred sum of squares, min x, max x
//   forward segmented inclusive scan over the head flags (the identity and
//     the flag 1 shifted in), then the reverse tail broadcast (0 shifted
//     in): every lane holds its bucket's totals
//   mean, sum, min, max NaN where count = 0, stddev NaN where count <= 1,
//   var = (s2 - s1*s1/max(cnt,1)) / max(cnt-1, 1) clamped at 0,
//   zscore = (x - mean) / std at valid lanes
//
// The head flags (bid changes) and tail flags are formed once per lane from
// the row's bucket ids, which all C columns of a launch share.  The ladders
// keep the TPU's Hillis-Steele association, so the sums round like the TPU
// kernel's and like the plain version's (ops/bucket.py:bucket_stats_plain);
// every add, product, quotient and root rounds to nearest (and the build
// passes -fmad=false), so count, min and max are bitwise equal to the plain
// version, and the rest differ only through the centre's summation order.
// A column's result is the same whether it runs alone or in a stack.
//
// Bound on H100: bytes.  One read of the int32 bucket ids (4 B a lane) and,
// per column, of x and valid (5 B), one write of the seven f32 outputs
// (28 B): 4 + 33C bytes a lane.  The forward ladder makes ceil(log2 L)
// levels of about a dozen flops a lane.
//
// Two forms, picked on the host by ops/stream.bucket_plan:
//
// * the row form (tempo_bucket_stats), four launches on the caller's
//   stream, the forward ladder tiled by the lemma of cumsum3.cu (after the
//   levels of spans < T = 1024, lane i holds a fixed tree over
//   [i - T + 1, i]; it holds for any operator, and the segmented one's
//   identity (flag 1, 0, 0, 0, +inf, -inf) is a fixed point of it, so a
//   halo before the row needs no special case):
//     (a) bucket_centres: a 1024-thread block per (column, row) forms the
//         centre as row_center does (lane-strided, block_sum), into a
//         [C, K] plane: the staged form's order, so the two forms agree
//         bitwise;
//     (b) bucket_tiles: a 512-thread block per (column, row, window of
//         kTileOut = 3072 outputs after a 1024-lane halo) runs the levels
//         of spans < T in registers, as common.cuh's ema_block runs the
//         EMA's (spans 1 .. 16 by shuffles in 32-lane segments, one
//         swizzled transpose through shared memory, spans 32 .. 512 by
//         shuffles along columns of segments), over the element (flag,
//         count, s1, s2, min, max) (SegPlanes below), and writes the six
//         planes to a [6, C, K, L] hand-off the wrapper allocates (written
//         once, read by (c) and (d)); it flags the rows where a lane's
//         flag is still 0, and column 0's blocks record the first bucket
//         tail of their outputs;
//     (c) common.cuh's class_ladder<SegPlanes> runs the levels of spans
//         T, 2T, ... < L along the residue classes mod T, on the flagged
//         rows only (a row whose every bucket is shorter than T is
//         complete after (b): every flag is set, so those levels copy);
//     (d) bucket_out: the reverse tail broadcast only copies the forward
//         value from the bucket's last lane, so a 512-thread block per
//         (row, window) finds each lane's tail (the lane before the next
//         id change: a suffix minimum over the window's run ends and the
//         first tails (b) recorded for the later windows), reads the five
//         planes there and forms the seven outputs of every column in
//         bucket_outputs' op order.
//   Traffic a column: 5 B a lane in (a), about 12 in and 24 out in (b),
//   44 in (c), 37 in (d): about 120 B against the function's 37.  Rows past
//   class_ladder_max_lanes(6) = 4,958,208 lanes are refused (the wrapper
//   raises before the launch).
// * the tile-local staged form (bucket_stats_ring_kernel): one block per
//   row first reduces each column's centre in the same order (1024
//   threads, lane-strided, block_sum), then cuts the row into windows of at
//   most T lanes, each starting at a bucket head: window j + 1 starts at
//   the head of the bucket that holds lane s_j + T.  The windows stream
//   through ring.cuh's staging ring (ids, then x and valid of each column),
//   and each runs the two ladders over its own lanes in shared memory
//   (12 float planes of T lanes), each stopping once every lane is
//   complete, and writes the outputs of the buckets that end inside it
//   (lanes [s_j, s_j+1)).  A segmented ladder combines a bucket's lanes in
//   a tree that depends only on the lanes' offsets from the bucket's head
//   (the head flag freezes every lane before it reads across the head), so
//   each such bucket gets the row form's bits.  A row holding a bucket
//   longer than T lanes has no such cut: the block appends it to
//   `long_rows` and leaves it to the row form, which the wrapper runs on
//   those rows.  Every two windows advance at least T + 1 lanes, so a row
//   has at most 2 * ceil(L / T) - 1 windows.
#include "common.cuh"
#include "ring.cuh"

#include <limits.h>

namespace {

constexpr int kPlanes = 6;                 // count, s1, s2, min, max, flag
constexpr int kSetPlanes = 2 * kPlanes;    // two ping-pong sets

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// The seven outputs of a lane from its bucket's totals (count, centred
// sum and sum of squares, min, max), the centre and the lane's x and
// validity, into out[at + s * stat_plane] for stat s.
__device__ __forceinline__ void bucket_outputs(float cnt, float s1, float s2, float mn,
                                               float mx, float center, float xi, bool ok,
                                               float* out, size_t at, size_t stat_plane) {
    const float NaN = tempo_nan();
    const float cnt1 = fmaxf(cnt, 1.f);
    const float mean = cnt > 0.f ? __fadd_rn(__fdiv_rn(s1, cnt1), center) : NaN;
    const float total = __fadd_rn(s1, __fmul_rn(cnt, center));
    const float var = cnt > 1.f ? __fdiv_rn(__fsub_rn(s2, __fdiv_rn(__fmul_rn(s1, s1), cnt1)),
                                            fmaxf(__fsub_rn(cnt, 1.f), 1.f))
                                : NaN;
    const float std = cnt > 1.f ? __fsqrt_rn(max_nan(var, 0.f)) : NaN;
    out[at] = mean;
    out[stat_plane + at] = cnt;
    out[2 * stat_plane + at] = cnt > 0.f ? mn : NaN;
    out[3 * stat_plane + at] = cnt > 0.f ? mx : NaN;
    out[4 * stat_plane + at] = cnt > 0.f ? total : NaN;
    out[5 * stat_plane + at] = std;
    out[6 * stat_plane + at] = ok ? __fdiv_rn(__fsub_rn(xi, mean), std) : NaN;
}

// The staged form's two ladders and the outputs over lanes [0, n) of one
// window of a column: `base` holds the 12 planes, `stride` floats apart;
// b, xr, vr are the lanes' ids, values and validity; outputs of lanes
// [0, m) go to out[o + i] (+ s * stat_plane for stat s).  Ends with a
// __syncthreads().  Each ladder stops after the first pass that leaves
// every lane's flag set: from then on every lane has its bucket's head
// (its tail) inside its span and each later pass would copy it unchanged,
// so the bits are those of the full log2(n) passes.
__device__ __forceinline__ void bucket_ladder(float* base, size_t stride, const int32_t* b,
                                              const float* xr, const uint8_t* vr,
                                              float center, int n, int m, float* out,
                                              size_t o, size_t stat_plane) {
    const float INF = pos_inf();
    float* a[kPlanes];
    float* nx[kPlanes];
    for (int p = 0; p < kPlanes; ++p) {
        a[p] = base + (size_t)p * stride;
        nx[p] = base + (size_t)(kPlanes + p) * stride;
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const bool ok = vr[i] != 0;
        const float xi = xr[i];
        const float xc = ok ? __fsub_rn(xi, center) : 0.f;
        a[0][i] = ok ? 1.f : 0.f;
        a[1][i] = xc;
        a[2][i] = __fmul_rn(xc, xc);
        a[3][i] = ok ? xi : INF;
        a[4][i] = ok ? xi : -INF;
        a[5][i] = (i == 0 || b[i] != b[i - 1]) ? 1.f : 0.f;
    }
    __syncthreads();

    // forward segmented inclusive scan: a lane stops taking its
    // predecessor's partial once a head flag lies between them
    for (int span = 1; span < n; span <<= 1) {
        int flagged = 1;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const bool ok = i >= span;
            const float f = a[5][i];
            const bool head = f > 0.f;
            for (int p = 0; p < 3; ++p) {
                const float prev = ok ? a[p][i - span] : 0.f;
                nx[p][i] = head ? a[p][i] : __fadd_rn(a[p][i], prev);
            }
            const float pmin = ok ? a[3][i - span] : INF;
            const float pmax = ok ? a[4][i - span] : -INF;
            nx[3][i] = head ? a[3][i] : min_nan(a[3][i], pmin);
            nx[4][i] = head ? a[4][i] : max_nan(a[4][i], pmax);
            nx[5][i] = fmaxf(f, ok ? a[5][i - span] : 1.f);
            flagged &= nx[5][i] > 0.f;
        }
        const bool done = __syncthreads_and(flagged) != 0;
        for (int p = 0; p < kPlanes; ++p) {
            float* t = a[p]; a[p] = nx[p]; nx[p] = t;
        }
        if (done) break;
    }

    // reverse tail broadcast: each lane takes the value at the first
    // tail at or after it, its own bucket's last lane
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        a[5][i] = (i == n - 1 || b[i] != b[i + 1]) ? 1.f : 0.f;
    }
    __syncthreads();
    for (int span = 1; span < n; span <<= 1) {
        int flagged = 1;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const bool ok = i < n - span;
            const float g = a[5][i];
            const bool tail = g > 0.f;
            for (int p = 0; p < 5; ++p) {
                const float next = ok ? a[p][i + span] : 0.f;
                nx[p][i] = tail ? a[p][i] : next;
            }
            nx[5][i] = fmaxf(g, ok ? a[5][i + span] : 0.f);
            flagged &= nx[5][i] > 0.f;
        }
        const bool done = __syncthreads_and(flagged) != 0;
        for (int p = 0; p < kPlanes; ++p) {
            float* t = a[p]; a[p] = nx[p]; nx[p] = t;
        }
        if (done) break;
    }

    for (int i = threadIdx.x; i < m; i += blockDim.x)
        bucket_outputs(a[0][i], a[1][i], a[2][i], a[3][i], a[4][i], center, xr[i], vr[i] != 0,
                       out, o + i, stat_plane);
    // the next call's first pass overwrites planes other threads may
    // still read here
    __syncthreads();
}

// The row's centre of column row (x, valid): sum(valid ? x : 0) /
// max(n_valid, 1), summed lane-strided over the block, then block_sum.
__device__ __forceinline__ float row_center(const float* xr, const uint8_t* vr, int L,
                                            float* shf) {
    float nv = 0.f, sx = 0.f;
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        if (vr[i]) {
            nv = __fadd_rn(nv, 1.f);
            sx = __fadd_rn(sx, xr[i]);
        }
    }
    nv = block_sum(nv, shf);
    sx = block_sum(sx, shf);
    return __fdiv_rn(sx, fmaxf(nv, 1.f));
}

// Largest (kMax) or least int over the block (blockDim.x a multiple of 32).
template <bool kMax>
__device__ __forceinline__ int block_extreme(int v, int* sh /* >= 32 */) {
    auto reduce = [](int t) {
        return kMax ? __reduce_max_sync(TEMPO_FULL_MASK, t) : __reduce_min_sync(TEMPO_FULL_MASK, t);
    };
    v = reduce(v);
    __syncthreads();                       // sh may still be read by a previous call
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
        int t = threadIdx.x < (blockDim.x >> 5) ? sh[threadIdx.x] : kMax ? INT_MIN : INT_MAX;
        t = reduce(t);
        if (threadIdx.x == 0) sh[0] = t;
    }
    __syncthreads();
    return sh[0];
}

// Least v over the threads after this one in threadIdx order (INT_MAX
// on the last); blockDim.x a multiple of 32.
__device__ __forceinline__ int block_after_min(int v, int* sh /* >= 32 */) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {     // inclusive suffix minimum in the warp
        const int n = __shfl_down_sync(TEMPO_FULL_MASK, v, o);
        if (lane + o < 32) v = min(v, n);
    }
    __syncthreads();                       // sh may still be read by a previous call
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    int after = __shfl_down_sync(TEMPO_FULL_MASK, v, 1);
    if (lane == 31) after = INT_MAX;
    for (int j = wid + 1; j < nw; ++j) after = min(after, sh[j]);
    return after;
}

// ---- the row form ---------------------------------------------------

constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileSegs = 128;                          // 32-lane segments a window
constexpr int kTileHalo = 1 << kClassTileLog2;          // T
constexpr int kTileOut = kTileSegs * 32 - kTileHalo;    // 3072 outputs a window
constexpr int kTileRun = kTileSegs / kTileWarps;        // segments a warp, row phase
constexpr int kTileEnt = kTileSegs / 32;                // entries a thread, column phase
constexpr int kOutThreads = 512;
constexpr int kOutLanes = kTileOut / kOutThreads;       // lanes a thread scans in (d)

// The forward ladder's element as six planes: flag, count, s1, s2, min,
// max.  combine(a, b) is bucket_ladder's step (a after its partner b): a
// head keeps its values, else each value plane takes b's in (sums rounded
// to nearest, min and max NaN-propagating); the flag takes the max.  The
// identity (flag 1, 0, 0, 0, +inf, -inf) is what the ladder shifts in
// below the row; every level leaves it as it is.
struct SegPlanes {
    static constexpr int kPlanes = 6;
    static constexpr int kFirstOut = 1;    // the flag is not written back
    __device__ static float ident(int p) {
        return p == 0 ? 1.f : p == 4 ? pos_inf() : p == 5 ? -pos_inf() : 0.f;
    }
    __device__ static void combine(float a[6], const float b[6]) {
        const bool head = a[0] > 0.f;
#pragma unroll
        for (int p = 1; p < 4; ++p) a[p] = head ? a[p] : __fadd_rn(a[p], b[p]);
        a[4] = head ? a[4] : min_nan(a[4], b[4]);
        a[5] = head ? a[5] : max_nan(a[5], b[5]);
        a[0] = fmaxf(a[0], b[0]);
    }
};

// (a) the centre of each (column, row), into centre[c * K + k]
__global__ void __launch_bounds__(kEmaThreads)
bucket_centres(const float* __restrict__ x, const uint8_t* __restrict__ valid,
               float* __restrict__ centre, int L) {
    __shared__ float shf[32];
    const size_t crow = (size_t)blockIdx.x * L;
    const float c = row_center(x + crow, valid + crow, L, shf);
    if (threadIdx.x == 0) centre[blockIdx.x] = c;
}

// (b) A block per (column c, row k, window): lane (g, l) of the window
// is row lane origin + 32 g + l, origin = window * kTileOut - kTileHalo
// (the identity outside the row); the levels of spans < T; the six planes
// of the outputs (lanes past the halo) go to `planes`.  live[c K + k] is
// set where an output's flag is still 0 (stage 2 has work there); column
// 0's blocks write the first bucket tail among their outputs (INT_MAX if
// none) to first_tail[k * tiles + window].
__global__ void __launch_bounds__(kTileThreads, 2)
bucket_tiles(const int32_t* __restrict__ bid, const float* __restrict__ x,
             const uint8_t* __restrict__ valid, const float* __restrict__ centre,
             ClassPlanes<kPlanes> planes, int* __restrict__ live, int* __restrict__ first_tail,
             int K, int L, int tiles) {
    extern __shared__ float smem[];        // plane p at [p S, (p + 1) S)
    __shared__ int shi[32];
    constexpr int S = kTileSegs * 32;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int ck = blockIdx.x / tiles, win = blockIdx.x % tiles;
    const int k = ck % K;
    const size_t crow = (size_t)ck * L, brow = (size_t)k * L;
    const float center = centre[ck];
    const long long origin = (long long)win * kTileOut - kTileHalo;
    const float INF = pos_inf();

    // row phase, spans 1 .. 16: warp w takes segments [g0, g0 + kTileRun),
    // carrying the segment before's shuffled values (its predecessor
    // laddered for them alone: the identity before the window); the run's
    // inputs are all loaded first
    {
        const int g0 = w * kTileRun;
        float xr[kTileRun + 1];
        bool okr[kTileRun + 1], hr[kTileRun + 1];
#pragma unroll
        for (int q = 0; q <= kTileRun; ++q) {
            const long long i = origin + 32LL * (g0 - 1 + q) + lane;
            const bool in = i >= 0 && i < L;
            const size_t at = in ? (size_t)i : 0;
            okr[q] = in && valid[crow + at] != 0;
            xr[q] = x[crow + at];
            hr[q] = !in || i == 0 || bid[brow + at] != bid[brow + at - 1];
        }
        float carry[5][kPlanes];
#pragma unroll
        for (int ls = 0; ls < 5; ++ls)
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) carry[ls][p] = SegPlanes::ident(p);
#pragma unroll
        for (int q = 0; q <= kTileRun; ++q) {
            // the element: the identity outside the row
            float e[kPlanes];
            const float xc = okr[q] ? __fsub_rn(xr[q], center) : 0.f;
            e[0] = hr[q] ? 1.f : 0.f;
            e[1] = okr[q] ? 1.f : 0.f;
            e[2] = xc;
            e[3] = __fmul_rn(xc, xc);
            e[4] = okr[q] ? xr[q] : INF;
            e[5] = okr[q] ? xr[q] : -INF;
#pragma unroll
            for (int ls = 0; ls < 5; ++ls) {
                const int s = 1 << ls;
                float b[kPlanes];
#pragma unroll
                for (int p = 0; p < kPlanes; ++p) {
                    const float sh = __shfl_sync(TEMPO_FULL_MASK, e[p], (lane - s) & 31);
                    b[p] = lane >= s ? sh : carry[ls][p];
                    carry[ls][p] = sh;
                }
                SegPlanes::combine(e, b);
            }
            if (q > 0) {
#pragma unroll
                for (int p = 0; p < kPlanes; ++p)
                    smem[p * S + ladder_slot(g0 - 1 + q, lane)] = e[p];
            }
        }
    }
    __syncthreads();

    // column phase, spans 32 m, m = 1 .. 16 segments: warp w takes columns
    // w and w + 16, thread c the segments c + 32 i; the partner is thread
    // c - m's entry i (c >= m), else thread c - m + 32's entry i - 1
    for (int col = w; col < 32; col += kTileWarps) {
        float e[kTileEnt][kPlanes];
#pragma unroll
        for (int i = 0; i < kTileEnt; ++i)
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) e[i][p] = smem[p * S + ladder_slot(lane + 32 * i, col)];
#pragma unroll
        for (int lm = 0; lm < 5; ++lm) {
            const int m = 1 << lm;
            float prev[kPlanes];
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) prev[p] = SegPlanes::ident(p);
#pragma unroll
            for (int i = 0; i < kTileEnt; ++i) {
                const bool in = lane + 32 * i >= m;
                float b[kPlanes];
#pragma unroll
                for (int p = 0; p < kPlanes; ++p) {
                    const float sh = __shfl_sync(TEMPO_FULL_MASK, e[i][p], (lane - m) & 31);
                    b[p] = !in ? SegPlanes::ident(p) : lane >= m ? sh : prev[p];
                    prev[p] = sh;
                }
                SegPlanes::combine(e[i], b);
            }
        }
#pragma unroll
        for (int i = 0; i < kTileEnt; ++i)
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) smem[p * S + ladder_slot(lane + 32 * i, col)] = e[i][p];
    }
    __syncthreads();

    const bool first_col = ck < K;
    bool open = false;
    int tail = INT_MAX;
    for (int e = threadIdx.x; e < S; e += kTileThreads) {
        const long long i = origin + e;
        if (e < kTileHalo || i >= L) continue;
        const int at = ladder_slot(e >> 5, e & 31);
        open |= smem[at] == 0.f;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) planes.p[p][crow + i] = smem[p * S + at];
        if (first_col && tail == INT_MAX && (i == L - 1 || bid[brow + i] != bid[brow + i + 1]))
            tail = (int)i;
    }
    if (__syncthreads_or(open) && threadIdx.x == 0) live[ck] = 1;
    if (first_col) {
        tail = block_extreme<false>(tail, shi);
        if (threadIdx.x == 0) first_tail[(size_t)k * tiles + win] = tail;
    }
}

// (d) A block per (row k, window): each lane's bucket tail, then the
// seven outputs of every column from the five planes at the tail.
__global__ void __launch_bounds__(kOutThreads)
bucket_out(const int32_t* __restrict__ bid, const float* __restrict__ x,
           const uint8_t* __restrict__ valid, const float* __restrict__ centre,
           ClassPlanes<kPlanes> planes, const int* __restrict__ first_tail,
           float* __restrict__ out, int C, int K, int L, int tiles) {
    __shared__ int shi[32];
    __shared__ int ids[kTileOut + 1];      // the window's ids, then one past it
    __shared__ int tails[kTileOut];        // each lane's bucket tail
    const int k = blockIdx.x / tiles, win = blockIdx.x % tiles;
    const long long s0 = (long long)win * kTileOut;
    const int n = (int)min((long long)kTileOut, L - s0);
    const size_t brow = (size_t)k * L + s0;
    const size_t stat_plane = (size_t)C * K * L;   // stride between outputs

    for (int j = threadIdx.x; j < n + (s0 + n < L); j += kOutThreads) ids[j] = bid[brow + j];
    // the first tail past the window: the least first tail of the later ones
    int after = INT_MAX;
    for (int j = win + 1 + threadIdx.x; j < tiles; j += kOutThreads)
        after = min(after, first_tail[(size_t)k * tiles + j]);
    after = block_extreme<false>(after, shi);    // (its barriers publish ids)
    // lanes kOutLanes t + q of thread t: the first run end at or after each
    // among them, then among the later threads' lanes, then past the window
    int tail[kOutLanes];
    int run = INT_MAX;
#pragma unroll
    for (int q = kOutLanes - 1; q >= 0; --q) {
        const int j = threadIdx.x * kOutLanes + q;
        if (j < n && (s0 + j == L - 1 || ids[j] != ids[j + 1])) run = (int)(s0 + j);
        tail[q] = run;
    }
    const int later = min(block_after_min(run, shi), after);
#pragma unroll
    for (int q = 0; q < kOutLanes; ++q) tails[threadIdx.x * kOutLanes + q] = min(tail[q], later);
    __syncthreads();

    for (int c = 0; c < C; ++c) {
        const size_t crow = ((size_t)c * K + k) * L;
        const float center = centre[(size_t)c * K + k];
#pragma unroll
        for (int q = 0; q < kOutLanes; ++q) {
            const int j = threadIdx.x + q * kOutThreads;
            if (j >= n) break;
            const size_t t = crow + tails[j], at = crow + s0 + j;
            bucket_outputs(planes.p[1][t], planes.p[2][t], planes.p[3][t], planes.p[4][t],
                           planes.p[5][t], center, x[at], valid[at] != 0, out, at, stat_plane);
        }
    }
}

// Shared memory of the staged form, in bytes from the start of the
// block's dynamic shared memory (ops/stream.bucket_ring_bytes mirrors the
// total): the ring's barriers, a block reduction's 32 words, the C centres, the
// window starts (and the end sentinel), the ladder's 12 planes of T
// floats, then `depth` slots of the ids and each column's x and valid.
struct BucketRingLayout {
    size_t centre, starts, ladder, slots;
    size_t id_plane, x_plane, v_plane, slot, total;
    int max_windows;
};

__host__ __device__ inline BucketRingLayout bucket_ring_layout(int C, int L, int T, int depth) {
    BucketRingLayout y;
    y.max_windows = 2 * ((L + T - 1) / T) - 1;
    y.centre = 8 * ring::kMaxDepth + 32 * 4;
    y.starts = y.centre + ring::align16(4 * (size_t)C);
    y.ladder = y.starts + ring::align16(4 * (size_t)(y.max_windows + 1));
    y.slots = y.ladder + 4 * (size_t)kSetPlanes * ring::align16(T);
    y.id_plane = ring::plane_bytes(4 * (size_t)T);
    y.x_plane = y.id_plane;
    y.v_plane = ring::plane_bytes((size_t)T);
    y.slot = y.id_plane + C * (y.x_plane + y.v_plane);
    y.total = y.slots + (size_t)depth * y.slot;
    return y;
}

__global__ void __launch_bounds__(kEmaThreads)
bucket_stats_ring_kernel(const int32_t* __restrict__ bid, const float* __restrict__ x,
                         const uint8_t* __restrict__ valid, float* __restrict__ out,
                         int32_t* __restrict__ long_rows, int32_t* __restrict__ n_long, int C,
                         int K, int L, int T, int depth) {
    extern __shared__ __align__(16) unsigned char sm[];
    const BucketRingLayout lay = bucket_ring_layout(C, L, T, depth);
    const ring::Ring r{(uint64_t*)sm, depth};
    float* shf = (float*)(sm + 8 * ring::kMaxDepth);
    int* shi = (int*)shf;
    float* centre = (float*)(sm + lay.centre);
    int* starts = (int*)(sm + lay.starts);
    float* ladder = (float*)(sm + lay.ladder);
    const int k = blockIdx.x;
    const int32_t* b = bid + (size_t)k * L;
    const size_t stat_plane = (size_t)C * K * L;

    for (int c = 0; c < C; ++c) {
        const size_t crow = ((size_t)c * K + k) * L;
        const float center = row_center(x + crow, valid + crow, L, shf);
        if (threadIdx.x == 0) centre[c] = center;
    }

    // the window chain: each start is a bucket head; the next is the last
    // head in (s, s + T], the head of the bucket holding lane s + T
    int s = 0, nw = 0;
    bool is_long = false;
    for (;;) {
        if (nw == lay.max_windows) { is_long = true; break; }   // not reached
        if (threadIdx.x == 0) starts[nw] = s;
        ++nw;
        if (s + T >= L) break;
        int best = -1;
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const int j = s + T - t;
            if (b[j] != b[j - 1]) best = max(best, j);
        }
        best = block_extreme<true>(best, shi);
        if (best < 0) { is_long = true; break; }
        s = best;
    }
    if (is_long) {
        if (threadIdx.x == 0) long_rows[atomicAdd(n_long, 1)] = k;
        return;
    }
    if (threadIdx.x == 0) starts[nw] = L;
    ring::init(r);

    const size_t n_all = (size_t)C * K * L;
    auto plane = [&](int slot, int p) -> unsigned char* {
        unsigned char* base = sm + lay.slots + (size_t)slot * lay.slot;
        return p == 0 ? base
                      : base + lay.id_plane + (size_t)(p - 1) * (lay.x_plane + lay.v_plane);
    };
    auto load = [&](int w, int slot, uint64_t* bar) {
        const int s0 = starts[w];
        const size_t n = (size_t)min(T, L - s0);
        ring::stage(plane(slot, 0), b + s0, 4 * n, bid + (size_t)K * L, bar);
        for (int c = 0; c < C; ++c) {
            const size_t at = ((size_t)c * K + k) * L + s0;
            unsigned char* p = plane(slot, 1 + c);
            ring::stage(p, x + at, 4 * n, x + n_all, bar);
            ring::stage(p + lay.x_plane, valid + at, n, valid + n_all, bar);
        }
    };
    auto consume = [&](int w, int slot) {
        const int s0 = starts[w];
        const int n = min(T, L - s0);
        const int m = starts[w + 1] - s0;
        const int32_t* bs =
            (const int32_t*)(plane(slot, 0) + ((uintptr_t)(b + s0) & 15));
        for (int c = 0; c < C; ++c) {
            const size_t at = ((size_t)c * K + k) * L + s0;
            unsigned char* p = plane(slot, 1 + c);
            const float* xs = (const float*)(p + ((uintptr_t)(x + at) & 15));
            const uint8_t* vs = p + lay.x_plane + ((uintptr_t)(valid + at) & 15);
            bucket_ladder(ladder, ring::align16(T), bs, xs, vs, centre[c], n, m, out, at,
                          stat_plane);
        }
    };
    ring::run(r, nw, load, consume);
}

}  // namespace

// longest row the row form takes (stage 2's classes at R = 1)
extern "C" long long tempo_bucket_max_lanes() { return class_ladder_max_lanes(kPlanes); }

// The row form: `planes` is the [6, C, K, L] hand-off, `centre` [C, K],
// `live` [C, K] zeros, `first_tail` [K, ceil(L / 3072)].
extern "C" int tempo_bucket_stats(const void* bid, const void* x, const void* valid,
                                  void* out, void* planes, void* centre, void* live,
                                  void* first_tail, int C, int K, int L, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int CK = C * K;
    const int tiles = (L + kTileOut - 1) / kTileOut;
    const size_t n = (size_t)CK * L;
    float* pl = (float*)planes;
    const ClassPlanes<kPlanes> p{{pl, pl + n, pl + 2 * n, pl + 3 * n, pl + 4 * n, pl + 5 * n}};
    bucket_centres<<<CK, kEmaThreads, 0, st>>>((const float*)x, (const uint8_t*)valid,
                                               (float*)centre, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = sizeof(float) * kPlanes * kTileSegs * 32;
    err = cudaFuncSetAttribute(bucket_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    bucket_tiles<<<(unsigned)((size_t)CK * tiles), kTileThreads, smem, st>>>(
        (const int32_t*)bid, (const float*)x, (const uint8_t*)valid, (const float*)centre, p,
        (int*)live, (int*)first_tail, K, L, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (L > (1 << kClassTileLog2)) {
        err = launch_class_ladder<SegPlanes>(p, CK, L, st, (const int*)live);
        if (err != cudaSuccess) return (int)err;
    }
    bucket_out<<<(unsigned)((size_t)K * tiles), kOutThreads, 0, st>>>(
        (const int32_t*)bid, (const float*)x, (const uint8_t*)valid, (const float*)centre, p,
        (const int*)first_tail, (float*)out, C, K, L, tiles);
    return (int)cudaGetLastError();
}

// Shared memory of the staged form at (C, L, T, depth), for the planner's
// check on the card.
extern "C" long long tempo_bucket_ring_smem(int C, int L, int T, int depth) {
    return (long long)bucket_ring_layout(C, L, T, depth).total;
}

extern "C" int tempo_bucket_stats_ring(const void* bid, const void* x, const void* valid,
                                       void* out, void* long_rows, void* n_long, int C, int K,
                                       int L, int T, int depth, void* stream) {
    const size_t smem = bucket_ring_layout(C, L, T, depth).total;
    if (depth < 2 || depth > ring::kMaxDepth || T < 32 || T % 32 != 0 ||
        smem > (size_t)kEmaSmemLimit)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        bucket_stats_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    bucket_stats_ring_kernel<<<K, kEmaThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)bid, (const float*)x, (const uint8_t*)valid, (float*)out,
        (int32_t*)long_rows, (int32_t*)n_long, C, K, L, T, depth);
    return (int)cudaGetLastError();
}
