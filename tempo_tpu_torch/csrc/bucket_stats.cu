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
//         [C, K] plane (the staged form launches it too, so the two
//         forms agree bitwise);
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
//   class_whole_max(6) * 1024 = 4,958,208 lanes, whose residue classes
//   outgrow shared memory, take (c) windowed and a third stage along the
//   classes mod 2^18 (common.cuh), so every int32 row length runs.
// * the staged form (tempo_bucket_stats_ring), two launches: bucket_centres
//   into a [C, K] plane (the row form's centres, so the two forms agree
//   bitwise), then bucket_stats_ring_kernel, a block a row, which streams
//   windows of T lanes of the ids and of every column's x and valid
//   through ring.cuh's staging ring and fuses (b) and (d) without a
//   ladder: at each bucket's tail the segmented ladder holds a fixed
//   pairwise tree of the bucket's lanes, which a thread evaluates in the
//   same order, so it writes the row form's bits.  A window covers the
//   carry (the lanes of the previous window's last bucket) and its own
//   lanes, and writes the seven outputs of every bucket that ends before
//   its last one (every bucket in the row's last window).  No plane goes
//   to global memory: 4 + 5C B a lane in and 28C out, the function's own
//   traffic (and the centres' 5C in).  A row with a bucket longer than
//   kSpan = 1024 lanes, the most a carry holds, goes to `long_rows` and the
//   row form, which the wrapper runs on those rows.
#include "common.cuh"
#include "ring.cuh"

#include <limits.h>

namespace {

constexpr int kPlanes = 6;                 // the row form's flag, count, s1, s2, min, max

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// A bucket's six outputs from its totals (count, centred sum and sum of
// squares, min, max) and the centre; every lane of the bucket writes them
// (bucket_store) beside its zscore.
struct BucketTotals {
    float mean, cnt, mn, mx, sum, std;
};

__device__ __forceinline__ BucketTotals bucket_totals(float cnt, float s1, float s2, float mn,
                                                      float mx, float center) {
    const float NaN = tempo_nan();
    const float cnt1 = fmaxf(cnt, 1.f);
    const float total = __fadd_rn(s1, __fmul_rn(cnt, center));
    const float var = cnt > 1.f ? __fdiv_rn(__fsub_rn(s2, __fdiv_rn(__fmul_rn(s1, s1), cnt1)),
                                            fmaxf(__fsub_rn(cnt, 1.f), 1.f))
                                : NaN;
    return {cnt > 0.f ? __fadd_rn(__fdiv_rn(s1, cnt1), center) : NaN, cnt,
            cnt > 0.f ? mn : NaN, cnt > 0.f ? mx : NaN, cnt > 0.f ? total : NaN,
            cnt > 1.f ? __fsqrt_rn(max_nan(var, 0.f)) : NaN};
}

// The seven outputs of a lane, x and validity xi, ok, into
// out[at + s * stat_plane] for stat s.
__device__ __forceinline__ void bucket_store(const BucketTotals& b, float xi, bool ok,
                                             float* out, size_t at, size_t stat_plane) {
    out[at] = b.mean;
    out[stat_plane + at] = b.cnt;
    out[2 * stat_plane + at] = b.mn;
    out[3 * stat_plane + at] = b.mx;
    out[4 * stat_plane + at] = b.sum;
    out[5 * stat_plane + at] = b.std;
    out[6 * stat_plane + at] = ok ? __fdiv_rn(__fsub_rn(xi, b.mean), b.std) : tempo_nan();
}

__device__ __forceinline__ void bucket_outputs(float cnt, float s1, float s2, float mn,
                                               float mx, float center, float xi, bool ok,
                                               float* out, size_t at, size_t stat_plane) {
    bucket_store(bucket_totals(cnt, s1, s2, mn, mx, center), xi, ok, out, at, stat_plane);
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

// Least int over the block (blockDim.x a multiple of 32).
__device__ __forceinline__ int block_min(int v, int* sh /* >= 32 */) {
    v = __reduce_min_sync(TEMPO_FULL_MASK, v);
    __syncthreads();                       // sh may still be read by a previous call
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
        int t = threadIdx.x < (blockDim.x >> 5) ? sh[threadIdx.x] : INT_MAX;
        t = __reduce_min_sync(TEMPO_FULL_MASK, t);
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
// max.  combine(a, b) is the segmented step (a after its partner b): a
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
        tail = block_min(tail, shi);
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
    after = block_min(after, shi);    // (its barriers publish ids)
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

// ---- the staged form ------------------------------------------------

constexpr int kRingThreads = 256;
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kSpan = 1 << kClassTileLog2;      // longest bucket a window takes (its halo)
constexpr int kSpanLog2 = kClassTileLog2;
constexpr int kRingEnt = 4;                     // segments a lane in the segment scans
constexpr int kGroupLog2 = 3;
constexpr int kGroup = 1 << kGroupLog2;         // leaves a static tree takes at once
constexpr int kPairs = 2 * kRingThreads;        // (tail, column) pairs a round

// lanes at or below lane l of a 32-bit mask (l in [0, 31])
__device__ __forceinline__ uint32_t mask_le(int l) { return (2u << l) - 1u; }

// the position of set bit k (from 0) of m
__device__ __forceinline__ int nth_bit(uint32_t m, int k) {
    int pos = 0;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
        const int c = __popc(m & ((1u << w) - 1u));
        if (k >= c) {
            k -= c;
            m >>= w;
            pos += w;
        }
    }
    return pos;
}

// a set to a after its partner b (a's leaves the later lanes): the row
// form's segmented step, SegPlanes::combine, on s1, s2, min and max
__device__ __forceinline__ void node_combine(float a[4], const float b[4]) {
    a[0] = __fadd_rn(a[0], b[0]);
    a[1] = __fadd_rn(a[1], b[1]);
    a[2] = min_nan(a[2], b[2]);
    a[3] = max_nan(a[3], b[3]);
}

// Shared memory of the staged form, in bytes from the start of the
// block's dynamic shared memory (ops/stream.bucket_ring_bytes mirrors the
// total): the ring's barriers and a block reduction's 32 words, 5 + 2 C
// words a segment of the largest region (kSpan + T lanes), four pointers a
// column (its x and valid in the carry and in the slot), six planes of
// kPairs bucket totals, the carry (ids,
// then each column's x and valid, of up to kSpan lanes), then `depth`
// slots of a window's ids and each column's x and valid.
struct BucketRingLayout {
    int G;
    size_t segs, ptrs, tot, carry, carry_col, slots;
    size_t id_plane, x_plane, v_plane, slot, total;
};

__host__ __device__ inline BucketRingLayout bucket_ring_layout(int C, int T, int depth) {
    BucketRingLayout y;
    y.G = (kSpan + T + 31) / 32;
    y.segs = 8 * ring::kMaxDepth + 32 * 4;
    y.ptrs = y.segs + ring::align16(4 * (size_t)(5 + 2 * C) * y.G);
    y.tot = y.ptrs + 32 * (size_t)C;
    y.carry = y.tot + 4 * 6 * (size_t)kPairs;
    y.carry_col = ring::align16(4 * (size_t)kSpan) + ring::align16(kSpan);
    y.slots = y.carry + ring::align16(4 * (size_t)kSpan) + (size_t)C * y.carry_col;
    y.id_plane = ring::plane_bytes(4 * (size_t)T);
    y.x_plane = y.id_plane;
    y.v_plane = ring::plane_bytes((size_t)T);
    y.slot = y.id_plane + (size_t)C * (y.x_plane + y.v_plane);
    y.total = y.slots + (size_t)depth * y.slot;
    return y;
}

// A block per row walks its windows: window w's slot holds lanes
// [w T, min(L, (w + 1) T)) of the ids and of every column's x and valid.
// Its region is the carry (the lanes of the previous window's last bucket,
// which it did not output) and then those lanes, so it starts at a bucket
// head.  Per region:
//   1. each 32-lane segment's head bits and each column's valid bits
//      (ballots), and the largest distance d = i - head(i) with its head
//      inside the segment;
//   2. the segment scans, a warp each: the last head before each segment
//      and D, the largest d of the region (D >= kSpan: a bucket longer
//      than the halo; the row goes to long_rows and the row form); the
//      bucket tails in and before each (every lane before a head; in the
//      row's last window the region's last lane too); each column's valid
//      lanes before each;
//   3. in rounds of kPairs (tail, column) pairs, column-major, a thread a
//      pair evaluates the bucket's value in the row form's forward ladder.
//      At a bucket's tail t, whose head is n - 1 lanes back, the segmented
//      Hillis-Steele ladder holds a fixed tree: with r = t - i for each
//      lane i of the bucket, the level of span 2^(k-1) adds into r = 0 mod
//      2^k the node of r + 2^(k-1) where it exists, the later lanes first
//      (SegPlanes::combine: the own value, then the partner's).  So the
//      thread takes r in groups of kGroup = 8, each group's node by a
//      static pairwise tree in registers, keeps the complete nodes of a
//      binary counter over the groups, one a level (merging a group's node
//      into the level-k node where bit k of its index is set), and folds
//      the remaining nodes from the highest r down: the same adds, mins and
//      maxes in the same order, so the same bits.  From those and the count
//      (an exact integer from the valid bits, as the float ladder's count
//      is), bucket_totals into shared memory; then every lane of the
//      round's buckets, a thread a lane, stores its bucket's outputs and
//      its own zscore (coalesced);
//   4. the region's last bucket, ids and every column's x and valid, into
//      the carry.
// Only the seven outputs reach global memory.
__global__ void __launch_bounds__(kRingThreads, 2)
bucket_stats_ring_kernel(const int32_t* __restrict__ bid, const float* __restrict__ x,
                         const uint8_t* __restrict__ valid, const float* __restrict__ centre,
                         float* __restrict__ out, int32_t* __restrict__ long_rows,
                         int32_t* __restrict__ n_long, int C, int K, int L, int T, int depth) {
    extern __shared__ __align__(16) unsigned char sm[];
    const BucketRingLayout lay = bucket_ring_layout(C, T, depth);
    const ring::Ring r{(uint64_t*)sm, depth};
    int* shi = (int*)(sm + 8 * ring::kMaxDepth);   // [0] D, [1] last head, [2] long, [3] tails
    const int G_ = lay.G;
    uint32_t* hmask = (uint32_t*)(sm + lay.segs);  // head bits of segment g
    uint32_t* tmask = hmask + G_;                  // tail bits
    int* dseg = (int*)(tmask + G_);                // largest d with its head inside g
    int* hbefore = dseg + G_;                      // last head before g (-1: none)
    int* tbefore = hbefore + G_;                   // tails before g
    uint32_t* vmask = (uint32_t*)(tbefore + G_);   // column c's valid bits at [c G_, ...)
    int* cbefore = (int*)(vmask + (size_t)C * G_); // column c's valid lanes before g
    unsigned char** xt = (unsigned char**)(sm + lay.ptrs);   // [2 c]: carry, [2 c + 1]: slot
    unsigned char** vt = xt + 2 * (size_t)C;
    float* tot = (float*)(sm + lay.tot);           // total s of round pair i at [s kPairs + i]
    int32_t* cid = (int32_t*)(sm + lay.carry);
    auto cx = [&](int c) {
        return (float*)(sm + lay.carry + ring::align16(4 * (size_t)kSpan) + c * lay.carry_col);
    };
    auto cv = [&](int c) {
        return (unsigned char*)(cx(c)) + ring::align16(4 * (size_t)kSpan);
    };
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int k = blockIdx.x;
    const int32_t* b = bid + (size_t)k * L;
    const size_t n_all = (size_t)C * K * L;
    const size_t stat_plane = n_all;
    const int nw = (int)(((long long)L + T - 1) / T);
    const float INF = pos_inf();
    if (threadIdx.x == 0) shi[2] = 0;
    ring::init(r);

    auto plane = [&](int slot, int p) -> unsigned char* {   // p = 0 ids, 1 + 2c x, 2 + 2c valid
        unsigned char* base = sm + lay.slots + (size_t)slot * lay.slot;
        if (p == 0) return base;
        const int c = (p - 1) >> 1;
        return base + lay.id_plane + (size_t)c * (lay.x_plane + lay.v_plane) +
               ((p - 1) & 1 ? lay.x_plane : 0);
    };
    auto load = [&](int w, int slot, uint64_t* bar) {
        if (shi[2]) return;                        // a long row: nothing more to read
        const int s0 = w * T;
        const size_t n = (size_t)min(T, L - s0);
        ring::stage(plane(slot, 0), b + s0, 4 * n, bid + (size_t)K * L, bar);
        for (int c = 0; c < C; ++c) {
            const size_t at = ((size_t)c * K + k) * L + s0;
            ring::stage(plane(slot, 1 + 2 * c), x + at, 4 * n, x + n_all, bar);
            ring::stage(plane(slot, 2 + 2 * c), valid + at, n, valid + n_all, bar);
        }
    };
    int nc = 0;                                    // carry lanes (the same in every thread)
    auto consume = [&](int w, int slot) {
        if (shi[2]) return;
        const int s0 = w * T;
        const int m = min(T, L - s0), n = nc + m, G = (n + 31) >> 5;
        const bool last = w == nw - 1;
        const int32_t* is = (const int32_t*)(plane(slot, 0) + ((uintptr_t)(b + s0) & 15));
        // column c's x and valid in the carry (xt[2 c], vt[2 c]) and in the
        // slot (xt[2 c + 1], vt[2 c + 1]), set a window
        for (int c = threadIdx.x; c < C; c += kRingThreads) {
            const size_t at = ((size_t)c * K + k) * L + s0;
            xt[2 * c] = (unsigned char*)cx(c);
            xt[2 * c + 1] = plane(slot, 1 + 2 * c) + ((uintptr_t)(x + at) & 15);
            vt[2 * c] = cv(c);
            vt[2 * c + 1] = plane(slot, 2 + 2 * c) + ((uintptr_t)(valid + at) & 15);
        }
        __syncthreads();
        // region lane j: the carry, then the slot
        auto rid = [&](int j) { return j < nc ? cid[j] : is[j - nc]; };
        auto rx = [&](int c, int j) {
            const bool s = j >= nc;
            return ((const float*)xt[2 * c + s])[s ? j - nc : j];
        };
        auto rok = [&](int c, int j) {
            const bool s = j >= nc;
            return vt[2 * c + s][s ? j - nc : j] != 0;
        };

        // 1. head and valid bits, the largest d with its head in the segment
        for (int g = warp; g < G; g += kRingWarps) {
            const int j = 32 * g + lane;
            const bool in = j < n;
            const bool head = in && (j == 0 || rid(j) != rid(j - 1));
            const uint32_t hm = __ballot_sync(TEMPO_FULL_MASK, head);
            const uint32_t le = hm & mask_le(lane);
            const int d = in && le ? lane - (31 - __clz(le)) : 0;
            const int dm = __reduce_max_sync(TEMPO_FULL_MASK, d);
            for (int c = 0; c < C; ++c) {
                const uint32_t vm = __ballot_sync(TEMPO_FULL_MASK, in && rok(c, j));
                if (lane == 0) vmask[(size_t)c * G_ + g] = vm;
            }
            if (lane == 0) {
                hmask[g] = hm;
                dseg[g] = dm;
            }
        }
        __syncthreads();

        // 2. the segment scans, kRingEnt segments a lane, a shuffle scan
        // over the lanes: warp 0 the last head before each segment and D,
        // warp 1 the tails in and before each, warps 2 .. the valid lanes
        // before each segment of a column each
        if (warp == 0) {
            int lh[kRingEnt];
            int lmax = -1;
#pragma unroll
            for (int u = 0; u < kRingEnt; ++u) {
                const int g = kRingEnt * lane + u;
                const uint32_t hm = g < G ? hmask[g] : 0u;
                lh[u] = hm ? 32 * g + 31 - __clz(hm) : -1;
                lmax = max(lmax, lh[u]);
            }
            int e = lmax;
            for (int o = 1; o < 32; o <<= 1) {
                const int a = __shfl_up_sync(TEMPO_FULL_MASK, e, o);
                if (lane >= o) e = max(e, a);
            }
            const int all = __shfl_sync(TEMPO_FULL_MASK, e, 31);
            e = __shfl_up_sync(TEMPO_FULL_MASK, e, 1);
            if (lane == 0) e = -1;
            int D = 0;
#pragma unroll
            for (int u = 0; u < kRingEnt; ++u) {
                const int g = kRingEnt * lane + u;
                if (g < G) {
                    const uint32_t hm = hmask[g];
                    const int end = min(32 * g + 31, n - 1);
                    hbefore[g] = e;
                    // d at the segment's last lane, and before its first
                    // head; other d inside the segment are dseg's
                    D = max(D, end - (hm ? lh[u] : e));
                    if (hm && !(hm & 1u)) D = max(D, 32 * g + __ffs(hm) - 2 - e);
                    D = max(D, dseg[g]);
                }
                e = max(e, lh[u]);
            }
            D = __reduce_max_sync(TEMPO_FULL_MASK, D);
            if (lane == 0) {
                shi[0] = D;
                shi[1] = all;
            }
        } else {
            // tails (c = -1, warp 1) or column c's valid lanes, summed;
            // warps 1 .. kRingWarps - 1 take c = warp - 2, then the next
            for (int c = warp - 2; c < C; c += kRingWarps - 1) {
                uint32_t bits[kRingEnt];
                int sum = 0;
#pragma unroll
                for (int u = 0; u < kRingEnt; ++u) {
                    const int g = kRingEnt * lane + u;
                    bits[u] = 0u;
                    if (g < G && c >= 0) bits[u] = vmask[(size_t)c * G_ + g];
                    if (g < G && c < 0) {
                        bits[u] = (hmask[g] >> 1) | (g + 1 < G ? hmask[g + 1] << 31 : 0u);
                        if (last && g == G - 1) bits[u] |= 1u << ((n - 1) & 31);
                        tmask[g] = bits[u];
                    }
                    sum += __popc(bits[u]);
                }
                int e = sum;
                for (int o = 1; o < 32; o <<= 1) {
                    const int a = __shfl_up_sync(TEMPO_FULL_MASK, e, o);
                    if (lane >= o) e += a;
                }
                if (c < 0 && lane == 31) shi[3] = e;
                e -= sum;
                int* before = c < 0 ? tbefore : cbefore + (size_t)c * G_;
#pragma unroll
                for (int u = 0; u < kRingEnt; ++u) {
                    const int g = kRingEnt * lane + u;
                    if (g < G) before[g] = e;
                    e += __popc(bits[u]);
                }
            }
        }
        __syncthreads();
        const int D = shi[0], h_last = shi[1], n_tails = shi[3];
        if (D >= kSpan) {                          // a bucket past the halo
            if (threadIdx.x == 0) {
                long_rows[atomicAdd(n_long, 1)] = k;
                shi[2] = 1;
            }
            return;
        }
        const long long o = (long long)s0 - nc;      // row lane of region lane 0
        auto head_of = [&](int j) {
            const int g = j >> 5;
            const uint32_t le = hmask[g] & mask_le(j & 31);
            return le ? 32 * g + 31 - __clz(le) : hbefore[g];
        };
        auto prefix = [&](int c, int t) {             // column c's valid lanes in [0, t]
            const size_t g = (size_t)c * G_ + (t >> 5);
            return t < 0 ? 0 : cbefore[g] + __popc(vmask[g] & mask_le(t & 31));
        };

        // the position of tail qt (from 0) in the region
        auto tail_at = [&](int qt) {
            int lo = 0, hi = G;                       // the last g with tbefore[g] <= qt
            while (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                if (tbefore[mid] <= qt) lo = mid; else hi = mid;
            }
            return 32 * lo + nth_bit(tmask[lo], qt - tbefore[lo]);
        };

        // 3. in rounds of kPairs (tail, column) pairs, column-major: a
        // thread a pair forms its bucket's totals into tot, then every lane
        // of the round's buckets stores its outputs
        const int work = n_tails * C;
        for (int p0 = 0; p0 < work; p0 += kPairs) {
            const int p1 = min(work, p0 + kPairs);
            for (int q = p0 + threadIdx.x; q < p1; q += kRingThreads) {
                const int c = q / n_tails;
                const int t = tail_at(q - c * n_tails);
                const int nb = t - head_of(t) + 1;
                const float center = centre[(size_t)c * K + k];
                // groups of kGroup leaves, r in [kGroup a, kGroup a + kGroup):
                // each group's node by a static pairwise tree (its loads all
                // in flight together), then a binary counter over the groups
                // (lv[kk]: the complete node of 2^kk groups)
                float lv[kSpanLog2 - kGroupLog2 + 1][4];
                const int groups = (nb + kGroup - 1) >> kGroupLog2;
                for (int a = 0; a < groups; ++a) {
                    const int r0 = a << kGroupLog2;
                    float lf[kGroup][4];
#pragma unroll
                    for (int u = 0; u < kGroup; ++u) {
                        const bool in = r0 + u < nb;
                        const bool ok = in && rok(c, t - r0 - u);
                        const float xv = in ? rx(c, t - r0 - u) : 0.f;
                        const float xc = ok ? __fsub_rn(xv, center) : 0.f;
                        lf[u][0] = xc;
                        lf[u][1] = __fmul_rn(xc, xc);
                        lf[u][2] = ok ? xv : INF;
                        lf[u][3] = ok ? xv : -INF;
                    }
                    // the node of [r0 + lo, r0 + lo + 2h) from its halves, the
                    // lower r (later lanes) first, where the upper half exists
#pragma unroll
                    for (int h = 1; h < kGroup; h <<= 1) {
#pragma unroll
                        for (int lo = 0; lo < kGroup; lo += 2 * h) {
                            if (r0 + lo + h < nb) node_combine(lf[lo], lf[lo + h]);
                        }
                    }
                    for (int kk = 0;; ++kk) {
                        if (!((a >> kk) & 1)) {
#pragma unroll
                            for (int p = 0; p < 4; ++p) lv[kk][p] = lf[0][p];
                            break;
                        }
                        float own[4];
#pragma unroll
                        for (int p = 0; p < 4; ++p) own[p] = lv[kk][p];
                        node_combine(own, lf[0]);
#pragma unroll
                        for (int p = 0; p < 4; ++p) lf[0][p] = own[p];
                    }
                }
                // the complete nodes left, from the highest r down
                float acc[4];
                bool started = false;
                for (int kk = 0; kk <= kSpanLog2 - kGroupLog2; ++kk) {
                    if ((groups >> kk) & 1) {
                        if (started) {
                            float own[4];
#pragma unroll
                            for (int p = 0; p < 4; ++p) own[p] = lv[kk][p];
                            node_combine(own, acc);
#pragma unroll
                            for (int p = 0; p < 4; ++p) acc[p] = own[p];
                        } else {
#pragma unroll
                            for (int p = 0; p < 4; ++p) acc[p] = lv[kk][p];
                            started = true;
                        }
                    }
                }
                const BucketTotals bt = bucket_totals((float)(prefix(c, t) - prefix(c, t - nb)),
                                                      acc[0], acc[1], acc[2], acc[3], center);
                float* tq = tot + (q - p0);
                tq[0] = bt.mean;
                tq[kPairs] = bt.cnt;
                tq[2 * kPairs] = bt.mn;
                tq[3 * kPairs] = bt.mx;
                tq[4 * kPairs] = bt.sum;
                tq[5 * kPairs] = bt.std;
            }
            __syncthreads();
            // the lanes of each column's buckets in the round
            for (int c = p0 / n_tails; c * n_tails < p1; ++c) {
                const int ta = max(p0, c * n_tails) - c * n_tails;
                const int tb = min(p1, (c + 1) * n_tails) - c * n_tails;
                const int lo = ta == 0 ? 0 : tail_at(ta - 1) + 1, hi = tail_at(tb - 1);
                const size_t crow = ((size_t)c * K + k) * L;
                const float* tc = tot + (c * n_tails - p0);
                for (int j = lo + threadIdx.x; j <= hi; j += kRingThreads) {
                    const int g = j >> 5;
                    const int tq = tbefore[g] + __popc(tmask[g] & (mask_le(j & 31) >> 1));
                    const BucketTotals bt{tc[tq], tc[kPairs + tq], tc[2 * kPairs + tq],
                                          tc[3 * kPairs + tq], tc[4 * kPairs + tq],
                                          tc[5 * kPairs + tq]};
                    bucket_store(bt, rx(c, j), rok(c, j), out, crow + (size_t)(o + j),
                                 stat_plane);
                }
            }
            __syncthreads();                       // the next round reuses tot
        }

        // 4. the region's last bucket (at most kSpan lanes) into the carry
        if (!last) {
            constexpr int kQ = kSpan / kRingThreads;
            int32_t ci[kQ];
#pragma unroll
            for (int qq = 0; qq < kQ; ++qq) {
                const int j = h_last + threadIdx.x + qq * kRingThreads;
                if (j < n) ci[qq] = rid(j);
            }
            float cxv[kQ];
            uint8_t cvv[kQ];
            for (int c = 0; c < C; ++c) {
#pragma unroll
                for (int qq = 0; qq < kQ; ++qq) {
                    const int j = h_last + threadIdx.x + qq * kRingThreads;
                    if (j < n) {
                        cxv[qq] = rx(c, j);
                        cvv[qq] = rok(c, j) ? 1 : 0;
                    }
                }
                __syncthreads();                   // every read of the old carry is done
#pragma unroll
                for (int qq = 0; qq < kQ; ++qq) {
                    const int j = threadIdx.x + qq * kRingThreads;
                    if (h_last + j < n) {
                        if (c == 0) cid[j] = ci[qq];
                        cx(c)[j] = cxv[qq];
                        cv(c)[j] = cvv[qq];
                    }
                }
            }
            nc = n - h_last;
        }
    };
    ring::run(r, nw, load, consume);
}

}  // namespace

// longest row the kernel takes: int32 lane indices (the class stages take
// any length)
extern "C" long long tempo_bucket_max_lanes() { return INT_MAX; }

// The row form: `planes` is the [6, C, K, L] hand-off, `centre` [C, K],
// `live` [C, K] zeros, `first_tail` [K, ceil(L / 3072)].
extern "C" int tempo_bucket_stats(const void* bid, const void* x, const void* valid,
                                  void* out, void* planes, void* centre, void* live,
                                  void* first_tail, int C, int K, int L, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int CK = C * K;
    const int tiles = (int)(((long long)L + kTileOut - 1) / kTileOut);
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

// Shared memory of the staged form at (C, T, depth), for the planner's
// check on the card.
extern "C" long long tempo_bucket_ring_smem(int C, int T, int depth) {
    return (long long)bucket_ring_layout(C, T, depth).total;
}

// The staged form: bucket_centres into `centre` ([C, K]), then the ring
// kernel, a block a row; rows with a bucket longer than kSpan lanes go to
// long_rows ([K]; their count in n_long, zeroed) for the row form.
extern "C" int tempo_bucket_stats_ring(const void* bid, const void* x, const void* valid,
                                       void* out, void* centre, void* long_rows, void* n_long,
                                       int C, int K, int L, int T, int depth, void* stream) {
    const size_t smem = bucket_ring_layout(C, T, depth).total;
    if (depth < 2 || depth > ring::kMaxDepth || T < 32 || T % 32 != 0 ||
        kSpan + T > 32 * 32 * kRingEnt || smem > (size_t)kEmaSmemLimit)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    bucket_centres<<<C * K, kEmaThreads, 0, st>>>((const float*)x, (const uint8_t*)valid,
                                                  (float*)centre, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(bucket_stats_ring_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    bucket_stats_ring_kernel<<<K, kRingThreads, smem, st>>>(
        (const int32_t*)bid, (const float*)x, (const uint8_t*)valid, (const float*)centre,
        (float*)out, (int32_t*)long_rows, (int32_t*)n_long, C, K, L, T, depth);
    return (int)cudaGetLastError();
}
