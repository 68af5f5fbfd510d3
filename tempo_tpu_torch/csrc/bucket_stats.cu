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
// (28 B): 4 + 33C bytes a lane.  The two ladders make 2 * ceil(log2 L)
// passes of about a dozen flops a lane; past the shared-memory limit each
// pass of the row form also reads and writes the scratch, which then bounds
// its time.  The staged form keeps the ladder in shared memory at any
// width (at most 2 * log2 T passes a window, a lane in at most two
// windows) and reads the inputs twice (the centre pre-pass, the ring).
//
// Two forms, picked on the host by ops/stream.bucket_plan:
//
// * the row form (bucket_stats_kernel): one block per series row walks the
//   C columns.  The five planes and the flag ping-pong between two sets (12
//   float planes, 48 bytes a lane): in dynamic shared memory up to 4,837
//   lanes, and past that in the block's slice of a global scratch of
//   [K, 12, L] floats (common.cuh's ladder switch; cuda_lib.ladder_scratch
//   makes the same decision).
// * the tile-local staged form (bucket_stats_ring_kernel): one block per
//   row first reduces each column's centre in the row form's order (1024
//   threads, lane-strided, block_sum), then cuts the row into windows of at
//   most T lanes, each starting at a bucket head: window j + 1 starts at
//   the head of the bucket that holds lane s_j + T.  The windows stream
//   through ring.cuh's staging ring (ids, then x and valid of each column),
//   and each runs the same two ladders over its own lanes in shared memory,
//   each stopping once every lane is complete, and writes the outputs of
//   the buckets that end inside it (lanes [s_j, s_j+1)).  A segmented
//   ladder combines a bucket's lanes in a tree that depends only on the
//   lanes' offsets from the bucket's head (the head flag freezes every
//   lane before it reads across the head), so each such bucket gets the
//   row form's bits.  A row holding a bucket
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

// A ladder pass's closing barrier; with kAll also whether `pred` holds on
// every thread of the block.
template <bool kAll>
__device__ __forceinline__ bool sync_all(int pred) {
    if (kAll) return __syncthreads_and(pred) != 0;
    __syncthreads();
    return false;
}

// The two ladders and the outputs over lanes [0, n) of one row (or window)
// of a column: `base` holds the 12 planes, `stride` floats apart; b, xr, vr
// are the lanes' ids, values and validity; outputs of lanes [0, m) go to
// out[o + i] (+ s * stat_plane for stat s).  Ends with a __syncthreads().
// With kStopEarly a ladder stops after the first pass that leaves every
// lane's flag set: from then on every lane has its bucket's head (its
// tail) inside its span and each later pass would copy it unchanged, so
// the bits are those of the full log2(n) passes.
template <bool kStopEarly>
__device__ __forceinline__ void bucket_ladder(float* base, size_t stride, const int32_t* b,
                                              const float* xr, const uint8_t* vr,
                                              float center, int n, int m, float* out,
                                              size_t o, size_t stat_plane) {
    const float INF = __int_as_float(0x7f800000);
    const float NaN = tempo_nan();
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
        const bool done = sync_all<kStopEarly>(flagged);
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
        const bool done = sync_all<kStopEarly>(flagged);
        for (int p = 0; p < kPlanes; ++p) {
            float* t = a[p]; a[p] = nx[p]; nx[p] = t;
        }
        if (done) break;
    }

    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const float cnt = a[0][i], s1 = a[1][i], s2 = a[2][i];
        const float cnt1 = fmaxf(cnt, 1.f);
        const float mean = cnt > 0.f ? __fadd_rn(__fdiv_rn(s1, cnt1), center) : NaN;
        const float total = __fadd_rn(s1, __fmul_rn(cnt, center));
        const float var =
            cnt > 1.f ? __fdiv_rn(__fsub_rn(s2, __fdiv_rn(__fmul_rn(s1, s1), cnt1)),
                                  fmaxf(__fsub_rn(cnt, 1.f), 1.f))
                      : NaN;
        const float std = cnt > 1.f ? __fsqrt_rn(max_nan(var, 0.f)) : NaN;
        const size_t at = o + i;
        out[at] = mean;
        out[stat_plane + at] = cnt;
        out[2 * stat_plane + at] = cnt > 0.f ? a[3][i] : NaN;
        out[3 * stat_plane + at] = cnt > 0.f ? a[4][i] : NaN;
        out[4 * stat_plane + at] = cnt > 0.f ? total : NaN;
        out[5 * stat_plane + at] = std;
        out[6 * stat_plane + at] = vr[i] ? __fdiv_rn(__fsub_rn(xr[i], mean), std) : NaN;
    }
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

__global__ void __launch_bounds__(kEmaThreads)
bucket_stats_kernel(const int32_t* __restrict__ bid, const float* __restrict__ x,
                    const uint8_t* __restrict__ valid, float* __restrict__ out,
                    float* __restrict__ scratch, int C, int K, int L) {
    extern __shared__ float smem[];
    __shared__ float shf[32];
    const int k = blockIdx.x;
    const int32_t* b = bid + (size_t)k * L;
    const size_t stat_plane = (size_t)C * K * L;   // stride between outputs
    float* base = ladder_row(smem, scratch, L, kSetPlanes);

    for (int c = 0; c < C; ++c) {
        const size_t crow = ((size_t)c * K + k) * L;
        const float* xr = x + crow;
        const uint8_t* vr = valid + crow;
        const float center = row_center(xr, vr, L, shf);
        bucket_ladder<false>(base, L, b, xr, vr, center, L, L, out, crow, stat_plane);
    }
}

// Shared memory of the staged form, in bytes from the start of the
// block's dynamic shared memory (ops/stream.bucket_ring_bytes mirrors the
// total): the ring's barriers, a reduction scratch, the C centres, the
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

// Largest int over the block (blockDim.x a multiple of 32).
__device__ __forceinline__ int block_max(int v, int* sh /* >= 32 */) {
    v = __reduce_max_sync(TEMPO_FULL_MASK, v);
    __syncthreads();                       // sh may still be read by a previous call
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
        int t = threadIdx.x < (blockDim.x >> 5) ? sh[threadIdx.x] : INT_MIN;
        t = __reduce_max_sync(TEMPO_FULL_MASK, t);
        if (threadIdx.x == 0) sh[0] = t;
    }
    __syncthreads();
    return sh[0];
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
        best = block_max(best, shi);
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
            bucket_ladder<true>(ladder, ring::align16(T), bs, xs, vs, centre[c], n, m, out,
                                at, stat_plane);
        }
    };
    ring::run(r, nw, load, consume);
}

}  // namespace

extern "C" int tempo_bucket_stats(const void* bid, const void* x, const void* valid,
                                  void* out, void* scratch, int C, int K, int L,
                                  void* stream) {
    size_t smem;
    cudaError_t err = ladder_smem(bucket_stats_kernel, scratch, L, kSetPlanes, &smem);
    if (err != cudaSuccess) return (int)err;
    bucket_stats_kernel<<<K, kEmaThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)bid, (const float*)x, (const uint8_t*)valid, (float*)out,
        (float*)scratch, C, K, L);
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
