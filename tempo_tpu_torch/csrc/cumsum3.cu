// Inclusive prefix sums of masked x, masked x^2 and the valid count on
// packed [K, L] series: the prefix half of the windowed range engine.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_kernels.py:_cumsum3_kernel
// (through _cumsum3_call and cumsum3):
//
//   xz = valid ? x : 0;  s1 = xz;  s2 = xz * xz;  c = valid ? 1 : 0
//   for span = 1, 2, 4, ... < L:  s += shift(s, span)   (0 shifted in)
//
// The Hillis-Steele association is kept (xz * xz formed first, then the
// shift-adds), so the float32 sums round like the TPU kernel's: a
// sequential or decoupled-lookback scan would associate, and round,
// differently.  Every add is __fadd_rn(own, partner) and the square
// __fmul_rn (the build also passes -fmad=false), and 0 is added where
// the shift runs off the row, as the TPU kernel adds its identity.
//
// Bound on H100: bytes, one read of x and valid and one write of the
// three sums (17 bytes a lane).  The ladder's log2(L) levels are 3 adds
// a lane each, far below the card's float rate; what a whole-row ladder
// in one block costs is its passes: 17 barrier-separated passes over 24
// bytes a lane through L2/HBM once a row outgrows shared memory.
//
// The design is tiled, by this lemma.  After the levels of spans < T =
// 2^t, lane i holds the sum of lanes [i - T + 1, i] in a fixed tree, so
// (a) those levels at the lanes of a tile [s0, s0 + n) need only the
// inputs [s0 - T + 1, s0 + n): tile-local, with a halo of T - 1 lanes
// that are 0 before the row's start; and (b) the levels of spans
// T * 2^j are a ladder along each residue class i mod T (the sequence
// z[r], z[r + T], z[r + 2T], ...) with span 2^j, 0 added where m < 2^j.
// Running exactly the ladder's levels (spans < L) keeps every bit,
// signed zeros included (one extra level would add +0.0 and turn a -0.0
// into +0.0).  So two launches on the caller's stream, the second
// ordered after the first by the stream (a grid-wide dependency inside
// one launch would need a cooperative launch or spinning blocks):
//
//   stage 1, one block of 512 threads per tile: a row of more than 1024
//     lanes takes T = 1024 and tiles of 3072 outputs after the 1024-lane
//     halo (4096 lanes, 48 KB of shared memory for the three planes); a
//     shorter row is one tile of T = its power of two, no halo, finished
//     here, and 128 / (T / 32) such rows share a block.  Row phase, spans
//     1 .. 16: each warp loads, then runs, 8 consecutive 32-lane segments
//     through shuffles, a lane below the span taking its partner from the
//     segment before, whose shuffled values it kept (so no level runs
//     twice, but for one predecessor segment a warp).  Column phase,
//     spans 32 .. 512: lane l of every segment forms a column of 128
//     values; 16 threads hold a column, thread c the segments c + 16 i in
//     registers, so a span of m < 16 segments is one shuffle within the
//     16 threads and m = 16 an add inside the thread.  Shared memory
//     (lane index swizzled by segment: no bank conflicts either way) only
//     carries the values between the phases and out to coalesced stores.
//   stage 2, only for rows longer than 1024: common.cuh's class_ladder
//     over the three planes (a block per (row, slab of residue classes),
//     the levels of spans T, 2T, ... < L in shared memory two at a time
//     where two remain, 24 bytes an entry, written back in place); a row
//     longer than 9,685 * 1024 = 9,917,440 lanes, whose class outgrows
//     shared memory, takes it windowed and a third stage along the classes
//     mod 2^18 (every int32 row length).
//
// Traffic at phase F's [128, 102056]: x and valid read about 1.33 times
// (the halo), the sums written, read and written again: about 43 bytes
// a lane, against the function's 17.
#include "common.cuh"

namespace {

constexpr int kSegs = 128;                    // 32-lane segments a stage-1 block holds
constexpr int kThreads1 = 512;
constexpr int kRun = kSegs / (kThreads1 / 32);   // segments a warp takes in a full tile
constexpr int kChunks = 16;                   // threads a segment column in the column phase
constexpr int kEnt = kSegs / kChunks;         // segments a thread holds there

// shared-memory slot of lane l of segment g: rows of 32 floats, the lane
// index swizzled so that both a row (a warp over l) and the column
// phase's accesses (two columns, segments c + 16 i) hit 32 banks
__device__ __forceinline__ int slot(int g, int l) { return g * 32 + (l ^ ((g & 15) << 1)); }

// x and the validity of row lane i, loaded unconditionally (clamped into
// the row), so that a thread's loads issue together
struct LaneIn {
    float x;
    bool ok;
};

__device__ __forceinline__ LaneIn lane_load(const float* x, const uint8_t* valid, size_t row,
                                            long long i, int L) {
    const size_t at = row + (size_t)min(max(i, 0LL), (long long)L - 1);
    const uint8_t vb = valid[at];
    const float xr = x[at];
    return {xr, vb != 0 && i >= 0 && i < L};
}

// xz, xz^2 and the count of a loaded lane (0 where it is not valid)
__device__ __forceinline__ void lane_planes(LaneIn in, float v[3]) {
    const float xz = in.ok ? in.x : 0.f;
    v[0] = xz;
    v[1] = __fmul_rn(xz, xz);
    v[2] = in.ok ? 1.f : 0.f;
}

// Stage 1.  A block holds kSegs 32-lane segments of the three planes in
// row slots of S segments: a row of more than 1024 lanes takes one slot
// (S = kSegs) per tile of 3072 outputs after its T = 1024-lane halo; a
// shorter row is one tile (T its power of two, no halo) in a slot of
// S = T / 32 segments, kSegs / S rows a block.  A level's partner in an
// earlier slot counts as 0, as the ladder's shift runs off the row.
__global__ void __launch_bounds__(kThreads1, 2)
cumsum3_tiles(const float* __restrict__ x, const uint8_t* __restrict__ valid,
              float* __restrict__ s1, float* __restrict__ s2, float* __restrict__ cnt, int K,
              int L, int t, int tiles, int S) {
    __shared__ float buf[3][kSegs * 32];
    const int T = 1 << t;
    const int H = tiles > 1 ? T >> 5 : 0;                 // halo segments
    const int nseg = tiles > 1 ? kSegs : (L + 31) >> 5;   // segments of a slot in the row
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    // the row of slot r, and the row lane of this block's buffer lane 0
    auto slot_row = [&](int r) -> long long {
        return tiles > 1 ? blockIdx.x / tiles : (long long)blockIdx.x * (kSegs / S) + r;
    };
    const long long origin = tiles > 1
        ? (long long)(blockIdx.x % tiles) * (kSegs - H) * 32 - 32LL * H : 0;
    // inputs of segment g, this lane: 0 outside the rows
    auto load = [&](int g) -> LaneIn {
        const long long k = slot_row(g / S);
        const long long i = origin + 32LL * (g % S) + lane;
        LaneIn in = lane_load(x, valid, (size_t)min(k, (long long)K - 1) * L, i, L);
        in.ok = in.ok && k < K;
        return in;
    };
    const int g0 = w * kRun;
    LaneIn in[kRun + 1];
#pragma unroll
    for (int q = 0; q <= kRun; ++q) in[q] = load(g0 - 1 + q);

    // row phase, spans 1 .. 16 (< T): a warp runs its kRun segments in
    // order; a lane below the span takes its partner from the segment
    // before, whose shuffled values it kept (the run's predecessor is
    // laddered from zeros before it: complete where it is read; a slot's
    // first segment takes 0).  The warp's inputs are all loaded first.
    {
        float carry[5][3], v[3];
        lane_planes(in[0], v);
#pragma unroll
        for (int ls = 0; ls < 5; ++ls) {
            const int s = 1 << ls;
            if (s >= T) break;
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                const float cur = __shfl_sync(TEMPO_FULL_MASK, v[p], (lane - s) & 31);
                carry[ls][p] = cur;
                v[p] = __fadd_rn(v[p], lane >= s ? cur : 0.f);
            }
        }
#pragma unroll
        for (int q = 1; q <= kRun; ++q) {
            const int g = g0 - 1 + q;
            const bool head = (g & (S - 1)) == 0;
            lane_planes(in[q], v);
#pragma unroll
            for (int ls = 0; ls < 5; ++ls) {
                const int s = 1 << ls;
                if (s >= T) break;
#pragma unroll
                for (int p = 0; p < 3; ++p) {
                    const float cur = __shfl_sync(TEMPO_FULL_MASK, v[p], (lane - s) & 31);
                    v[p] = __fadd_rn(v[p], lane >= s ? cur : head ? 0.f : carry[ls][p]);
                    carry[ls][p] = cur;
                }
            }
#pragma unroll
            for (int p = 0; p < 3; ++p) buf[p][slot(g, lane)] = v[p];
        }
    }
    __syncthreads();

    // column phase, spans 32 .. T/2 = m segments, m = 1 .. 16: lane l of
    // every segment is one column; 16 threads hold a column, thread c the
    // segments c + 16 i, so a span of m < 16 comes from thread c - m (or
    // its entry i - 1) and m = 16 is entry i - 1 of the same thread
    if (T > 32) {
        const int col = 2 * w + (lane >> 4), c = lane & 15;
        float u[kEnt][3];
#pragma unroll
        for (int i = 0; i < kEnt; ++i)
#pragma unroll
            for (int p = 0; p < 3; ++p) u[i][p] = buf[p][slot(c + 16 * i, col)];
#pragma unroll
        for (int lm = 0; lm < 4; ++lm) {
            const int m = 1 << lm;
            if ((32 << lm) >= T) break;
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                float prev = 0.f;
#pragma unroll
                for (int i = 0; i < kEnt; ++i) {
                    const float cur = __shfl_sync(TEMPO_FULL_MASK, u[i][p], (c - m) & 15, kChunks);
                    const bool in_slot = ((c + 16 * i) & (S - 1)) >= m;
                    u[i][p] = __fadd_rn(u[i][p], !in_slot ? 0.f : c >= m ? cur : prev);
                    prev = cur;
                }
            }
        }
        if ((32 << 4) < T) {
#pragma unroll
            for (int i = kEnt - 1; i >= 0; --i) {
                const bool in_slot = ((c + 16 * i) & (S - 1)) >= 16;
#pragma unroll
                for (int p = 0; p < 3; ++p)
                    u[i][p] = __fadd_rn(u[i][p], in_slot ? u[i - (i > 0)][p] : 0.f);
            }
        }
#pragma unroll
        for (int i = 0; i < kEnt; ++i)
#pragma unroll
            for (int p = 0; p < 3; ++p) buf[p][slot(c + 16 * i, col)] = u[i][p];
        __syncthreads();
    }

    for (int e = threadIdx.x; e < kSegs * 32; e += kThreads1) {
        const int g = e >> 5, l = e & 31, j = g % S;
        const long long k = slot_row(g / S);
        const long long i = origin + 32LL * j + l;
        if (j >= H && j < nseg && k < K && i < L) {
            const size_t at = (size_t)k * L + (size_t)i;
            s1[at] = buf[0][slot(g, l)];
            s2[at] = buf[1][slot(g, l)];
            cnt[at] = buf[2][slot(g, l)];
        }
    }
}

// Stage 2's combine (common.cuh's class_ladder): the three sums, 0 the
// identity.
struct SumPlanes {
    static constexpr int kPlanes = 3;
    static constexpr int kFirstOut = 0;
    __device__ static float ident(int) { return 0.f; }
    __device__ static void combine(float a[3], const float b[3]) {
#pragma unroll
        for (int p = 0; p < 3; ++p) a[p] = __fadd_rn(a[p], b[p]);
    }
};

}  // namespace

// longest row the kernel takes: int32 lane indices (the class stages take
// any length)
extern "C" long long tempo_cumsum3_max_lanes() { return INT_MAX; }

extern "C" int tempo_cumsum3(const void* x, const void* valid, void* s1, void* s2, void* cnt,
                             int K, int L, void* stream) {
    int levels = 0;
    while ((1LL << levels) < L) ++levels;        // spans 1 .. 2^(levels-1) < L
    const int t = min(levels, kClassTileLog2);
    // a row past 1024 lanes takes tiles of 3072 outputs, one a block;
    // shorter rows share a block, kSegs / S of them
    const int tiles = L > (1 << t)
        ? (int)(((long long)L + (kSegs * 32 - (1 << t)) - 1) / (kSegs * 32 - (1 << t))) : 1;
    const int S = L > 1024 ? kSegs : max(1, (1 << t) >> 5);
    const size_t blocks = L > 1024 ? (size_t)K * tiles : ((size_t)K + kSegs / S - 1) / (kSegs / S);
    cumsum3_tiles<<<(unsigned)blocks, kThreads1, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const uint8_t*)valid, (float*)s1, (float*)s2, (float*)cnt, K, L, t,
        tiles, S);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || levels <= kClassTileLog2) return (int)err;
    return (int)launch_class_ladder<SumPlanes>({{(float*)s1, (float*)s2, (float*)cnt}}, K, L,
                                               (cudaStream_t)stream);
}
