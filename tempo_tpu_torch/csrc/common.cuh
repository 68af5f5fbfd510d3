// Shared device helpers of the tempo_tpu_torch kernels.
//
// Every kernel launches on the caller's stream and allocates nothing:
// the Python wrappers allocate outputs and the planes one launch hands
// the next.  Each C entry point returns cudaGetLastError() right after
// its launch.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TEMPO_FULL_MASK 0xffffffffu

// the canonical quiet NaN (the bit pattern of numpy/jax/torch nan)
__device__ __forceinline__ float tempo_nan() { return __int_as_float(0x7fc00000); }

// jnp.minimum / torch.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? tempo_nan() : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? tempo_nan() : fmaxf(a, b);
}

// int32 add/sub with two's-complement wrap (the TPU kernels' i32 lane
// arithmetic), written through unsigned so the compiler may not assume
// no overflow
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// first m in [lo, hi) with pred(m) false (pred true on a prefix): the
// merge-path co-rank search of asof_merge.cu and merge_rank.cu
template <typename Pred>
__device__ __forceinline__ int first_false(int lo, int hi, Pred pred) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pred(mid)) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Block-wide sum; blockDim.x must be a multiple of 32 (<= 1024).  The
// order is fixed by the launch shape, so results repeat run to run.
template <typename T>
__device__ T block_sum(T v, T* sh /* >= 32 */) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(TEMPO_FULL_MASK, v, o);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    __syncthreads();                       // sh may still be read by a previous call
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        v = lane < nw ? sh[lane] : T(0);
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(TEMPO_FULL_MASK, v, o);
        if (lane == 0) sh[0] = v;
    }
    __syncthreads();
    return sh[0];
}

// Block-wide inclusive running max over threadIdx order; *total gets
// the max of the whole block.  blockDim.x a multiple of 32.
__device__ __forceinline__ int block_scan_max(int v, int* sh /* >= 32 */, int* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(TEMPO_FULL_MASK, v, o);
        if (lane >= o) v = max(v, n);
    }
    __syncthreads();                       // sh may still be read by a previous call
    if (lane == 31) sh[wid] = v;
    __syncthreads();
    if (wid == 0) {
        int t = lane < nw ? sh[lane] : -1;
        for (int o = 1; o < 32; o <<= 1) {
            const int n = __shfl_up_sync(TEMPO_FULL_MASK, t, o);
            if (lane >= o) t = max(t, n);
        }
        if (lane < nw) sh[lane] = t;
    }
    __syncthreads();
    if (wid > 0) v = max(v, sh[wid - 1]);
    *total = sh[nw - 1];
    return v;
}

constexpr int kEmaThreads = 1024;    // bucket_stats.cu's centre blocks
// largest dynamic shared memory a block may take on sm_90 (227 KB)
constexpr int kEmaSmemLimit = 232448;

// ---------------------------------------------------------------------
// The class stages of a tiled Hillis-Steele ladder: cumsum3.cu (three
// sums), the register ladder below (the EMA's (d, v): ema_ladder.cu,
// resample_ema.cu) and bucket_stats.cu's row form (the segmented six
// planes).  By the lemma in cumsum3.cu's header, once a first stage has
// run the levels of spans < T = 2^kClassTileLog2, the levels of spans T,
// 2T, ... < L are a ladder along each residue class i mod T (entry m of
// class r is lane r + m T, class-index span s the lane span s T).
//
// The lemma holds again along a class: after the class-index spans < T2,
// entry m holds a fixed tree over entries [m - T2 + 1, m].  So a class
// stage is one of two kinds, picked per row length on the host:
//
//   whole: the class's M = ceil(L / S) entries (S the lane stride between
//     entries) in one block, every remaining level (spans s S < L): the
//     last stage;
//   windowed: where a whole class outgrows shared memory (M entries of P
//     planes in two buffers past kEmaSmemLimit), the class-index spans
//     < T2 = 2^kClass2Log2 only, on windows of kClassWindow entries whose
//     first T2 only feed the rest (the identity before the class); the
//     next stage then runs along the classes mod S T2.
//
// So a row of up to class_whole_max(P) * 1024 lanes takes one class
// stage, as it always has (the same launch, the same bits), and a longer
// one two or more (three stages in all up to 1.27e9 lanes at six planes,
// four past that); the levels run are exactly the ladder's, each once.
//
// A block per (row, slab of R residue classes) takes its windows in order
// (one in a whole stage): it copies a window's entries (asynchronous
// 4-byte copies, runs of R consecutive floats; the halo's from the inputs
// the window before kept) into shared memory, runs its levels there two at
// a time where two remain (the same tree: (X o X[-s]) o (X[-2s] o
// X[-3s]), each partner the identity where it runs off the window),
// ping-ponging two buffers of P planes, and writes planes kFirstOut .. P-1
// (every plane in a windowed stage: the next stage reads them) of the
// entries past the halo back in place.  R is the widest power of
// two <= T that keeps a window at kClassSlab entries and kClassSlabBytes
// of buffers (one class at least).
//
// Op gives kPlanes (P), kFirstOut, ident(p) (the identity's plane p) and
// combine(a, b) (a set to a after its partner b, every operation rounded
// as the first stage rounds it).  Where `live` is given, a row whose entry
// is 0 is left as the first stage wrote it (its blocks return at once):
// the first stage found every level after its own would copy.
// ---------------------------------------------------------------------

constexpr int kClassTileLog2 = 10;     // T: residue classes mod 1024
constexpr int kClassThreads = 256;
constexpr size_t kClassSlab = 2048;    // entries a block (at least one class)
constexpr size_t kClassSlabBytes = 49152;   // both buffers (at least one class)
constexpr int kClass2Log2 = 8;         // T2: a windowed stage's class-index spans < 256
constexpr int kClassWindow = 1024;     // entries a windowed block, its T2-entry halo included

template <int P>
struct ClassPlanes {
    float* p[P];
};

// Block b: slab b % slabs of row b / slabs's residue classes mod S =
// 2^log_s.  It walks windows w = 0 .. wins - 1 in order: window w holds
// class entries [w (M - halo) - halo, ...), M of them, and its first
// `halo` come from the inputs the window before kept (the planes are
// updated in place, so no block reads what another writes); the
// class-index spans s < span_end with s S < L run.
template <class Op, bool kWindowed>
__global__ void __launch_bounds__(kClassThreads)
class_ladder(ClassPlanes<Op::kPlanes> planes, const int* __restrict__ live, int L, int log_s,
             int log_r, int M, int wins_, int halo_, int span_end_) {
    constexpr int P = Op::kPlanes;
    extern __shared__ float smem[];
    // a whole stage: one window, no halo, every remaining level
    const int wins = kWindowed ? wins_ : 1, halo = kWindowed ? halo_ : 0;
    const int span_end = kWindowed ? span_end_ : INT_MAX;
    const int R = 1 << log_r;
    const int n = M * R, nh = halo * R;
    const unsigned k = blockIdx.x >> (log_s - log_r);
    if (live != nullptr && live[k] == 0) return;
    const size_t row = (size_t)k * L;
    const long long r0 = (long long)(blockIdx.x & ((1u << (log_s - log_r)) - 1)) * R;
    float* keep = smem + 2 * P * (size_t)n;   // the next window's halo inputs, P nh floats
    // entry f of the buffer, or the identity where take is false
    auto entry = [&](const float* buf, bool take, int f, float out[P]) {
#pragma unroll
        for (int p = 0; p < P; ++p) out[p] = take ? buf[p * n + f] : Op::ident(p);
    };
    for (int w = 0; w < wins; ++w) {
        float* cur = smem;                 // plane p at [p n, (p + 1) n)
        float* nxt = smem + P * (size_t)n;
        const long long m0 = (long long)w * (M - halo) - halo;
        // (a negative class index, in the halo before the class, shifts as
        // two's complement)
        auto lane_of = [&](int e) {
            return r0 + (e & (R - 1)) +
                   (long long)((unsigned long long)(m0 + (e >> log_r)) << log_s);
        };

        // asynchronous 4-byte copies, all in flight before the one wait
        for (int e = threadIdx.x; e < n; e += kClassThreads) {
            const long long i = lane_of(e);
#pragma unroll
            for (int p = 0; p < P; ++p) {
                if (w > 0 && e < nh) cur[p * n + e] = keep[p * nh + e];
                else if (i >= 0 && i < L)
                    __pipeline_memcpy_async(cur + p * n + e, planes.p[p] + row + i,
                                            sizeof(float));
                else cur[p * n + e] = Op::ident(p);
            }
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        if (w + 1 < wins) {
            for (int e = threadIdx.x; e < nh; e += kClassThreads) {
#pragma unroll
                for (int p = 0; p < P; ++p) keep[p * nh + e] = cur[p * n + n - nh + e];
            }
        }
        long long span = 1;
        while (span < span_end && (span << log_s) < L) {
            const bool two = 2 * span < span_end && (span << (log_s + 1)) < L;
            const int m1 = (int)span;
            for (int e = threadIdx.x; e < n; e += kClassThreads) {
                const int m = e >> log_r;
                float a[P], b[P];
                entry(cur, true, e, a);
                entry(cur, m >= m1, e - m1 * R, b);
                Op::combine(a, b);
                if (two) {
                    entry(cur, m >= 2 * m1, e - 2 * m1 * R, b);
                    if (m >= 2 * m1) {
                        float c[P];
                        entry(cur, m >= 3 * m1, e - 3 * m1 * R, c);
                        Op::combine(b, c);
                    }
                    Op::combine(a, b);
                }
#pragma unroll
                for (int p = 0; p < P; ++p) nxt[p * n + e] = a[p];
            }
            __syncthreads();
            float* t = cur; cur = nxt; nxt = t;
            span <<= two ? 2 : 1;
        }
        for (int e = threadIdx.x; e < n; e += kClassThreads) {
            const long long i = lane_of(e);
            if (i >= 0 && i < L && e >= nh) {
#pragma unroll
                for (int p = Op::kFirstOut; p < P; ++p) planes.p[p][row + i] = cur[p * n + e];
                if (halo > 0) {                // the next stage reads every plane
#pragma unroll
                    for (int p = 0; p < Op::kFirstOut; ++p)
                        planes.p[p][row + i] = cur[p * n + e];
                }
            }
        }
        __syncthreads();                   // the next window's copies reuse the buffers
    }
}

// most entries of P planes a whole-class stage holds (at R = 1)
inline long long class_whole_max(int P) {
    return (long long)(kEmaSmemLimit / (2 * P * sizeof(float)));
}

// The class stages over K rows of L > T lanes, on the stream after stage
// 1: windowed stages while a whole class outgrows shared memory, then the
// whole-class stage.
template <class Op>
inline cudaError_t launch_class_ladder(ClassPlanes<Op::kPlanes> planes, int K, int L,
                                       cudaStream_t st, const int* live = nullptr) {
    constexpr size_t kEntry = 2 * Op::kPlanes * sizeof(float);   // both buffers
    const int whole = (int)class_whole_max(Op::kPlanes);
    for (int log_s = kClassTileLog2; (1LL << log_s) < L; log_s += kClass2Log2) {
        const long long S = 1LL << log_s;
        const long long Mall = (L + S - 1) / S;
        const bool last = Mall <= whole;
        const int M = last ? (int)Mall : kClassWindow;
        const int halo = last ? 0 : 1 << kClass2Log2;
        const long long wins = last ? 1 : (Mall + (M - halo) - 1) / (M - halo);
        int log_r = kClassTileLog2;
        while (log_r > 0 && (((size_t)M << log_r) > kClassSlab
                             || kEntry * ((size_t)M << log_r) > kClassSlabBytes))
            --log_r;
        // both buffers, and the kept halo of a windowed stage
        const size_t smem = kEntry * ((size_t)M << log_r)
                            + sizeof(float) * Op::kPlanes * ((size_t)halo << log_r);
        const auto kernel = last ? class_ladder<Op, false> : class_ladder<Op, true>;
        cudaError_t err = cudaFuncSetAttribute(kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return err;
        const size_t blocks = (size_t)K * (size_t)(S >> log_r);
        kernel<<<(unsigned)blocks, kClassThreads, smem, st>>>(
            planes, live, L, log_s, log_r, M, (int)wins, halo, 1 << kClass2Log2);
        err = cudaGetLastError();
        if (err != cudaSuccess || last) return err;
    }
    return cudaSuccess;
}

// ---------------------------------------------------------------------
// The exact-EMA ladder in registers: ema_ladder.cu (the EMA) and
// resample_ema.cu (the resample EMA, the same ladder over the bucket
// heads).  The recurrence y_i = d_i * y_{i-1} + v_i is combined as the
// TPU kernels combine it (v += d * v_prev, then d *= d_prev, for spans 1,
// 2, 4, ... < L, the identity (1, +0) shifted in below the span); every
// product and sum rounds to nearest (and the build passes -fmad=false),
// and exactly the ladder's levels run (one more would add d * 0 and turn
// a -0.0 into +0.0).  A kernel gives the lanes' (d, v) through a fill
// functor: fill(at, i, in, own, d, v) for row lane i at element `at` of
// its arrays (`in`: i inside the row; `own`: a lane the block outputs,
// at its one load), so the one ladder serves both kernels.
//
// A row's (d, v) lives in one block of 512 threads, laid out so that no
// level moves data through shared memory but one transpose:
//
//   row phase, spans 1 .. 16: 32-lane segments, each warp a run of
//     consecutive segments, loaded four at a time; a level is one
//     shuffle, a lane below the span taking its partner from the
//     segment before, whose shuffled values it kept (the run's first
//     segment is preceded by its predecessor, laddered for its carries
//     alone; before the row, or the window, the identity (1, +0), which
//     the ladder leaves as it is).  Results go to shared memory, lane
//     index swizzled by segment (no bank conflicts either way).
//   column phase, spans 32 .. : lane l of every segment is a column of
//     G segments; a warp holds a column, thread c the segments c + 32 i
//     (i < E) in registers, so a span of m < 32 segments is one shuffle
//     and m = 32 k an entry i - k of the same thread.  The last level's
//     d is not formed.  v goes back through shared memory to coalesced
//     stores.
//
// That is 8 bytes a lane of shared memory: rows up to kRowMax = 16,384
// lanes (E = 16) run so in one launch (HHAR's 12,760 lanes, 102 KB).
// Longer rows take two launches or more by the lemma of cumsum3.cu (after the
// levels of spans < T, lane i holds a fixed tree over [i - T + 1, i]):
//
//   stage 1 (ema_block, windows): a block per (row, window of kLadderWindow
//     = 8192 lanes: a T = 1024-lane halo, then 7168 outputs), the same two
//     phases over the levels of spans < T; it writes v to out and the
//     window's d to a [K, L] plane the wrapper allocates (4 bytes a lane,
//     written once and read once: no level runs in global memory).
//   class stages: class_ladder above over the (d, v) planes (a block per
//     (row, slab of residue classes mod T), the levels of spans T, 2T, ...
//     < L in shared memory two at a time where two remain, 16 bytes an
//     entry; v written back): one stage up to 14,528 * 1024 = 14,876,672
//     lanes, a windowed stage and a stage along the classes mod 2^18
//     past it (every int32 row length).
// ---------------------------------------------------------------------

constexpr int kLadderThreads = 512;
constexpr int kLadderWarps = kLadderThreads / 32;
constexpr int kRowMax = 16 * 32 * 32;        // lanes of the one-launch form (E = 16)
constexpr int kLadderWindow = 8 * 32 * 32;   // stage-1 lanes a block (E = 8), halo included
constexpr int kLadderBatch = 4;              // segments a warp loads at once

// shared-memory slot of lane l of segment g: a row of 32 floats, the lane
// swizzled by the segment, so a segment (a warp over l) and a column (a
// warp over g = c + 32 i) both hit 32 banks
__device__ __forceinline__ int ladder_slot(int g, int l) { return g * 32 + (l ^ (g & 31)); }

// one ladder level: (d, v) after its partner (dp, vp); v first, from the
// level's own d
__device__ __forceinline__ void affine_step(float& d, float& v, float dp, float vp, bool need_d) {
    v = __fadd_rn(v, __fmul_rn(d, vp));
    if (need_d) d = __fmul_rn(d, dp);
}

// The row phase's carries: the segment before's shuffled (d, v), a level
// each; the identity before a run's first segment.
struct AffineCarry {
    float d[5], v[5];
    __device__ __forceinline__ void reset() {
#pragma unroll
        for (int ls = 0; ls < 5; ++ls) { d[ls] = 1.f; v[ls] = 0.f; }
    }
};

// the row phase's levels (spans < min(32, span_end)) on one segment
__device__ __forceinline__ void affine_row_levels(float& d, float& v, AffineCarry& c, int lane,
                                                  int span_end) {
#pragma unroll
    for (int ls = 0; ls < 5; ++ls) {
        const int s = 1 << ls;
        if (s >= span_end) break;
        const float dc = __shfl_sync(TEMPO_FULL_MASK, d, (lane - s) & 31);
        const float vc = __shfl_sync(TEMPO_FULL_MASK, v, (lane - s) & 31);
        affine_step(d, v, lane >= s ? dc : c.d[ls], lane >= s ? vc : c.v[ls], true);
        c.d[ls] = dc;
        c.v[ls] = vc;
    }
}

// The column phase over the G segments in ds / vs (spans 32 m < span_end;
// warp w takes columns w, w + 16), then a __syncthreads(); d is written
// back only with keep_d.
template <int E>
__device__ __forceinline__ void affine_columns(float* ds, float* vs, int G, int span_end,
                                               bool keep_d) {
    if (span_end <= 32) return;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    for (int col = w; col < 32; col += kLadderWarps) {
        float d[E], v[E];
#pragma unroll
        for (int i = 0; i < E; ++i) {
            const int g = lane + 32 * i;
            d[i] = g < G ? ds[ladder_slot(g, col)] : 1.f;
            v[i] = g < G ? vs[ladder_slot(g, col)] : 0.f;
        }
        // m < 32: thread c - m, entry i (c >= m), else thread c - m + 32,
        // entry i - 1 (its shuffle of the step before)
#pragma unroll
        for (int lm = 0; lm < 5; ++lm) {
            const int m = 1 << lm;
            if (32 * m >= span_end) break;
            const bool need_d = keep_d || 64 * m < span_end;
            float dp = 1.f, vp = 0.f;
#pragma unroll
            for (int i = 0; i < E; ++i) {
                const float dc = __shfl_sync(TEMPO_FULL_MASK, d[i], (lane - m) & 31);
                const float vc = __shfl_sync(TEMPO_FULL_MASK, v[i], (lane - m) & 31);
                const bool in = lane + 32 * i >= m;
                affine_step(d[i], v[i], !in ? 1.f : lane >= m ? dc : dp,
                            !in ? 0.f : lane >= m ? vc : vp, need_d);
                dp = dc;
                vp = vc;
            }
        }
        // m = 32 k: entry i - k of the same thread, newest entry first
#pragma unroll
        for (int k = 1; k < E; k <<= 1) {
            if (1024LL * k >= span_end) break;
            const bool need_d = keep_d || 2048LL * k < span_end;
#pragma unroll
            for (int i = E - 1; i >= 0; --i) {
                const bool in = i >= k;
                affine_step(d[i], v[i], in ? d[i - k * in] : 1.f, in ? v[i - k * in] : 0.f,
                            need_d);
            }
        }
#pragma unroll
        for (int i = 0; i < E; ++i) {
            const int g = lane + 32 * i;
            if (g < G) {
                vs[ladder_slot(g, col)] = v[i];
                if (keep_d) ds[ladder_slot(g, col)] = d[i];
            }
        }
    }
    __syncthreads();
}

// A block's ladder over G segments of a row: lane (g, l) is row lane
// origin + 32 g + l (the identity (1, +0) outside [0, L)), the levels of
// spans < span_end; writes v of the lanes past the first `halo` to out
// and, where dplane is given, their d to it.  A block per row
// (tiles = 1, origin 0) or per (row, window of 32 * G lanes whose first
// `halo` lanes only feed the rest).
template <int E, class Fill>
__global__ void __launch_bounds__(kLadderThreads, 2)
ema_block(Fill fill, float* __restrict__ out, float* __restrict__ dplane, int L, int G,
          int tiles, int halo, int span_end) {
    extern __shared__ float smem[];
    float* ds = smem;
    float* vs = smem + (size_t)G * 32;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const size_t row = (size_t)(blockIdx.x / tiles) * L;
    const long long origin = (long long)(blockIdx.x % tiles) * (32LL * G - halo) - halo;

    // (d, v) of segment g, this lane; `own` at the run's loads
    auto load = [&](int g, bool own, float& d, float& v) {
        const int e = 32 * g + lane;
        const long long i = origin + e;
        const bool in = i >= 0 && i < L;
        fill(row + (size_t)(in ? i : 0), i, in, own && in && e >= halo, d, v);
    };

    // row phase: warp w takes segments [g0, g1), four loads in flight
    {
        const int per = (G + kLadderWarps - 1) / kLadderWarps;
        const int g0 = w * per, g1 = min(G, g0 + per);
        AffineCarry c;
        c.reset();
        if (g0 > 0 && g0 < g1) {
            float d, v;
            load(g0 - 1, false, d, v);
            affine_row_levels(d, v, c, lane, span_end);
        }
        for (int g = g0; g < g1; g += kLadderBatch) {
            float d[kLadderBatch], v[kLadderBatch];
#pragma unroll
            for (int q = 0; q < kLadderBatch; ++q)
                load(min(g + q, g1 - 1), g + q < g1, d[q], v[q]);
#pragma unroll
            for (int q = 0; q < kLadderBatch; ++q) {
                if (g + q >= g1) break;
                affine_row_levels(d[q], v[q], c, lane, span_end);
                ds[ladder_slot(g + q, lane)] = d[q];
                vs[ladder_slot(g + q, lane)] = v[q];
            }
        }
    }
    __syncthreads();
    affine_columns<E>(ds, vs, G, span_end, dplane != nullptr);

    for (int e = threadIdx.x; e < G * 32; e += kLadderThreads) {
        const int g = e >> 5, l = e & 31;
        const long long i = origin + e;
        if (e >= halo && i < L) {
            out[row + i] = vs[ladder_slot(g, l)];
            if (dplane) dplane[row + i] = ds[ladder_slot(g, l)];
        }
    }
}

// Stage 2's combine (class_ladder): (d, v) after its partner as
// affine_step forms it, the identity (1, +0); only v is written back.
struct AffinePlanes {
    static constexpr int kPlanes = 2;
    static constexpr int kFirstOut = 1;
    __device__ static float ident(int p) { return p == 0 ? 1.f : 0.f; }
    __device__ static void combine(float a[2], const float b[2]) {
        a[1] = __fadd_rn(a[1], __fmul_rn(a[0], b[1]));
        a[0] = __fmul_rn(a[0], b[0]);
    }
};

template <int E, class Fill>
inline cudaError_t launch_ema_block(unsigned blocks, size_t smem, cudaStream_t st, Fill fill,
                                    float* out, float* dplane, int L, int G, int tiles,
                                    int halo, int span_end) {
    cudaError_t err = cudaFuncSetAttribute(ema_block<E, Fill>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    ema_block<E, Fill><<<blocks, kLadderThreads, smem, st>>>(fill, out, dplane, L, G, tiles,
                                                             halo, span_end);
    return cudaGetLastError();
}

// The ladder over K rows of L lanes into out: one launch up to kRowMax
// lanes, else stage 1 (the windows' d into dplane, [K, L]) and the class
// stages.
template <class Fill>
inline cudaError_t launch_ema_ladder(Fill fill, float* out, float* dplane, int K, int L,
                                     cudaStream_t st) {
    if (L <= kRowMax) {
        const int G = (L + 31) / 32;
        const size_t smem = 2 * sizeof(float) * 32 * (size_t)G;
        return G <= 8 * 32 ? launch_ema_block<8>(K, smem, st, fill, out, nullptr, L, G, 1, 0, L)
                           : launch_ema_block<16>(K, smem, st, fill, out, nullptr, L, G, 1, 0, L);
    }
    if (dplane == nullptr) return cudaErrorInvalidValue;
    const int T = 1 << kClassTileLog2;
    const int tiles = (int)(((long long)L + (kLadderWindow - T) - 1) / (kLadderWindow - T));
    const size_t smem1 = 2 * sizeof(float) * (size_t)kLadderWindow;
    cudaError_t err = launch_ema_block<8>((unsigned)((size_t)K * tiles), smem1, st, fill, out,
                                          dplane, L, kLadderWindow / 32, tiles, T, T);
    if (err != cudaSuccess) return err;
    return launch_class_ladder<AffinePlanes>({{dplane, out}}, K, L, st);
}
