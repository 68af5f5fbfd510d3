// Exact EMA y_t = (1-a) y_{t-1} + a x_t on packed [K, L] series; invalid
// rows carry the previous value forward.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_kernels.py:_ema_kernel
// (through _ema_call and ema_scan).  The recurrence is the linear map
// y_i = d_i * y_{i-1} + v_i with (d, v) = (1-a, a x) at valid rows and
// (1, 0) elsewhere, combined by the same Hillis-Steele ladder with the
// same association (v += d * v_prev, then d *= d_prev, for spans 1, 2,
// 4, ... < L, (1, 0) shifted in below the span), so the f32 rounding is
// the TPU kernel's: a decoupled-lookback or sequential scan would round
// differently.  Every product and sum rounds to nearest (__fmul_rn /
// __fadd_rn, and the build passes -fmad=false).  Exactly the ladder's
// levels run: one more would add d * 0 and turn a -0.0 into +0.0.
//
// Bound on H100: bytes, one read of x and valid and one write of y
// (9 bytes a lane).  The ladder is about 3 flops a lane a level.
//
// Design.  A row's (d, v) lives in one block of 512 threads, laid out so
// that no level moves data through shared memory but one transpose:
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
// Longer rows take two launches by the lemma of cumsum3.cu (after the
// levels of spans < T, lane i holds a fixed tree over [i - T + 1, i]):
//
//   stage 1 (ema_block, windows): a block per (row, window of kWindow =
//     8192 lanes: a T = 1024-lane halo, then 7168 outputs), the same two
//     phases over the levels of spans < T; it writes v to out and the
//     window's d to a [K, L] plane the wrapper allocates (4 bytes a lane,
//     written once and read once: no level runs in global memory).
//   stage 2: common.cuh's class_ladder over the (d, v) planes, the
//     stage cumsum3.cu runs over its sums (a block per (row, slab of
//     residue classes mod T), the levels of spans T, 2T, ... < L in
//     shared memory two at a time where two remain, the identity where
//     the class runs out, 16 bytes an entry; v written back).  A row past
//     14,528 * 1024 = 14,876,672 lanes does not fit even at one class a
//     block and is refused (the wrapper raises before the launch).
//
// Traffic at phase F's [128, 102056]: x and valid read about 1.14 times
// (the halo), v and d written, read and v written again: about 26 bytes a
// lane, against the function's 9.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowMax = 16 * 32 * 32;     // lanes of the one-launch form (E = 16)
constexpr int kWindow = 8 * 32 * 32;      // stage-1 lanes a block (E = 8), halo included
constexpr int kBatch = 4;                 // segments a warp loads at once

// shared-memory slot of lane l of segment g: a row of 32 floats, the lane
// swizzled by the segment, so a segment (a warp over l) and a column (a
// warp over g = c + 32 i) both hit 32 banks
__device__ __forceinline__ int slot(int g, int l) { return g * 32 + (l ^ (g & 31)); }

// one ladder level: (d, v) after its partner (dp, vp); v first, from the
// level's own d
__device__ __forceinline__ void combine(float& d, float& v, float dp, float vp, bool need_d) {
    v = __fadd_rn(v, __fmul_rn(d, vp));
    if (need_d) d = __fmul_rn(d, dp);
}

// A block's ladder over G segments of a row: lane (g, l) is row lane
// origin + 32 g + l (the identity (1, +0) outside [0, L)), the levels of
// spans < span_end; writes v of the lanes past the first `halo` to out
// and, where dplane is given, their d to it.  A block per row
// (tiles = 1, origin 0) or per (row, window of 32 * G lanes whose first
// `halo` lanes only feed the rest).
template <int E>
__global__ void __launch_bounds__(kThreads, 2)
ema_block(const float* __restrict__ x, const uint8_t* __restrict__ valid, float alpha,
          float* __restrict__ out, float* __restrict__ dplane, int L, int G, int tiles,
          int halo, int span_end) {
    extern __shared__ float smem[];
    float* ds = smem;
    float* vs = smem + (size_t)G * 32;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const size_t row = (size_t)(blockIdx.x / tiles) * L;
    const long long origin = (long long)(blockIdx.x % tiles) * (32LL * G - halo) - halo;
    const float one_minus_a = __fsub_rn(1.f, alpha);

    // (d, v) of segment g, this lane
    auto load = [&](int g, float& d, float& v) {
        const long long i = origin + 32LL * g + lane;
        const bool in = i >= 0 && i < L;
        const size_t at = row + (size_t)(in ? i : 0);
        const bool ok = in && valid[at] != 0;
        const float xv = x[at];
        d = ok ? one_minus_a : 1.f;
        v = ok ? __fmul_rn(alpha, xv) : 0.f;
    };
    // the row phase's levels on one segment, carrying the segment before
    float cd[5], cv[5];
    auto row_levels = [&](float& d, float& v) {
#pragma unroll
        for (int ls = 0; ls < 5; ++ls) {
            const int s = 1 << ls;
            if (s >= span_end) break;
            const float dc = __shfl_sync(TEMPO_FULL_MASK, d, (lane - s) & 31);
            const float vc = __shfl_sync(TEMPO_FULL_MASK, v, (lane - s) & 31);
            combine(d, v, lane >= s ? dc : cd[ls], lane >= s ? vc : cv[ls], true);
            cd[ls] = dc;
            cv[ls] = vc;
        }
    };

    // row phase: warp w takes segments [g0, g1), four loads in flight
    {
        const int per = (G + kWarps - 1) / kWarps;
        const int g0 = w * per, g1 = min(G, g0 + per);
#pragma unroll
        for (int ls = 0; ls < 5; ++ls) { cd[ls] = 1.f; cv[ls] = 0.f; }
        if (g0 > 0 && g0 < g1) {
            float d, v;
            load(g0 - 1, d, v);
            row_levels(d, v);
        }
        for (int g = g0; g < g1; g += kBatch) {
            float d[kBatch], v[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) load(min(g + q, g1 - 1), d[q], v[q]);
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
                if (g + q >= g1) break;
                row_levels(d[q], v[q]);
                ds[slot(g + q, lane)] = d[q];
                vs[slot(g + q, lane)] = v[q];
            }
        }
    }
    __syncthreads();

    // column phase, spans 32 m < span_end: warp w takes columns w, w + 16
    if (span_end > 32) {
        const bool keep_d = dplane != nullptr;
        for (int col = w; col < 32; col += kWarps) {
            float d[E], v[E];
#pragma unroll
            for (int i = 0; i < E; ++i) {
                const int g = lane + 32 * i;
                d[i] = g < G ? ds[slot(g, col)] : 1.f;
                v[i] = g < G ? vs[slot(g, col)] : 0.f;
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
                    combine(d[i], v[i], !in ? 1.f : lane >= m ? dc : dp,
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
                    combine(d[i], v[i], in ? d[i - k * in] : 1.f, in ? v[i - k * in] : 0.f,
                            need_d);
                }
            }
#pragma unroll
            for (int i = 0; i < E; ++i) {
                const int g = lane + 32 * i;
                if (g < G) {
                    vs[slot(g, col)] = v[i];
                    if (keep_d) ds[slot(g, col)] = d[i];
                }
            }
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < G * 32; e += kThreads) {
        const int g = e >> 5, l = e & 31;
        const long long i = origin + e;
        if (e >= halo && i < L) {
            out[row + i] = vs[slot(g, l)];
            if (dplane) dplane[row + i] = ds[slot(g, l)];
        }
    }
}

// Stage 2's combine (common.cuh's class_ladder): (d, v) after its partner
// as combine() forms it, the identity (1, +0); only v is written back.
struct AffinePlanes {
    static constexpr int kPlanes = 2;
    static constexpr int kFirstOut = 1;
    __device__ static float ident(int p) { return p == 0 ? 1.f : 0.f; }
    __device__ static void combine(float a[2], const float b[2]) {
        a[1] = __fadd_rn(a[1], __fmul_rn(a[0], b[1]));
        a[0] = __fmul_rn(a[0], b[0]);
    }
};

template <int E>
cudaError_t launch_block(unsigned blocks, size_t smem, cudaStream_t st, const void* x,
                         const void* valid, float alpha, void* out, void* dplane, int L, int G,
                         int tiles, int halo, int span_end) {
    cudaError_t err = cudaFuncSetAttribute(ema_block<E>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    ema_block<E><<<blocks, kThreads, smem, st>>>((const float*)x, (const uint8_t*)valid, alpha,
                                                 (float*)out, (float*)dplane, L, G, tiles,
                                                 halo, span_end);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tempo_ema_smem_limit() { return kEmaSmemLimit; }

// rows the one-launch form takes; longer rows need the wrapper's d plane
extern "C" long long tempo_ema_row_max() { return kRowMax; }

// longest row the two stages take (stage 2's classes at R = 1)
extern "C" long long tempo_ema_max_lanes() { return class_ladder_max_lanes(2); }

extern "C" int tempo_ema_ladder(const void* x, const void* valid, float alpha, void* out,
                                void* dplane, int K, int L, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (L <= kRowMax) {
        const int G = (L + 31) / 32;
        const size_t smem = 2 * sizeof(float) * 32 * (size_t)G;
        return (int)(G <= 8 * 32
            ? launch_block<8>(K, smem, st, x, valid, alpha, out, nullptr, L, G, 1, 0, L)
            : launch_block<16>(K, smem, st, x, valid, alpha, out, nullptr, L, G, 1, 0, L));
    }
    if (dplane == nullptr) return (int)cudaErrorInvalidValue;
    const int T = 1 << kClassTileLog2;
    const int tiles = (L + (kWindow - T) - 1) / (kWindow - T);
    const size_t smem1 = 2 * sizeof(float) * (size_t)kWindow;
    cudaError_t err = launch_block<8>((unsigned)((size_t)K * tiles), smem1, st, x, valid, alpha,
                                      out, dplane, L, kWindow / 32, tiles, T, T);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_class_ladder<AffinePlanes>({{(float*)dplane, (float*)out}}, K, L, st);
}
