// Fused floor-resample + exact EMA on packed [K, L] series.
//
// Replaces the Pallas kernel tempo_tpu/ops/pallas_bucket.py:
// _resample_ema_kernel (through _resample_ema_call and
// resample_ema_pallas; the op sequence is _resample_ema_math):
//
//   xs     = x * scale
//   bucket = floor(secs / step)                  (int32, floor division)
//   head   = (lane == 0 || bucket != bucket[lane - 1]) && valid
//   res    = head ? xs : NaN
//   ema    = the exact EMA over the head-masked samples: (d, v) =
//            (1 - alpha, alpha * xs) at heads, (1, 0) elsewhere
//
// JAX's // on int32 floors, and C's / truncates toward zero, so seconds
// before 1970 are floored explicitly.  Pad lanes carry seconds that
// wrapped in the int32 cast; they are never valid, so they are never
// heads, and the lane after them is a pad too.  Every float op rounds to
// nearest (and the build passes -fmad=false), so the result is bitwise
// the plain version's on the card.
//
// Bound on H100: bytes, one read of secs, x and valid and one write of
// res and ema (17 bytes a lane).
//
// Design: the EMA's ladder is ema_ladder.cu's, common.cuh's register
// ladder, with the fill above (ResampleFill), which also writes res at
// the lanes a block outputs (never a halo's).  Two forms, picked on the
// host by ops/stream.resample_plan:
//
// * the row form (tempo_resample_ema) reads its inputs straight from
//   global memory: one launch (ema_block) up to kRowMax = 16,384 lanes,
//   two past it (stage 1 on windows, writing res, v and a [K, L] d plane
//   the wrapper allocates, then class_ladder), as the EMA takes them;
// * the staged form (resample_ema_ring_kernel), rows of at most kRowMax
//   lanes: the same one-launch ladder, whose row phase reads secs, x and
//   valid from ring.cuh's staging ring in tiles of T lanes (tile order),
//   each slot holding its tile and the kBehind = 33 lanes before it, so
//   the warp whose run starts a tile re-ladders its predecessor segment
//   (and compares its first bucket with the lane behind) from the slot.
//   The ladder's planes take 8 bytes a lane of shared memory (102 KB at
//   12,760 lanes), the slots the rest.
//
// Both forms run the same levels in the same order, so they give the
// same bits.
#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int kBehind = 33;     // staged lanes before a tile: a segment and its lane behind

// floor(a / d) for int32 a and a fixed d >= 1, without a division on the
// card: with 2^31 = Q d + R, floor(a / d) = floor((u - R) / d) - Q for
// u = a + 2^31 in [0, 2^32), which is -1 - Q where u < R, else an
// unsigned quotient, taken by a multiply-high (Granlund and Montgomery's
// method: l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1,
// t = mulhi(m, n), n / d = (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0)).
// The host forms the constants once a call.
struct FloorDiv {
    uint32_t m, r;
    int32_t q;
    int sh1, sh2;

    static FloorDiv of(int d) {
        int l = 0;
        while ((1LL << l) < d) ++l;
        const uint64_t two31 = 1ULL << 31;
        FloorDiv f;
        f.m = (uint32_t)((((1ULL << l) - (uint64_t)d) << 32) / (uint64_t)d + 1);
        f.r = (uint32_t)(two31 % (uint64_t)d);
        f.q = (int32_t)(two31 / (uint64_t)d);
        f.sh1 = l < 1 ? l : 1;
        f.sh2 = l > 1 ? l - 1 : 0;
        return f;
    }

    __device__ __forceinline__ int32_t operator()(int32_t a) const {
        const uint32_t u = (uint32_t)a + 0x80000000u;
        if (u < r) return -1 - q;
        const uint32_t n = u - r;
        const uint32_t t = __umulhi(m, n);
        return (int32_t)((t + ((n - t) >> sh1)) >> sh2) - q;
    }
};

// Lane i's res and (d, v): bucket of lane i from secs `si`, of lane
// i - 1 from `sp` (i > 0); `ok` its validity.
__device__ __forceinline__ void resample_lane(long long i, int32_t si, int32_t sp, bool ok,
                                              float xi, FloorDiv bucket, float alpha,
                                              float one_minus_a, float scale, float& d,
                                              float& v, float& r) {
    const bool head = ok && (i == 0 || bucket(si) != bucket(sp));
    const float xs = __fmul_rn(xi, scale);
    r = head ? xs : tempo_nan();
    d = head ? one_minus_a : 1.f;
    v = head ? __fmul_rn(alpha, xs) : 0.f;
}

// the row form's fill (common.cuh's ema_block): inputs from global memory
struct ResampleFill {
    const int32_t* __restrict__ secs;
    const float* __restrict__ x;
    const uint8_t* __restrict__ valid;
    float* __restrict__ res;
    FloorDiv bucket;
    float alpha, one_minus_a, scale;
    __device__ __forceinline__ void operator()(size_t at, long long i, bool in, bool own,
                                               float& d, float& v) const {
        const int32_t si = secs[at];
        const int32_t sp = in && i > 0 ? secs[at - 1] : 0;
        float r;
        resample_lane(i, si, sp, in && valid[at] != 0, x[at], bucket, alpha, one_minus_a,
                      scale, d, v, r);
        if (own) res[at] = r;
    }
};

// Shared memory of the staged form, in bytes (ops/stream.resample_ring_bytes
// mirrors the total): the ring's barriers, the ladder's two planes of
// 32 * G floats (G = ceil(L / 32) segments), then `depth` slots of a
// tile's secs, x and valid with the kBehind lanes before it.
struct ResampleRingLayout {
    size_t planes, slots, s_plane, x_plane, v_plane, slot, total;
};

__host__ __device__ inline ResampleRingLayout resample_ring_layout(int L, int T, int depth) {
    ResampleRingLayout y;
    y.planes = 8 * ring::kMaxDepth;
    y.slots = y.planes + 2 * 4 * 32 * (size_t)((L + 31) / 32);
    y.s_plane = ring::plane_bytes(4 * ((size_t)T + kBehind));
    y.x_plane = y.s_plane;
    y.v_plane = ring::plane_bytes((size_t)T + kBehind);
    y.slot = y.s_plane + y.x_plane + y.v_plane;
    y.total = y.slots + (size_t)depth * y.slot;
    return y;
}

template <int E>
__global__ void __launch_bounds__(kLadderThreads, 1)
resample_ema_ring_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                         const uint8_t* __restrict__ valid, FloorDiv bucket, float alpha,
                         float scale,
                         float* __restrict__ res, float* __restrict__ ema, int K, int L, int T,
                         int depth) {
    extern __shared__ __align__(16) unsigned char sm[];
    const ResampleRingLayout lay = resample_ring_layout(L, T, depth);
    const ring::Ring r{(uint64_t*)sm, depth};
    const int G = (L + 31) / 32;
    float* ds = (float*)(sm + lay.planes);
    float* vs = ds + 32 * (size_t)G;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t n_all = (size_t)K * L;
    const int nt = (L + T - 1) / T;
    const float one_minus_a = __fsub_rn(1.f, alpha);
    ring::init(r);

    auto slot_base = [&](int slot) { return sm + lay.slots + (size_t)slot * lay.slot; };
    auto load = [&](int t, int slot, uint64_t* bar) {
        const int lo = max(t * T - kBehind, 0), hi = min(L, t * T + T);
        unsigned char* b = slot_base(slot);
        ring::stage(b, secs + row + lo, 4 * (size_t)(hi - lo), secs + n_all, bar);
        ring::stage(b + lay.s_plane, x + row + lo, 4 * (size_t)(hi - lo), x + n_all, bar);
        ring::stage(b + lay.s_plane + lay.x_plane, valid + row + lo, (size_t)(hi - lo),
                    valid + n_all, bar);
    };
    auto consume = [&](int t, int slot) {
        const int lo = max(t * T - kBehind, 0), hi = min(L, t * T + T);
        unsigned char* b = slot_base(slot);
        const int32_t* ss = (const int32_t*)(b + ((uintptr_t)(secs + row + lo) & 15));
        const float* xs = (const float*)(b + lay.s_plane + ((uintptr_t)(x + row + lo) & 15));
        const uint8_t* vb =
            b + lay.s_plane + lay.x_plane + ((uintptr_t)(valid + row + lo) & 15);
        // (d, v) of segment g, this lane, from the slot; res where `own`
        auto fill = [&](int g, bool own, float& d, float& v) {
            const int i = 32 * g + lane;
            const bool in = i < L;
            const int o = in ? i - lo : 0;
            float rv;
            resample_lane(i, in ? ss[o] : 0, in && i > 0 ? ss[o - 1] : 0, in && vb[o] != 0,
                          in ? xs[o] : 0.f, bucket, alpha, one_minus_a, scale, d, v, rv);
            if (own && in) res[row + i] = rv;
        };
        // the tile's segments [ga, gb), a run a warp
        const int ga = t * T / 32, gb = (hi + 31) / 32;
        const int per = (gb - ga + kLadderWarps - 1) / kLadderWarps;
        const int g0 = ga + w * per, g1 = min(gb, g0 + per);
        if (g0 >= g1) return;
        AffineCarry c;
        c.reset();
        float d, v;
        if (g0 > 0) {
            fill(g0 - 1, false, d, v);
            affine_row_levels(d, v, c, lane, L);
        }
        for (int g = g0; g < g1; ++g) {
            fill(g, true, d, v);
            affine_row_levels(d, v, c, lane, L);
            ds[ladder_slot(g, lane)] = d;
            vs[ladder_slot(g, lane)] = v;
        }
    };
    ring::run(r, nt, load, consume);
    affine_columns<E>(ds, vs, G, L, false);
    for (int e = threadIdx.x; e < L; e += kLadderThreads)
        ema[row + e] = vs[ladder_slot(e >> 5, e & 31)];
}

template <int E>
cudaError_t launch_ring(unsigned K, size_t smem, cudaStream_t st, const void* secs,
                        const void* x, const void* valid, int step, float alpha, float scale,
                        void* res, void* ema, int L, int T, int depth) {
    cudaError_t err = cudaFuncSetAttribute(resample_ema_ring_kernel<E>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    resample_ema_ring_kernel<E><<<K, kLadderThreads, smem, st>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, FloorDiv::of(step),
        alpha, scale, (float*)res, (float*)ema, (int)K, L, T, depth);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tempo_resample_ema(const void* secs, const void* x, const void* valid,
                                  int step, float alpha, float scale, void* res, void* ema,
                                  void* dplane, int K, int L, void* stream) {
    const ResampleFill fill{(const int32_t*)secs, (const float*)x, (const uint8_t*)valid,
                            (float*)res, FloorDiv::of(step), alpha, 1.f - alpha, scale};
    return (int)launch_ema_ladder(fill, (float*)ema, (float*)dplane, K, L,
                                  (cudaStream_t)stream);
}

// Shared memory of the staged form, for the planner's check on the card.
extern "C" long long tempo_resample_ring_smem(int L, int T, int depth) {
    return (long long)resample_ring_layout(L, T, depth).total;
}

extern "C" int tempo_resample_ema_ring(const void* secs, const void* x, const void* valid,
                                       int step, float alpha, float scale, void* res,
                                       void* ema, int K, int L, int T, int depth,
                                       void* stream) {
    const size_t smem = resample_ring_layout(L, T, depth).total;
    if (depth < 2 || depth > ring::kMaxDepth || T < 32 || T % 32 != 0 || L > kRowMax ||
        smem > (size_t)kEmaSmemLimit)
        return (int)cudaErrorInvalidValue;
    const int G = (L + 31) / 32;
    cudaStream_t st = (cudaStream_t)stream;
    return (int)(G <= 8 * 32
        ? launch_ring<8>(K, smem, st, secs, x, valid, step, alpha, scale, res, ema, L, T, depth)
        : launch_ring<16>(K, smem, st, secs, x, valid, step, alpha, scale, res, ema, L, T,
                          depth));
}
