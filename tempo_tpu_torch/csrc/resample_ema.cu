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
//   lanes, two blocks an SM as the row form: the same one-launch ladder,
//   whose row phase reads secs, x and valid through a ring a warp
//   (ring.cuh's warp ring), each warp streaming its own run of segments
//   in items of T lanes, its carries in registers over the whole run and
//   one predecessor re-laddered per run, as the row form does.  secs and
//   x land in place, in the ladder's planes, which hold 8 bytes a lane
//   (102 KB at 12,760 lanes); the slots hold only the valid bytes, so
//   ring state beside the planes stays under 13.5 KB.
//
// Both forms run the same levels in the same order, so they give the
// same bits.
#include "common.cuh"
#include "ring.cuh"

namespace {

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
// mirrors the total): kLadderWarps * depth barriers (a ring a warp), the
// ladder's two planes of 32 * G floats (G = ceil(L / 32) segments), each
// followed by 16 bytes that take the staged words of the row's last lanes
// when the row does not start on 16 bytes, then kLadderWarps * depth
// slots of an item's T valid bytes.
struct ResampleRingLayout {
    size_t ds, vs, slots, v_slot, total;
};

__host__ __device__ inline ResampleRingLayout resample_ring_layout(int L, int T, int depth) {
    ResampleRingLayout y;
    const size_t plane = 4 * 32 * (size_t)((L + 31) / 32) + 16;
    y.ds = ring::align16(8 * (size_t)kLadderWarps * depth);
    y.vs = y.ds + plane;
    y.slots = y.vs + plane;
    y.v_slot = ring::plane_bytes((size_t)T);
    y.total = y.slots + (size_t)kLadderWarps * depth * y.v_slot;
    return y;
}

// Staged form, rows of at most kRowMax lanes, two blocks an SM: a block a
// row, and the row phase of ema_block's ladder with each warp's run of
// segments (the row form's [g0, g1)) streamed through a ring of its own,
// items of T lanes.  An item lands where it is used: its secs in the d
// plane and its x in the v plane, lane i at word i from the row's 16-byte
// aligned start (ring::stage_at), so segment g's inputs sit in row g of
// the planes (and, off 16 bytes, in the first words of row g + 1) until
// the warp writes segment g's (d, v) there; its valid bytes take a slot.
// Each warp keeps its carries in registers over its whole run and
// re-ladders one predecessor segment (read from global memory, with the
// lane behind it) per run.  A warp writes its first segment's (d, v)
// only after the block barrier that ends the row phase: the warp before
// it may still read its own last lanes from that row.  No block barrier
// runs before that one; the column phase follows as in ema_block.
template <int E>
__global__ void __launch_bounds__(kLadderThreads, 2)
resample_ema_ring_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                         const uint8_t* __restrict__ valid, FloorDiv bucket, float alpha,
                         float scale, float* __restrict__ res, float* __restrict__ ema, int K,
                         int L, int T, int depth) {
    extern __shared__ __align__(16) unsigned char sm[];
    const ResampleRingLayout lay = resample_ring_layout(L, T, depth);
    const int G = (L + 31) / 32;
    float* ds = (float*)(sm + lay.ds);
    float* vs = (float*)(sm + lay.vs);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const size_t row = (size_t)blockIdx.x * L;
    const size_t n_all = (size_t)K * L;
    const int32_t* srow = secs + row;
    const float* xrow = x + row;
    const uint8_t* vrow = valid + row;
    const uintptr_t s_base = (uintptr_t)srow & ~(uintptr_t)15;
    const uintptr_t x_base = (uintptr_t)xrow & ~(uintptr_t)15;
    const int32_t* s_at = (const int32_t*)ds + (((uintptr_t)srow & 15) >> 2);   // lane i: s_at[i]
    const float* x_at = vs + (((uintptr_t)xrow & 15) >> 2);
    const float one_minus_a = __fsub_rn(1.f, alpha);

    // this warp's run: segments [g0, g1), lanes [a0, a1), items of T lanes
    const int per = (G + kLadderWarps - 1) / kLadderWarps;
    const int g0 = min(G, w * per), g1 = min(G, g0 + per);
    const int a0 = 32 * g0, a1 = min(L, 32 * g1);
    const int n = a1 > a0 ? (a1 - a0 + T - 1) / T : 0;
    const ring::WarpRing r{(uint64_t*)sm + (size_t)w * depth, depth};
    unsigned char* vslots = sm + lay.slots + (size_t)w * depth * lay.v_slot;

    auto load = [&](int j, int slot, uint64_t* bar) {
        const int a = a0 + j * T, b = min(a1, a + T);
        ring::stage_at(ds, s_base, srow + a, 4 * (size_t)(b - a), bar);
        ring::stage_at(vs, x_base, xrow + a, 4 * (size_t)(b - a), bar);
        ring::stage(vslots + (size_t)slot * lay.v_slot, vrow + a, (size_t)(b - a),
                    valid + n_all, bar);
    };
    ring::warp_begin(r, n, load);

    // the predecessor segment, from global memory, for the carries; the
    // secs of the lane before the next segment (lane 0's comparison)
    AffineCarry c;
    c.reset();
    int32_t prev_s = 0;
    if (g0 > 0 && g0 < g1) {
        const int i = a0 - 32 + lane;
        const int32_t si = srow[i];
        const int32_t up = __shfl_up_sync(TEMPO_FULL_MASK, si, 1);
        float d, v, rv;
        const int32_t sb = lane > 0 ? up : i > 0 ? srow[i - 1] : 0;
        resample_lane(i, si, sb, vrow[i] != 0, xrow[i], bucket, alpha, one_minus_a, scale, d, v,
                      rv);
        affine_row_levels(d, v, c, lane, L);
        prev_s = __shfl_sync(TEMPO_FULL_MASK, si, 31);
    }
    float d0 = 1.f, v0 = 0.f;   // the run's first segment, written after the row phase
    auto consume = [&](int j, int slot) {
        const int a = a0 + j * T, b = min(a1, a + T);
        const uint8_t* vb = vslots + (size_t)slot * lay.v_slot + ((uintptr_t)(vrow + a) & 15);
        for (int g = a >> 5; 32 * g < b; ++g) {
            const int i = 32 * g + lane;
            const bool in = i < L;
            const int32_t si = in ? s_at[i] : 0;
            const int32_t up = __shfl_up_sync(TEMPO_FULL_MASK, si, 1);
            float d, v, rv;
            resample_lane(i, si, lane == 0 ? prev_s : up, in && vb[i - a] != 0,
                          in ? x_at[i] : 0.f, bucket, alpha, one_minus_a, scale, d, v, rv);
            if (in) res[row + i] = rv;
            prev_s = __shfl_sync(TEMPO_FULL_MASK, si, 31);
            affine_row_levels(d, v, c, lane, L);
            __syncwarp();   // every lane has read segment g's words of row g
            if (g == g0) {
                d0 = d;
                v0 = v;
            } else {
                ds[ladder_slot(g, lane)] = d;
                vs[ladder_slot(g, lane)] = v;
            }
        }
    };
    ring::warp_run(r, n, load, consume);
    __syncthreads();
    if (g0 < g1) {
        ds[ladder_slot(g0, lane)] = d0;
        vs[ladder_slot(g0, lane)] = v0;
    }
    __syncthreads();
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
        smem > (size_t)kEmaSmemLimit || ((uintptr_t)secs & 3) != 0 || ((uintptr_t)x & 3) != 0)
        return (int)cudaErrorInvalidValue;
    const int G = (L + 31) / 32;
    cudaStream_t st = (cudaStream_t)stream;
    return (int)(G <= 8 * 32
        ? launch_ring<8>(K, smem, st, secs, x, valid, step, alpha, scale, res, ema, L, T, depth)
        : launch_ring<16>(K, smem, st, secs, x, valid, step, alpha, scale, res, ema, L, T,
                          depth));
}
