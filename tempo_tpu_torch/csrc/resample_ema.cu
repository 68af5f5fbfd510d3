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
//            (1 - alpha, alpha * xs) at heads, (1, 0) elsewhere, through
//            the ladder of common.cuh (ema_ladder.cu runs the same
//            association in registers)
//
// JAX's // on int32 floors, and C's / truncates toward zero, so seconds
// before 1970 are floored explicitly.  Pad lanes carry seconds that
// wrapped in the int32 cast; they are never valid, so they are never
// heads, and the lane after them is a pad too.  One block per row, the
// ladder's planes in shared memory (16 bytes a lane) or, past 227 KB, in
// a global scratch the wrapper allocates.  Every float op rounds to
// nearest (and the build passes -fmad=false), so the result is bitwise
// the plain version's on the card.
//
// Two forms, picked on the host by ops/stream.resample_plan: the row form
// (resample_ema_kernel) reads its inputs straight from global memory; the
// staged form (resample_ema_ring_kernel) keeps the whole row's ladder in
// shared memory and streams the fill pass's inputs (secs with one lane
// behind for the bucket compare, x, valid: 9 bytes a lane) in tiles of T
// lanes through ring.cuh's staging ring in the shared memory the ladder
// leaves (about 28 KB at 12,760 lanes).  The fill and the ladder are the
// same code, so both forms give the same bits.  Past the ladder's
// shared-memory limit, or where no tile fits beside it, the planner takes
// the row form.
//
// Bound on H100: bytes, one read of secs, x and valid and one write of
// res and ema (17 bytes a lane); the ladder's log2(L) passes run in
// shared memory.
#include "common.cuh"
#include "ring.cuh"

namespace {

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {  // b >= 1
    const int32_t q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Lane i's fill: res, and the ladder's (d, v) at the bucket heads; bucket
// of lane i from secs `si`, of lane i - 1 from `sp` (i > 0).
__device__ __forceinline__ void resample_fill(int i, int32_t si, int32_t sp, bool ok, float xi,
                                              int step, float alpha, float one_minus_a,
                                              float scale, float* res, EmaPlanes p) {
    const int32_t b = floor_div(si, step);
    const bool head = ok && (i == 0 || b != floor_div(sp, step));
    const float xs = __fmul_rn(xi, scale);
    res[i] = head ? xs : tempo_nan();
    p.d0[i] = head ? one_minus_a : 1.f;
    p.v0[i] = head ? __fmul_rn(alpha, xs) : 0.f;
}

__global__ void __launch_bounds__(kEmaThreads)
resample_ema_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                    const uint8_t* __restrict__ valid, int step, float alpha, float scale,
                    float* __restrict__ res, float* __restrict__ ema,
                    float* __restrict__ scratch, int L) {
    extern __shared__ float smem[];
    const size_t row = (size_t)blockIdx.x * L;
    const EmaPlanes p = ema_planes(smem, scratch, L);

    const float one_minus_a = __fsub_rn(1.f, alpha);
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
        resample_fill(i, secs[row + i], i > 0 ? secs[row + i - 1] : 0, valid[row + i] != 0,
                      x[row + i], step, alpha, one_minus_a, scale, res + row, p);
    }
    __syncthreads();
    const float* y = ema_ladder(p, L);
    for (int i = threadIdx.x; i < L; i += blockDim.x) ema[row + i] = y[i];
}

// Shared memory of the staged form, in bytes (ops/stream.resample_ring_bytes
// mirrors the total): the ring's barriers, the ladder's four planes of L
// floats, then `depth` slots of a tile's secs (and the lane behind it), x
// and valid.
struct ResampleRingLayout {
    size_t ladder, slots, s_plane, x_plane, v_plane, slot, total;
};

__host__ __device__ inline ResampleRingLayout resample_ring_layout(int L, int T, int depth) {
    ResampleRingLayout y;
    y.ladder = 8 * ring::kMaxDepth;
    y.slots = y.ladder + 4 * 4 * ring::align16((size_t)L);
    y.s_plane = ring::plane_bytes(4 * ((size_t)T + 1));
    y.x_plane = ring::plane_bytes(4 * (size_t)T);
    y.v_plane = ring::plane_bytes((size_t)T);
    y.slot = y.s_plane + y.x_plane + y.v_plane;
    y.total = y.slots + (size_t)depth * y.slot;
    return y;
}

__global__ void __launch_bounds__(kEmaThreads)
resample_ema_ring_kernel(const int32_t* __restrict__ secs, const float* __restrict__ x,
                         const uint8_t* __restrict__ valid, int step, float alpha, float scale,
                         float* __restrict__ res, float* __restrict__ ema, int K, int L, int T,
                         int depth) {
    extern __shared__ __align__(16) unsigned char sm[];
    const ResampleRingLayout lay = resample_ring_layout(L, T, depth);
    const ring::Ring r{(uint64_t*)sm, depth};
    float* lad = (float*)(sm + lay.ladder);
    const size_t ls = ring::align16((size_t)L);
    const EmaPlanes p{lad, lad + ls, lad + 2 * ls, lad + 3 * ls};
    const size_t row = (size_t)blockIdx.x * L;
    const size_t n_all = (size_t)K * L;
    const int nt = (L + T - 1) / T;
    const float one_minus_a = __fsub_rn(1.f, alpha);
    ring::init(r);

    auto slot_base = [&](int slot) { return sm + lay.slots + (size_t)slot * lay.slot; };
    auto load = [&](int t, int slot, uint64_t* bar) {
        const int t0 = t * T;
        const int lo = t0 > 0 ? t0 - 1 : 0;
        const int hi = min(L, t0 + T);
        unsigned char* b = slot_base(slot);
        ring::stage(b, secs + row + lo, 4 * (size_t)(hi - lo), secs + n_all, bar);
        ring::stage(b + lay.s_plane, x + row + t0, 4 * (size_t)(hi - t0), x + n_all, bar);
        ring::stage(b + lay.s_plane + lay.x_plane, valid + row + t0, (size_t)(hi - t0),
                    valid + n_all, bar);
    };
    auto consume = [&](int t, int slot) {
        const int t0 = t * T;
        const int lo = t0 > 0 ? t0 - 1 : 0;
        const int hi = min(L, t0 + T);
        unsigned char* b = slot_base(slot);
        const int32_t* ss = (const int32_t*)(b + ((uintptr_t)(secs + row + lo) & 15));
        const float* xs = (const float*)(b + lay.s_plane + ((uintptr_t)(x + row + t0) & 15));
        const uint8_t* vs =
            b + lay.s_plane + lay.x_plane + ((uintptr_t)(valid + row + t0) & 15);
        for (int i = t0 + threadIdx.x; i < hi; i += blockDim.x) {
            resample_fill(i, ss[i - lo], i > 0 ? ss[i - 1 - lo] : 0, vs[i - t0] != 0,
                          xs[i - t0], step, alpha, one_minus_a, scale, res + row, p);
        }
    };
    ring::run(r, nt, load, consume);
    const float* y = ema_ladder(p, L);
    for (int i = threadIdx.x; i < L; i += blockDim.x) ema[row + i] = y[i];
}

}  // namespace

extern "C" int tempo_resample_ema(const void* secs, const void* x, const void* valid,
                                  int step, float alpha, float scale, void* res, void* ema,
                                  void* scratch, int K, int L, void* stream) {
    size_t smem;
    cudaError_t err = ladder_smem(resample_ema_kernel, scratch, L, 4, &smem);
    if (err != cudaSuccess) return (int)err;
    resample_ema_kernel<<<K, kEmaThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, step, alpha, scale,
        (float*)res, (float*)ema, (float*)scratch, L);
    return (int)cudaGetLastError();
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
    if (depth < 2 || depth > ring::kMaxDepth || T < 32 || T % 32 != 0 ||
        smem > (size_t)kEmaSmemLimit)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        resample_ema_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    resample_ema_ring_kernel<<<K, kEmaThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)secs, (const float*)x, (const uint8_t*)valid, step, alpha, scale,
        (float*)res, (float*)ema, K, L, T, depth);
    return (int)cudaGetLastError();
}
