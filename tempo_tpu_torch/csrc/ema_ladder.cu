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
// Design: common.cuh's register ladder (ema_block, and class_ladder for
// rows past kRowMax = 16,384 lanes), the fill (d, v) = (1-a, a x) at valid
// lanes and (1, 0) elsewhere.  A row of up to 16,384 lanes is one block's
// registers and one shared-memory transpose (8 bytes a lane; HHAR's 12,760
// lanes, 102 KB); longer rows take two launches, stage 1 on windows with a
// 1024-lane halo writing v and a [K, L] d plane the wrapper allocates,
// stage 2 along the residue classes mod 1024; past 14,876,672 lanes, where
// a class outgrows shared memory, stage 2 runs windowed and a third stage
// along the classes mod 2^18 finishes the ladder (every int32 row length).
//
// Traffic at phase F's [128, 102056]: x and valid read about 1.14 times
// (the halo), v and d written, read and v written again: about 26 bytes a
// lane, against the function's 9.
#include "common.cuh"

namespace {

struct EmaFill {
    const float* __restrict__ x;
    const uint8_t* __restrict__ valid;
    float alpha, one_minus_a;
    __device__ __forceinline__ void operator()(size_t at, long long, bool in, bool, float& d,
                                               float& v) const {
        const bool ok = in && valid[at] != 0;
        const float xv = x[at];
        d = ok ? one_minus_a : 1.f;
        v = ok ? __fmul_rn(alpha, xv) : 0.f;
    }
};

}  // namespace

// rows the one-launch form takes; longer rows need the wrapper's d plane
extern "C" long long tempo_ema_row_max() { return kRowMax; }

// longest row the kernel takes: int32 lane indices (the class stages take
// any length)
extern "C" long long tempo_ema_max_lanes() { return INT_MAX; }

extern "C" int tempo_ema_ladder(const void* x, const void* valid, float alpha, void* out,
                                void* dplane, int K, int L, void* stream) {
    const EmaFill fill{(const float*)x, (const uint8_t*)valid, alpha, 1.f - alpha};
    return (int)launch_ema_ladder(fill, (float*)out, (float*)dplane, K, L, (cudaStream_t)stream);
}
