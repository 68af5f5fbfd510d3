// The sequential EMA with an explicit carry, over rows of [R, L].
//
// Replaces no Pallas kernel: tempo_tpu/ops/rolling.py:485 ema_scan is a
// lax.scan, strictly left to right, and the serving steps
// (tempo_tpu/serve/state.py:_push_fn) run it on every push.  In PyTorch
// that scan is one launch a lane (three graph nodes a lane inside a CUDA
// graph), so it is written by hand here.
//
//   decay = valid ? 1 - a : 1      inp = valid ? a * x : 0
//   y[l]  = decay[l] * y[l - 1] + inp[l]      (y[-1] = y0, or 0)
//   ys = y, y_end = y[L - 1]
//
// Each step rounds twice (a multiply, then an add: the intrinsics below,
// and the library builds with -fmad=false), the plain version's two torch
// ops, so the result is bitwise that of ops/scan.py:ema_scan_plain and
// resuming from y_end at any split is bitwise one run over the whole row.
// No reassociation (a row split by the affine carry) is allowed: it would
// round differently, and serving's emissions must be the batch bits.
//
// Bound on H100, two of them.  Bytes: a read of x and valid and a write of ys
// (9 B a float32 lane; [2, 1024, 4096] moves 75.5 MB, 0.023 ms at
// 3.35 TB/s).  The chain: a row's lanes are one dependent multiply-add
// chain, L times the latency of __fmul_rn then __fadd_rn (about 8.6
// cycles, 4.35 ns at 1.98 GHz, measured by ema_chain_probe below; 4096
// lanes ~0.018 ms, 2^20 lanes ~4.6 ms).  Rows run in parallel, so a call
// takes at least the larger of the two.
//
// Design: a block is one scan warp (a thread a row, `rows` <= 32 rows)
// and three helper warps, which keep the scan warp fed and drained:
//
// * Loads: a ring of `depth` raw tiles ([rows, tile lanes] of x and
//   valid) in flight by 1-D bulk copies (ring.cuh's stage(): its 16-byte
//   spans and plain tail bytes, so any row length and any tensor offset
//   works), a row a loader lane, or, where the block's rows fit one tile
//   (serving's short rows), one contiguous span for all of them: every
//   load of a short row is in flight before its scan.  A bulk copy costs
//   the copy engine about the same however small, so the plan keeps
//   tiles wide (about 2048 / rows lanes).
// * Planes: each landed tile becomes the scan's decay and input planes,
//   16 bytes (four float32 lanes) at a time, rows an odd number of
//   16-byte words apart, so the scan warp's transposed 128-bit reads hit
//   distinct banks.
// * The scan warp only reads its two planes, runs the chain and writes y
//   over the input plane; the reads of the next eight lanes are started
//   before the chain of the current eight, so it never waits on memory.
// * Outputs: the helpers write each scanned tile out, a row's 16 bytes a
//   store where the row is 16-byte aligned.
//
// While the scan warp runs tile k the helpers write tile k - 1 out,
// prepare tile k + 1 in the other plane buffer and refill the ring: one
// block barrier a tile.  The plan (ops/scan.py:ema_scan_plan) spreads the
// rows over four blocks an SM, whose shared memory it keeps within a
// quarter SM; the scan warp of block b is warp b % 4, so the four blocks'
// chains run on the SM's four schedulers.  y0 is read and y_end written
// in the same launch.
#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int kThreads = 128;               // the scan warp and three helpers
constexpr int kHelpers = kThreads - 32;
constexpr int kMaxRows = 32;                // rows a block: a scan thread each

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// 16 bytes of T: one 128-bit shared-memory access (four float32 lanes,
// two float64)
template <typename T>
struct alignas(16) Pack {
    static constexpr int G = 16 / sizeof(T);
    T v[G];
};

// A block's shared memory: `depth` barriers, `depth` raw slots, then the
// scan planes (decay and input/output) in one buffer where the block's
// rows fit one tile (tile == L), else two.  A slot holds a plane a row of
// x and of valid (plane_bytes: any alignment), or, for one tile, one plane
// each spanning all the block's rows.  A scan plane's rows are an odd
// number of 16-byte words apart, so eight rows' 128-bit accesses at one
// lane hit distinct banks.
struct ScanLayout {
    size_t px, pv;     // bytes of a row's (or the span's) x and valid plane
    size_t raw_v;      // offset of the valid planes inside a slot
    size_t slot;       // bytes a slot
    size_t slots;      // offset of slot 0
    size_t planes;     // offset of the scan planes
    size_t plane;      // bytes a scan plane
    int stride;        // elements a row of a scan plane (an odd number of 16 bytes)
    size_t total;
};

__host__ __device__ inline ScanLayout scan_layout(int rows, int tile, int depth, int L,
                                                  int esize) {
    ScanLayout y;
    const bool whole = tile >= L;
    if (whole) {
        y.px = ring::plane_bytes((size_t)rows * L * esize);
        y.pv = ring::plane_bytes((size_t)rows * L);
        y.raw_v = y.px;
        y.slot = y.px + y.pv;
    } else {
        y.px = ring::plane_bytes((size_t)tile * esize);
        y.pv = ring::plane_bytes((size_t)tile);
        y.raw_v = (size_t)rows * y.px;
        y.slot = y.raw_v + (size_t)rows * y.pv;
    }
    y.stride = (int)(((ring::align16((size_t)tile * esize) / 16) | 1) * 16 / esize);
    y.plane = (size_t)rows * y.stride * esize;
    y.slots = ring::align16(8 * (size_t)depth);
    y.planes = y.slots + (size_t)depth * y.slot;
    y.total = y.planes + (whole ? 2 : 4) * y.plane;
    return y;
}

// Two packs of a row from the decay plane and the input plane.
template <typename T>
__device__ __forceinline__ void read(const T* d, const T* io, Pack<T> (&dr)[2],
                                     Pack<T> (&ir)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        dr[u] = ((const Pack<T>*)d)[u];
        ir[u] = ((const Pack<T>*)io)[u];
    }
}

// The chain over two packs: y = d * y + i, y written over i.
template <typename T>
__device__ __forceinline__ T chain(const Pack<T> (&d)[2], const Pack<T> (&i)[2], T* io, T y) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        Pack<T> out;
#pragma unroll
        for (int g = 0; g < Pack<T>::G; ++g) {
            y = add_rn(mul_rn(d[u].v[g], y), i[u].v[g]);
            out.v[g] = y;
        }
        ((Pack<T>*)io)[u] = out;
    }
    return y;
}

// One row's lanes [0, n) of a tile (d and io 16-byte aligned): y = d * y
// + i, y written over i.  Chunks of two packs alternate between two
// register sets, and each chunk's reads are started, unconditionally (the
// last chunk is read again rather than branched around, so the reads
// share the chain's basic block and the scheduler starts them first),
// before the chain of the chunk before it runs: the chain never waits on
// shared memory.
template <typename T>
__device__ __forceinline__ T scan_row(const T* d, T* io, int n, T y) {
    constexpr int U = 2 * Pack<T>::G;
    const int full = n / U;
    if (full > 0) {
        Pack<T> da[2], ia[2], db[2], ib[2];
        read(d, io, da, ia);
        int c = 0;
        for (; c + 2 <= full; c += 2) {
            read(d + (c + 1) * U, io + (c + 1) * U, db, ib);
            y = chain(da, ia, io + c * U, y);
            const int next = min(c + 2, full - 1) * U;
            read(d + next, io + next, da, ia);
            y = chain(db, ib, io + (c + 1) * U, y);
        }
        if (c < full) y = chain(da, ia, io + c * U, y);
    }
    for (int j = full * U; j < n; ++j) {
        y = add_rn(mul_rn(d[j], y), io[j]);
        io[j] = y;
    }
    return y;
}

__device__ __forceinline__ void helpers_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(kHelpers) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ema_scan_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid, T alpha,
                const T* __restrict__ y0, T* __restrict__ ys, T* __restrict__ y_end, int R,
                int L, int rows, int tile, int depth) {
    using PK = Pack<T>;
    constexpr int G = PK::G;
    extern __shared__ __align__(128) unsigned char sm[];
    const ScanLayout lay = scan_layout(rows, tile, depth, L, sizeof(T));
    uint64_t* bar = (uint64_t*)sm;
    unsigned char* slots = sm + lay.slots;
    T* planes = (T*)(sm + lay.planes);
    const size_t plane_n = lay.plane / sizeof(T);
    const int stride = lay.stride;
    // The scan warp is warp blockIdx % 4, so the scan warps of the blocks
    // an SM holds sit on different schedulers; role 0 scans, roles 1-3
    // help (role 1's lanes start the copies).
    const int lane = threadIdx.x & 31;
    const int role = ((threadIdx.x >> 5) - (int)(blockIdx.x & 3)) & 3;
    const int ht = (role - 1) * 32 + lane;  // a helper's index
    const size_t row0 = (size_t)blockIdx.x * rows;
    const int nrows = (int)min((size_t)rows, (size_t)R - row0);
    const bool whole = tile >= L;
    const int ntiles = whole ? 1 : (int)(((long long)L + tile - 1) / tile);
    const int loaders = whole ? 1 : nrows;  // lanes of role 1 that start copies
    const size_t n_all = (size_t)R * L;
    const uint32_t xrow = (uint32_t)L * (uint32_t)sizeof(T);   // a row's bytes, mod 2^32
    const T one = T(1), zero = T(0);
    const T d_valid = sub_rn(one, alpha);

    auto lanes_of = [&](int k) { return whole ? L : min(tile, L - k * tile); };
    // tile k's decay (which 0) and input/output (which 1) planes
    auto plane = [&](int k, int which) {
        return planes + (size_t)(2 * (k & 1) + which) * plane_n;
    };
    // a loader lane: start tile k's copies into its slot
    auto load = [&](int k) {
        const int s = k % depth;
        unsigned char* slot = slots + (size_t)s * lay.slot;
        ring::fence_proxy_async();
        if (whole) {
            const size_t off = row0 * L, n = (size_t)nrows * L;
            ring::stage(slot, x + off, n * sizeof(T), x + n_all, &bar[s]);
            ring::stage(slot + lay.raw_v, valid + off, n, valid + n_all, &bar[s]);
        } else {
            const size_t off = (row0 + lane) * L + (size_t)k * tile;
            const int n = lanes_of(k);
            ring::stage(slot + lane * lay.px, x + off, n * sizeof(T), x + n_all, &bar[s]);
            ring::stage(slot + lay.raw_v + lane * lay.pv, valid + off, n, valid + n_all,
                        &bar[s]);
        }
        ring::arrive(&bar[s]);
    };
    // Helpers walk a tile's packs e = r * ng + g (row r, lanes G g ..
    // G g + G - 1 of the tile's n) from their index in steps of kHelpers,
    // (r, g) carried without a division.  A pack past lane n reads and
    // writes the planes' padding only.
    auto walk = [&](int k, auto&& at) {
        const int n = lanes_of(k), ng = (n + G - 1) / G, total = nrows * ng;
        const int step_r = kHelpers / ng, step_g = kHelpers - step_r * ng;
        int r = ht / ng, g = ht - r * ng;
#pragma unroll 2
        for (int e = ht; e < total; e += kHelpers) {
            at(r, g * G, n);
            g += step_g;
            r += step_r;
            if (g >= ng) {
                g -= ng;
                ++r;
            }
        }
    };
    // helpers: wait for tile k and form its scan planes
    auto prep = [&](int k) {
        const int s = k % depth;
        ring::wait(&bar[s], (uint32_t)((k / depth) & 1));
        const unsigned char* slot = slots + (size_t)s * lay.slot;
        T* dp = plane(k, 0);
        T* ip = plane(k, 1);
        const size_t first = row0 * L + (size_t)k * tile;   // row 0's lane 0
        const uint32_t xa = (uint32_t)(uintptr_t)(x + first);
        const uint32_t va = (uint32_t)(uintptr_t)(valid + first);
        // every row's x (valid) starts on 16 (4) bytes: packs read whole
        const bool x_packs = ((xa | xrow) & 15) == 0;
        const bool v_words = G == 4 && ((va | (uint32_t)L) & 3) == 0;
        walk(k, [&](int r, int p, int) {
            // where stage() put row r: its span starts at the row's
            // address rounded down to 16 bytes (one span for all rows in
            // the one-tile form)
            const unsigned char* xr =
                slot + (whole ? (xa & 15) + r * xrow
                              : (uint32_t)(r * lay.px) + ((xa + r * xrow) & 15));
            const unsigned char* vr =
                slot + lay.raw_v +
                (whole ? (va & 15) + (uint32_t)(r * L)
                       : (uint32_t)(r * lay.pv) + ((va + r * (uint32_t)L) & 15));
            PK xv, d, i;
            uint32_t vw = 0;
            if (x_packs) {
                xv = *(const PK*)(xr + p * sizeof(T));
            } else {
#pragma unroll
                for (int g = 0; g < G; ++g) xv.v[g] = ((const T*)xr)[p + g];
            }
            if (v_words) {
                vw = *(const uint32_t*)(vr + p);
            } else {
#pragma unroll
                for (int g = 0; g < G; ++g) vw |= (uint32_t)vr[p + g] << (8 * g);
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const bool v = ((vw >> (8 * g)) & 0xff) != 0;
                d.v[g] = v ? d_valid : one;
                i.v[g] = v ? mul_rn(alpha, xv.v[g]) : zero;
            }
            *(PK*)(dp + r * stride + p) = d;
            *(PK*)(ip + r * stride + p) = i;
        });
    };
    // helpers: tile k's outputs to ys
    auto writeout = [&](int k) {
        const T* yp = plane(k, 1);
        T* out = ys + row0 * L + (size_t)k * tile;
        const bool y_packs = (((uint32_t)(uintptr_t)out | xrow) & 15) == 0;
        walk(k, [&](int r, int p, int n) {
            const PK yv = *(const PK*)(yp + r * stride + p);
            T* o = out + (size_t)r * L + p;
            if (y_packs && p + G <= n) {
                *(PK*)o = yv;
            } else {
#pragma unroll
                for (int g = 0; g < G; ++g)
                    if (p + g < n) o[g] = yv.v[g];
            }
        });
    };
    // helpers, after prep(k): tile k's slot takes tile k + depth
    auto refill = [&](int k) {
        if (k + depth < ntiles) {
            helpers_sync();
            if (role == 1 && lane < loaders) load(k + depth);
        }
    };

    if (role == 1 && lane == 0) {
        for (int s = 0; s < depth; ++s) ring::bar_init(&bar[s], (uint32_t)loaders);
        ring::fence_bar_init();
    }
    __syncthreads();
    if (role == 1 && lane < loaders) {
        for (int k = 0; k < depth; ++k) load(k);
    }
    T y = zero;
    if (role == 0 && lane < nrows && y0 != nullptr) y = y0[row0 + lane];
    if (role > 0) {
        prep(0);
        refill(0);
    }
    __syncthreads();
    for (int k = 0; k < ntiles; ++k) {
        if (role == 0) {
            if (lane < nrows)
                y = scan_row(plane(k, 0) + lane * stride, plane(k, 1) + lane * stride,
                             lanes_of(k), y);
        } else {
            if (k > 0) writeout(k - 1);
            if (k + 1 < ntiles) {
                if (k > 0) helpers_sync();   // tile k + 1 reuses tile k - 1's planes
                prep(k + 1);
                refill(k + 1);
            }
        }
        __syncthreads();
    }
    if (role > 0) {
        writeout(ntiles - 1);
    } else if (lane < nrows) {
        y_end[row0 + lane] = y;
    }
}

template <typename T>
int launch(const void* x, const void* valid, double alpha, const void* y0, void* ys,
           void* y_end, int R, int L, int rows, int tile, int depth, void* stream) {
    const size_t smem = scan_layout(rows, tile, depth, L, sizeof(T)).total;
    const long long tiles = tile >= L ? 1 : ((long long)L + tile - 1) / tile;
    if (R < 1 || L < 1 || rows < 1 || rows > kMaxRows || tile < 1 || tile > L ||
        depth < 1 || depth > ring::kMaxDepth || depth > tiles || smem > (size_t)kEmaSmemLimit)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            ema_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned blocks = (unsigned)(((long long)R + rows - 1) / rows);
    ema_scan_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const uint8_t*)valid, (T)alpha, (const T*)y0, (T*)ys, (T*)y_end, R, L,
        rows, tile, depth);
    return (int)cudaGetLastError();
}

// The chain bound's probe: one thread runs L dependent steps
// y = add_rn(mul_rn(d, y), i), d, i and y0 read from di[0..2], y written
// to out[0].  Its time over L is the latency of a step.
template <typename T>
__global__ void ema_chain_probe(const T* __restrict__ di, T* __restrict__ out, int L) {
    const T d = di[0], i = di[1];
    T y = di[2];
#pragma unroll 16
    for (int l = 0; l < L; ++l) y = add_rn(mul_rn(d, y), i);
    out[0] = y;
}

}  // namespace

// Shared memory of a block at the plan (rows, tile, depth) for rows of L
// lanes, for the planner's check on the card.
extern "C" long long tempo_ema_scan_smem(int rows, int tile, int depth, int L,
                                         int is_double) {
    return (long long)scan_layout(rows, tile, depth, L, is_double ? 8 : 4).total;
}

// x, valid, ys: [R, L] row-major; y0 (may be NULL: the zero carry) and
// y_end: [R].  (rows, tile, depth): the plan (ops/scan.py:ema_scan_plan):
// rows a block (<= 32), lanes a tile (tile == L: the block's rows are one
// tile), ring slots (<= the tiles a row).  is_double picks float64 over
// float32.  R >= 1, L >= 1.
extern "C" int tempo_ema_scan(const void* x, const void* valid, double alpha,
                              const void* y0, void* ys, void* y_end, int R, int L, int rows,
                              int tile, int depth, int is_double, void* stream) {
    return is_double
        ? launch<double>(x, valid, alpha, y0, ys, y_end, R, L, rows, tile, depth, stream)
        : launch<float>(x, valid, alpha, y0, ys, y_end, R, L, rows, tile, depth, stream);
}

// One launch of the chain probe: a single thread, L steps.
extern "C" int tempo_ema_chain_probe(const void* di, void* out, int L, int is_double,
                                     void* stream) {
    if (is_double)
        ema_chain_probe<double><<<1, 1, 0, (cudaStream_t)stream>>>((const double*)di,
                                                                   (double*)out, L);
    else
        ema_chain_probe<float><<<1, 1, 0, (cudaStream_t)stream>>>((const float*)di,
                                                                  (float*)out, L);
    return (int)cudaGetLastError();
}
