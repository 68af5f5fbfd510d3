// The staging ring of the streaming kernels: an N-deep global -> shared
// memory input ring, each slot filled by 1-D bulk copies (the Tensor Memory
// Accelerator) that complete on the slot's own mbarrier.
//
// Replaces the Pallas mechanism tempo_tpu/ops/pallas_stream.py:
// _make_ring_kernel (through ring_call), which streams row slabs through a
// TEMPO_TPU_DMA_BUFFERS-slot VMEM ring with pltpu.make_async_copy and DMA
// semaphores, keeping depth - 1 copies in flight ahead of the compute.  On
// Hopper the same schedule is a loop inside one block: ring::run() starts
// the loads of work items 0 .. depth-2, then for each item i starts item
// i + depth - 1 into the slot item i - 1 just left, waits on item i's
// barrier and hands the slot to the caller's compute.  A slot's barrier
// completes once per use, so item i waits on phase parity (i / depth) & 1,
// as the reference waits on in_dma(i) before it reads slot i % depth.  The
// __syncthreads() after each item's compute is the reference's slot
// release: the next iteration refills that slot.
//
// Outputs leave by plain coalesced stores from registers: a store does not
// stall the thread that made it, so item i's writes drain while item
// i + 1 computes (the reference's double-buffered output staging; the
// kernels here have no shared memory left for an output pair, and Hopper
// needs none for the overlap).
//
// Alignment: a bulk copy moves a multiple of 16 bytes between 16-byte
// aligned addresses, and a work item starts anywhere (a 1-byte validity
// row starts every L bytes; a bucket window starts at a bucket head).
// stage() copies the 16-byte aligned span that covers the item's bytes and
// tells the caller where they start inside the slot; at the end of an
// allocation, where the span would read past it, the last few bytes are
// copied by the loading thread with plain loads before it arrives on the
// barrier (its arrive releases them to the waiting threads).  A plane of
// B bytes therefore needs plane_bytes(B) = align16(B) + 16 bytes of slot.
//
// Bound: the ring moves each byte of an item once; what it buys is
// overlap of the copy of item i + depth - 1 with the compute of item i.
//
// Two more shapes of the same ring serve kernels that cannot afford a
// block barrier an item:
//
// * run_synced() drops the slot-release barrier after each item, for a
//   consume() that synchronises the block after its last read of the
//   slot and whose other shared state needs no barrier: thread 0 refills
//   a slot only after that barrier of the item that used it.
// * a warp ring (WarpRing, warp_begin / warp_run): each warp owns its
//   barriers and slots, its lane 0 issues the copies, and __syncwarp()
//   releases a slot, so warps stream their own runs of items with no
//   block barrier.  stage_at() copies into a fixed place of a plane (an
//   address map fixed for the whole run) instead of a slot, for kernels
//   that land each item where it is consumed.
#pragma once

#include "common.cuh"

namespace ring {

constexpr int kMaxDepth = 8;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// slot bytes a plane of `bytes` bytes takes at any alignment
__host__ __device__ constexpr size_t plane_bytes(size_t bytes) { return align16(bytes) + 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

// make initialised barriers visible to the async proxy (the copy engine)
__device__ __forceinline__ void fence_bar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// order this thread's earlier shared-memory accesses before later
// async-proxy (bulk copy) accesses of the same memory
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// raise the current phase's transaction count by `bytes` (before the
// copies that complete them start)
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

// the loading thread's arrive: the phase completes once it has arrived and
// every expected byte has landed; it releases the thread's earlier plain
// shared-memory stores to the threads that wait on the phase
__device__ __forceinline__ void arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool try_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
    while (!try_wait(bar, parity)) {
    }
}

// 1-D bulk copy global -> shared, completing `bytes` of the barrier's
// transaction count (dst, src 16-byte aligned, bytes a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Start the copy of global bytes [src, src + nbytes) into the slot plane
// `dst` (16-byte aligned, plane_bytes(nbytes) long) on `bar`; `end` is
// the end of src's allocation.  Returns the offset in bytes of src inside
// dst.  Called by the loading thread only, before its arrive.
__device__ __forceinline__ uint32_t stage(void* dst, const void* src, size_t nbytes,
                                          const void* end, uint64_t* bar) {
    const uintptr_t a = (uintptr_t)src, e = a + nbytes;
    const uintptr_t a0 = a & ~(uintptr_t)15;
    uintptr_t b1 = (e + 15) & ~(uintptr_t)15;
    if (b1 > (uintptr_t)end) b1 = e & ~(uintptr_t)15;   // no read past the allocation
    if (b1 > a0) {
        expect_tx(bar, (uint32_t)(b1 - a0));
        bulk_load(dst, (const void*)a0, (uint32_t)(b1 - a0), bar);
    }
    unsigned char* d = (unsigned char*)dst;
    for (uintptr_t p = b1 > a0 ? b1 : a0; p < e; ++p) d[p - a0] = *(const unsigned char*)p;
    return (uint32_t)(a - a0);
}

// The ring's barriers: `depth` of them in shared memory.
struct Ring {
    uint64_t* bar;
    int depth;
};

// Initialise the barriers (one arrival a phase: the loading thread's).
// All threads of the block call it.
__device__ __forceinline__ void init(Ring r) {
    if (threadIdx.x == 0) {
        for (int d = 0; d < r.depth; ++d) bar_init(&r.bar[d], 1);
        fence_bar_init();
    }
    __syncthreads();
}

// Run consume(i, slot) for work items i = 0 .. n-1 in order, the loads of
// items i + 1 .. i + depth - 1 in flight meanwhile, with no block barrier
// of its own: consume(i, slot) must end its reads of the slot with a
// block barrier, which releases the slot.  load(i, slot, bar) runs on
// thread 0 and starts item i's copies into `slot` with stage().  All
// threads of the block call it, once per block (each slot's barrier phase
// counts from the kernel's start).
template <class Load, class Consume>
__device__ __forceinline__ void run_synced(Ring r, int n, Load load, Consume consume) {
    auto start = [&](int i) {
        const int slot = i % r.depth;
        fence_proxy_async();
        load(i, slot, &r.bar[slot]);
        arrive(&r.bar[slot]);
    };
    if (threadIdx.x == 0) {
        for (int i = 0; i < r.depth - 1 && i < n; ++i) start(i);
    }
    for (int i = 0; i < n; ++i) {
        const int slot = i % r.depth;
        // the slot of item i - 1, released by consume(i - 1)'s barrier
        if (threadIdx.x == 0 && i + r.depth - 1 < n) start(i + r.depth - 1);
        wait(&r.bar[slot], (uint32_t)((i / r.depth) & 1));
        consume(i, slot);
    }
}

// run_synced() with a block barrier after each consume(i, slot), for a
// consume that ends without one.
template <class Load, class Consume>
__device__ __forceinline__ void run(Ring r, int n, Load load, Consume consume) {
    run_synced(r, n, load, [&](int i, int slot) {
        consume(i, slot);
        __syncthreads();
    });
}

// Copy the global words [src, src + nbytes) (4-byte aligned, nbytes a
// multiple of 4) to `plane` + (src - base), base the 16-byte aligned
// address the plane's first byte stands for: the 16-byte aligned middle
// by a bulk copy on `bar`, the words before and after it by plain copies
// of the loading thread (released by its arrive).  Items that abut share
// no bulk span, so items staged one after the other into one plane never
// copy a byte twice.  Called by the loading thread only, before its arrive.
__device__ __forceinline__ void stage_at(void* plane, uintptr_t base, const void* src,
                                         size_t nbytes, uint64_t* bar) {
    const uintptr_t a = (uintptr_t)src, e = a + nbytes;
    const uintptr_t a1 = (a + 15) & ~(uintptr_t)15, e0 = e & ~(uintptr_t)15;
    unsigned char* d = (unsigned char*)plane;
    auto words = [&](uintptr_t p0, uintptr_t p1) {
        for (uintptr_t p = p0; p < p1; p += 4) *(uint32_t*)(d + (p - base)) = *(const uint32_t*)p;
    };
    if (a1 < e0) {
        expect_tx(bar, (uint32_t)(e0 - a1));
        bulk_load(d + (a1 - base), (const void*)a1, (uint32_t)(e0 - a1), bar);
        words(a, a1);
        words(e0, e);
    } else {
        words(a, e);
    }
}

// A warp's own ring: `depth` barriers of its own.
struct WarpRing {
    uint64_t* bar;
    int depth;
};

// Initialise the warp's barriers (one arrival a phase: its lane 0's) and
// start the loads of items 0 .. depth - 2.  All lanes of the warp call
// it; the warp may do other work before warp_run().
template <class Load>
__device__ __forceinline__ void warp_begin(WarpRing r, int n, Load load) {
    if ((threadIdx.x & 31) == 0) {
        for (int d = 0; d < r.depth; ++d) bar_init(&r.bar[d], 1);
        fence_bar_init();
        for (int i = 0; i < r.depth - 1 && i < n; ++i) {
            fence_proxy_async();
            load(i, i % r.depth, &r.bar[i % r.depth]);
            arrive(&r.bar[i % r.depth]);
        }
    }
    __syncwarp();
}

// ring::run for one warp after warp_begin(): lane 0 starts item
// i + depth - 1 into the slot item i - 1 left, the warp waits on item i
// and consumes it, and __syncwarp() releases its slot.
template <class Load, class Consume>
__device__ __forceinline__ void warp_run(WarpRing r, int n, Load load, Consume consume) {
    for (int i = 0; i < n; ++i) {
        const int slot = i % r.depth;
        if ((threadIdx.x & 31) == 0 && i + r.depth - 1 < n) {
            const int s = (i + r.depth - 1) % r.depth;
            fence_proxy_async();
            load(i + r.depth - 1, s, &r.bar[s]);
            arrive(&r.bar[s]);
        }
        wait(&r.bar[slot], (uint32_t)((i / r.depth) & 1));
        consume(i, slot);
        __syncwarp();
    }
}

}  // namespace ring
