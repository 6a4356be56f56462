// G D2Q9 BGK timesteps per launch on every shard of a row-sharded lattice
// with each shard's rows on chip: the shard's strips in shared memory for
// all G steps, seam rows through the ring's slots, on a CUDA device
// (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/parallel/resident_ring.py::_kernel_ring
// (launched by _pallas_ring) in its TPU design, the shard resident in fast
// memory for G steps and its boundary rows traded with its ring
// neighbours inside the kernel, in both of its buffer modes: two buffers
// (kBufs 2) and the in-place mode (kBufs 1; inplace=True,
// one_step_inplace, LBM_RESIDENT_INPLACE). ring.cu is the device-memory
// form of the same kernel, for shards whose strips do not fit
// (parallel/resident_ring.py: ring_form).
//
// What bounds it: while the strips fit, no lattice byte crosses L2
// between the first load and the last store, so a step is the cell update
// (issue-bound, as the depth kernel's stages) plus what a strip waits for
// its neighbours' rows, as in the single-device on-chip form
// (resident_onchip.cu), whose strip step (lbm_onchip.cuh) every block here
// runs. The design:
//
// - One cooperative launch per card hosts every shard on that card, its
//   blocks split evenly among them (bps blocks a shard, one an SM at
//   most; a launch of more than can be co-resident is refused), as ring.cu
//   does. A shard's h rows are split into bps strips that differ by at
//   most one row; block lb of shard s owns strip lb.
// - The strips of all shards form one ring: strip lb's neighbours are lb
//   + 1 and lb - 1 of its shard, and the top strip's north neighbour is the
//   north shard's strip 0, the bottom strip's south neighbour the south
//   shard's strip bps - 1. Each strip has two slots a direction in its
//   shard's memory, of halo values that carry their step's tag (one 64-bit
//   word each, lbm_onchip.cuh); a strip at a shard's edge stores into the
//   neighbouring shard's edge strip's slot, through peer pointers when
//   that shard is on another card (system-scope words in a launch where
//   some neighbour is on another card: kCross, an instantiation of its own,
//   so that one card's launches carry no system-scope path). Step tags go
//   on across a wrapper's launches (step_base), so the slot protocol of
//   the single-device form (two slots, each reader waiting on its own
//   words for its step's tag) holds across shards, launches and cards: a
//   card's launch that starts before a neighbour's has ended writes a slot
//   only behind that neighbour's words of the step before, as within a
//   launch.
// - Forcing: row mode by global row (the shard's row0 plus the strip's
//   row), column mode at lane column nx-2 in every shard. The owner forces
//   the copies it sends; in one buffer the line is forced in place before
//   the send (lbm_onchip.cuh).
// - tot_u per shard: each strip's per-step partial, then the shard's last
//   block (an integer ticket a shard) sums its strips' partials in strip
//   order. No float atomics.
// - G is even, as in the JAX kernel, so the result is in each shard's
//   cells in both modes: two buffers end in the buffer they started from,
//   one buffer updates it in place.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/parallel/
// resident_ring.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lbm_onchip.cuh"

namespace {

using namespace onchip;

// One shard as the kernel sees it (the layout of resident_ring.py's
// RingStripShard ctypes structure).
struct RingStripShard {
    float* cells;               // (9, h, nx), in place
    const uint8_t* mask;        // (h, nx)
    Word* halo;                 // (bps, 2, 2, kHalo, nx) words: [strip][0
                                // south / 1 north][slot]
    float* partials;            // (gsteps, bps)
    unsigned* ticket;           // zero between launches
    float* tots;                // per-step tot_u of the shard
    Word* north_slots;          // the north shard's strip 0 south slots
    Word* south_slots;          // the south shard's last strip's north slots
    long long row0;             // global index of row 0
};

// One launch's arguments, the same for every shard of it.
struct RingStrips {
    const RingStripShard* shards;
    int bps, h, nx, ny_global, accel;
    float w1, w2, omega;
    int gsteps;
    unsigned step_base;
    int t_out;
};

template <bool kCols, int kMode, int kBufs, bool kCross>
__global__ void __launch_bounds__(kThreads, 1)
ring_onchip_kernel(const RingStrips r) {
    using Scope = typename std::conditional<kCross, SystemScope,
                                            DeviceScope>::type;
    const RingStripShard& sh = r.shards[blockIdx.x / r.bps];
    const int bps = r.bps, lb = blockIdx.x % bps, nx = r.nx;
    const int base = r.h / bps, rem = r.h % bps;
    const int h = base + (lb < rem ? 1 : 0);
    const int r0 = lb * base + (lb < rem ? lb : rem);
    const size_t pair = (size_t)2 * kHalo * nx;
    Word* halo = sh.halo;
    const bool top = lb + 1 == bps, bottom = lb == 0;
    const Strip st{h, (int)sh.row0 + r0, r.ny_global,
                   top ? sh.north_slots : halo + (size_t)((lb + 1) * 2) * pair,
                   bottom ? sh.south_slots
                          : halo + (size_t)((lb - 1) * 2 + 1) * pair,
                   halo + (size_t)(lb * 2) * pair,
                   halo + (size_t)(lb * 2 + 1) * pair};
    const size_t goff = (size_t)r0 * nx;
    const long long hmax_nx = strip_floats(r.h, nx, bps);
    strip_steps<kCols, kMode, kBufs, Scope>(
        st, sh.cells + goff, sh.cells + goff, sh.mask + goff,
        (size_t)r.h * nx, nx, r.accel, r.w1, r.w2, r.omega, r.gsteps,
        r.step_base, hmax_nx, carry_floats(r.h, nx, bps), sh.partials + lb,
        bps);
    sum_partials_last(sh.ticket, bps, sh.partials, sh.tots + r.t_out,
                      r.gsteps, 1.0f, hmax_nx, kBufs);
}

template <int kBufs, bool kCross>
const void* ring_fn_bufs(int axis, int mode) {
    if (axis) {
        return mode == 1
                   ? (const void*)ring_onchip_kernel<true, 1, kBufs, kCross>
               : mode == 2
                   ? (const void*)ring_onchip_kernel<true, 2, kBufs, kCross>
                   : (const void*)ring_onchip_kernel<true, 0, kBufs, kCross>;
    }
    return mode == 1 ? (const void*)ring_onchip_kernel<false, 1, kBufs, kCross>
           : mode == 2
               ? (const void*)ring_onchip_kernel<false, 2, kBufs, kCross>
               : (const void*)ring_onchip_kernel<false, 0, kBufs, kCross>;
}

const void* ring_fn(int axis, int mode, int bufs, bool cross) {
    if (cross) {
        return bufs == 1 ? ring_fn_bufs<1, true>(axis, mode)
                         : ring_fn_bufs<2, true>(axis, mode);
    }
    return bufs == 1 ? ring_fn_bufs<1, false>(axis, mode)
                     : ring_fn_bufs<2, false>(axis, mode);
}

}  // namespace

extern "C" {

// Opt the on-chip ring kernel of forcing mode axis, association mode,
// buffer count and scope (cross: some neighbour on another card) into
// bytes of dynamic shared memory a block and check that blocks of them
// (every shard's on this card) can be co-resident. 0, or a CUDA error code
// (cudaErrorNotSupported: no cooperative launch;
// cudaErrorCooperativeLaunchTooLarge: too many blocks).
int lbm_ring_onchip_prepare(int axis, int mode, int bufs, int cross,
                            long long bytes, int blocks, int device) {
    if (bufs != 1 && bufs != 2) return (int)cudaErrorInvalidValue;
    return prepare(ring_fn(axis, mode, bufs, cross != 0), bytes, blocks,
                   device);
}

// gsteps steps (even) on the n_shards shards of shards (a device array of
// RingStripShard, all on this device), bps strips each of the h x nx
// shard, in bufs buffers (2, or 1: in place), as one cooperative launch;
// the result is in each shard's cells. step_base: steps these slots have
// run before (every shard of the ring the same); t_out: where
// in each shard's tots this call's gsteps values go. axis 0 forces global
// row ny_global - 2, axis 1 (shards of a transposed lattice) column
// nx - 2 of every row. cross: a neighbour of some shard is on another
// card. lbm_ring_onchip_prepare has run for the same axis, mode, bufs,
// cross, bytes and n_shards * bps blocks.
int lbm_ring_onchip(const void* shards, int n_shards, int bps, int h, int nx,
                    int ny_global, float w1, float w2, float omega, int mode,
                    int axis, int bufs, int gsteps, unsigned step_base,
                    int t_out, int cross, int device, void* stream) {
    if (n_shards < 1 || bps < 1 || bps > h || gsteps < 2 || gsteps % 2 ||
        (bufs != 1 && bufs != 2)) {
        return (int)cudaErrorInvalidValue;
    }
    // One buffer defers stores by at most three waves (inplace_delay).
    if (bufs == 1 && (h + bps - 1) / bps >= 2 && nx + 1 > 3 * kThreads) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    RingStrips r{(const RingStripShard*)shards, bps, h, nx, ny_global,
                 axis ? (nx - 2) % nx : (ny_global - 2) % ny_global,
                 w1, w2, omega, gsteps, step_base, t_out};
    void* args[] = {&r};
    return launch(ring_fn(axis, mode, bufs, cross != 0), n_shards * bps,
                  args, smem_bytes(h, nx, bps, bufs), stream);
}

}  // extern "C"
