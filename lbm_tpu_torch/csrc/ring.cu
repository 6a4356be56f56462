// G D2Q9 BGK timesteps per launch on every shard of a row-sharded lattice,
// in rounds of D steps with D-row halos exchanged between rounds inside
// the kernel, on a CUDA device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/parallel/resident_ring.py::_kernel_ring
// (launched by _pallas_ring): each shard keeps its state for G steps and
// trades its boundary rows with its ring neighbours inside the kernel,
// through 2-slot halo buffers with one signal per (direction, slot). On
// the TPU the rows move by remote DMA with semaphores, one row a step;
// here they are stores into the neighbour's halo slot (a peer pointer when
// the neighbour is on another card) and a flag per (direction, slot) with
// release/acquire semantics, D rows every D steps.
//
// What bounds it: above the 50 MB L2 (1024x1024 over 4 shards: two 37.7 MB
// lattices), a form that steps the lattice in device memory once a step
// pays a pass over it every step (73 B a cell: the step-a-round form this
// replaces, 1.68x its design ceiling, PERF.md). This one steps D at a
// time in shared memory, as the depth kernel does (fused_depth.cu,
// lbm_depth.cuh), so the lattice crosses device memory once per D steps
// and the stages on shared memory, issue-bound, are what is left. The
// design:
//
// - One cooperative launch per card hosts every shard on that card, its
//   blocks split evenly among them (bps blocks a shard, two an SM). Shards
//   are coupled only through the halo slots and flags, on one card or
//   several, so P shards on one card run the same protocol as P cards.
//   Each shard has its own barrier (an atomic counter with a generation,
//   safe because cooperative blocks are co-resident); there is no grid
//   barrier.
// - A block is a depth-kernel block: the (TY + 2D) x (32 + 2 HX) window of
//   all nine speeds and the mask in dynamic shared memory, one thread a
//   group of V cells; it takes the shard's tiles in turn (a stride of
//   bps) and runs each through lbm_depth_tile, the depth kernel's own
//   stages in seam mode, as a call (ring_tile) and not inlined: the round
//   loop's state is saved once a tile around the call instead of
//   crowding the stages' 48 registers (3-5 % faster, PERF.md).
// - Round k (slot s = round mod 2, tag round + 1, rounds counted on from
//   earlier calls): (a) the shard's blocks copy its pre-round top D rows,
//   nine speeds, raw, into the north neighbour's south slot s and its
//   bottom D rows into the south neighbour's north slot s, each block a
//   share; (b) the block that completes the round's count of shares
//   publishes the neighbours' flags for slot s; (c) the blocks run the
//   interior tiles, whose windows lie inside the shard (tile rows 1 ..
//   (h - D) / TY - 1); (d) a block that comes to an edge tile first waits
//   with acquire semantics until both of its shard's flags for slot s
//   hold the tag; (e) it runs the edge tiles (the first tile row and the
//   rows past the interior ones), whose window rows outside the shard
//   come from the slots and are forced by their global row at every
//   stage (column mode: column nx-2 of every row, halo rows included);
//   (f) the round ends at the shard barrier. One barrier per D steps.
// - Why two slots with a flag each: a shard writes slot s in round t only
//   after its round t-1 wait for both neighbours' round t-1 flags, which
//   they published after finishing round t-2, the last round that read
//   slot s. One flag shared by both slots lets a round-t wait pass on the
//   round t+1 signal: the JAX package measured silent wrong trajectories
//   that way (tests/test_ring.py); tests/test_torch_ring.py models both.
// - Fences: one release fence a block a round behind its share, at device
//   scope, at system scope where a neighbour is on another card; flags
//   are system-scope atomics.
// - Per-step tot_u: each (step, tile) gets the partial the seam depth
//   kernel gives it (the same thread, warp and tile map); after the last
//   round the shard's blocks sum each round's D rows of partials in tile
//   order (lbm_reduce.cuh's lbm_sum_rows, as the depth kernel's
//   epilogue), so a step's tot of a shard has the bits of
//   SeamShardImpl(ss, D). No float atomics.
// - D is 2 or 4 (parallel/resident_ring.py picks the first of
//   plan.AUTO_DEPTHS that divides G and fits the shard's rows). After an
//   odd number of rounds the result is in b; the wrapper swaps.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/parallel/
// resident_ring.py.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_depth.cuh"

namespace {

// One shard as the kernel sees it (the layout of resident_ring.py's
// RingShard ctypes structure).
struct RingShard {
    float* a;                  // (9, h, nx): the state at even rounds
    float* b;                  // (9, h, nx): the state at odd rounds
    const uint8_t* mask;       // (h, nx)
    float* halo_s;             // (2, 9, D, nx): this shard's south slots
    float* halo_n;             // (2, 9, D, nx): this shard's north slots
    const uint8_t* hmask_s;    // (D, nx): mask rows below row 0
    const uint8_t* hmask_n;    // (D, nx): mask rows above row h-1
    float* north_halo_s;       // the north neighbour's halo_s
    float* south_halo_n;       // the south neighbour's halo_n
    unsigned* sync;            // flag_s[2], flag_n[2], barrier count and
                               // generation, shares sent
    unsigned* north_sync;      // the north neighbour's sync
    unsigned* south_sync;      // the south neighbour's sync
    float* partials;           // (gsteps, n_tiles)
    float* tots;               // per-step tot_u of the shard
    long long row0;            // global index of row 0
};

// One launch's arguments, the same for every shard of it.
struct Ring {
    const RingShard* shards;
    int bps, h, nx, ny_global, accel;
    float w1, w2, omega;
    int mode, gsteps;
    unsigned round_base;
    int t_out;
    int tiles_x, n_tiles, n_inner;
    bool vec, cross;
};

using SysFlag = cuda::atomic_ref<unsigned, cuda::thread_scope_system>;
using DevCounter = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;

// All bps blocks of one shard meet here; prior writes of every block are
// visible to every block after it.
__device__ void shard_barrier(unsigned* sync, unsigned bps) {
    __syncthreads();
    if (threadIdx.x == 0) {
        DevCounter count(sync[4]), gen(sync[5]);
        const unsigned g = gen.load(cuda::memory_order_relaxed);
        __threadfence();
        if (count.fetch_add(1, cuda::memory_order_acq_rel) == bps - 1) {
            count.store(0, cuda::memory_order_relaxed);
            gen.store(g + 1, cuda::memory_order_release);
        } else {
            while (gen.load(cuda::memory_order_acquire) == g) {
            }
        }
        __threadfence();
    }
    __syncthreads();
}

__device__ __forceinline__ void release_fence(bool cross) {
    if (cross) {
        __threadfence_system();
    } else {
        __threadfence();
    }
}

template <int D, bool kCols, int kMode>
__device__ __noinline__ void ring_tile(const Args& a, float* buf, int tile,
                                       float* part, size_t n_tiles) {
    lbm_depth_tile<D, true, kCols, kMode>(a, buf, tile, part, n_tiles);
}

template <int D, bool kCols, int kMode>
__device__ __forceinline__ void ring_block(const Ring& r, float* buf) {
    using G = Geo<D, kCellsPerThread<kCols>>;
    // The shard's pointers and the round's tile arguments live in shared
    // memory, not in registers.
    __shared__ RingShard S;
    __shared__ Args A;
    const int tid = threadIdx.x;
    const int lb = blockIdx.x % r.bps;
    const int bps = r.bps, h = r.h, nx = r.nx;
    if (tid == 0) S = r.shards[blockIdx.x / bps];
    __syncthreads();
    const size_t plane = (size_t)h * nx, rows = (size_t)D * nx;
    const size_t slot_size = 9 * rows;
    const int rounds = r.gsteps / D;

    for (int k = 0; k < rounds; ++k) {
        const unsigned round = r.round_base + (unsigned)k, tag = round + 1;
        const int slot = (int)(round & 1u);
        const float* src = (k & 1) ? S.b : S.a;
        float* dst = (k & 1) ? S.a : S.b;
        if (tid == 0) {
            A = Args{src, dst, S.mask, nullptr, 1.0f, nullptr, h, nx,
                     r.accel, r.w1, r.w2, r.omega, kMode, r.tiles_x,
                     r.n_tiles, r.vec,
                     Halo{S.halo_s + slot * slot_size,
                          S.halo_n + slot * slot_size, S.hmask_s, S.hmask_n,
                          D, (int)S.row0, r.ny_global}};
        }

        // (a) Send: each block its share of the top D rows (north) and the
        // bottom D rows (south), each speed's D rows one contiguous run.
        {
            float* to_n = S.north_halo_s + slot * slot_size;
            float* to_s = S.south_halo_n + slot * slot_size;
            const float* top = src + (size_t)(h - D) * nx;
            if (r.vec) {
                const int run = (int)(rows / 4), total = 9 * run;
                const int share = (total + bps - 1) / bps;
                const int end = min(total, (lb + 1) * share);
                for (int i = lb * share + tid; i < end; i += G::kThreads) {
                    const int q = i / run, o = i - q * run;
                    const float4 vt =
                        reinterpret_cast<const float4*>(top + q * plane)[o];
                    const float4 vb =
                        reinterpret_cast<const float4*>(src + q * plane)[o];
                    __stcg(reinterpret_cast<float4*>(to_n + q * rows) + o, vt);
                    __stcg(reinterpret_cast<float4*>(to_s + q * rows) + o, vb);
                }
            } else {
                const int run = (int)rows, total = 9 * run;
                const int share = (total + bps - 1) / bps;
                const int end = min(total, (lb + 1) * share);
                for (int i = lb * share + tid; i < end; i += G::kThreads) {
                    const int q = i / run, o = i - q * run;
                    __stcg(to_n + q * rows + o, top[q * plane + o]);
                    __stcg(to_s + q * rows + o, src[q * plane + o]);
                }
            }
            __syncthreads();
            // (b) One fence a block for its share (ordered before it by the
            // barrier); the block that completes the round's count
            // publishes both flags.
            if (tid == 0) {
                release_fence(r.cross);
                const unsigned done = DevCounter(S.sync[6]).fetch_add(
                    1, cuda::memory_order_acq_rel);
                if (done + 1 == tag * (unsigned)bps) {
                    release_fence(r.cross);
                    SysFlag(S.north_sync[slot]).store(
                        tag, cuda::memory_order_release);
                    SysFlag(S.south_sync[2 + slot]).store(
                        tag, cuda::memory_order_release);
                }
            }
        }

        // (c)-(e) The block's tiles: interior tiles (tile rows 1 ..
        // n_inner / tiles_x) first, then the edge tiles (tile row 0 and the
        // rows past the interior ones) once both slots hold this round's
        // rows. j runs over the interior tiles, then the edge ones, in
        // strides of bps.
        float* part = S.partials + (size_t)k * D * r.n_tiles;
        bool waited = false;
        // Not needed for order (the send's barrier is), but without it
        // ptxas spills more in the round loop and the tile (212 / 200 B
        // against 140 / 152 in row mode at D = 4) and the ring took 9-11 %
        // longer a step (PERF.md).
        __syncthreads();
        for (int j = lb; j < r.n_tiles; j += bps) {
            int tile;
            if (j < r.n_inner) {
                tile = r.tiles_x + j;
            } else {
                if (!waited) {
                    // Two threads wait on the two flags at once; the
                    // barrier orders the block's halo loads after their
                    // acquires.
                    if (tid == 0 || tid == 32) {
                        SysFlag from(S.sync[tid ? 2 + slot : slot]);
                        while (from.load(cuda::memory_order_acquire) < tag) {
                        }
                    }
                    __syncthreads();
                    waited = true;
                }
                const int e = j - r.n_inner;
                tile = e < r.tiles_x ? e : e + r.n_inner;
            }
            ring_tile<D, kCols, kMode>(A, buf, tile, part,
                                       (size_t)r.n_tiles);
        }
        // (f)
        shard_barrier(S.sync, (unsigned)bps);
    }

    // Each round's D steps of partials, summed in tile order: block lb of
    // the shard takes rounds lb, lb + bps, ...
    for (int k = lb; k < rounds; k += bps) {
        lbm_sum_rows<D>(S.partials + (size_t)k * D * r.n_tiles, nullptr,
                        r.n_tiles, 1.0f, S.tots + r.t_out + k * D, tid);
        __syncthreads();
    }
}

template <int D, bool kCols>
__global__ void __launch_bounds__(Geo<D, kCellsPerThread<kCols>>::kThreads, 2)
ring_kernel(const Ring r) {
    extern __shared__ float4 smem[];
    float* buf = reinterpret_cast<float*>(smem);
    switch (r.mode) {
        case 1: ring_block<D, kCols, 1>(r, buf); break;
        case 2: ring_block<D, kCols, 2>(r, buf); break;
        default: ring_block<D, kCols, 0>(r, buf); break;
    }
}

template <int D, bool kCols>
struct RingGeo {
    using G = Geo<D, kCellsPerThread<kCols>>;
    static const void* fn() { return (const void*)ring_kernel<D, kCols>; }
};

// The kernel of depth and axis, its threads and its dynamic shared memory;
// false for a depth it does not take.
bool ring_kernel_of(int depth, int axis, const void** fn, int* threads,
                    size_t* bytes) {
    if (depth == 2 && !axis) {
        *fn = RingGeo<2, false>::fn();
        *threads = RingGeo<2, false>::G::kThreads;
        *bytes = RingGeo<2, false>::G::kBytes;
    } else if (depth == 2) {
        *fn = RingGeo<2, true>::fn();
        *threads = RingGeo<2, true>::G::kThreads;
        *bytes = RingGeo<2, true>::G::kBytes;
    } else if (depth == 4 && !axis) {
        *fn = RingGeo<4, false>::fn();
        *threads = RingGeo<4, false>::G::kThreads;
        *bytes = RingGeo<4, false>::G::kBytes;
    } else if (depth == 4) {
        *fn = RingGeo<4, true>::fn();
        *threads = RingGeo<4, true>::G::kThreads;
        *bytes = RingGeo<4, true>::G::kBytes;
    } else {
        return false;
    }
    return true;
}

}  // namespace

extern "C" {

// Co-resident blocks of the ring kernel of this depth in forcing mode
// axis (0 rows, 1 columns) on this device (occupancy with its shared
// memory x SMs). Negative: a CUDA error code, negated
// (cudaErrorNotSupported when the device takes no cooperative launch,
// cudaErrorInvalidValue for a depth the kernel does not take).
int lbm_ring_blocks(int depth, int axis, int device) {
    const void* fn;
    int threads;
    size_t bytes;
    if (!ring_kernel_of(depth, axis, &fn, &threads, &bytes)) {
        return -(int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return -(int)err;
    if (!coop) return -(int)cudaErrorNotSupported;
    err = depth_opt_in(fn, device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        bytes);
    if (err != cudaSuccess) return -(int)err;
    return per_sm * sms;
}

// Peer access from device to peer, for halo slots and flags of shards on
// another card. Already enabled is not an error.
int lbm_enable_peer_access(int device, int peer) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
        return 0;
    }
    return (int)err;
}

// gsteps steps (a multiple of depth, 2 or 4, and depth <= h) on the
// n_shards shards of shards (a device array of RingShard, all on this
// device), bps blocks each, as one cooperative launch. The result is in
// each shard's a after an even number of rounds (gsteps / depth), in its b
// after an odd one. round_base: rounds this ring has run before (the
// flags' tags go on from there); t_out: where in each shard's tots this
// call's gsteps values go. axis 1: shards of a transposed lattice, column
// nx-2 of every row forced. vec: nx is a multiple of 4 and every buffer
// 16-byte aligned. cross: a neighbour of some shard is on another card.
// A launch of more blocks than can be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge).
int lbm_ring(const void* shards, int n_shards, int bps, int h, int nx,
             int ny_global, float w1, float w2, float omega, int mode,
             int axis, int depth, int gsteps, unsigned round_base, int t_out,
             int vec, int cross, int device, void* stream) {
    const void* fn;
    int threads;
    size_t bytes;
    if (!ring_kernel_of(depth, axis, &fn, &threads, &bytes) || n_shards < 1 ||
        bps < 1 || h < depth || gsteps < depth || gsteps % depth) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = depth_opt_in(fn, device);
    if (err != cudaSuccess) return (int)err;
    Ring r{(const RingShard*)shards, bps, h, nx, ny_global,
           axis ? (nx - 2) % nx : (ny_global - 2) % ny_global,
           w1, w2, omega, mode, gsteps, round_base, t_out, 0, 0, 0,
           vec != 0, cross != 0};
    depth_tiles(depth, h, nx, &r.tiles_x, &r.n_tiles);
    if (r.n_tiles < 1) return (int)cudaErrorInvalidValue;
    // Interior tile rows: window rows by * TY - D .. (by + 1) * TY + D - 1
    // all inside the shard.
    const int inner_rows = (h - depth) / Geo<4, 2>::TY - 1;
    r.n_inner = (inner_rows > 0 ? inner_rows : 0) * r.tiles_x;
    void* args[] = {&r};
    err = cudaLaunchCooperativeKernel(fn, dim3(n_shards * bps), dim3(threads),
                                      args, bytes, (cudaStream_t)stream);
    if (err != cudaSuccess) {
        // A refused launch never ran; its error is returned here and must
        // not stay behind for the next launch's check.
        cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
