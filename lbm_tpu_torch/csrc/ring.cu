// G D2Q9 BGK timesteps per launch on every shard of a row-sharded lattice,
// with the seam rows exchanged every step inside the kernel, on a CUDA
// device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/parallel/resident_ring.py::_kernel_ring
// (launched by _pallas_ring): each shard keeps its state for G steps and
// sends its two boundary rows to its ring neighbours every step, through
// 2-slot halo buffers with one signal per (direction, slot). On the TPU the
// rows move by remote DMA with semaphores; here they are stores into the
// neighbour's halo slot (a peer pointer when the neighbour is on another
// card) and a flag per (direction, slot) with release/acquire semantics.
//
// What bounds it: as resident.cu, each step reads 37 B and writes 36 B per
// cell of device memory plus two barriers' worth of latency; the seam rows
// are 2 x 36 B x nx per shard per step. The design:
//
// - One cooperative launch per card hosts every shard on that card, its
//   blocks split evenly among them (bps blocks a shard). Shards are coupled
//   only through the halo slots and flags, on one card or several, so P
//   shards on one card run the same protocol as P cards. No grid.sync():
//   each shard has its own barrier, an atomic counter with a generation,
//   safe because cooperative blocks are co-resident.
// - Step t (slot s = t mod 2, tag t + 1, t counted from the first call):
//   the shard's blocks write its pre-step top row into the north
//   neighbour's halo_s[s] and its bottom row into the south neighbour's
//   halo_n[s], each block a share; the block that completes the step's
//   count of shares publishes the neighbours' flags for slot s with release
//   semantics. (One block sending both rows alone held every step back by
//   its copy.) Every block computes its interior rows (1 .. h-2), waits with
//   acquire semantics until both of its own flags for slot s hold the tag,
//   computes its share of the two boundary rows (0 and h-1) from the halos
//   (lbm_seam.cuh), and passes the shard barrier. Rows are raw: the
//   receiver forces them by the global-row rule.
// - Why two slots with a flag each: a shard writes slot s at step t only
//   after waiting at step t-1 for both neighbours' step t-1 flags, which
//   they published after finishing step t-2, the last step that read slot s.
//   One flag shared by both slots lets a step-t wait pass on the step-t+1
//   signal: the JAX package measured silent wrong trajectories that way
//   (tests/test_ring.py); tests/test_torch_ring.py models both.
// - Per-step tot_u: each block reduces its |u| in a fixed shared-memory
//   tree into partials[step][block]; after the last barrier block b of the
//   shard sums steps b, b + bps, ... in a fixed order into tots[t_out + s].
//   The caller sums the shards in a fixed order. No float atomics.
// - Column mode (kCols, the shards of a wide grid's transposed lattice,
//   sharded over its rows: the lane mode of _kernel_ring,
//   lbm_tpu/parallel/resident_ring.py:280-311): the column accel of every
//   row is forced, interior, boundary and staged halo rows alike, so no
//   shard needs a forced row by global index. The blocks a shard
//   (bps) are coprime with its tile columns, so the forced column's tiles
//   spread over all of them (resident.cu says why; resident_ring.py picks
//   bps).
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/parallel/
// resident_ring.py.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_cell.cuh"
#include "lbm_seam.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kThreads = kBX * kBY;

// One shard as the kernel sees it (the layout of resident_ring.py's
// RingShard ctypes structure).
struct RingShard {
    float* a;                  // (9, h, nx): the state at even steps
    float* b;                  // (9, h, nx): the state at odd steps
    const uint8_t* mask;       // (h, nx)
    float* halo_s;             // (2, 9, nx): this shard's south halo slots
    float* halo_n;             // (2, 9, nx): this shard's north halo slots
    const uint8_t* hmask_s;    // (nx): mask row below row 0
    const uint8_t* hmask_n;    // (nx): mask row above row h-1
    float* north_halo_s;       // the north neighbour's halo_s
    float* south_halo_n;       // the south neighbour's halo_n
    unsigned* sync;            // flag_s[2], flag_n[2], barrier count and
                               // generation, rows sent (blocks' shares)
    unsigned* north_sync;      // the north neighbour's sync
    unsigned* south_sync;      // the south neighbour's sync
    float* partials;           // (gsteps, bps)
    float* tots;               // per-step tot_u of the shard
    long long row0;            // global index of row 0
};

using SysFlag = cuda::atomic_ref<unsigned, cuda::thread_scope_system>;
using DevCounter = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;

// All bps blocks of one shard meet here; prior writes of every block are
// visible to every block after it.
__device__ void shard_barrier(unsigned* sync, unsigned bps) {
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0) {
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

// Four blocks an SM (64 registers, no spills): 15 % faster per step than
// the unbounded 126-register build at 1024x1024 and 16384x1024 over 4
// shards on an H100 (PERF.md).
template <bool kCols>
__global__ void __launch_bounds__(kThreads, 4)
ring_kernel(const RingShard* __restrict__ shards, int bps, int h, int nx,
            int ny_global, int accel, float w1, float w2, float omega,
            int mode, int gsteps, unsigned step_base, int t_out) {
    __shared__ float red[kThreads];
    // The shard's pointers live in shared memory, not in registers.
    __shared__ RingShard S;
    const int lb = blockIdx.x % bps;
    const int tid = threadIdx.y * kBX + threadIdx.x;
    if (tid == 0) S = shards[blockIdx.x / bps];
    __syncthreads();
    const int row0 = (int)S.row0;
    const size_t plane = (size_t)h * nx, slot_size = (size_t)9 * nx;
    const int tiles_x = (nx + kBX - 1) / kBX;
    const int n_inner = tiles_x * ((h - 2 + kBY - 1) / kBY);
    const int edge_x = (nx + kThreads - 1) / kThreads;

    for (int s = 0; s < gsteps; ++s) {
        const unsigned step = step_base + (unsigned)s, tag = step + 1;
        const int slot = (int)(step & 1u);
        const float* src = (s & 1) ? S.b : S.a;
        float* dst = (s & 1) ? S.a : S.b;

        {
            // Send: each block its share of the top row (north) and the
            // bottom row (south); the block that completes the step's
            // count of shares publishes both flags.
            float* to_n = S.north_halo_s + slot * slot_size;
            float* to_s = S.south_halo_n + slot * slot_size;
            const int share = (9 * nx + bps - 1) / bps;
            const int end = min(9 * nx, (lb + 1) * share);
            for (int idx = lb * share + tid; idx < end; idx += kThreads) {
                const int q = idx / nx, c = idx - q * nx;
                __stcg(to_n + idx, src[q * plane + (size_t)(h - 1) * nx + c]);
                __stcg(to_s + idx, src[q * plane + c]);
            }
            __syncthreads();
            if (tid == 0) {
                __threadfence_system();
                const unsigned done = SysFlag(S.sync[6]).fetch_add(
                    1, cuda::memory_order_acq_rel);
                if (done + 1 == tag * (unsigned)bps) {
                    __threadfence_system();
                    SysFlag(S.north_sync[slot]).store(
                        tag, cuda::memory_order_release);
                    SysFlag(S.south_sync[2 + slot]).store(
                        tag, cuda::memory_order_release);
                }
            }
        }

        const SeamView v{src, S.mask, S.halo_s + slot * slot_size,
                         S.halo_n + slot * slot_size, S.hmask_s, S.hmask_n,
                         h, nx, 1};
        float acc = 0.0f;
        float out[9];
        // Interior rows read no halo: plain indexing, as resident.cu.
        auto ld = [&](int q, size_t o) { return src[q * plane + o]; };
        auto solid = [&](size_t o) { return S.mask[o] != 0; };
        for (int tile = lb; tile < n_inner; tile += bps) {
            const int i = (tile % tiles_x) * kBX + threadIdx.x;
            const int j = 1 + (tile / tiles_x) * kBY + threadIdx.y;
            if (i >= nx || j > h - 2) continue;
            const int iw = (i == 0) ? nx - 1 : i - 1;
            const int ie = (i == nx - 1) ? 0 : i + 1;
            const size_t rj = (size_t)j * nx;
            bool f0, f1, f2;
            if constexpr (kCols) {
                f0 = i == accel;
                f1 = iw == accel;
                f2 = ie == accel;
            } else {
                f0 = lbm_wrap(row0 + j, ny_global) == accel;
                f1 = lbm_wrap(row0 + j - 1, ny_global) == accel;
                f2 = lbm_wrap(row0 + j + 1, ny_global) == accel;
            }
            acc += lbm_cell_update<kCols, size_t>(
                ld, solid, rj, rj - nx, rj + nx, (size_t)i, (size_t)iw,
                (size_t)ie, f0, f1, f2, w1, w2, omega, mode, out);
#pragma unroll
            for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = out[k];
        }

        // Receive: both halos of this slot hold this step's rows.
        if (tid == 0) {
            SysFlag from_s(S.sync[slot]), from_n(S.sync[2 + slot]);
            while (from_s.load(cuda::memory_order_acquire) < tag) {
            }
            while (from_n.load(cuda::memory_order_acquire) < tag) {
            }
            __threadfence();
        }
        __syncthreads();
        for (int tile = lb; tile < 2 * edge_x; tile += bps) {
            const int j = tile < edge_x ? 0 : h - 1;
            const int i = (tile % edge_x) * kThreads + tid;
            if (i >= nx) continue;
            acc += lbm_seam_cell<kCols>(v, j, i, row0, ny_global, accel, w1,
                                        w2, omega, mode, out);
#pragma unroll
            for (int k = 0; k < 9; ++k) dst[k * plane + (size_t)j * nx + i] = out[k];
        }

        red[tid] = acc;
        lbm_tree_sum<kThreads>(red, tid);
        if (tid == 0) S.partials[(size_t)s * bps + lb] = red[0];
        shard_barrier(S.sync, (unsigned)bps);
    }

    for (int s = lb; s < gsteps; s += bps) {
        float acc = 0.0f;
        for (int p = tid; p < bps; p += kThreads) {
            acc += S.partials[(size_t)s * bps + p];
        }
        red[tid] = acc;
        lbm_tree_sum<kThreads>(red, tid);
        if (tid == 0) S.tots[t_out + s] = red[0];
        __syncthreads();
    }
}

const void* ring_fn(int axis) {
    return axis ? (const void*)ring_kernel<true>
                : (const void*)ring_kernel<false>;
}

}  // namespace

extern "C" {

// Co-resident blocks of the ring kernel in forcing mode axis (0 rows, 1
// columns) on this device (occupancy x SMs). Negative: a CUDA error code,
// negated (cudaErrorNotSupported when the device takes no cooperative
// launch).
int lbm_ring_blocks(int axis, int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return -(int)err;
    if (!coop) return -(int)cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_fn(axis),
                                                        kThreads, 0);
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

// gsteps (even) steps on the n_shards shards of shards (a device array of
// RingShard, all on this device), bps blocks each, as one cooperative
// launch; the result is in each shard's a. step_base: steps this ring has
// run before (the flags' tags go on from there); t_out: where in each
// shard's tots this call's gsteps values go. axis 1: shards of a
// transposed lattice, column nx-2 of every row forced; bps from
// lbm_ring_blocks for the same axis.
int lbm_ring(const void* shards, int n_shards, int bps, int h, int nx,
             int ny_global, float w1, float w2, float omega, int mode,
             int axis, int gsteps, unsigned step_base, int t_out, int device,
             void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_shards < 1 || bps < 1 || h < 2 || gsteps < 2 || gsteps % 2) {
        return (int)cudaErrorInvalidValue;
    }
    int accel = axis ? (nx - 2) % nx : (ny_global - 2) % ny_global;
    const RingShard* ptr = (const RingShard*)shards;
    void* args[] = {&ptr,  &bps,  &h,         &nx,   &ny_global,
                    &accel,       &w1, &w2,   &omega, &mode,
                    &gsteps,      &step_base, &t_out};
    err = cudaLaunchCooperativeKernel(ring_fn(axis), dim3(n_shards * bps),
                                      dim3(kBX, kBY), args, 0,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
