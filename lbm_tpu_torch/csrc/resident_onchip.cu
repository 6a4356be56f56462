// G D2Q9 BGK timesteps per launch with the lattice on chip: each block
// holds its strip of rows in shared memory for all G steps, on a CUDA
// device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/ops/pallas_resident.py::_kernel_resident
// (launched by _pallas_resident): the lattice copied on chip once, G steps
// between two buffers, a (G,) vector of per-step tot_u, one copy out. This
// is its on-chip form, for lattices whose strips fit a block's shared
// memory (ops/plan.py: resident_form); resident.cu is the device-memory
// form for the others. Both give the plain version's bits.
//
// What bounds it: while the strips fit, no lattice byte crosses L2 between
// the first load and the last store, so a step is the cell update (~150
// instructions a cell, issue-bound as the depth kernel's stages) plus what
// a block waits for its neighbours' rows. The design:
//
// - One cooperative block an SM at most (B <= SMs, co-resident, so a block
//   may spin on another's flag). Block b owns rows [r0, r0 + h) at full
//   width, so the x wrap stays inside the block; ny is split so that
//   strips differ by at most one row. Dynamic shared memory holds the
//   strip's two buffers (SoA, [9][h][nx] f32) and its mask bytes, 73 B a
//   cell; the strip is read from a once and written once, into the buffer
//   that G's parity names (a after an even G, b after an odd one), as the
//   device-memory form leaves it.
// - No grid-wide barrier. Step t (slot t mod 2, tag t + 1, t counted over
//   the launches of one wrapper): the block stores its top row's three
//   north-going speeds (2, 5, 6) into the north neighbour's south slot and
//   its bottom row's south-going speeds (4, 7, 8) into the south
//   neighbour's north slot, then publishes one flag per (direction, slot)
//   with release semantics (one fence, then relaxed stores, after the
//   block's barrier; the waiting side: acquire loads by one thread a
//   flag, then the barrier, as CUTLASS's GenericBarrier does); computes
//   its interior rows while the rows travel; waits with acquire semantics
//   until its own two flags for the slot hold the tag; computes its edge
//   rows, reading the halo copies through L2. Blocks wrap north-south, as
//   the lattice does.
// - Why two slots with a flag each (ring.cu's protocol): a block writes
//   slot s at step t only after waiting at step t-1 for both neighbours'
//   step t-1 flags, which they published after finishing step t-2, the
//   last step that read slot s. One flag shared by both slots lets a
//   step-t wait pass on the step-t+1 signal
//   (tests/test_torch_resident.py models both).
// - Forcing: the guard of a forced cell reads speeds 3, 6 and 7 (column
//   mode: 4, 8, 7) of that cell before the step, which do not travel. So
//   the owner forces the copies it sends: a site on the forced row (or
//   column) that passes the guard sends speed k + delta_k, the copy its
//   neighbour would have pulled from the forced lattice. The receiver
//   must not force it again: to lbm_cell_update's guard a halo site
//   reports itself solid (that flag is read for no other purpose there;
//   a cell's own obstacle flag is always in the strip). Three floats a
//   halo cell instead of nine and a mask row.
// - tot_u: each block sums its |u| per step in a fixed order (warp
//   butterflies, then the warps' sums by a butterfly) into
//   partials[t][b]; the block that finishes last (an integer ticket after
//   a __threadfence() in each block, once per launch) sums each step's
//   partials in block order, a warp a step. No float atomics, so repeat
//   runs are bit-identical.
// - Column mode (kCols, the transposed lattice of a wide grid): the forced
//   column crosses every strip, so the load is even by construction.
// - The association is a template parameter, as in fused_depth.cu.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/resident.py.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_cell.cuh"
#include "lbm_reduce.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Floats of dynamic shared memory beside the strip: the per-step warp sums
// of two steps and the ticket's answer. ops/plan.py's ONCHIP_SCRATCH_BYTES.
constexpr int kScratch = 2 * kWarps + 4;
// Speeds a halo cell carries (ops/plan.py's ONCHIP_HALO_SPEEDS).
constexpr int kHalo = 3;

using Flag = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;

__host__ __device__ long long strip_floats(int ny, int nx, int blocks) {
    const long long hmax = (ny + blocks - 1) / blocks;
    return hmax * nx;
}

long long smem_bytes(int ny, int nx, int blocks) {
    // Two buffers of 9 speeds, the scratch floats, then the mask bytes.
    return (18 * strip_floats(ny, nx, blocks) + kScratch) * 4 +
           strip_floats(ny, nx, blocks);
}

// Slot of speed k in a halo row: north-going rows carry 2, 5, 6 and
// south-going rows 4, 7, 8, in that order. Other speeds are never read
// from a halo (its sites are solid to the guard); they map to 0 so that
// any address the compiler forms stays in the row.
__device__ __forceinline__ int halo_q(int k) {
    return (k == 5 || k == 7) ? 1 : ((k == 6 || k == 8) ? 2 : 0);
}

// The guard of a forced site (lbm_cell.cuh): fluid, and its guarded
// speeds each strictly above their weight after the subtraction.
template <bool kCols>
__device__ __forceinline__ bool guard(const float* src, int plane, int o,
                                      bool solid, float w1, float w2) {
    if constexpr (kCols) {
        return !solid && (src[4 * plane + o] - w1 > 0.0f) &&
               (src[8 * plane + o] - w2 > 0.0f) &&
               (src[7 * plane + o] - w2 > 0.0f);
    } else {
        return !solid && (src[3 * plane + o] - w1 > 0.0f) &&
               (src[6 * plane + o] - w2 > 0.0f) &&
               (src[7 * plane + o] - w2 > 0.0f);
    }
}

// The three copies that row j's column c sends, forced where the site is
// on the forced line and passes the guard (the deltas of
// ops/reference.forcing; a zero delta is not added). kNorth: speeds 2, 5,
// 6 to the block above; else 4, 7, 8 to the block below.
template <bool kCols, bool kNorth>
__device__ __forceinline__ void send_cell(const float* src,
                                          const uint8_t* m, int plane,
                                          int j, int c, int nx, bool row_on,
                                          int accel, float w1, float w2,
                                          float* to) {
    const int o = j * nx + c;
    const bool on = kCols ? c == accel : row_on;
    const bool g = on && guard<kCols>(src, plane, o, m[o] != 0, w1, w2);
    float q0, q1, q2;
    if constexpr (kNorth) {
        q0 = src[2 * plane + o];
        q1 = src[5 * plane + o];
        q2 = src[6 * plane + o];
        if (g) {
            if constexpr (kCols) {
                q0 = q0 + w1;
                q1 = q1 + w2;
                q2 = q2 + w2;
            } else {
                q1 = q1 + w2;
                q2 = q2 - w2;
            }
        }
    } else {
        q0 = src[4 * plane + o];
        q1 = src[7 * plane + o];
        q2 = src[8 * plane + o];
        if (g) {
            if constexpr (kCols) {
                q0 = q0 - w1;
                q1 = q1 - w2;
                q2 = q2 - w2;
            } else {
                q1 = q1 - w2;
                q2 = q2 + w2;
            }
        }
    }
    __stcg(to + c, q0);
    __stcg(to + nx + c, q1);
    __stcg(to + 2 * nx + c, q2);
}

// halo: (B, 2, 2, kHalo, nx) floats, [block][0 south / 1 north][slot];
// flags: (B, 2, 2) unsigned, the same order; partials: (G, B); ticket:
// one unsigned, zero between launches. a and res may be the same buffer
// (an even G): each thread writes back exactly the cells it loaded.
template <bool kCols, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
resident_onchip_kernel(const float* a, float* res,
                       const uint8_t* __restrict__ mask, float* halo,
                       unsigned* flags, float* partials, unsigned* ticket,
                       float* __restrict__ tots, int ny, int nx, int accel,
                       float w1, float w2, float omega, int gsteps,
                       float scale, unsigned step_base) {
    extern __shared__ float smem[];
    const int nb = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int base = ny / nb, rem = ny % nb;
    const int h = base + (b < rem ? 1 : 0);
    const int r0 = b * base + (b < rem ? b : rem);
    const int plane = h * nx;
    const long long hmax_nx = strip_floats(ny, nx, nb);
    float* buf0 = smem;
    float* buf1 = smem + 9 * hmax_nx;
    float* red = smem + 18 * hmax_nx;
    uint8_t* m = reinterpret_cast<uint8_t*>(red + kScratch);
    const size_t gplane = (size_t)ny * nx, goff = (size_t)r0 * nx;

    for (int idx = tid; idx < 9 * plane; idx += kThreads) {
        const int k = idx / plane, o = idx - k * plane;
        buf0[idx] = a[k * gplane + goff + o];
    }
    for (int o = tid; o < plane; o += kThreads) m[o] = mask[goff + o];
    __syncthreads();

    const int north = (b + 1 == nb) ? 0 : b + 1;
    const int south = (b == 0) ? nb - 1 : b - 1;
    const size_t hrow = (size_t)kHalo * nx;
    auto halo_at = [&](int blk, int dir, int slot) {
        return halo + ((size_t)(blk * 2 + dir) * 2 + slot) * hrow;
    };
    auto wrap = [&](int g) { return g < 0 ? g + ny : (g >= ny ? g - ny : g); };

    for (int s = 0; s < gsteps; ++s) {
        const unsigned step = step_base + (unsigned)s, tag = step + 1u;
        const int slot = (int)(step & 1u);
        const float* src = (s & 1) ? buf1 : buf0;
        float* dst = (s & 1) ? buf0 : buf1;

        // Send: the top row north, the bottom row south, then the flags.
        {
            float* to_n = halo_at(north, 0, slot);
            float* to_s = halo_at(south, 1, slot);
            const bool top_on = r0 + h - 1 == accel, bot_on = r0 == accel;
            for (int c = tid; c < nx; c += kThreads) {
                send_cell<kCols, true>(src, m, plane, h - 1, c, nx, top_on,
                                       accel, w1, w2, to_n);
                send_cell<kCols, false>(src, m, plane, 0, c, nx, bot_on,
                                        accel, w1, w2, to_s);
            }
            __syncthreads();
            if (tid == 0) {
                // One release fence for the block's stores (ordered before
                // it by the barrier), then both flags.
                cuda::atomic_thread_fence(cuda::memory_order_release,
                                          cuda::thread_scope_device);
                Flag(flags[(north * 2 + 0) * 2 + slot])
                    .store(tag, cuda::memory_order_relaxed);
                Flag(flags[(south * 2 + 1) * 2 + slot])
                    .store(tag, cuda::memory_order_relaxed);
            }
        }

        float acc = 0.0f;
        float cell[9];
        // Interior rows 1 .. h-2 read the strip alone.
        {
            auto ld = [&](int k, int o) { return src[k * plane + o]; };
            auto solid = [&](int o) { return m[o] != 0; };
            const int n_inner = (h - 2) * nx;
            for (int idx = tid; idx < n_inner; idx += kThreads) {
                const int j = 1 + idx / nx, i = idx - (j - 1) * nx;
                const int iw = (i == 0) ? nx - 1 : i - 1;
                const int ie = (i == nx - 1) ? 0 : i + 1;
                const int rj = j * nx, g = r0 + j;
                const bool f0 = kCols ? i == accel : g == accel;
                const bool f1 = kCols ? iw == accel : g - 1 == accel;
                const bool f2 = kCols ? ie == accel : g + 1 == accel;
                acc += lbm_cell_update<kCols, int>(
                    ld, solid, rj, rj - nx, rj + nx, i, iw, ie, f0, f1, f2,
                    w1, w2, omega, kMode, cell);
#pragma unroll
                for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = cell[k];
            }
        }

        // Receive: both halo slots hold this step's rows. Two threads wait
        // on the two flags at once; the barrier orders the block's halo
        // loads after their acquires.
        if (tid == 0 || tid == 32) {
            Flag from(flags[(b * 2 + (tid ? 1 : 0)) * 2 + slot]);
            while (from.load(cuda::memory_order_acquire) < tag) {
            }
        }
        __syncthreads();

        // Edge rows 0 and h-1 (one row when h is 1), row -1 from the south
        // slot and row h from the north slot.
        {
            const float* hs = halo_at(b, 0, slot);
            const float* hn = halo_at(b, 1, slot);
            auto ld = [&](int k, int o) -> float {
                if (o < 0) return __ldcg(hs + halo_q(k) * nx + (o + nx));
                if (o >= plane) {
                    return __ldcg(hn + halo_q(k) * nx + (o - plane));
                }
                return src[k * plane + o];
            };
            auto solid = [&](int o) {
                return o < 0 || o >= plane || m[o] != 0;
            };
            const int n_edge = (h == 1 ? 1 : 2) * nx;
            for (int idx = tid; idx < n_edge; idx += kThreads) {
                const bool top = idx >= nx;
                const int j = top ? h - 1 : 0, i = top ? idx - nx : idx;
                const int iw = (i == 0) ? nx - 1 : i - 1;
                const int ie = (i == nx - 1) ? 0 : i + 1;
                const int rj = j * nx, g = r0 + j;
                const bool f0 = kCols ? i == accel : g == accel;
                const bool f1 = kCols ? iw == accel : wrap(g - 1) == accel;
                const bool f2 = kCols ? ie == accel : wrap(g + 1) == accel;
                acc += lbm_cell_update<kCols, int>(
                    ld, solid, rj, rj - nx, rj + nx, i, iw, ie, f0, f1, f2,
                    w1, w2, omega, kMode, cell);
#pragma unroll
                for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = cell[k];
            }
        }

        // The block's sum of this step: warps, then the warps' sums. The
        // two steps' scratch alternate, so warp 0 reads this step's while
        // the others start the next.
        acc = lbm_warp_sum(acc);
        float* wsum = red + (s & 1) * kWarps;
        if (lane == 0) wsum[warp] = acc;
        __syncthreads();
        if (warp == 0) {
            const float v = lbm_warp_sum(lane < kWarps ? wsum[lane] : 0.0f);
            if (lane == 0) partials[(size_t)s * nb + b] = v;
        }
    }

    const float* fin = (gsteps & 1) ? buf1 : buf0;
    for (int idx = tid; idx < 9 * plane; idx += kThreads) {
        const int k = idx / plane, o = idx - k * plane;
        res[k * gplane + goff + o] = fin[idx];
    }

    // The block that finishes last sums the partials, step by step.
    unsigned* last = reinterpret_cast<unsigned*>(red + 2 * kWarps);
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        *last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int s = warp; s < gsteps; s += kWarps) {
        float v = 0.0f;
        for (int p = lane; p < nb; p += 32) {
            v += __ldcg(partials + (size_t)s * nb + p);
        }
        v = lbm_warp_sum(v);
        if (lane == 0) tots[s] = v * scale;
    }
    if (tid == 0) *ticket = 0u;
}

const void* onchip_fn(int axis, int mode) {
    if (axis) {
        return mode == 1 ? (const void*)resident_onchip_kernel<true, 1>
               : mode == 2 ? (const void*)resident_onchip_kernel<true, 2>
                           : (const void*)resident_onchip_kernel<true, 0>;
    }
    return mode == 1 ? (const void*)resident_onchip_kernel<false, 1>
           : mode == 2 ? (const void*)resident_onchip_kernel<false, 2>
                       : (const void*)resident_onchip_kernel<false, 0>;
}

}  // namespace

extern "C" {

// The device's SM count and the shared memory a block may opt in to, for
// ops/plan.py's resident_form. Negative: a CUDA error code, negated.
int lbm_sm_count(int device) {
    int v = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
    return err == cudaSuccess ? v : -(int)err;
}

int lbm_smem_optin(int device) {
    int v = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return err == cudaSuccess ? v : -(int)err;
}

// Dynamic shared memory of one block of the on-chip kernel for an ny x nx
// lattice over blocks strips (ops/plan.py's onchip_smem_bytes).
long long lbm_onchip_smem_bytes(int ny, int nx, int blocks) {
    return smem_bytes(ny, nx, blocks);
}

// Opt the kernel of forcing mode axis and association mode into bytes of
// dynamic shared memory and check that blocks of them can be co-resident
// on this device. 0, or a CUDA error code (cudaErrorNotSupported: no
// cooperative launch; cudaErrorCooperativeLaunchTooLarge: too many
// blocks).
int lbm_onchip_prepare(int axis, int mode, long long bytes, int blocks,
                       int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int coop = 0, sms = 0, per_sm = 0, optin = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    // The attribute is the function's, shared by every wrapper of this
    // instantiation: raise it to the card's limit once, never to one
    // lattice's size, which another wrapper's launch would then exceed.
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(onchip_fn(axis, mode),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, onchip_fn(axis, mode), kThreads, (size_t)bytes);
    if (err != cudaSuccess) return (int)err;
    if (blocks < 1 || (long long)per_sm * sms < blocks) {
        return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    return 0;
}

// gsteps steps of the ny x nx lattice in a over blocks strips; the result
// goes to res (the caller passes a for an even gsteps, its other buffer
// for an odd one). out[s] = scale * step s's sum of fluid |u|. step_base:
// steps this scratch (halo, flags) has run before; flags must hold no tag
// above it. axis 0 forces row accel, axis 1 (a transposed lattice) column
// accel; lbm_onchip_prepare has run for the same axis, mode, bytes and
// blocks.
int lbm_resident_onchip(const float* a, float* res, const uint8_t* mask,
                        float* halo, unsigned* flags, float* partials,
                        unsigned* ticket, float* out, int ny, int nx,
                        int accel, float w1, float w2, float omega, int mode,
                        int gsteps, float scale, unsigned step_base,
                        int blocks, int axis, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (gsteps < 1 || blocks < 1 || blocks > ny) {
        return (int)cudaErrorInvalidValue;
    }
    void* args[] = {&a,  &res, &mask,  &halo,   &flags, &partials,
                    &ticket, &out, &ny, &nx, &accel, &w1,
                    &w2, &omega, &gsteps, &scale, &step_base};
    err = cudaLaunchCooperativeKernel(
        onchip_fn(axis, mode), dim3(blocks), dim3(kThreads), args,
        (size_t)smem_bytes(ny, nx, blocks), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
