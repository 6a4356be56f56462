// The depth kernel's flow form (fused_depth_flow_kernel, D = 4, periodic),
// on a CUDA device (sm_90a): one launch runs K rounds of D steps, with no
// grid barrier and no kernel boundary between them, where a launch of one
// round is short in waves of the card's block slots (ops/plan.py's
// flow_rounds). What it removes is what every one-round launch pays
// (PERF.md): the lockstep start, the partial last wave, the last block's
// epilogue and the gap between kernels. Replaces no TPU kernel: the TPU
// runs _kernel_fused's grid in order with no launch between calls to
// amortise; the resident forms are the TPU's many-step kernels.
// - A block takes a ticket as it starts (lbm_block_enters: start order,
//   not blockIdx, whose dispatch order is not guaranteed); tickets run
//   round-major, ticket t = r * n + i, and i gives the round's tile, its
//   walk starting half the lattice's tile rows on at odd rounds, away from
//   where the last round ended (the periodic wrap makes row 0's tiles the
//   neighbours of the last rows').
// - Round r reads buffer r mod 2 and writes the other (args[r & 1]). Its
//   block waits, with acquire loads, until every tile whose cells its
//   window reads, and every tile whose window reads its cells, has
//   finished round r - 1: the first covers read-after-write, the second
//   write-after-read (its output overwrites what they read in round r -
//   1). Both lie within `reach` tile rows and columns a side, which the
//   wrapper computes from the tiles and windows (ops/fused_depth.py's
//   flow_reach: one a side, more where a ragged last tile is thinner than
//   the window's halo or the lattice smaller than a window). So neighbours
//   drift apart by at most one round, and the two buffers suffice.
// - A block waits only on lower tickets, whose blocks have started: the
//   launch cannot deadlock. The wait is bounded and traps past it.
// - After its stores, behind the stage loop's last barrier, the block
//   releases its tile's round counter (one atomic with release order).
//   The counters count rounds, monotone over the launches (the wrapper
//   passes the count before this one), so nothing resets them.
// - tot_u keeps its bits: the block with the last ticket of round r sums
//   the round's D rows of tile partials in tile order (lbm_sum_rows, as
//   the epilogue of one round does) while the other blocks run round
//   r + 1. Rounds of one parity share D rows of slots, so the rows are an
//   argument of the parity's Args and cost no register across the stages;
//   a block of round r >= 2 waits for round r - 2's sum, which empties its
//   slots, as it waits for its neighbours (a count of the rounds summed,
//   in their order). The tile body and its two blocks an SM are
//   fused_depth_kernel's; a launch of one round runs fused_depth_kernel
//   itself.
// - Measured (PERF.md, the flow form's findings): its ticket, polls and
//   release cost ~7 % of a tile's time, so it wins where a launch is a few
//   waves (0.94x at 1024^2) and loses where it is many (1.07x at
//   16384x1024); persistent blocks that draw their tickets ahead ran 1.09x
//   at 1024^2.
// - A flowing block (round r > 0) whose first poll found a tile behind
//   adds one to a device word, read by the runner
//   (timings["compute.depth.waits"]).
//
// Its own translation unit: compiled beside fused_depth_kernel, it moved
// the compiler's inlining in that kernel's column mode; here every
// one-round kernel keeps the instructions it had (scripts/sass_diff_torch.py).
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/fused_depth.py.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_depth.cuh"

namespace {

constexpr int kMaxDevices = 64;

bool aligned(const void* p, uintptr_t bytes) {
    return ((uintptr_t)p & (bytes - 1)) == 0;
}

// The flow form's depth and arguments. done[tile]: the rounds the tile has
// finished over every launch, base before this one; done[n_tiles]: the
// flowing blocks whose first poll found a tile behind; done[n_tiles + 1]:
// the rounds whose tot_u have been summed, base before this one. reach_y,
// reach_x: the tile rows and columns a side that a tile's dependencies
// reach. args[p].partials: the D rows of tile partials of the rounds of
// parity p, and behind the two parities' rows the ticket counter and the
// partials as the sums read them, by parity.
constexpr int kFlowDepth = 4;
struct Flow {
    Args args[2];  // round r steps args[r & 1]: a -> b, then b -> a
    unsigned* done;
    unsigned base;
    int rounds, reach_y, reach_x;
};

using RoundCounter = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;
// Reads of a counter before a wait gives up and traps: seconds, which no
// round comes near; a fault ends the launch instead of holding the card.
constexpr int kMaxRoundReads = 1 << 26;

// Whether counter value v has reached k (wrap-safe).
__device__ __forceinline__ bool reached(unsigned v, unsigned k) {
    return (int)(v - k) >= 0;
}

// The tile of ticket i of round r: the walk starts half the tile rows on
// at odd rounds.
__device__ __forceinline__ int flow_tile(const Args& a, int i, int r) {
    const int ty = a.n_tiles / a.tiles_x;
    const int t = i + ((r & 1) ? (ty / 2) * a.tiles_x : 0);
    return t < a.n_tiles ? t : t - a.n_tiles;
}

// Before round r >= 1 of `tile`: wait until every tile within reach has
// finished round r - 1, and, from round 2 on, until round r - 2's tot_u
// are summed (its slots, of this parity, are empty again). The threads
// poll a counter each; the acquire orders each poller's later loads, and
// behind the barrier its block's, after what the counter's releaser
// stored. A block whose first read of some counter found it behind counts
// once in done[n_tiles].
__device__ __forceinline__ void flow_wait(const Flow& f, int tile, int r) {
    __shared__ int behind;
    const Args& a = f.args[0];
    const int tx = a.tiles_x, ty = a.n_tiles / tx;
    const int by = tile / tx, bx = tile - by * tx;
    const bool all_y = 2 * f.reach_y + 1 >= ty;
    const bool all_x = 2 * f.reach_x + 1 >= tx;
    const int my = all_y ? ty : 2 * f.reach_y + 1;
    const int mx = all_x ? tx : 2 * f.reach_x + 1;
    if (threadIdx.x == 0) behind = 0;
    __syncthreads();
    for (int j = threadIdx.x; j <= my * mx; j += blockDim.x) {
        unsigned* word;
        unsigned k;
        if (j < my * mx) {
            const int jy = j / mx, jx = j - jy * mx;
            const int y = all_y ? jy : wrap(by - f.reach_y + jy, ty);
            const int x = all_x ? jx : wrap(bx - f.reach_x + jx, tx);
            word = f.done + y * tx + x;
            k = f.base + r;
        } else {
            if (r < 2) break;
            word = f.done + a.n_tiles + 1;
            k = f.base + r - 1;
        }
        RoundCounter c(*word);
        if (!reached(c.load(cuda::memory_order_acquire), k)) {
            behind = 1;
            for (int i = 1;
                 !reached(c.load(cuda::memory_order_acquire), k); ++i) {
                if (i == kMaxRoundReads) __trap();
            }
        }
    }
    __syncthreads();
    if (threadIdx.x == 0 && behind) atomicAdd(f.done + a.n_tiles, 1u);
}

template <bool kCols, int kMode>
__device__ __forceinline__ void flow_block(const Flow& f, float* buf) {
    constexpr int D = kFlowDepth;
    // The ticket is read again from shared memory after the tile, and the
    // partials' rows are the parity's argument: of the block's place only
    // its tile is held across the stages.
    __shared__ unsigned int ticket;
    const Args& a = f.args[0];
    const int n = a.n_tiles;
    if (threadIdx.x == 0) {
        ticket = lbm_block_enters(reinterpret_cast<unsigned int*>(
            a.partials + (size_t)2 * D * n));
    }
    __syncthreads();
    int r = (int)(ticket / (unsigned)n);
    const int tile = flow_tile(a, (int)ticket - r * n, r);
    if (r > 0) flow_wait(f, tile, r);
    // One copy of the tile, its arguments the round's parity's (a copy
    // for each parity, as the device form's rounds have, spilled 3.3x the
    // bytes and ran 1.06x the time: PERF.md).
    const Args& ar = f.args[r & 1];
    lbm_depth_tile<D, false, kCols, kMode>(ar, buf, tile, ar.partials, n);
    // The tile's stores are behind the stage loop's last barrier: one
    // release for all of them.
    if (threadIdx.x == 0) {
        RoundCounter(f.done[tile]).fetch_add(1u, cuda::memory_order_release);
    }
    r = (int)(ticket / (unsigned)n);
    if ((int)ticket - r * n == n - 1) {
        // The round's last ticket: every other tile of the round is on the
        // card or done, so its partials are summed as one round's are.
        // The slots' emptying is behind the sum's barrier: one release,
        // in the order of the rounds.
        const int p = r & 1;
        unsigned int* counter =
            reinterpret_cast<unsigned int*>(a.partials + (size_t)2 * D * n);
        lbm_sum_rows<D, kReduceWidth, true>(
            f.args[p].partials, reinterpret_cast<float*>(counter) + 1 +
                                    (size_t)p * D * n,
            n, a.scale, a.out + r * D, threadIdx.x);
        if (threadIdx.x == 0) {
            // The count says every round below it is summed: the sums of
            // the rounds before, lower tickets, come first.
            RoundCounter summed(f.done[n + 1]);
            for (int i = 1; !reached(summed.load(cuda::memory_order_acquire),
                                     f.base + r);
                 ++i) {
                if (i == kMaxRoundReads) __trap();
            }
            summed.fetch_add(1u, cuda::memory_order_release);
            if (r == f.rounds - 1) *counter = 0u;
        }
    }
}

template <bool kCols>
__global__ void __launch_bounds__(
    Geo<kFlowDepth, kCellsPerThread<kCols>>::kThreads, 2)
fused_depth_flow_kernel(const Flow f) {
    extern __shared__ float4 smem[];
    float* buf = reinterpret_cast<float*>(smem);
    switch (f.args[0].mode) {
        case 1: flow_block<kCols, 1>(f, buf); break;
        case 2: flow_block<kCols, 2>(f, buf); break;
        default: flow_block<kCols, 0>(f, buf); break;
    }
}

template <bool kCols>
cudaError_t launch_flow(const Flow& f, int device, cudaStream_t stream) {
    static bool opted_in[kMaxDevices] = {};
    using G = Geo<kFlowDepth, kCellsPerThread<kCols>>;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted_in[device]) {
        cudaError_t err = cudaFuncSetAttribute(
            fused_depth_flow_kernel<kCols>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
        if (err != cudaSuccess) return err;
        opted_in[device] = true;
    }
    const long long blocks = (long long)f.rounds * f.args[0].n_tiles;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    fused_depth_flow_kernel<kCols>
        <<<(int)blocks, G::kThreads, G::kBytes, stream>>>(f);
    return cudaGetLastError();
}

// Resident blocks of the depth kernel's block on the whole card: blocks an
// SM by the occupancy API, times the SMs. The flow kernel's block has
// fused_depth_kernel's threads, shared memory and launch bounds, so the
// count is the one-round launch's slots too.
template <bool kCols>
int block_slots(int device) {
    using G = Geo<kFlowDepth, kCellsPerThread<kCols>>;
    cudaError_t err = cudaFuncSetAttribute(
        fused_depth_flow_kernel<kCols>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fused_depth_flow_kernel<kCols>, G::kThreads, G::kBytes);
    }
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    return err == cudaSuccess ? per_sm * sms : -(int)err;
}

}  // namespace

extern "C" {

// The depth kernel's resident blocks on the card at the flow form's depth
// (one round a launch, periodic): the occupancy API's blocks an SM times
// the SMs; minus a CUDA error code on failure.
int lbm_depth_block_slots(int axis, int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    return axis ? block_slots<true>(device) : block_slots<false>(device);
}

// The flow form: dst = rounds * 4 steps of src, periodic, ping-ponging src
// -> dst -> src ... (the result is in dst after an odd number of rounds,
// in src after an even one), rounds >= 2; out[s] = scale * tot_u of step
// s for s < 4 * rounds. partials: lbm_fused_depth's scratch for 8 rows
// (4 a parity of round), 2 * 8 * n + 1 words, n =
// lbm_depth_num_partials(4, ny, nx). done: n + 2 words, zero before the
// first launch of this scratch: per tile the rounds finished, every tile
// at base before this launch (the launches so far times their rounds),
// then the count of flowing blocks that waited, then the rounds summed
// (base before this launch). reach_y, reach_x: the tile rows and columns a
// side a tile's dependencies reach.
int lbm_fused_depth_flow(float* src, float* dst, const uint8_t* mask,
                         float* partials, unsigned* done, int ny, int nx,
                         int accel, float w1, float w2, float omega, int mode,
                         int axis, float scale, float* out, int rounds,
                         unsigned base, int reach_y, int reach_x, int device,
                         void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rounds < 2 || reach_y < 0 || reach_x < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const Halo periodic{nullptr, nullptr, nullptr, nullptr, 0, 0, ny};
    Args a{src, dst, mask, partials, scale, out, ny, nx, accel,
           w1, w2, omega, mode, 0, 0, false, periodic};
    depth_tiles(kFlowDepth, ny, nx, &a.tiles_x, &a.n_tiles);
    if (a.n_tiles < 1) return (int)cudaErrorInvalidValue;
    a.vec = nx % 4 == 0 && aligned(src, 16) && aligned(dst, 16) &&
            aligned(mask, 4);
    Flow f{{a, a}, done, base, rounds, reach_y, reach_x};
    f.args[1].src = dst;
    f.args[1].dst = src;
    f.args[1].partials = partials + (size_t)kFlowDepth * a.n_tiles;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(axis ? launch_flow<true>(f, device, s)
                      : launch_flow<false>(f, device, s));
}

}  // extern "C"
