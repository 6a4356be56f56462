// tot_u from per-block partials: the fixed-order sum shared by the depth
// kernel (fused_depth.cu), which runs it in its epilogue, and the one-step
// kernel (fused_step.cu), which launches it on its own.
//
// Replaces the final sum of lbm_tpu/ops/pallas_fused.py:396 (the TPU
// kernel carries one accumulator over its sequential grid; blocks here run
// in any order, so each writes a partial and the partials are summed
// once). No float atomics: the sum's order, and so its bits, never depend
// on the order in which the blocks ran.
//
// The epilogue form, without a second launch and without a fence in any
// block but one: every block writes its partials, one per row (a row is
// one timestep of the launch), into slots that hold kNoPartial before the
// launch, with plain (volatile) stores, and is done. An integer counter in
// device memory numbers the blocks in the order they start
// (lbm_block_enters; the answer arrives while the block loads its window).
// The block that started last knows that every other block is on the card
// or done, so it can wait for them without holding up any: it sums the
// rows in the fixed order, waiting at each slot until the slot holds a
// partial, copies each partial into `kept` (for whoever wants to read the
// partials after the launch), puts kNoPartial back for the next launch,
// writes scale * sum, and zeroes the counter. (A ticket drawn at the end
// of every block behind a __threadfence() was measured dearer than the
// launch it replaced: PERF.md.)
//
// The order of a row's sum is a function of the row's length and of the
// sum's width alone: thread t < kWidth adds partials t, t + kWidth, ... in
// order, a butterfly of __shfl_xor_sync adds a warp's 32 values (every
// lane ends with the same bits), and one thread adds the warps' values in
// warp order. The block size and the number of rows do not enter, so the
// depth kernel's depths, all kReduceWidth wide, give a step the same
// total.

#pragma once

constexpr int kReduceWidth = 256;

// Sum of v over the warp's 32 lanes, the same bits in every lane.
__device__ __forceinline__ float lbm_warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// A slot's content before its block has written it: the bits of a NaN that
// no sum produces (arithmetic gives the canonical NaN).
constexpr unsigned int kNoPartial = 0xffffffffu;
// Reads of an empty slot before the sum gives up and lets the NaN through
// (seconds; no run comes near it).
constexpr int kMaxSlotReads = 1 << 24;

// A block's partial into its slot, for a reader in another block.
__device__ __forceinline__ void lbm_publish_partial(float* slot, float v) {
    *reinterpret_cast<volatile float*>(slot) = v;
}

// The bits of a slot, as its block left them or kNoPartial.
__device__ __forceinline__ unsigned int lbm_peek(const float* slot) {
    return *reinterpret_cast<const volatile unsigned int*>(slot);
}

// out[r] = scale * sum(partials[r * n : (r + 1) * n]) for r < kRows, by
// one block of at least kWidth threads, all of which call this. kTake
// false: the partials are complete (blocks of an earlier launch wrote
// them) and are read through L2. kTake true: they are slots that other
// blocks of this launch are filling; a thread reads a batch of them at
// once, reads again those that are still empty until their blocks have
// written them, copies each partial to kept and leaves the slot empty.
template <int kRows, int kWidth = kReduceWidth, bool kTake = false>
__device__ __forceinline__ void lbm_sum_rows(float* partials, float* kept,
                                             int n, float scale, float* out,
                                             int tid) {
    constexpr int kWarps = kWidth / 32;
    // Slots a thread reads at once: 16 with the rows.
    constexpr int kBatch = kRows >= 8 ? 2 : 4;
    __shared__ float warp_tot[kRows][kWarps];
    if (tid < kWidth) {
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        if constexpr (kTake) {
            for (int p0 = tid; p0 < n; p0 += kBatch * kWidth) {
                unsigned int bits[kBatch][kRows];
#pragma unroll
                for (int j = 0; j < kBatch; ++j) {
                    const int p = p0 + j * kWidth;
#pragma unroll
                    for (int r = 0; r < kRows; ++r) {
                        bits[j][r] = p < n ? lbm_peek(partials +
                                                      (size_t)r * n + p)
                                           : 0u;
                    }
                }
#pragma unroll
                for (int j = 0; j < kBatch; ++j) {
                    const int p = p0 + j * kWidth;
                    if (p >= n) break;
#pragma unroll
                    for (int r = 0; r < kRows; ++r) {
                        float* slot = partials + (size_t)r * n + p;
                        for (int i = 0; bits[j][r] == kNoPartial &&
                                        i < kMaxSlotReads; ++i) {
                            bits[j][r] = lbm_peek(slot);
                        }
                        const float v = __uint_as_float(bits[j][r]);
                        *reinterpret_cast<volatile unsigned int*>(slot) =
                            kNoPartial;
                        kept[(size_t)r * n + p] = v;
                        acc[r] += v;
                    }
                }
            }
        } else {
#pragma unroll 4
            for (int p = tid; p < n; p += kWidth) {
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    acc[r] += __ldcg(partials + (size_t)r * n + p);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const float w = lbm_warp_sum(acc[r]);
            if ((tid & 31) == 0) warp_tot[r][tid >> 5] = w;
        }
    }
    __syncthreads();
    if (tid < kRows) {
        float tot = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += warp_tot[tid][w];
        out[tid] = tot * scale;
    }
}

// This block's number in the order the launch's blocks start. One thread
// of every block calls it, at the block's start.
__device__ __forceinline__ unsigned int lbm_block_enters(
        unsigned int* counter) {
    return atomicAdd(counter, 1u);
}

// The epilogue of a kernel whose blocks publish their partials
// (lbm_publish_partial) as they finish: the block that started last
// (entered: its lbm_block_enters answer, the same in all its threads)
// sums the rows. Every thread of every block calls this, as its last
// action. Before the first launch every slot holds kNoPartial and counter
// zero, and every launch leaves them so.
template <int kRows>
__device__ __forceinline__ void lbm_last_block_sums(float* slots, float* kept,
                                                    int n, float scale,
                                                    float* out,
                                                    unsigned int* counter,
                                                    unsigned int entered,
                                                    int n_blocks, int tid) {
    if (entered != (unsigned int)(n_blocks - 1)) return;
    lbm_sum_rows<kRows, kReduceWidth, true>(slots, kept, n, scale, out, tid);
    if (tid == 0) *counter = 0u;
}
