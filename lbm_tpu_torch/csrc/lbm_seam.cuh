// A shard's rows with one halo row on each side, for the one-step seam
// kernel (fused_step.cu). The depth kernel and the ring have their own
// (lbm_depth.cuh's Halo).
//
// One signed offset addresses the shard: row r in [-1, h] at column c is
// r * nx + c. Row -1 is the south halo row, row h the north halo row. Each
// is given by the address of its speed-0 row and its own plane stride, so
// a halo row is read wherever it lies: in place in the neighbouring
// shard's lattice (plane stride h * nx of that shard) or in a (9, k, nx)
// halo buffer the caller filled (plane stride k * nx). hmask_s and hmask_n
// are the halo rows' obstacle flags, static copies of the neighbours' mask
// rows, so forcing a halo row needs no obstacle channel.
//
// wrap_row (or -1): a row of the shard whose speeds are read from the
// south halo row instead of from the shard, with the shard's own obstacle
// flags. Under the wrap discipline it is shard 0's pad row p - 1, which
// the plain shard step refreshes from the south halo before every step
// (lbm_tpu_torch/parallel/halo.py); reading it there replaces that copy.
//
// Halo rows are raw (pre-step, not forced): the kernel forces every row,
// halo rows included, by the global rule, a row whose global index
// (row0 + r) mod ny_global is the forced row (or, in column mode, the
// forced column of every row). Halo loads go through L2 only (__ldcg):
// another kernel, possibly on another card, wrote them.

#pragma once

#include <stdint.h>

#include "lbm_cell.cuh"

__device__ __forceinline__ int lbm_wrap(int v, int n) {
    const int m = v % n;
    return m < 0 ? m + n : m;
}

struct SeamView {
    const float* src;        // (9, h, nx)
    const uint8_t* mask;     // (h, nx)
    const float* halo_s;     // row -1, speed 0; speed q at q * plane_s
    const float* halo_n;     // row h, speed 0; speed q at q * plane_n
    const uint8_t* hmask_s;  // (nx) flags of row -1
    const uint8_t* hmask_n;  // (nx) flags of row h
    long long plane_s, plane_n;
    int h, nx, wrap_row;

    // Speed q of the site at offset o, o in [-nx, (h + 1) nx).
    __device__ __forceinline__ float ld(int q, long long o) const {
        const long long plane = (long long)h * nx;
        if (o < 0) return __ldcg(halo_s + q * plane_s + (o + nx));
        if (o >= plane) return __ldcg(halo_n + q * plane_n + (o - plane));
        const long long w = o - (long long)wrap_row * nx;
        if (w >= 0 && w < nx) return __ldcg(halo_s + q * plane_s + w);
        return src[q * plane + o];
    }
    __device__ __forceinline__ bool solid(long long o) const {
        const long long plane = (long long)h * nx;
        if (o < 0) return hmask_s[o + nx] != 0;
        if (o >= plane) return hmask_n[o - plane] != 0;
        return mask[o] != 0;
    }
};

// The update of local cell (j, i), j in [0, h), into out[9]; returns |u|
// (0 for an obstacle). kEdge: rows j-1 and j+1 may be a halo row or
// wrap_row, so every load goes through SeamView's branches. Otherwise all
// three rows lie in the shard and are none of them wrap_row: the loads
// are plain ones from src and mask. Row mode (kCols false): a row whose
// global index is accel is forced. Column mode (kCols true, a shard of
// the transposed lattice of a wide grid, sharded over its rows): the
// column accel of every row is forced, halo rows included, and row0 /
// ny_global are not read.
template <bool kCols, bool kEdge>
__device__ __forceinline__ float lbm_seam_cell(const SeamView& v, int j, int i,
                                               int row0, int ny_global,
                                               int accel, float w1,
                                               float w2, float omega,
                                               int mode, float out[9]) {
    const int nx = v.nx;
    const int iw = (i == 0) ? nx - 1 : i - 1;
    const int ie = (i == nx - 1) ? 0 : i + 1;
    const long long plane = (long long)v.h * nx;
    auto ld = [&](int q, long long o) {
        if constexpr (kEdge) return v.ld(q, o);
        else return v.src[q * plane + o];
    };
    auto solid = [&](long long o) {
        if constexpr (kEdge) return v.solid(o);
        else return v.mask[o] != 0;
    };
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
    return lbm_cell_update<kCols, long long>(
        ld, solid, (long long)j * nx, (long long)(j - 1) * nx,
        (long long)(j + 1) * nx, (long long)i, (long long)iw, (long long)ie,
        f0, f1, f2, w1, w2, omega, mode, out);
}
