// One D2Q9 BGK lattice-Boltzmann timestep on a CUDA device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/ops/pallas_fused.py::_kernel (launched by
// _pallas_step in the CarryStep role): guarded forcing of row ny-2, periodic
// pull streaming, bounce-back, BGK relaxation and tot_u = sum |u| over fluid
// cells, all in one pass over a planar (9, ny, nx) float32 state.
//
// What bounds it: per cell-step the kernel reads 9 floats and the mask byte
// and writes 9 floats, 73 B, for ~130 flops: it is memory-bound on this card
// by a wide margin. The design moves nothing but those bytes:
//
// - One thread per cell, a 32x8 block with x fastest, so each speed's loads
//   and stores are coalesced 128 B rows (the pull shift moves a row by at
//   most one element). Periodic wrap is a modulo index per load; the TPU
//   kernel's edge-row arrays, DMA double-buffering and 0/1-indicator
//   products exist for its tiles and sequential grid and are not carried
//   over. Neighbouring blocks' rows are re-read through L1/L2, not HBM.
// - Forcing is applied to the pulled copy: a speed whose source row is
//   ny-2 adds its delta when the SOURCE cell passes the guard (fluid, and
//   its pre-forcing speeds 3, 6, 7 each strictly above their weight). That
//   equals forcing first and streaming after, with no extra pass or
//   in-place write; only destination rows ny-3..ny-1 take the branch.
// - tot_u is deterministic: each block reduces its fluid |u| in a fixed
//   shared-memory tree into one partial; lbm_reduce_tot sums the partials
//   in a fixed order in one block and writes scale * sum to the device.
//   No float atomics, so repeated runs are bit-identical.
// - The BGK association is a runtime argument (0 paired, 1 reference
//   order, 2 omega-absorbed), written term by term as
//   lbm_tpu/ops/reference.py::_bgk_update_planes. Build without
//   --use_fast_math: division and sqrt stay IEEE; nvcc's default FMA
//   contraction is allowed.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/fused.py. Every
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kThreads = kBX * kBY;
constexpr int kReduceThreads = 1024;

// Fixed-order tree over kN shared floats; the sum ends in buf[0].
template <int kN>
__device__ __forceinline__ void tree_sum(float* buf, int tid) {
#pragma unroll
    for (int s = kN / 2; s > 0; s >>= 1) {
        if (tid < s) buf[tid] += buf[tid + s];
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  const uint8_t* __restrict__ mask,
                  float* __restrict__ partials, int ny, int nx,
                  int accel_row, float w1, float w2, float omega, int mode) {
    __shared__ float red[kThreads];
    const int i = blockIdx.x * kBX + threadIdx.x;
    const int j = blockIdx.y * kBY + threadIdx.y;
    const int tid = threadIdx.y * kBX + threadIdx.x;
    float umag = 0.0f;

    if (i < nx && j < ny) {
        const size_t plane = (size_t)ny * (size_t)nx;
        // Source rows/columns of the pull: speed k reads
        // ((j - cy[k]) mod ny, (i - cx[k]) mod nx).
        const int jm = (j == 0) ? ny - 1 : j - 1;   // cy = +1
        const int jp = (j == ny - 1) ? 0 : j + 1;   // cy = -1
        const int iw = (i == 0) ? nx - 1 : i - 1;   // cx = +1
        const int ie = (i == nx - 1) ? 0 : i + 1;   // cx = -1
        const size_t rj = (size_t)j * nx, rm = (size_t)jm * nx,
                     rp = (size_t)jp * nx;

        // The forcing guard of a source cell on row accel_row.
        auto forced = [&](size_t o) -> bool {
            return !mask[o] && (src[3 * plane + o] - w1 > 0.0f) &&
                   (src[6 * plane + o] - w2 > 0.0f) &&
                   (src[7 * plane + o] - w2 > 0.0f);
        };

        const float s0 = src[0 * plane + rj + i];
        float s1 = src[1 * plane + rj + iw];
        const float s2 = src[2 * plane + rm + i];
        float s3 = src[3 * plane + rj + ie];
        const float s4 = src[4 * plane + rp + i];
        float s5 = src[5 * plane + rm + iw];
        float s6 = src[6 * plane + rm + ie];
        float s7 = src[7 * plane + rp + ie];
        float s8 = src[8 * plane + rp + iw];
        // Deltas: +w1 on 1, -w1 on 3, +w2 on 5 and 8, -w2 on 6 and 7
        // (x + (-w) is exactly x - w in IEEE arithmetic).
        if (j == accel_row) {
            if (forced(rj + iw)) s1 = s1 + w1;
            if (forced(rj + ie)) s3 = s3 - w1;
        }
        if (jm == accel_row) {
            if (forced(rm + iw)) s5 = s5 + w2;
            if (forced(rm + ie)) s6 = s6 - w2;
        }
        if (jp == accel_row) {
            if (forced(rp + ie)) s7 = s7 - w2;
            if (forced(rp + iw)) s8 = s8 + w2;
        }

        const float rho = s0 + s1 + s2 + s3 + s4 + s5 + s6 + s7 + s8;
        const float u_x = (s1 + s5 + s8 - (s3 + s6 + s7)) / rho;
        const float u_y = (s2 + s5 + s6 - (s4 + s7 + s8)) / rho;
        const float u_sq = u_x * u_x + u_y * u_y;

        const float w0 = 4.0f / 9.0f, wa = 1.0f / 9.0f, wd = 1.0f / 36.0f;
        float f[9];
        if (mode == 1) {
            // Reference order: w * rho * (1 + uc*3 + uc*uc*4.5 - u_sq*1.5).
            const float sq = u_sq * 1.5f;
            const float ra = wa * rho, rd = wd * rho;
            auto feq = [&](float wr, float uc) {
                return wr * (1.0f + uc * 3.0f + (uc * uc) * 4.5f - sq);
            };
            f[0] = w0 * rho * (1.0f - sq);
            f[1] = feq(ra, u_x);
            f[2] = feq(ra, u_y);
            f[3] = feq(ra, -u_x);
            f[4] = feq(ra, -u_y);
            f[5] = feq(rd, u_x + u_y);
            f[6] = feq(rd, -u_x + u_y);
            f[7] = feq(rd, -u_x + -u_y);
            f[8] = feq(rd, u_x + -u_y);
        } else {
            // Paired: feq_k = E + O, feq_opp(k) = E - O; mode 2 folds
            // omega into the weight constants.
            const float scale = (mode == 2) ? omega : 1.0f;
            const float base = 1.0f - u_sq * 1.5f;
            const float wrho_a = (wa * scale) * rho;
            const float wrho_d = (wd * scale) * rho;
            const float odd_a = 3.0f * wrho_a;
            const float odd_d = 3.0f * wrho_d;
            auto pair = [&](float wrho, float oddw, float uc, float& plus,
                            float& minus) {
                const float even = wrho * (base + (uc * uc) * 4.5f);
                const float odd = oddw * uc;
                plus = even + odd;
                minus = even - odd;
            };
            f[0] = (w0 * scale) * rho * base;
            pair(wrho_a, odd_a, u_x, f[1], f[3]);
            pair(wrho_a, odd_a, u_y, f[2], f[4]);
            pair(wrho_d, odd_d, u_x + u_y, f[5], f[7]);
            pair(wrho_d, odd_d, u_y - u_x, f[6], f[8]);
        }

        const float s[9] = {s0, s1, s2, s3, s4, s5, s6, s7, s8};
        const int opp[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
        const size_t o = rj + i;
        const bool obstacle = mask[o] != 0;
        const float one_m_omega = 1.0f - omega;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            float out;
            if (obstacle) {
                out = s[opp[k]];
            } else if (mode == 2) {
                out = s[k] * one_m_omega + f[k];
            } else {
                out = s[k] + omega * (f[k] - s[k]);
            }
            dst[k * plane + o] = out;
        }
        umag = obstacle ? 0.0f : sqrtf(u_sq);
    }

    red[tid] = umag;
    __syncthreads();
    tree_sum<kThreads>(red, tid);
    if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_tot_kernel(const float* __restrict__ partials, int n, float scale,
                  float* __restrict__ out) {
    __shared__ float red[kReduceThreads];
    const int tid = threadIdx.x;
    float acc = 0.0f;
    for (int p = tid; p < n; p += kReduceThreads) acc += partials[p];
    red[tid] = acc;
    __syncthreads();
    tree_sum<kReduceThreads>(red, tid);
    if (tid == 0) *out = red[0] * scale;
}

dim3 step_grid(int ny, int nx) {
    return dim3((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
}

}  // namespace

extern "C" {

// Number of tot_u partials (one per block) the step kernel writes.
int lbm_num_partials(int ny, int nx) {
    const dim3 g = step_grid(ny, nx);
    return (int)(g.x * g.y);
}

// Largest ny a launch accepts (the grid's y dimension is at most 65535).
int lbm_max_rows(void) { return 65535 * kBY; }

const char* lbm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// dst = one step of src; partials[b] = block b's sum of fluid |u|.
int lbm_fused_step(const float* src, float* dst, const uint8_t* mask,
                   float* partials, int ny, int nx, int accel_row, float w1,
                   float w2, float omega, int mode, int device,
                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    fused_step_kernel<<<step_grid(ny, nx), dim3(kBX, kBY), 0,
                        (cudaStream_t)stream>>>(
        src, dst, mask, partials, ny, nx, accel_row, w1, w2, omega, mode);
    return (int)cudaGetLastError();
}

// *out = scale * sum(partials[0:n]), summed in a fixed order.
int lbm_reduce_tot(const float* partials, int n, float scale, float* out,
                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    reduce_tot_kernel<<<1, kReduceThreads, 0, (cudaStream_t)stream>>>(
        partials, n, scale, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
