#!/usr/bin/env python3
"""How the H100's tensor cores round one mma.m16n8k8 product: tf32 inputs
with f32 accumulation, and f64 (DMMA). The question behind the
equilibrium's product precision in ``lbm_tpu_torch/csrc/mxu_eq.cu``.

Builds :data:`SOURCE` with ``nvcc`` into ``build/lbm_tpu_torch/`` and runs
it: 4096 warps each multiply their own random A (16 x 8) and B (8 x 8) from
a zero accumulator, with the fragments of the PTX ISA's m16n8k8 layout (the
kernel's). For tf32 (inputs already tf32 values, so every product is exact
and the exact sum fits a double), each result is compared with the exact
sum rounded to nearest and rounded toward zero: the counts of results equal
to only one of them, to both, to neither, and the mean error in ulps
toward the exact sum's magnitude (negative: toward zero), for positive
inputs and for mixed signs. For f64, each result against a sequential
fused multiply-add in k order and against a long double sum (its largest
error over the sum of the products' magnitudes): the layout and the
rounding.

Prints one JSON line a case and, with ``-o``, writes them with the card's
name and power limit.

Usage: python3 scripts/mma_rounding_torch.py [-o FILE]
       (A CUDA device and nvcc are required.)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BUILD = REPO / "build" / "lbm_tpu_torch" / "mma_rounding"

SOURCE = r'''
// How the tensor cores round one m16n8k8 product: tf32 inputs with f32
// accumulation, and f64. Each warp multiplies its own random A (16x8) and
// B (8x8) from zero; the host compares D with the exact sums.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <random>
#include <vector>

__global__ void mma_tf32(const float* A, const float* B, float* D) {
    const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* a = A + w * 128; const float* b = B + w * 64; float* d = D + w * 128;
    uint32_t a0 = __float_as_uint(a[g * 8 + t]), a1 = __float_as_uint(a[(g + 8) * 8 + t]);
    uint32_t a2 = __float_as_uint(a[g * 8 + t + 4]), a3 = __float_as_uint(a[(g + 8) * 8 + t + 4]);
    uint32_t b0 = __float_as_uint(b[t * 8 + g]), b1 = __float_as_uint(b[(t + 4) * 8 + g]);
    float c[4] = {0, 0, 0, 0};
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    d[g * 8 + 2 * t] = c[0]; d[g * 8 + 2 * t + 1] = c[1];
    d[(g + 8) * 8 + 2 * t] = c[2]; d[(g + 8) * 8 + 2 * t + 1] = c[3];
}

__global__ void mma_f64(const double* A, const double* B, double* D) {
    const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const double* a = A + w * 128; const double* b = B + w * 64; double* d = D + w * 128;
    double c[4] = {0, 0, 0, 0};
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[g * 8 + t]), "d"(a[(g + 8) * 8 + t]), "d"(a[g * 8 + t + 4]), "d"(a[(g + 8) * 8 + t + 4]),
          "d"(b[t * 8 + g]), "d"(b[(t + 4) * 8 + g]));
    d[g * 8 + 2 * t] = c[0]; d[g * 8 + 2 * t + 1] = c[1];
    d[(g + 8) * 8 + 2 * t] = c[2]; d[(g + 8) * 8 + 2 * t + 1] = c[3];
}

static float tf32(float x) {  // round to nearest, ties away, 10 mantissa bits
    uint32_t u; memcpy(&u, &x, 4); u = (u + 0x1000u) & 0xffffe000u; memcpy(&x, &u, 4); return x;
}

int main() {
    const int W = 4096;  // warps
    for (int signs = 0; signs < 2; ++signs) {
        std::mt19937_64 rng(7 + signs);
        std::uniform_real_distribution<double> mag(0.01, 1.0);
        std::vector<float> A(W * 128), B(W * 64), D(W * 128);
        for (auto& x : A) x = tf32((float)(mag(rng) * (signs && (rng() & 1) ? -1 : 1)));
        for (auto& x : B) x = tf32((float)(mag(rng) * (signs && (rng() & 1) ? -1 : 1)));
        float *dA, *dB, *dD;
        cudaMalloc(&dA, A.size() * 4); cudaMalloc(&dB, B.size() * 4); cudaMalloc(&dD, D.size() * 4);
        cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
        cudaMemcpy(dB, B.data(), B.size() * 4, cudaMemcpyHostToDevice);
        mma_tf32<<<W / 8, 256>>>(dA, dB, dD);
        cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost);
        long rn = 0, rz = 0, both = 0, other = 0, n = 0; double ulps = 0, worst = 0;
        for (int w = 0; w < W; ++w) for (int m = 0; m < 16; ++m) for (int j = 0; j < 8; ++j) {
            double e = 0;  // exact: 22-bit products, sums well inside 53 bits
            for (int k = 0; k < 8; ++k) e += (double)A[w * 128 + m * 8 + k] * (double)B[w * 64 + k * 8 + j];
            float r_n = (float)e;
            float r_z = (std::fabs((double)r_n) > std::fabs(e)) ? std::nextafterf(r_n, 0.0f) : r_n;
            float got = D[w * 128 + m * 8 + j];
            bool isn = got == r_n, isz = got == r_z;
            rn += isn && !isz; rz += isz && !isn; both += isn && isz; other += !isn && !isz; ++n;
            double ulp = std::fabs(std::nextafterf(r_n, INFINITY) - r_n);
            double err = ((double)got - e) / ulp * (e < 0 ? -1 : 1);  // signed toward |e|: negative = toward zero
            ulps += err; worst = std::fmax(worst, std::fabs(err));
        }
        printf("{\"what\": \"tf32 m16n8k8, f32 accumulate from 0\", \"signs\": \"%s\", \"n\": %ld, \"rn_only\": %ld, \"rz_only\": %ld, \"exact\": %ld, \"neither\": %ld, \"mean_err_ulps_toward_magnitude\": %.6f, \"max_abs_err_ulps\": %.4f}\n",
               signs ? "mixed" : "positive", n, rn, rz, both, other, ulps / n, worst);
        cudaFree(dA); cudaFree(dB); cudaFree(dD);
    }
    // f64: the layout (same as tf32's) and the rounding against long double.
    std::mt19937_64 rng(11);
    std::uniform_real_distribution<double> val(-1.0, 1.0);
    std::vector<double> A(W * 128), B(W * 64), D(W * 128);
    for (auto& x : A) x = val(rng);
    for (auto& x : B) x = (double)(float)val(rng);
    double *dA, *dB, *dD;
    cudaMalloc(&dA, A.size() * 8); cudaMalloc(&dB, B.size() * 8); cudaMalloc(&dD, D.size() * 8);
    cudaMemcpy(dA, A.data(), A.size() * 8, cudaMemcpyHostToDevice);
    cudaMemcpy(dB, B.data(), B.size() * 8, cudaMemcpyHostToDevice);
    mma_f64<<<W / 8, 256>>>(dA, dB, dD);
    cudaError_t err = cudaMemcpy(D.data(), dD, D.size() * 8, cudaMemcpyDeviceToHost);
    long eq_seq = 0, n = 0; double worst_rel = 0;
    for (int w = 0; w < W; ++w) for (int m = 0; m < 16; ++m) for (int j = 0; j < 8; ++j) {
        long double e = 0; double s = 0;
        for (int k = 0; k < 8; ++k) { e += (long double)A[w * 128 + m * 8 + k] * B[w * 64 + k * 8 + j]; s = std::fma(A[w * 128 + m * 8 + k], B[w * 64 + k * 8 + j], s); }
        double got = D[w * 128 + m * 8 + j];
        eq_seq += got == s; ++n;
        double scale = 0; for (int k = 0; k < 8; ++k) scale += std::fabs(A[w * 128 + m * 8 + k] * B[w * 64 + k * 8 + j]);
        worst_rel = std::fmax(worst_rel, (double)std::fabs((long double)got - e) / scale);
    }
    printf("{\"what\": \"f64 m16n8k8\", \"cuda\": \"%s\", \"n\": %ld, \"equal_to_sequential_fma\": %ld, \"max_err_over_sum_abs_products\": %.3e}\n",
           cudaGetErrorString(err), n, eq_seq, worst_rel);
    return 0;
}
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from lbm_tpu_torch.ops import _build

    BUILD.mkdir(parents=True, exist_ok=True)
    src, exe = BUILD / "mma_rounding.cu", BUILD / "mma_rounding"
    src.write_text(SOURCE)
    cc = subprocess.run([_build.nvcc_path(), "-gencode",
                         "arch=compute_90a,code=sm_90a", "-O2", "-o", str(exe),
                         str(src)], capture_output=True, text=True)
    if cc.returncode != 0:
        print(cc.stdout + cc.stderr, file=sys.stderr)
        return 2
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    if run.returncode != 0:
        print(run.stdout + run.stderr, file=sys.stderr)
        return 2
    rows = [json.loads(ln) for ln in run.stdout.splitlines() if ln.strip()]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps({"card": card, "rows": rows},
                                                indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
