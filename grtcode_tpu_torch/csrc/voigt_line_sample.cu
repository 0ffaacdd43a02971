// line_sample Voigt optical depth for one molecule on one spectral block.
//
// Replaces the Pallas TPU kernel grtcode_tpu/gas_optics/pallas_kernels.py
// ::_voigt_kernel (launched by voigt_pallas).  It computes
//
//   tau[row, g] += sum_l  S_l * n_row / 1e20 * K(x, y)
//
// over the center-sorted lines whose per-row rounded center cidx satisfies
// |g - cidx| <= fsteps, with 0 <= cidx < num_global and g < num_global.
// Far wings (|g - cidx| > near) use Humlicek regions 0/1 (exact there: the
// near window is sized so |x| >= 13 outside it); the near core uses the
// full five-region RFM scheme; lines with y >= 70.55 are pure Lorentz.
//
// What bounds it on the card: f32 arithmetic and the IEEE division of
// every (row, line, point) term.  Each (row, line) pair's ~20 input bytes
// serve up to 2*fsteps+1 points (501 at 0.1 cm-1), so device memory is not
// the limit.  The design keeps each term to as few instructions around its
// one division as the rounding allows:
//
//   * A block covers a spectral tile of `tile` points and a strip of rows;
//     each thread owns kPoints consecutive points of one row and keeps
//     their sums in registers, so a line's factors, read from shared
//     memory once, serve kPoints terms.
//   * The block walks the center-sorted lines that can reach its tile in
//     chunks of kChunk; per chunk it computes the per-(row, line) factors
//     once into shared memory (one row per warp: the reads broadcast).
//   * Zones (host tables, build_chunk_ranges, as the TPU kernel's): the
//     lines split into runs by their distance from the tile.  Interior
//     lines cover the whole tile, lie beyond the region-0 half-width and
//     cannot shift off the grid: their term is num0 / (x^2 + y^2) with no
//     window, near, validity or region test.  Edge lines keep only the
//     window test.  Core-adjacent lines keep every test.  Every zone
//     computes the bits the full path would: it only drops tests whose
//     outcome the tables prove.
//   * Near core: for the chunks whose lines can have a near-core sample in
//     the tile, the block first evaluates every such (row, line, offset)
//     sample, one (row, line) per thread with its Humlicek coefficients in
//     registers and the lanes of a warp at the same offset of 32 lines,
//     into shared memory.  The point loop then reads the value instead of
//     branching into the five-region evaluation for one lane of a warp.
//
// Every output sums its lines in line-index order into a register and adds
// once into tau (in place): no atomics, so two runs are bit-identical, and
// the result is bit-identical to the one-path kernel this design replaced.
//
// Rounding.  x, y and every Humlicek region limit are computed with the
// same operations, in the same order, as the plain PyTorch version
// (voigt_kernel.voigt_line_sample_reference): ((g - cidx) - frac) * dw *
// repwid with repwid = sqrt(ln2) / alpha_d.  Both then place every sample
// in the same region; a sample one ulp across a region limit would
// otherwise differ by up to 1e-4 (regions 0 and 1 at |x| ~ 123), and in
// the Gaussian core a 1-ulp change of x moves K by ~2 x^2 ulps.  The file
// is also built without FMA contraction (nvcc -fmad=false): with the
// limits rounded as here but the rationals, polynomials and CPF sums
// contracted, the kernel misses the 2e-6 bar against the plain version by
// up to 12x (H100, rfmip_like LW O2 and SW H2O at 1,728 rows).
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (no PyTorch headers); no fast-math: IEEE division and no
// flush-to-zero, since the far-wing tails are small numbers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "humlicek.cuh"

namespace {

using namespace grtcode;

constexpr int kChunk = 32;         // lines per shared-memory chunk
constexpr int kStride = kChunk + 1;  // factor row stride (bank offset)
constexpr int kPoints = 4;         // consecutive points per thread
constexpr int kThreads = 256;      // threads per block
constexpr int kInvalid = -(1 << 30);  // cidx of a line that adds nothing
constexpr int kZoneCols = 10;      // per-tile table columns (see below)
constexpr size_t kMaxSmem = 227 * 1024;

constexpr float kRsqrpiSq = (float)(0.56418958 * 0.56418958);

// Per-(row, line) factors, 48 bytes.  The interior path reads the first
// two 16-byte words only.
struct __align__(16) LineFactors {
  int cidx;      // per-row rounded center, kInvalid if the line is out
  float frac;    // fractional center offset [grid points]
  float repwid;  // sqrt(ln2) / alpha_d
  float num0;    // region-0 numerator y / pi (Lorentz: repwid y / pi)
  float yq;      // y^2 (Lorentz: unclamped y^2)
  float sns;     // S n / 1e20
  float xlim0;   // region-0 bound on x^2 (Lorentz: -1, always region 0)
  float a0;      // y^2 + 1/2
  float d0;      // a0^2
  float d2;      // 2 y^2 - 1
  float y;       // y clamped to 70
  float kfac;    // sqrt(1/pi) repwid
};

enum Zone { kEdge = 0, kInterior = 1, kCore = 2 };

__device__ __forceinline__ float4 word(const LineFactors& f, int i) {
  return reinterpret_cast<const float4*>(&f)[i];
}

__device__ __forceinline__ LineFactors line_factors(
    const int* center_idx, const float* center_frac, const float* strength,
    const float* lorentz, const float* doppler, const float* ns, int64_t fr,
    int l, int64_t rows, int hi, int64_t num_lines, int num_global) {
  LineFactors f;
  f.cidx = kInvalid;
  f.frac = 0.0f;
  f.repwid = 0.0f;
  f.num0 = 0.0f;
  f.yq = 1.0f;
  f.sns = 0.0f;
  f.xlim0 = -1.0f;
  f.a0 = 1.0f;
  f.d0 = 1.0f;
  f.d2 = 1.0f;
  f.y = 0.0f;
  f.kfac = 0.0f;
  if (fr < rows && l < hi) {
    const int64_t off = fr * num_lines + l;
    const int cidx = center_idx[off];
    if (cidx >= 0 && cidx < num_global) {
      const float sns = strength[off] * (ns[fr] / kStrengthScale);
      const float repwid = kSqrtLn2 / doppler[off];
      const float y_true = repwid * lorentz[off];
      const bool lor = y_true >= 70.55f;
      const float y = fminf(y_true, 70.0f);
      const float yq = y * y;
      f.cidx = cidx;
      f.frac = center_frac[off];
      f.repwid = repwid;
      f.num0 = lor ? repwid * y_true / kPi : (kRsqrpiSq * repwid) * y;
      f.yq = lor ? y_true * y_true : yq;
      f.xlim0 = lor ? -1.0f : xlim0_sq(y);
      f.a0 = yq + 0.5f;
      f.d0 = f.a0 * f.a0;
      f.d2 = yq + yq - 1.0f;
      f.y = y;
      f.sns = sns;
      f.kfac = kRsqrpi * repwid;
    }
  }
  return f;
}

// zones: (num_tiles, kZoneCols) int32 line-index bounds per tile:
//   lo, hi            every line that can reach the tile
//   near_lo, near_hi  lines that can have a near-core sample in the tile
//   core_lo, core_hi  core-adjacent lines (every test kept)
//   left_lo, left_hi, right_lo, right_hi   interior lines
// Lines of [lo, hi) in none of the last three ranges are edge lines.
__global__ void __launch_bounds__(kThreads) voigt_line_sample_kernel(
    const int* __restrict__ center_idx, const float* __restrict__ center_frac,
    const float* __restrict__ strength, const float* __restrict__ lorentz,
    const float* __restrict__ doppler, const float* __restrict__ ns,
    const int* __restrict__ zones, float* __restrict__ tau, int64_t rows,
    int64_t num_lines, int start, int num_wpoints, int num_global, int fsteps,
    int near, int tile, int first_tile, int num_tiles, float dw) {
  extern __shared__ float4 smem[];
  __shared__ int z[kZoneCols];      // this tile's row of the zone table
  const int nrows = blockDim.y;                         // rows per block
  LineFactors* factors = reinterpret_cast<LineFactors*>(smem);
  const int width = 2 * near + 1;                       // near-core offsets
  float* nearval = reinterpret_cast<float*>(factors + nrows * kStride);

  const int px = threadIdx.x;
  const int ry = threadIdx.y;
  const int nthreads = blockDim.x * nrows;
  const int tid = ry * blockDim.x + px;
  const int64_t row0 = (int64_t)blockIdx.x * nrows;
  const int64_t row = row0 + ry;
  const int t = first_tile + (int)blockIdx.y;           // global tile index
  const int tile0 = (int)blockIdx.y * tile;             // block-local start
  const int gt0 = start + tile0;                        // its global point
  const int l0 = tile0 + px * kPoints;                  // this thread's
  const int g0 = start + l0;                            //   first point

  if (tid < kZoneCols) {
    z[tid] = (t < num_tiles) ? zones[(int64_t)t * kZoneCols + tid] : 0;
  }
  __syncthreads();
  const int lo = z[0];
  const int hi = (int)min((int64_t)z[1], num_lines);
  const int near_lo = z[2], near_hi = z[3];

  float acc[kPoints];
#pragma unroll
  for (int p = 0; p < kPoints; ++p) acc[p] = 0.0f;

  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    // 1. Per-(row, line) factors of this chunk, once per block.
    for (int i = tid; i < nrows * kChunk; i += nthreads) {
      const int r = i / kChunk;
      const int k = i - r * kChunk;
      factors[r * kStride + k] =
          line_factors(center_idx, center_frac, strength, lorentz, doppler,
                       ns, row0 + r, c0 + k, rows, hi, num_lines, num_global);
    }
    __syncthreads();

    // 2. Near-core samples that fall in the tile: one (row, line) per
    // thread, its coefficients in registers; the lanes of a warp take the
    // same offset of neighbouring lines.
    const int nlo = max(c0, near_lo), nhi = min(c0 + n, near_hi);
    if (nlo < nhi) {
      for (int i = tid; i < nrows * kChunk; i += nthreads) {
        const int r = i / kChunk;
        const int k = i - r * kChunk;
        const int l = c0 + k;
        const LineFactors& f = factors[r * kStride + k];
        if (l < nlo || l >= nhi || f.xlim0 < 0.0f) continue;  // Lorentz too
        const int olo = max(-near, gt0 - f.cidx);
        const int ohi = min(near, gt0 + tile - 1 - f.cidx);
        if (olo > ohi) continue;
        const HumlicekCoeffs hc = humlicek_coeffs(f.y);
        float* out = nearval + (r * kChunk + k) * width + near;
        for (int o = olo; o <= ohi; ++o) {
          const float xi = (((float)o - f.frac) * dw) * f.repwid;
          out[o] = f.kfac * humlicek_k(xi, hc);
        }
      }
      __syncthreads();
    }

    // 3. The thread's points, run by run of one zone, in line order.
    if (row < rows) {
      const LineFactors* fr = factors + ry * kStride;
      const float* nv = nearval + ry * kChunk * width + near;
      int j = 0;
      while (j < n) {
        const int l = c0 + j;
        // The zone of line l (core first) and the end of its run: the
        // next table bound past l.
        const int zone = (l >= z[4] && l < z[5]) ? kCore
                         : ((l >= z[6] && l < z[7]) ||
                            (l >= z[8] && l < z[9])) ? kInterior : kEdge;
        int end = c0 + n;
#pragma unroll
        for (int i = 4; i < kZoneCols; ++i) {
          if (z[i] > l && z[i] < end) end = z[i];
        }
        const int je = end - c0;
        if (zone == kInterior) {
          // Window, validity, near core and region 0 all hold.
          for (; j < je; ++j) {
            const float4 a = word(fr[j], 0);   // cidx frac repwid num0
            const float4 b = word(fr[j], 1);   // yq sns xlim0 a0
            const float base = (float)(g0 - __float_as_int(a.x));
#pragma unroll
            for (int p = 0; p < kPoints; ++p) {
              const float xi = (((base + (float)p) - a.y) * dw) * a.z;
              const float xq = xi * xi;
              acc[p] += b.y * div_rn(a.w, xq + b.x);
            }
          }
        } else if (zone == kEdge) {
          // Beyond the near core and region 0: the window test only (it
          // also drops lines off the grid).
          for (; j < je; ++j) {
            const float4 a = word(fr[j], 0);
            const float4 b = word(fr[j], 1);
            const int d0 = g0 - __float_as_int(a.x);
#pragma unroll
            for (int p = 0; p < kPoints; ++p) {
              const int delta = d0 + p;
              if (abs(delta) > fsteps) continue;
              const float xi = (((float)delta - a.y) * dw) * a.z;
              const float xq = xi * xi;
              acc[p] += b.y * div_rn(a.w, xq + b.x);
            }
          }
        } else {
          for (; j < je; ++j) {
            const float4 a = word(fr[j], 0);
            const float4 b = word(fr[j], 1);
            const float4 c = word(fr[j], 2);   // d0 d2 y kfac
            const int d0 = g0 - __float_as_int(a.x);
#pragma unroll
            for (int p = 0; p < kPoints; ++p) {
              const int delta = d0 + p;
              const int adelta = abs(delta);
              if (adelta > fsteps) continue;
              float k;
              if (adelta <= near && b.z >= 0.0f) {
                k = nv[j * width + delta];     // near core, from step 2
              } else {
                // Far wing (or a pure-Lorentz line): one rational.
                const float xi = (((float)delta - a.y) * dw) * a.z;
                const float xq = xi * xi;
                const bool reg0 = xq >= b.z;
                const float num = reg0 ? a.w : a.w * (b.w + xq);
                const float den = reg0 ? xq + b.x : c.x + xq * (c.y + xq);
                k = div_rn(num, den);
              }
              acc[p] += b.y * k;
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (row < rows) {
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      const int local = l0 + p;
      if (local < tile0 + tile && local < num_wpoints &&
          start + local < num_global) {
        tau[row * num_wpoints + local] += acc[p];
      }
    }
  }
}

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0: launched).
extern "C" int voigt_line_sample(
    const void* center_idx, const void* center_frac, const void* strength,
    const void* lorentz, const void* doppler, const void* ns,
    const void* zones, void* tau, int64_t rows, int64_t num_lines, int start,
    int num_wpoints, int num_global, int fsteps, int near, int tile,
    int num_tiles, float dw, void* stream) {
  if (rows <= 0 || num_wpoints <= 0) return 0;
  if (tile <= 0 || start % tile != 0 || near < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int bx = (tile + kPoints - 1) / kPoints;
  if (bx > kThreads) return (int)cudaErrorInvalidValue;
  int rows_per_block = kThreads / bx;
  const int width = 2 * near + 1;
  auto smem_bytes = [&](int r) {
    return sizeof(LineFactors) * kStride * r +
           sizeof(float) * kChunk * width * r;
  };
  while (rows_per_block > 1 && smem_bytes(rows_per_block) > kMaxSmem) {
    rows_per_block /= 2;
  }
  const size_t smem = smem_bytes(rows_per_block);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      voigt_line_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(bx, rows_per_block);
  const int64_t row_blocks = (rows + rows_per_block - 1) / rows_per_block;
  const int block_tiles = (num_wpoints + tile - 1) / tile;
  const dim3 grid((unsigned)row_blocks, (unsigned)block_tiles);
  voigt_line_sample_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)center_idx, (const float*)center_frac,
      (const float*)strength, (const float*)lorentz, (const float*)doppler,
      (const float*)ns, (const int*)zones, (float*)tau, rows, num_lines,
      start, num_wpoints, num_global, fsteps, near, tile, start / tile,
      num_tiles, dw);
  return (int)cudaGetLastError();
}
