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
// Design.  Each thread owns one (row, grid point) output and sums the
// lines into a register in line-index order, then adds once into tau (in
// place).  No atomics, so two runs are bit-identical.  A block covers a
// spectral tile of `tile` points and a strip of rows; it walks the
// contiguous range of center-sorted lines that can reach its tile (host
// table built with searchsorted, as build_chunk_ranges does for the TPU),
// in chunks of kChunk lines.  For each chunk the block computes the
// per-(row, line) factors once into shared memory; every thread of a
// warp then reads the same factors (one row per warp), a broadcast.
//
// What bounds it on the card: f32 arithmetic and IEEE division.  Each
// (row, line) pair's ~20 input bytes are reused across up to 2*fsteps+1
// (501 at 0.1 cm-1) points, so device memory is not the limit; every
// (row, point, line) pair costs ~20 f32 operations and one division in
// the far wing.  The design keeps the far-wing path to one rational with a
// single division, computes the ~300-operation five-region evaluation only
// where a thread's own point is in the near core (a per-thread branch,
// not a computed-and-selected lane), and hoists every point-independent
// factor into shared memory.
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
constexpr int kMaxRows = 16;       // rows per block
constexpr int kInvalid = -(1 << 30);  // cidx of a line that adds nothing

constexpr float kRsqrpiSq = (float)(0.56418958 * 0.56418958);

// Per-(row, line) factors, 48 bytes: three 16-byte shared-memory loads.
struct __align__(16) LineFactors {
  int cidx;      // per-row rounded center, kInvalid if the line is out
  float frac;    // fractional center offset [grid points]
  float repwid;  // sqrt(ln2) / alpha_d
  float num0;    // region-0 numerator y / pi (Lorentz: repwid y / pi)
  float yq;      // y^2 (Lorentz: unclamped y^2)
  float xlim0;   // region-0 bound on x^2 (Lorentz: -1, always region 0)
  float a0;      // y^2 + 1/2
  float d0;      // a0^2
  float d2;      // 2 y^2 - 1
  float y;       // y clamped to 70
  float sns;     // S n / 1e20
  float kfac;    // sqrt(1/pi) repwid
};

__global__ void voigt_line_sample_kernel(
    const int* __restrict__ center_idx, const float* __restrict__ center_frac,
    const float* __restrict__ strength, const float* __restrict__ lorentz,
    const float* __restrict__ doppler, const float* __restrict__ ns,
    const int* __restrict__ tile_lo, const int* __restrict__ tile_hi,
    float* __restrict__ tau, int64_t rows, int64_t num_lines, int start,
    int num_wpoints, int num_global, int fsteps, int near, int tile,
    int first_tile, int num_tiles, float dw) {
  extern __shared__ LineFactors factors[];  // [blockDim.y][kChunk]

  const int px = threadIdx.x;
  const int ry = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ry * blockDim.x + px;
  const int64_t row0 = (int64_t)blockIdx.x * blockDim.y;
  const int t = first_tile + (int)blockIdx.y;  // global tile index
  const int local = (int)blockIdx.y * tile + px;  // block-local point
  const int g = start + local;                    // global grid point
  const int64_t row = row0 + ry;
  const bool own = row < rows && px < tile && local < num_wpoints &&
                   g < num_global;

  int lo = 0, hi = 0;
  if (t < num_tiles) {
    lo = tile_lo[t];
    hi = (int)min((int64_t)tile_hi[t], num_lines);
  }

  float acc = 0.0f;
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    // Per-(row, line) factors for this chunk, computed once per block.
    for (int i = tid; i < (int)blockDim.y * kChunk; i += nthreads) {
      const int r = i / kChunk;
      const int k = i - r * kChunk;
      const int64_t fr = row0 + r;
      const int l = c0 + k;
      LineFactors f;
      f.cidx = kInvalid;
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
      factors[i] = f;
    }
    __syncthreads();

    if (own) {
      const LineFactors* fr = factors + ry * kChunk;
      const int n = min(kChunk, hi - c0);
      for (int j = 0; j < n; ++j) {
        const LineFactors f = fr[j];
        const int delta = g - f.cidx;
        const int adelta = abs(delta);
        if (adelta > fsteps) continue;
        const float xi = (((float)delta - f.frac) * dw) * f.repwid;
        const float xq = xi * xi;
        float k;
        if (adelta <= near && f.xlim0 >= 0.0f) {
          // Near core: the full five-region scheme.
          k = f.kfac * humlicek_k(xi, f.y);
        } else {
          // Far wing (or a pure-Lorentz line): one rational.
          const bool reg0 = xq >= f.xlim0;
          const float num = reg0 ? f.num0 : f.num0 * (f.a0 + xq);
          const float den = reg0 ? xq + f.yq : f.d0 + xq * (f.d2 + xq);
          k = num / den;
        }
        acc += f.sns * k;
      }
    }
    __syncthreads();
  }
  if (own) {
    tau[row * num_wpoints + local] += acc;
  }
}

}  // namespace

extern "C" int voigt_line_sample(
    const void* center_idx, const void* center_frac, const void* strength,
    const void* lorentz, const void* doppler, const void* ns,
    const void* tile_lo, const void* tile_hi, void* tau, int64_t rows,
    int64_t num_lines, int start, int num_wpoints, int num_global, int fsteps,
    int near, int tile, int num_tiles, float dw, void* stream) {
  if (rows <= 0 || num_wpoints <= 0) return 0;
  int rows_per_block = 256 / tile;
  if (rows_per_block > kMaxRows) rows_per_block = kMaxRows;
  if (rows_per_block < 1) rows_per_block = 1;
  const dim3 block(tile, rows_per_block);
  const int64_t row_blocks = (rows + rows_per_block - 1) / rows_per_block;
  const int block_tiles = (num_wpoints + tile - 1) / tile;
  const dim3 grid((unsigned)row_blocks, (unsigned)block_tiles);
  const size_t smem = sizeof(LineFactors) * kChunk * rows_per_block;
  voigt_line_sample_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)center_idx, (const float*)center_frac,
      (const float*)strength, (const float*)lorentz, (const float*)doppler,
      (const float*)ns, (const int*)tile_lo, (const int*)tile_hi,
      (float*)tau, rows, num_lines, start, num_wpoints, num_global, fsteps,
      near, tile, start / tile, num_tiles, dw);
  return (int)cudaGetLastError();
}
