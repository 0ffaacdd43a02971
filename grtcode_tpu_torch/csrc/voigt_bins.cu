// Bin-method Voigt optical depth (wavenumber_sweep / line_sweep) for one
// molecule on one window of spectral bins.
//
// Replaces the Pallas TPU kernel grtcode_tpu/gas_optics/bins_pallas.py
// ::_bin_kernel (launched by bins_pallas).  For bin j of the window
// [start_bin, start_bin + nbins) it computes
//
//   fine[row, (j - start_bin) ppb + p]
//       += sum over local lines l in [llo_j, lend_j) of S_l n_row/1e20 K
//   coarse[row, j - start_bin, k]
//       += the same sum over the remote lines [rlo_j, rendl_j) and
//          [rhs_j, rendr_j), at the bin's interpolation point w_rel[j, k]
//
// with the full Voigt K (five Humlicek regions, pure Lorentz for
// y >= 70.55) at x = ((pos - cidx) - frac) dw sqrt(ln2)/alpha_d.  The index
// ranges alone decide which lines add: lines whose centre lies just off
// the grid add their wings too.  Fine points at or past num_wpoints (the
// short last bin) are not written.  The quadratic interpolation of the
// coarse wings runs afterwards in PyTorch (bins.interpolate_bins).
//
// Design.  Each thread owns one (row, fine point) or one (row, coarse
// point) output, keeps its sum in a register in line-index order and adds
// once into the buffer at the end: no atomics, reruns are bit-identical.
// One launch holds two kinds of block, both kTile points by kRows rows:
// fine blocks take kTile consecutive fine points of the window, coarse
// blocks kTile consecutive coarse points (bin, k).  A block walks the
// contiguous union of its bins' line ranges (local ranges for a fine
// block, remote ranges for a coarse one) in chunks of kChunk lines; for
// each chunk every thread computes one (row, line) factor set into shared
// memory, and the threads of a warp (one row) then read the same factors.
// A thread skips the lines outside its own bin's ranges.
//
// What bounds it on the card: f32 arithmetic and IEEE division, as in the
// line_sample kernel.  A (row, line) pair's ~20 input bytes serve a whole
// tile of points.  Most samples are Humlicek region 0 (one division); the
// ~300-operation five-region evaluation runs only for the samples that
// need it, as a per-thread branch.
//
// Rounding.  x, y, the region-0 limit and every term are computed with the
// same operations in the same order as the plain PyTorch version
// (bins.accumulate_bins -> voigt.voigt_line_shape), and the file is built
// with -fmad=false (see humlicek.cuh), so every (row, line, point) term
// rounds as there and each sample lands in the same region; only the order
// of the sum over lines differs.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (no PyTorch headers); no fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "humlicek.cuh"

namespace {

using namespace grtcode;

constexpr int kTile = 32;                 // points per block (one warp)
constexpr int kRows = 8;                  // rows per block (one per warp)
constexpr int kThreads = kTile * kRows;
constexpr int kChunk = kThreads / kRows;  // lines per shared chunk
constexpr int kNip = 3;                   // interpolation points per bin

// Per-(row, line) factors, 32 bytes.
struct __align__(16) LineFactors {
  int cidx;      // per-row rounded center [grid points]
  float frac;    // fractional center offset [grid points]
  float repwid;  // sqrt(ln2) / alpha_d
  float y;       // y clamped to 70 (Humlicek path)
  float num0;    // region 0: y / sqrt(pi); Lorentz: repwid y
  float yq;      // y^2 (Lorentz: unclamped y^2)
  float xlim0;   // region-0 bound on |x| (Lorentz: -1)
  float sns;     // S n / 1e20
};

__global__ void __launch_bounds__(kThreads) voigt_bins_kernel(
    const int* __restrict__ center_idx, const float* __restrict__ center_frac,
    const float* __restrict__ strength, const float* __restrict__ lorentz,
    const float* __restrict__ doppler, const float* __restrict__ ns,
    const int* __restrict__ bounds, const float* __restrict__ w_rel,
    float* __restrict__ fine, float* __restrict__ coarse, int64_t rows,
    int64_t num_lines, int start_bin, int nbins, int total_bins, int ppb,
    int64_t num_wpoints, int fine_tiles, int tiles, float dw) {
  __shared__ LineFactors factors[kRows * kChunk];
  __shared__ int s_lo, s_hi;

  // bounds: (6, total_bins) int32: local, remote-left, remote-right
  // half-open ranges.
  const int* llo = bounds;
  const int* lend = bounds + total_bins;
  const int* rlo = bounds + 2 * total_bins;
  const int* rendl = bounds + 3 * total_bins;
  const int* rhs = bounds + 4 * total_bins;
  const int* rendr = bounds + 5 * total_bins;

  const int tid = threadIdx.x;
  const int px = tid % kTile;
  const int ry = tid / kTile;
  // Tiles vary fastest: neighbouring blocks share rows and most lines.
  const int tile = (int)(blockIdx.x % (unsigned)tiles);
  const int64_t strip = blockIdx.x / (unsigned)tiles;
  const bool is_coarse = tile >= fine_tiles;
  const int64_t row0 = strip * kRows;
  const int64_t row = row0 + ry;

  // This thread's output, bin, line ranges and evaluation position.
  const int per_bin = is_coarse ? kNip : ppb;
  const int64_t span = (int64_t)nbins * per_bin;   // outputs per row
  const int64_t first = (int64_t)(is_coarse ? tile - fine_tiles : tile) *
                        kTile;
  const int64_t q = first + px;                    // window-local output
  const int j = start_bin + (int)(q / per_bin);    // global bin
  bool own = row < rows && q < span && j < total_bins;
  int lo1 = 0, hi1 = 0, lo2 = 0, hi2 = 0;
  float pos = 0.0f;
  if (!is_coarse) {
    const int64_t g = (int64_t)start_bin * ppb + q;  // global fine index
    own = own && g < num_wpoints;
    if (own) {
      lo1 = llo[j];
      hi1 = lend[j];
      pos = (float)g;
    }
  } else if (own) {
    lo1 = rlo[j];
    hi1 = rendl[j];
    lo2 = rhs[j];
    hi2 = rendr[j];
    pos = w_rel[(int64_t)j * kNip + (int)(q % kNip)];
  }

  // The union of the tile's bins' ranges.
  if (tid == 0) {
    s_lo = 0x7fffffff;
    s_hi = 0;
  }
  __syncthreads();
  {
    const int jb0 = start_bin + (int)(first / per_bin);
    const int64_t last = (first + kTile < span ? first + kTile : span) - 1;
    const int jb1 = start_bin + (int)(last / per_bin);
    for (int jb = jb0 + tid; jb <= jb1 && jb < total_bins; jb += kThreads) {
      int lo = 0x7fffffff, hi = 0;
      if (!is_coarse) {
        if (lend[jb] > llo[jb]) {
          lo = llo[jb];
          hi = lend[jb];
        }
      } else {
        if (rendl[jb] > rlo[jb]) {
          lo = rlo[jb];
          hi = rendl[jb];
        }
        if (rendr[jb] > rhs[jb]) {
          lo = min(lo, rhs[jb]);
          hi = max(hi, rendr[jb]);
        }
      }
      if (hi > lo) {
        atomicMin(&s_lo, lo);
        atomicMax(&s_hi, hi);
      }
    }
  }
  __syncthreads();
  const int lo_b = s_lo;
  const int hi_b = (int)min((int64_t)s_hi, num_lines);

  float acc = 0.0f;
  for (int c0 = lo_b; c0 < hi_b; c0 += kChunk) {
    // Per-(row, line) factors of this chunk: one per thread.
    {
      const int r = tid / kChunk;
      const int k = tid - r * kChunk;
      const int64_t fr = row0 + r;
      const int l = c0 + k;
      LineFactors f;
      f.cidx = 0;
      f.frac = 0.0f;
      f.repwid = 0.0f;
      f.y = 0.0f;
      f.num0 = 0.0f;
      f.yq = 1.0f;
      f.xlim0 = -1.0f;
      f.sns = 0.0f;
      if (fr < rows && l < hi_b) {
        const int64_t off = fr * num_lines + l;
        const float repwid = kSqrtLn2 / doppler[off];
        const float y_true = repwid * lorentz[off];
        const bool lor = y_true >= 70.55f;
        const float y = fminf(y_true, 70.0f);
        f.cidx = center_idx[off];
        f.frac = center_frac[off];
        f.repwid = repwid;
        f.y = y;
        f.num0 = lor ? repwid * y_true : y * kRsqrpi;
        f.yq = lor ? y_true * y_true : y * y;
        f.xlim0 = lor ? -1.0f : sqrtf(xlim0_sq(y));
        f.sns = strength[off] * (ns[fr] / kStrengthScale);
      }
      factors[tid] = f;
    }
    __syncthreads();

    if (own) {
      const LineFactors* fr = factors + ry * kChunk;
      const int n = min(kChunk, hi_b - c0);
      for (int i = 0; i < n; ++i) {
        const int l = c0 + i;
        if (!((l >= lo1 && l < hi1) || (l >= lo2 && l < hi2))) continue;
        const LineFactors f = fr[i];
        const float xi = (((pos - (float)f.cidx) - f.frac) * dw) * f.repwid;
        const float xq = xi * xi;
        float k;
        if (f.xlim0 < 0.0f) {
          // Pure Lorentz: repwid y / (pi (x^2 + y^2)).
          k = f.num0 / (kPi * (xq + f.yq));
        } else if (fabsf(xi) >= f.xlim0) {
          // Region 0: sqrt(1/pi) repwid (y / sqrt(pi)) / (x^2 + y^2).
          k = (kRsqrpi * f.repwid) * (f.num0 / (xq + f.yq));
        } else {
          k = (kRsqrpi * f.repwid) * humlicek_k(xi, f.y);
        }
        acc += f.sns * k;
      }
    }
    __syncthreads();
  }
  if (own) {
    float* out = is_coarse ? coarse : fine;
    out[row * span + q] += acc;
  }
}

}  // namespace

extern "C" int voigt_bins(
    const void* center_idx, const void* center_frac, const void* strength,
    const void* lorentz, const void* doppler, const void* ns,
    const void* bounds, const void* w_rel, void* fine, void* coarse,
    int64_t rows, int64_t num_lines, int start_bin, int nbins,
    int total_bins, int ppb, int64_t num_wpoints, float dw, void* stream) {
  if (rows <= 0 || nbins <= 0) return 0;
  const int fine_tiles = (int)(((int64_t)nbins * ppb + kTile - 1) / kTile);
  const int coarse_tiles = (int)(((int64_t)nbins * kNip + kTile - 1) / kTile);
  const int64_t row_strips = (rows + kRows - 1) / kRows;
  const int64_t blocks = row_strips * (fine_tiles + coarse_tiles);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  voigt_bins_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)center_idx, (const float*)center_frac,
      (const float*)strength, (const float*)lorentz, (const float*)doppler,
      (const float*)ns, (const int*)bounds, (const float*)w_rel,
      (float*)fine, (float*)coarse, rows, num_lines, start_bin, nbins,
      total_bins, ppb, num_wpoints, fine_tiles, fine_tiles + coarse_tiles,
      dw);
  return (int)cudaGetLastError();
}
