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
// What bounds it on the card: f32 arithmetic and the IEEE division of
// every term, as in the line_sample kernel.  A (row, line) pair's ~20
// input bytes serve a whole bin of points.  At the production 0.01 cm-1
// nine samples in ten are a pure-Lorentz or region-0 term (one division);
// region 1 is most of the rest and regions 2-4 are 0.3 % (RFMIP-IRF LW
// step).  One launch holds two kinds of block, 256 threads each, and no
// atomics; every output keeps its sum in a register and adds once into
// its buffer, so reruns are bit-identical.
//
//   * Coarse blocks (launched first: they run longest) take 32 rows, one
//     per lane, by kCoarseBins bins, one per warp; a thread owns the three
//     interpolation points of one (row, bin).  The block computes the
//     per-(row, line) factors of the union of its bins' remote ranges
//     chunk by chunk into shared memory (loaded with lanes over lines, so
//     the global reads coalesce), laid out line-major so the reads, lanes
//     over rows, are free of bank conflicts; each warp then walks exactly
//     its own bin's two remote ranges.  No lane skips a line.
//   * Fine blocks take one bin (or a part of kSlots points of a longer
//     bin) by kRows rows, one row per warp; lane l owns the points l, l +
//     32, l + 64 and l + 96 of the part (101 points at 0.01 cm-1: 79 % of
//     the slots), so a line's factors, read from shared memory once, serve
//     four terms, and the walk is exactly the bin's local range.  When the
//     factors are computed, each (row, line) is tested once at the part's
//     nearest points: if every sample of the line there is Humlicek region
//     0 (or the line is pure Lorentz), its terms are one division;
//     otherwise the line is "tested" and its Humlicek coefficients (limits
//     and region 1-4 polynomials, humlicek.cuh) are computed once into
//     shared memory.  The walk then makes two passes over each chunk: a
//     branch-free pass over the untested lines, then a pass over the tested
//     lines (a warp ballot's mask), whose samples inside the region-0 limit
//     evaluate from the coefficients.
//
// Order of the sums.  A coarse output adds its remote lines in line order.
// A fine output adds, chunk by chunk of 32 lines, the untested lines in
// line order and then the tested ones in line order.
//
// Rounding.  x, y, the region-0 limit and every term are computed with the
// same operations in the same order as the plain PyTorch version
// (bins.accumulate_bins -> voigt.voigt_line_shape), and the file is built
// with -fmad=false (see humlicek.cuh), so every (row, line, point) term
// rounds as there and each sample lands in the same region; only the order
// of the sum over lines differs from the plain version.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (no PyTorch headers); no fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "humlicek.cuh"

namespace {

using namespace grtcode;

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;      // fine rows per block (one a warp)
constexpr int kPoints = 4;                // fine points per lane
constexpr int kSlots = 32 * kPoints;      // fine points per block part
constexpr int kChunk = 32;                // lines per shared chunk
constexpr int kNip = 3;                   // interpolation points per bin
constexpr int kCoarseRows = 32;           // coarse rows per block (lanes)
constexpr int kCoarseBins = kThreads / kCoarseRows;  // bins (warps)
constexpr int kPad = kCoarseRows + 1;     // padded row stride

// Per-(row, line) factors, 32 bytes: two 16-byte shared-memory reads.
// The region-0 and pure-Lorentz terms share one form,
//   K = m2 * (num0 / (|m1| * (x^2 + yq))),
// with |m1| = 1, m2 = sqrt(1/pi) repwid in region 0 and m1 = pi, m2 = 1
// for a pure-Lorentz line; a product with 1 is exact, so each rounds as
// its own formula in the plain version does.  m1 = -1 marks a line whose
// samples may fall inside the region-0 limit (|x| < xlim0): those take
// the Humlicek evaluation (m2 K(x, y)).
struct __align__(16) LineFactors {
  float cidx;    // per-row rounded center [grid points], exact in f32
  float frac;    // fractional center offset [grid points]
  float repwid;  // sqrt(ln2) / alpha_d
  float m1;      // 1, pi for a pure-Lorentz line; -1: test each sample
  float num0;    // region 0: y / sqrt(pi); Lorentz: repwid y
  float yq;      // y^2 (Lorentz: unclamped y^2)
  float m2;      // sqrt(1/pi) repwid (Lorentz: 1)
  float sns;     // S n / 1e20
};

struct FineShared {
  LineFactors factors[kRows][kChunk];
  HumlicekCoeffs coeffs[kRows][kChunk];  // only for lines that need them
};

// Coarse blocks: the factors line-major with a padded row stride, and
// each (row, line)'s region-0 limit and y for the samples inside it.
struct CoarseShared {
  LineFactors f[kChunk][kPad];
  float xlim0[kChunk][kPad];
  float y[kChunk][kPad];
};

union SharedBuffers {
  FineShared fine;
  CoarseShared coarse;
};

// The factors of (row fr, line l); `y` is y clamped to 70.
struct RawFactors {
  int cidx;
  float frac, repwid, y, num0, yq, xlim0, sns;
};

__device__ __forceinline__ RawFactors raw_factors(
    const int* center_idx, const float* center_frac, const float* strength,
    const float* lorentz, const float* doppler, const float* ns, int64_t fr,
    int l, int64_t rows, int hi, int64_t num_lines) {
  RawFactors f;
  f.cidx = 0;
  f.frac = 0.0f;
  f.repwid = 0.0f;
  f.y = 0.0f;
  f.num0 = 0.0f;
  f.yq = 1.0f;
  f.xlim0 = -1.0f;
  f.sns = 0.0f;
  if (fr < rows && l < hi) {
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
  return f;
}

__device__ __forceinline__ LineFactors line_factors(const RawFactors& rf,
                                                    bool test) {
  const bool lor = rf.xlim0 < 0.0f;
  const float kfac = kRsqrpi * rf.repwid;
  LineFactors f;
  f.cidx = (float)rf.cidx;
  f.frac = rf.frac;
  f.repwid = rf.repwid;
  f.m1 = lor ? kPi : (test ? -1.0f : 1.0f);
  f.num0 = rf.num0;
  f.yq = rf.yq;
  f.m2 = lor ? 1.0f : kfac;
  f.sns = rf.sns;
  return f;
}

// The region-0 or pure-Lorentz term of one sample at x = xi: one division.
__device__ __forceinline__ float region0_term(float xi, const LineFactors& f) {
  return f.m2 * div_rn(f.num0, fabsf(f.m1) * (xi * xi + f.yq));
}

__device__ void coarse_block(
    SharedBuffers& sh, const int* center_idx, const float* center_frac,
    const float* strength, const float* lorentz, const float* doppler,
    const float* ns, const int* bounds, const float* w_rel, float* coarse,
    int64_t rows, int64_t num_lines, int start_bin, int nbins,
    int total_bins, int tile, int64_t strip, float dw) {
  const int* rlo = bounds + 2 * total_bins;
  const int* rendl = bounds + 3 * total_bins;
  const int* rhs = bounds + 4 * total_bins;
  const int* rendr = bounds + 5 * total_bins;
  LineFactors (*f)[kPad] = sh.coarse.f;
  float (*xlim0)[kPad] = sh.coarse.xlim0;
  float (*yc)[kPad] = sh.coarse.y;

  const int tid = threadIdx.x;
  const int lane = tid % kCoarseRows;
  const int w = tid / kCoarseRows;
  const int64_t row0 = strip * kCoarseRows;
  const int64_t row = row0 + lane;
  const int jw = tile * kCoarseBins + w;            // window-local bin
  const int j = start_bin + jw;                      // global bin
  const bool bin_ok = jw < nbins && j < total_bins;

  // The union of the block's bins' remote ranges: lane b of each warp
  // reads bin b's, and a warp reduction gives every warp the union (one
  // round trip to memory, no barrier).
  int lo = 0x7fffffff, hi = 0;
  {
    const int jb = start_bin + tile * kCoarseBins + lane;
    if (lane < kCoarseBins && tile * kCoarseBins + lane < nbins &&
        jb < total_bins) {
      if (rendl[jb] > rlo[jb]) {
        lo = rlo[jb];
        hi = rendl[jb];
      }
      if (rendr[jb] > rhs[jb]) {
        lo = min(lo, rhs[jb]);
        hi = max(hi, rendr[jb]);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = (int)min((int64_t)__reduce_max_sync(0xffffffffu, hi), num_lines);
  }
  int lo1 = 0, hi1 = 0, lo2 = 0, hi2 = 0;
  float pos[kNip] = {0.0f, 0.0f, 0.0f};
  if (bin_ok && row < rows) {
    lo1 = rlo[j];
    hi1 = rendl[j];
    lo2 = rhs[j];
    hi2 = rendr[j];
#pragma unroll
    for (int k = 0; k < kNip; ++k) pos[k] = w_rel[(int64_t)j * kNip + k];
  }

  float acc[kNip] = {0.0f, 0.0f, 0.0f};
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    // Factors of (32 rows) x (kChunk lines), lanes over lines to load.
    // Any non-Lorentz line may have a sample inside its region-0 limit.
    for (int i = tid; i < kCoarseRows * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int k = i - r * kChunk;
      const RawFactors rf =
          raw_factors(center_idx, center_frac, strength, lorentz, doppler,
                      ns, row0 + r, c0 + k, rows, hi, num_lines);
      f[k][r] = line_factors(rf, true);
      xlim0[k][r] = rf.xlim0;
      yc[k][r] = rf.y;
    }
    __syncthreads();
    // This bin's two remote ranges inside the chunk, in line order (empty
    // for a lane without an output).
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int a = max(part ? lo2 : lo1, c0) - c0;
      const int b = min(part ? hi2 : hi1, c0 + kChunk) - c0;
      for (int k = a; k < b; ++k) {
        const LineFactors lf = f[k][lane];
#pragma unroll
        for (int p = 0; p < kNip; ++p) {
          const float xi = (((pos[p] - lf.cidx) - lf.frac) * dw) * lf.repwid;
          const float kv = (lf.m1 < 0.0f && fabsf(xi) < xlim0[k][lane])
                               ? lf.m2 * humlicek_k(xi, yc[k][lane])
                               : region0_term(xi, lf);
          acc[p] += lf.sns * kv;
        }
      }
    }
    __syncthreads();
  }
  if (bin_ok && row < rows) {
#pragma unroll
    for (int p = 0; p < kNip; ++p) {
      coarse[(row * nbins + jw) * kNip + p] += acc[p];
    }
  }
}

__device__ void fine_block(
    SharedBuffers& sh, const int* center_idx, const float* center_frac,
    const float* strength, const float* lorentz, const float* doppler,
    const float* ns, const int* bounds, float* fine, int64_t rows,
    int64_t num_lines, int start_bin, int nbins, int total_bins, int ppb,
    int64_t num_wpoints, int jw, int part, int64_t strip, float dw) {
  const int* llo = bounds;
  const int* lend = bounds + total_bins;
  LineFactors (*factors)[kChunk] = sh.fine.factors;
  HumlicekCoeffs (*coeffs)[kChunk] = sh.fine.coeffs;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ry = tid / 32;
  const int64_t row0 = strip * kRows;
  const int64_t row = row0 + ry;
  const int j = start_bin + jw;                        // global bin
  const int64_t gbin = (int64_t)j * ppb;               // its first point
  const int first = part * kSlots;                     // this part's slots
  // Points of the part on the grid: first .. first + npts - 1 of the bin.
  const int npts = (int)min((int64_t)min(ppb - first, kSlots),
                            num_wpoints - gbin - first);
  if (j >= total_bins || npts <= 0) return;            // block-uniform
  const int gfirst = (int)(gbin + first), glast = gfirst + npts - 1;
  float pos[kPoints];
#pragma unroll
  for (int p = 0; p < kPoints; ++p) {
    pos[p] = (float)(gfirst + lane + 32 * p);
  }
  const int lo = llo[j];
  const int hi = (int)min((int64_t)lend[j], num_lines);

  float acc[kPoints];
#pragma unroll
  for (int p = 0; p < kPoints; ++p) acc[p] = 0.0f;
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    // Factors of this chunk, one (row, line) per thread, and the Humlicek
    // coefficients of the lines with a sample inside the region-0 limit.
    unsigned tested;
    {
      const int r = tid / kChunk;
      const int k = tid - r * kChunk;
      const RawFactors rf =
          raw_factors(center_idx, center_frac, strength, lorentz, doppler,
                      ns, row0 + r, c0 + k, rows, hi, num_lines);
      bool test = false;
      if (rf.xlim0 >= 0.0f) {
        // |x| is monotone in the point on each side of the centre, so its
        // least value over the part is at the point nearest cidx - 1, cidx
        // or cidx + 1 (|frac| <= 1/2); computed as the samples are.
        float xmin = 3.0e38f;
#pragma unroll
        for (int s = -1; s <= 1; ++s) {
          const int g = min(max(rf.cidx + s, gfirst), glast);
          const float xi = ((((float)g - (float)rf.cidx) - rf.frac) * dw) *
                           rf.repwid;
          xmin = fminf(xmin, fabsf(xi));
        }
        test = xmin < rf.xlim0;
        if (test) coeffs[r][k] = humlicek_coeffs(rf.y);
      }
      factors[r][k] = line_factors(rf, test);
      // Warp r computes row r's factors and then walks row r: bit k of
      // its mask marks line c0 + k for the second pass.
      tested = __ballot_sync(0xffffffffu, test);
    }
    __syncthreads();

    const int n = min(kChunk, hi - c0);
    // Pass 1, branch-free: the region-0 and Lorentz terms of every line
    // but the tested ones, in line order; one line's factors serve the
    // lane's kPoints points.
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      const LineFactors lf = factors[ry][i];
      const bool skip = lf.m1 < 0.0f;
#pragma unroll
      for (int p = 0; p < kPoints; ++p) {
        const float xi = (((pos[p] - lf.cidx) - lf.frac) * dw) * lf.repwid;
        const float t = lf.sns * region0_term(xi, lf);
        acc[p] += skip ? 0.0f : t;
      }
    }
    // Pass 2: the tested lines, each sample in region 0 or, inside the
    // limit, from the line's coefficients.
    unsigned m = tested & (n < kChunk ? (1u << n) - 1u : 0xffffffffu);
    while (m) {
      const int i = __ffs(m) - 1;
      m &= m - 1u;
      const LineFactors lf = factors[ry][i];
#pragma unroll
      for (int p = 0; p < kPoints; ++p) {
        const float xi = (((pos[p] - lf.cidx) - lf.frac) * dw) * lf.repwid;
        const float kv = (fabsf(xi) < coeffs[ry][i].xlim0)
                             ? lf.m2 * humlicek_k(xi, coeffs[ry][i])
                             : region0_term(xi, lf);
        acc[p] += lf.sns * kv;
      }
    }
    __syncthreads();
  }
  if (row < rows) {
    float* out = fine + row * ((int64_t)nbins * ppb) + (int64_t)jw * ppb +
                 first;
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      if (lane + 32 * p < npts) out[lane + 32 * p] += acc[p];
    }
  }
}

__global__ void __launch_bounds__(kThreads) voigt_bins_kernel(
    const int* __restrict__ center_idx, const float* __restrict__ center_frac,
    const float* __restrict__ strength, const float* __restrict__ lorentz,
    const float* __restrict__ doppler, const float* __restrict__ ns,
    const int* __restrict__ bounds, const float* __restrict__ w_rel,
    float* __restrict__ fine, float* __restrict__ coarse, int64_t rows,
    int64_t num_lines, int start_bin, int nbins, int total_bins, int ppb,
    int64_t num_wpoints, int coarse_tiles, int64_t coarse_blocks,
    int parts, float dw) {
  __shared__ SharedBuffers sh;
  // bounds: (6, total_bins) int32: local, remote-left, remote-right
  // half-open ranges.  Tiles vary fastest: neighbouring blocks share rows
  // and most lines.
  const int64_t b = blockIdx.x;
  if (b < coarse_blocks) {
    coarse_block(sh, center_idx, center_frac, strength, lorentz, doppler, ns,
                 bounds, w_rel, coarse, rows, num_lines, start_bin, nbins,
                 total_bins, (int)(b % coarse_tiles), b / coarse_tiles, dw);
  } else {
    // Fine blocks: (row strip, bin, part of the bin), parts fastest.
    const int64_t bf = b - coarse_blocks;
    const int64_t tiles = (int64_t)nbins * parts;
    const int t = (int)(bf % tiles);
    fine_block(sh, center_idx, center_frac, strength, lorentz, doppler, ns,
               bounds, fine, rows, num_lines, start_bin, nbins, total_bins,
               ppb, num_wpoints, t / parts, t % parts, bf / tiles, dw);
  }
}

}  // namespace

// Launches the kernel on `stream`.  Returns a cudaError_t (0: launched).
extern "C" int voigt_bins(
    const void* center_idx, const void* center_frac, const void* strength,
    const void* lorentz, const void* doppler, const void* ns,
    const void* bounds, const void* w_rel, void* fine, void* coarse,
    int64_t rows, int64_t num_lines, int start_bin, int nbins,
    int total_bins, int ppb, int64_t num_wpoints, float dw, void* stream) {
  if (rows <= 0 || nbins <= 0) return 0;
  const int parts = (ppb + kSlots - 1) / kSlots;       // fine blocks a bin
  const int coarse_tiles = (nbins + kCoarseBins - 1) / kCoarseBins;
  const int64_t coarse_blocks =
      (rows + kCoarseRows - 1) / kCoarseRows * coarse_tiles;
  const int64_t blocks = coarse_blocks + (rows + kRows - 1) / kRows *
                                             (int64_t)nbins * parts;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  voigt_bins_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)center_idx, (const float*)center_frac,
      (const float*)strength, (const float*)lorentz, (const float*)doppler,
      (const float*)ns, (const int*)bounds, (const float*)w_rel,
      (float*)fine, (float*)coarse, rows, num_lines, start_bin, nbins,
      total_bins, ppb, num_wpoints, coarse_tiles, coarse_blocks, parts, dw);
  return (int)cudaGetLastError();
}
